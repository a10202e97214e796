# Developer entry points, mirroring the reference Makefile's targets
# (`Makefile:52-82`: all/test/bench/opt/genkeys) in this repo's terms.

PY ?= python
# tests run on the CPU with 8 virtual devices (tests/conftest.py sets them)
TESTENV = JAX_PLATFORMS=cpu

.PHONY: all test memcheck bench bench-suite smoke smoke-four genkeys native clean help parity-driver parity-check parity-check-quick diagrams

all: native

# build the native host runtime (`radix_sorting/native/radix_rt.cpp`);
# fails the make when the build fails (a bare availability print let a broken
# toolchain green-light `make all` — round-3 review)
native:
	$(PY) -c "from radix_sorting.runtime import native; import sys; ok = native.available(); print('native:', ok); sys.exit(0 if ok else 1)"

# CPU test suite (8 virtual devices; `make test` analog, Makefile:54-55)
test:
	$(TESTENV) $(PY) -m pytest tests/ -x -q

# single source of truth for the ledger test counts (PARITY row 12 /
# ROADMAP verification section): collection counts per opt-in gate.
# The "selected" count of each row is what that gate ADDS.
counts:
	@$(TESTENV) $(PY) -m pytest tests/ -q --collect-only 2>/dev/null | tail -1 | sed 's/^/default (property+mesh): /'
	@RST_SOAK=1 $(TESTENV) $(PY) -m pytest tests/test_soak.py -q --collect-only 2>/dev/null | tail -1 | sed 's/^/soak gate adds:           /'
	@RST_MULTIPROC=1 $(TESTENV) $(PY) -m pytest tests/test_multiprocess.py -q --collect-only 2>/dev/null | tail -1 | sed 's/^/multiproc gate adds:       /'

# sanitizer-analog pass (`MEMCHECK=1 make test` analog, Makefile:14-16):
# checkify NaN/OOB/div checks over the engines at small sizes. Also part of
# the plain `test` run — this target runs it alone, verbosely.
memcheck:
	$(TESTENV) $(PY) -m pytest tests/test_checkify.py -v

# headline benchmark on the attached GPU (`make bench` analog, Makefile:57-58);
# exits nonzero off the GPU
bench:
	$(PY) bench.py

# the public API at 40M keys on one GPU, against host oracles
smoke:
	$(PY) chip_smoke.py

# the distributed sorts on a 4-GPU mesh, one process
smoke-four:
	$(PY) chip_smoke.py --four

# full size-sweep suite + dated report (bench.sh analog)
bench-suite:
	$(PY) bench_suite.py --out report

# --- bit-exact parity vs the ACTUAL reference implementation ---------------
# REF points at the reference checkout; its header-only templates are
# included at build time (no reference code is vendored into this repo).
REF ?= /root/reference

parity-driver: parity/ref_driver

parity/ref_driver: parity/ref_driver.cpp
	g++ -O2 -std=gnu++17 -fpermissive -I$(REF) $< -o $@

# full-array byte-exact compare: 8 types x {no mask, 0xF0F00000} x fwd/rev
# value sorts + all-type fwd/rev rank permutations (BASELINE.md target #1).
# Exits nonzero on any mismatch.
parity-check: parity/ref_driver
	$(PY) scripts/parity_check.py

parity-check-quick: parity/ref_driver
	$(TESTENV) $(PY) scripts/parity_check.py --quick

# render architecture diagrams (the reference's data/Makefile analog);
# degrades to a notice when graphviz is absent
diagrams:
	@if command -v dot >/dev/null 2>&1; then \
		for f in docs/*.dot; do dot $$f -Tsvg -o $${f%.dot}.svg && echo "rendered $${f%.dot}.svg" || exit 1; done; \
	else \
		echo "graphviz 'dot' not installed; diagram sources in docs/*.dot"; \
	fi

# create the 40M-key dataset (`make genkeys` analog, Makefile:79-82)
genkeys:
	$(PY) -c "from radix_sorting.utils import keyfile; keyfile.load_or_create(); print(keyfile.default_keyfile())"

clean:
	rm -rf radix_sorting/native/build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

help:
	@grep -E '^[a-z-]+:' Makefile | sed 's/:.*//'
