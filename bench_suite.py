"""Benchmark suite — the counterpart of the reference's Google-benchmark
binary (`radix_bench.cpp:14-141`) plus its `bench.sh` report writer.

Sweeps n = 1 ... 40,000,000 x10 (`radix_bench.cpp:135-138`) over:
  * radix_sort        (keys-only value sort, the framework's general path)
  * radix_sort_rank   (stable argsort, `radix_bench.cpp:107-121`)
  * masked counting   (the column-skip showcase, 8 live bits)
  * jnp.sort          (the `std::sort` stand-in baseline, `:123-127`)

Reports KeyRate (keys/s) and bytes/s derived counters exactly like the
fixture's UpdateCounters (`radix_bench.cpp:72-77`), and writes a dated
report file with environment info in the spirit of `bench.sh:6-18`.

Usage: python bench_suite.py [--quick] [--out report/]

Runs on a GPU only: off the GPU it exits nonzero before measuring. Every
report names the card (JAX platform, device kind and count, and the card's
name and power limit from ``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _sizes(quick: bool):
    sizes = []
    n = 1
    while n < 40_000_000:
        sizes.append(n)
        n *= 10
    sizes.append(40_000_000)
    return sizes[-3:] if quick else sizes


def _steady_ms(fn, x, reps, repeats=2):
    """Steady-state per-op time; loops inside one jit, closes with readback.

    Deliberately NOT `utils.timing.steady_chain_ms`: the suite's cases carry
    static domain promises (masked keys, u16, batched rows) that the
    canonical scramble chain would destroy between iterations; this chain
    flips only bit 0 of the input by an output bit, preserving every case's
    distribution/mask contract. Best-of-``repeats`` matches the canonical
    harness.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def outer(a):
        def body(i, c):
            r = fn(c)
            # real data dependence (defeats DCE) that leaves the workload's
            # distribution intact: flip bit 0 of the input by an output bit.
            # A ~4096-point strided sample XOR-reduced spreads the consumed
            # output across the whole result (a single consumed element would
            # leave more of the op vulnerable to slice-of-sort rewrites).
            flat = jnp.ravel(r)
            dep = jnp.bitwise_xor.reduce(flat[:: max(1, flat.size // 4096)])
            return c ^ (dep.astype(c.dtype) & c.dtype.type(1))
        return lax.fori_loop(0, reps, body, a)

    g = jax.jit(outer)
    np.asarray(g(x)[-1:])  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.asarray(g(x)[-1:])
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def stage_breakdown(n: int, reps: int = 10):
    """Per-stage timing of the headline sort (SURVEY §5 tracing row; the
    counterpart of the reference's perf-stat sections, `bench.sh:14-17`).

    Method: each tier is measured as PIPELINE PREFIXES (stage 1, stages
    1-2, full), every prefix steady-looped with a data dependence on the
    varying key input; stage cost = difference of adjacent prefixes. A
    prefix loop cannot be constant-folded (its input varies per iteration),
    which a fixed-input per-stage loop could be.
    """
    import jax.numpy as jnp

    from radix_sorting.ops import hw_engine, kdf
    from radix_sorting.utils import keyfile

    keys = keyfile.generate_keys(n)
    rows = []

    def prefixes(tier, x, fns, reps=reps):
        prev = 0.0
        for stage, fn in fns:
            ms = _steady_ms(fn, x, reps)
            rows.append({"tier": tier, "stage": stage,
                         "cum_ms": round(ms, 3),
                         "stage_ms": round(ms - prev, 3)})
            print(json.dumps(rows[-1]), flush=True)
            prev = ms

    # headline: encode -> oblivious sort -> decode (u32 encode/decode are
    # identity bijections — their measured cost is the stream truth)
    prefixes("headline_u32", jnp.asarray(keys), [
        ("encode", lambda a: kdf.encode(a)[0]),
        ("encode+sort", lambda a: hw_engine.sort_words(
            kdf.encode(a), stable=False)[0][0]),
        ("full(+decode)", lambda a: kdf.decode(
            hw_engine.sort_words(kdf.encode(a), stable=False)[0],
            jnp.uint32)),
    ])

    return rows


def hbm_sweep():
    """HBM-scale rows: 2^25 / 2^25+1 (the pow2-cliff pair) and 160M / 200M
    u32 (beyond the reference's 40M table ceiling, `radix_bench.cpp:135-138`).

    Keys are generated ON DEVICE (threefry). Each row is verified bit-exact
    on device against XLA's stable sorter and carries the same SoL fields
    as the main sweep.
    """
    import jax
    import jax.numpy as jnp

    from radix_sorting.ops import hw_engine, kdf
    from radix_sorting.utils.timing import stream_gbps

    def value_sort(a):
        (w,) = kdf.encode(a)
        (sw,), _ = hw_engine.sort_words((w,), stable=False)
        return kdf.decode((sw,), jnp.uint32)

    rows = []
    bw = None
    for n in (1 << 25, (1 << 25) + 1, 160_000_000, 200_000_000):
        x = jax.jit(lambda nn=n: jax.random.bits(
            jax.random.PRNGKey(nn & 0xFFFF), (nn,), jnp.uint32))()
        np.asarray(x[-1:])
        if bw is None:
            bw = stream_gbps(x=x[: 1 << 25])
            rows.append({"stream_GBps": round(bw, 1)})
            print(json.dumps(rows[-1]), flush=True)
        reps = 4 if n >= 100_000_000 else 8
        ms = _steady_ms(value_sort, x, reps)
        ok = bool(np.asarray(jnp.array_equal(value_sort(x), jnp.sort(x))))
        eff = 8 * n / (ms / 1e3) / 1e9
        rows.append({
            "case": "radix_sort", "n": n, "ms": round(ms, 3),
            "KeyRate": round(n / (ms / 1e3), 0),
            "bytes_per_second": round(4 * n / (ms / 1e3), 0),
            "min_traffic_bytes": 8 * n,
            "eff_GBps": round(eff, 2),
            "sol_fraction": round(eff / bw, 4),
            "verified_bit_exact": ok,
        })
        print(json.dumps(rows[-1]), flush=True)
        del x
    return rows


def _report(outdir, kind: str, device: dict, **fields) -> None:
    """Write one dated report file naming the card (bench.sh analog)."""
    import jax

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True,
                         text=True).stdout.strip() or "nogit"
    dev = device["kind"].replace(" ", "-")
    path = outdir / f"{kind}-{dev}-{datetime.date.today().isoformat()}-{sha}.json"
    path.write_text(json.dumps({
        "uname": platform.uname()._asdict(), "sha": sha, "device": device,
        "jax": jax.__version__, **fields}, indent=2))
    print(f"# wrote {path}")


def main() -> int:
    from radix_sorting.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="only the top sizes")
    ap.add_argument("--out", default="report", help="report directory")
    ap.add_argument("--stages", action="store_true",
                    help="per-stage breakdown of the headline sort")
    ap.add_argument("--stages-n", type=int, default=40_000_000)
    ap.add_argument("--hbm", action="store_true",
                    help="HBM-scale sweep: 2^25 +/- the pow2 cliff, 160M, "
                    "200M u32 rows, keys generated on device")
    args = ap.parse_args()

    import jax.numpy as jnp

    import radix_sorting as rst
    from radix_sorting.ops import hw_engine, kdf
    from radix_sorting.utils import keyfile
    from radix_sorting.utils.gpu import NoGPUError, device_record

    try:
        device = device_record()
    except NoGPUError as e:
        print(f"bench_suite: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"device": device}), flush=True)

    if args.hbm:
        _report(args.out, "hbm", device, rows=hbm_sweep())
        return 0

    if args.stages:
        _report(args.out, "stages", device, n=args.stages_n,
                rows=stage_breakdown(args.stages_n))
        return 0

    keys = keyfile.generate_keys(40_000_000)
    mask = 0xF0F00000

    def value_sort(a):
        (w,) = kdf.encode(a)
        (sw,), _ = hw_engine.sort_words((w,), stable=False)
        return kdf.decode((sw,), jnp.uint32)

    def rank_sort(a):
        (w,) = kdf.encode(a)
        _, perm = hw_engine.argsort_words((w,))
        return perm

    # the COUNTING contract through the public API, with the presorted
    # guard off like the other cases
    counting = rst.SortConfig(strategy=rst.Strategy.COUNTING,
                              detect_presorted=False)

    def masked_sort(a):
        return rst.sort(a, value_mask=mask, config=counting)

    mask13 = 0x1FFF << 7  # 13 live bits

    def masked13_sort(a):
        return rst.sort(a, value_mask=mask13, config=counting)

    def u16_sort(a):
        return rst.sort(a, config=counting)

    def bf16_sort(a):
        # bfloat16 keys are a dense 16-bit domain. Takes RAW u16 bits (the
        # steady-state chain needs an integer input) and bitcasts in-graph
        from jax import lax
        s = rst.sort(lax.bitcast_convert_type(a, jnp.bfloat16),
                     config=counting)
        return lax.bitcast_convert_type(s, jnp.uint16)

    def f8_sort(a):
        # float8 keys are a dense 8-bit domain
        from jax import lax
        s = rst.sort(lax.bitcast_convert_type(a, jnp.dtype("float8_e4m3fn")),
                     config=counting)
        return lax.bitcast_convert_type(s, jnp.uint8)

    def pairs_sort(a):
        # stable record sort: key + one u32 payload plane riding the sorter
        (w,) = kdf.encode(a)
        (sw,), (p,) = hw_engine.sort_words((w,), (a,))
        return p

    # plane compaction: masked u64 keys (24 live bits across both planes)
    # + payload ship as TWO sorter operands instead of three
    cm_hi, cm_lo = 0x00003FFF, 0xFFC00000

    def pairs_masked_u64_compacted(a):
        from jax import lax

        from radix_sorting.ops import probes
        hi = a & np.uint32(cm_hi)
        lo = (a * np.uint32(2654435761)) & np.uint32(cm_lo)
        merged = probes.compact_word_planes((hi, lo), (cm_hi, cm_lo))
        s, p = lax.sort((merged, a), dimension=0, is_stable=True, num_keys=1)
        sh, sl = probes.expand_word_planes(s, (hi, lo), (cm_hi, cm_lo))
        return sh ^ sl ^ p

    ROW = 4096

    def batched_sort(a):
        # independent row sorts (one fused dispatch) — no reference analog
        (w,) = kdf.encode(a)
        from jax import lax
        (s,) = lax.sort((w,), dimension=1, is_stable=False, num_keys=1)
        return kdf.decode((s,), jnp.uint32)

    def group_dense_sum(a):
        # dense group-by tier: keys/values derived from the chained
        # operand inside the jit (keys dense in [0, 1024), i32 values);
        # returns the per-group sums so the chain consumes real output
        from radix_sorting.extras import group_reduce
        k = a & np.uint32(1023)
        v = (a >> np.uint32(10)).astype(jnp.int32)
        _, red, _ = group_reduce(k, v, reduce="sum", groups=1024, size=1024)
        return red.astype(jnp.uint32)

    cases = {
        "radix_sort": (value_sort, lambda n: jnp.asarray(keys[:n])),
        "group_reduce_dense_1024": (
            group_dense_sum, lambda n: jnp.asarray(keys[:n])),
        "radix_sort_rank": (rank_sort, lambda n: jnp.asarray(keys[:n])),
        "radix_sort_pairs": (pairs_sort, lambda n: jnp.asarray(keys[:n])),
        "pairs_masked_u64_compacted": (
            pairs_masked_u64_compacted, lambda n: jnp.asarray(keys[:n])),
        "counting_masked": (masked_sort, lambda n: jnp.asarray(keys[:n] & np.uint32(mask))),
        "counting_13bit": (
            masked13_sort, lambda n: jnp.asarray(keys[:n] & np.uint32(mask13))),
        "counting_u16": (
            u16_sort, lambda n: jnp.asarray(keys[:n].astype(np.uint16))),
        "counting_bf16": (
            bf16_sort, lambda n: jnp.asarray(keys[:n].astype(np.uint16))),
        "counting_f8": (
            f8_sort, lambda n: jnp.asarray(keys[:n].astype(np.uint8))),
        "jnp_sort_baseline": (jnp.sort, lambda n: jnp.asarray(keys[:n])),
        "batched_rows_4096": (
            batched_sort,
            lambda n: (jnp.asarray(keys[: (n // ROW) * ROW].reshape(-1, ROW))
                       if n >= ROW else None),
        ),
    }

    # Speed-of-light normalization: ONE same-process stream probe, then every
    # row carries its effective GB/s under an explicit minimum-traffic model
    # and the fraction of delivered stream bandwidth it reaches (the
    # memory-bound question must be answerable from the artifact, like the
    # reference's per-row bytes/s — `radix_bench.cpp:72-77`).
    from radix_sorting.utils.timing import stream_gbps
    bw = stream_gbps(x=jnp.asarray(keys))
    print(json.dumps({"stream_GBps": round(bw, 1)}), flush=True)
    # minimum traffic per element: one read + one write of the element
    # stream (2 * itemsize) unless the case moves extra planes
    traffic_override = {
        "radix_sort_pairs": 16,            # (key, payload) both ways
        "pairs_masked_u64_compacted": 24,  # (hi, lo, payload) both ways
    }

    rows = []
    for n in _sizes(args.quick):
        # enough in-jit iterations to amortize the per-call dispatch
        # (google-benchmark style: more reps at smaller sizes)
        reps = max(10, min(20, 20_000_000 // max(n, 1)))
        for name, (fn, mk) in cases.items():
            x = mk(n)
            if x is None:  # case inapplicable at this size (SkipWithError style)
                continue
            n_eff = int(np.prod(x.shape))
            ms = _steady_ms(fn, x, reps)
            itemsize = x.dtype.itemsize        # u16 case is 2 bytes, not 4
            tb = traffic_override.get(name, 2 * itemsize) * n_eff
            eff = tb / (ms / 1e3) / 1e9
            rows.append({
                "case": name,
                "n": n_eff,
                "ms": round(ms, 4),
                "KeyRate": round(n_eff / (ms / 1e3), 0),
                "bytes_per_second": round(n_eff * itemsize / (ms / 1e3), 0),
                "min_traffic_bytes": tb,
                "eff_GBps": round(eff, 2),
                "sol_fraction": round(eff / bw, 4),
            })
            print(json.dumps(rows[-1]), flush=True)

    _report(args.out, "report", device, rows=rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
