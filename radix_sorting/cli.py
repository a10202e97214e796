"""Experiment CLI — the counterpart of the reference `radix` harness.

Reference usage: ``./radix <count> [<use_mmap> <use_huge> <type> <hex-mask>]``
(`radix_experiment.cpp:250`): load keys from the 40M key file, optionally
apply a hex value-mask to force column skipping (`:188-198`), time one sort
with a monotonic clock (`:200-206`), verify sortedness (`:208-212`), print
head/tail and timing (`:214-228`).

Mapping:
* ``use_mmap`` / ``use_huge`` were host-allocator experiments; the array
  lives in device memory here, so they are accepted-and-ignored for drop-in
  arg compatibility (a note is printed).
* the type dispatch covers the reference's eight CLI types
  (`radix_experiment.cpp:264-279`) plus the half floats and float8.
* verification is always on (the reference compiles the CLI with
  ``-DVERIFY_SORT``, `Makefile:61`), accepting forward or reverse order like
  `verify_sort_kf` (`radix_experiment.cpp:137-174`).

Usage:
  python -m radix_sorting.cli <count> [type] [hexmask]
  python -m radix_sorting.cli 40000000 u32 0xF0F00000
  python -m radix_sorting.cli <count> <use_mmap> <use_huge> <type> [hexmask]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

_TYPES = {
    # the reference's runtime type-name dispatch (`radix_experiment.cpp:264-279`)
    "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
    "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
    "f32": np.float32, "f64": np.float64,
    # beyond-reference extras
    "f16": np.float16, "bf16": "bfloat16",
    "f8e4m3": "float8_e4m3fn", "f8e5m2": "float8_e5m2",
}

# ml_dtypes keys (numpy cannot resolve these names via np.dtype): name -> itemsize.
# They ride as unsigned views host-side and reinterpret on device.
_ML_DTYPES = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def _parse(argv):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    count = int(argv[0])
    rest = argv[1:]
    use_mmap = False
    # accept the reference's positional (use_mmap, use_huge) pair if present
    if len(rest) >= 2 and rest[0] in ("0", "1") and rest[1] in ("0", "1"):
        use_mmap = rest[0] == "1"
        if rest[1] == "1":
            print("# note: hugepage placement is a host-allocator knob; "
                  "keys live in device memory (accepted, ignored)")
        rest = rest[2:]
    tname = rest[0] if rest else "u32"
    if tname not in _TYPES:
        sys.exit(f"unknown type {tname!r}; one of {sorted(_TYPES)}")
    mask = int(rest[1], 16) if len(rest) > 1 else None
    return count, tname, mask, use_mmap


def main(argv=None) -> int:
    count, tname, mask, use_mmap = _parse(sys.argv[1:] if argv is None else argv)

    # PGO analog (`Makefile:69-77`): persist compiled executables across CLI
    # invocations so `first_call_ms` collapses to H2D + dispatch on repeat
    # runs.
    from radix_sorting.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp

    import radix_sorting as rst
    from radix_sorting.utils import keyfile, verify

    # dataset: the cached 40M key file, reinterpreted at the requested type
    # (the reference reads the same bytes as any type, `radix_experiment.cpp:78`)
    dt = _TYPES[tname]
    itemsize = _ML_DTYPES[dt] if dt in _ML_DTYPES else np.dtype(dt).itemsize
    # ceil-divide: the +1 blunt form over-requested one word at 40M u32 and
    # triggered a pointless full keyfile rewrite under the growth check
    words_needed = -(-count * itemsize // 4)
    if use_mmap:
        # real mmap-backed host read via the native runtime (the reference's
        # `my_allocate` mmap path + provenance print, `radix_experiment.cpp:53-76`);
        # numpy read fallback when no toolchain is present
        from radix_sorting.runtime import native
        keyfile.load_or_create(words_needed)  # ensure the file exists AND covers the request
        raw = native.read_keyfile(keyfile.default_keyfile(), words_needed)
        print("# allocation: native mmap read" if native.available()
              else "# allocation: numpy read (native runtime unavailable)")
        raw = raw.view(np.uint8)
    else:
        raw = keyfile.load_or_create(words_needed).view(np.uint8)
    if raw.size < count * itemsize:
        sys.exit(f"dataset too small for {count} x {tname}")
    if dt in _ML_DTYPES:
        x_np = raw[: count * itemsize].view(np.dtype(f"u{itemsize}"))
    else:
        x_np = raw[: count * itemsize].view(dt)

    if mask is not None:
        # type-punned bitwise mask, like the memcpy mask of `:188-198`
        u = x_np.view(np.dtype(f"u{itemsize}"))
        u = (u & np.dtype(f"u{itemsize}").type(mask & ((1 << (8 * itemsize)) - 1)))
        x_np = u.view(x_np.dtype)

    if dt in _ML_DTYPES:
        x = jnp.asarray(x_np).view(jnp.dtype(dt))
    elif itemsize == 8:
        x = x_np  # 64-bit numpy path (works without x64)
    else:
        x = jnp.asarray(x_np)

    # The reference times ONLY the sort (`radix_experiment.cpp:204-206`) —
    # allocation and file IO sit outside the clock. The JAX analog: the first
    # call pays trace+compile (and H2D for host inputs), so it is reported
    # separately as `first_call_ms`, and the comparable `ms` is a warm second
    # call on the SAME input, closed by `block_until_ready` (the fetch for
    # verification/head/tail rides the untimed first call; both calls run
    # the identical program on the identical input).
    t0 = time.perf_counter()
    out = rst.sort(x, value_mask=mask)
    out_np = np.asarray(out)
    first_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    out2 = rst.sort(x, value_mask=mask)
    if not isinstance(out2, np.ndarray):  # 64-bit numpy path is on host
        out2.block_until_ready()
    dt_s = time.perf_counter() - t0

    # the raw host bytes are the expectation: NaN payloads survive the device
    # bit for bit (f16 included; checked on an H100 by chip_smoke.py)
    ok = verify.is_sorted(out_np if itemsize != 8 else out_np.astype(x_np.dtype))
    ok = ok and verify.same_multiset(out_np.view(x_np.dtype) if out_np.dtype != x_np.dtype
                                     else out_np, x_np)

    head = ", ".join(str(v) for v in out_np[:4])
    tail = ", ".join(str(v) for v in out_np[-4:])
    print(f"# head: {head}")
    print(f"# tail: {tail}")
    rec = {
        "n": count,
        "type": tname,
        "mask": f"0x{mask:08X}" if mask is not None else None,
        "ms": round(dt_s * 1e3, 2),
        "first_call_ms": round(first_ms, 2),
        "Mkeys_per_s": round(count / dt_s / 1e6, 1),
        "bytes_per_s": round(count * itemsize / dt_s, 0),
        "verified": bool(ok),
    }
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
