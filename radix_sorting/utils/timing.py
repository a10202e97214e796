"""Tracing / profiling subsystem (SURVEY §5 row 1).

The reference wraps runs in `perf stat` (`Makefile:18-20`), times with
`CLOCK_MONOTONIC_RAW` (`radix_experiment.cpp:200-206`), and derives
KeyRate/bytes-per-second counters (`radix_bench.cpp:72-77`). Device-side
equivalents:

* :func:`steady_state_ms` — steady-state op timing (loops inside one jit
  with a folding-proof data dependence; closes with ``block_until_ready``).
* :func:`counters` — KeyRate / bytes-per-second derivation.
* :func:`trace` — context manager around `jax.profiler` for device traces,
  and :func:`device_op_table`, its reduction to per-op device time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np

__all__ = ["steady_state_ms", "steady_chain_ms", "stream_gbps", "counters",
           "trace", "device_op_table"]


def steady_state_ms(fn: Callable, x, reps: int = 4) -> float:
    """Per-op steady-state milliseconds of ``fn(x) -> array``.

    Lightweight generic helper (any output shape/dtype). Its xor chain feeds
    nearly identical input every iteration — for engines with data-dependent
    paths (presorted guard, device probe) use :func:`steady_chain_ms`, whose
    scramble keeps each iteration's input fresh.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def outer(a):
        def body(i, c):
            r = fn(c)
            return c ^ (jnp.ravel(r)[-1].astype(c.dtype) & c.dtype.type(1))
        return lax.fori_loop(0, reps, body, a)

    g = jax.jit(outer)
    g(x).block_until_ready()  # compile + warm
    t0 = time.perf_counter()
    g(x).block_until_ready()
    return (time.perf_counter() - t0) * 1e3 / reps


def steady_chain_ms(fn: Callable, x, reps: int = 8, repeats: int = 2,
                    aux=None) -> float:
    """Canonical scramble-chained steady-state harness (u32-plane ops).

    * ``reps`` iterations inside ONE jit (`lax.fori_loop`): amortizes the
      per-dispatch overhead.
    * iterations chain through a multiplicative scramble with a REAL data
      dependence on the result (``c * 2654435761 + (r[-1] & 1)``): an odd
      multiplier is a bijection mod 2^32, so every iteration sees fresh
      uniform data — honest even for data-dependent engines — and the
      ``& 1`` term cannot be constant-folded/DCE'd the way ``& 0`` was.
      Callers measuring *structured* inputs (narrow range, masked) must
      restore the structure inside ``fn`` (mask + re-offset), as the chain
      deliberately destroys it.
    * closes with ``block_until_ready``.
    * best of ``repeats`` outer runs.

    ``aux``: optional extra device operand passed as ``fn(c, aux)``. It
    enters the jit as a RUNTIME argument — a closed-over device array would
    be embedded as an HLO constant, inviting XLA to fold any reduce over it
    (exactly the bug this parameter exists to prevent: a constant u64 hi
    plane folding the range probe's min/max and faking the probe as free).
    """
    import jax
    from jax import lax

    def chain(c, r):
        # dtype-generic: the odd multiplier truncated to the key width stays
        # odd, hence a bijection mod 2^bits
        m = c.dtype.type(2654435761 & np.iinfo(c.dtype).max)
        return c * m + r[-1].astype(c.dtype) % c.dtype.type(2)

    if aux is None:
        def outer(a):
            return lax.fori_loop(0, reps, lambda i, c: chain(c, fn(c)), a)

        g = jax.jit(outer)
        args = (x,)
    else:
        def outer(a, h):
            return lax.fori_loop(0, reps, lambda i, c: chain(c, fn(c, h)), a)

        g = jax.jit(outer)
        args = (x, aux)

    g(*args).block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        g(*args).block_until_ready()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def stream_gbps(n: int = 40_000_000, reps: int = 20, x=None) -> float:
    """Same-process effective device-memory stream bandwidth (GB/s), the
    denominator of every speed-of-light fraction in the bench artifacts.

    One u32 multiply-add chain = one read + one write stream of the whole
    array per iteration, measured in the same process as the numbers it
    normalizes. Pass ``x`` to reuse an on-device u32 array.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if x is None:
        x = jnp.asarray(np.random.default_rng(1).integers(
            0, 1 << 32, size=n, dtype=np.uint32))
    else:
        n = int(x.shape[0])

    @jax.jit
    def g(a):
        return lax.fori_loop(
            0, reps, lambda i, c: c * np.uint32(2654435761) + np.uint32(1), a)

    g(x).block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        g(x).block_until_ready()
        best = min(best, (time.perf_counter() - t0) / reps)
    return 2 * 4 * n / best / 1e9


def counters(n: int, ms: float, itemsize: int = 4) -> dict:
    """KeyRate / bytes-per-second counters (`radix_bench.cpp:72-77`)."""
    s = ms / 1e3
    return {
        "KeyRate": n / s,
        "bytes_per_second": n * itemsize / s,
        "ms": ms,
    }


@contextlib.contextmanager
def trace(logdir: str, perfetto: bool = True):
    """Capture a device profile around a block (`jax.profiler` trace).

    ``perfetto=True`` additionally writes ``perfetto_trace.json.gz`` — plain
    gzipped Chrome-trace JSON that :func:`device_op_table` reduces to an
    op-level table without any profiler plugin.
    """
    import jax

    jax.profiler.start_trace(logdir, create_perfetto_trace=perfetto)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def device_op_table(logdir: str) -> list:
    """Aggregate the newest perfetto trace under ``logdir`` into a per-op
    device-time table, the counterpart of the reference's archived
    perf-stat sections (`bench.sh:14-17`).

    Device processes are the ones named ``/device:GPU:<i>``. Within them the
    ``XLA Ops`` thread, where the trace has one, names each event by its HLO
    op; otherwise the ``Stream #...`` threads name the kernels. Returns rows
    ``{"op", "total_us", "calls"}`` sorted by total time (all devices
    summed).
    """
    import collections
    import glob
    import gzip
    import json as _json

    paths = sorted(glob.glob(
        f"{logdir}/plugins/profile/*/perfetto_trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no perfetto trace under {logdir}")
    with gzip.open(paths[-1]) as f:
        evs = _json.load(f)["traceEvents"]
    meta = [e for e in evs if e.get("ph") == "M"]
    dev_pids = {e["pid"] for e in meta if e.get("name") == "process_name"
                and "/device:GPU" in str(e.get("args", {}).get("name", ""))}
    threads = {(e["pid"], e["tid"]): str(e.get("args", {}).get("name", ""))
               for e in meta if e.get("name") == "thread_name"
               and e["pid"] in dev_pids}
    op_tids = ({k for k, v in threads.items() if v == "XLA Ops"}
               or {k for k, v in threads.items() if v.startswith("Stream")})
    tot = collections.Counter()
    calls = collections.Counter()
    for e in evs:
        if (e.get("ph") == "X"
                and (e.get("pid"), e.get("tid")) in op_tids):
            tot[e["name"]] += e.get("dur", 0.0)
            calls[e["name"]] += 1
    return [{"op": name, "total_us": us, "calls": calls[name]}
            for name, us in tot.most_common()]
