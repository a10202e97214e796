"""Headline benchmark: sort the 40M-u32 dataset on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mkeys/s", "vs_baseline": N, ...,
   "device": {"platform", "kind", "count", "nvidia_smi"}}

Baseline: the reference's best steady-state single-core rate on the same
workload — 404.3 M keys/s (i7-8550U, `report/report-i7-8550U-2019-02-10.txt:211`
of the reference; see BASELINE.md). The dataset mirrors `make genkeys`
(`Makefile:79-82`): 40,000,000 uniform-random u32.

Methodology:
* keys are generated ON DEVICE (threefry);
* each op loops K times inside one jit with a data dependence between
  iterations — the steady-state style of the reference's Google-benchmark
  runs (`radix_bench.cpp:88-133`); the best of 2 timed runs is reported,
  each closed by ``block_until_ready``;
* the result is self-verified like the reference CLI's always-on
  `-DVERIFY_SORT` (`radix_experiment.cpp:208-212`): full-array on-device
  equality against ``jnp.sort``, plus a 1M-key host numpy check.

Off the GPU it prints ``{"ok": false, "error": ...}`` and exits 1: a CPU time
is not a device number.
"""

import json
import sys
import time

import numpy as np

BASELINE_MKEYS = 404.3  # reference best steady-state, BASELINE.md


def main() -> int:
    from radix_sorting.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    from jax import lax

    import radix_sorting as rst
    from radix_sorting.utils.gpu import NoGPUError, device_record

    try:
        device = device_record()
    except NoGPUError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1

    n = 40_000_000
    x = jax.jit(lambda: jax.random.bits(
        jax.random.PRNGKey(0x5EED), (n,), jnp.uint32))()
    x.block_until_ready()

    def sort_once(a):
        # the public keys-only path: KDF encode -> unstable hardware sort
        # (exact for keys-only; see hw_engine.sort_words) -> decode
        (w,) = rst.ops.kdf.encode(a)
        (sw,), _ = rst.ops.hw_engine.sort_words((w,), stable=False)
        return rst.ops.kdf.decode((sw,), jnp.uint32)

    # in-jit iterations amortize the per-call dispatch; the reference's
    # google-benchmark runs likewise iterate to steady state
    K = 20

    @jax.jit
    def steady(a):
        def body(i, carry):
            r = sort_once(carry)
            # Chain iterations through a multiplicative scramble: an odd
            # multiplier is a bijection mod 2^32, so every iteration sorts a
            # fresh uniform-distributed array — the measurement stays honest
            # even if a data-dependent path (e.g. the presorted guard) ever
            # enters the headline engine. (A rotate-by-1 chain would feed
            # nearly-sorted input after iteration 1 — valid only for
            # data-oblivious engines.)
            return r * np.uint32(2654435761) + (r[-1] & np.uint32(1))
        return lax.fori_loop(0, K, body, a)

    steady(x).block_until_ready()  # compile + warm
    dt = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        steady(x).block_until_ready()
        dt = min(dt, (time.perf_counter() - t0) / K)

    # Verification (like -DVERIFY_SORT): full-array on-device equality
    # against jnp.sort...
    out = sort_once(x)
    ok_dev = bool(jnp.array_equal(out, jnp.sort(x)))
    # ...plus a 1M-key host numpy check (exact, different oracle).
    m = min(n, 1_000_000)
    xs = np.asarray(x[:m])
    ok_host = bool(np.array_equal(np.asarray(sort_once(jnp.asarray(xs))),
                                  np.sort(xs)))
    ok = ok_dev and ok_host

    # secondary showcase rates, same steady-state methodology (recorded as
    # extra keys of the same single JSON line)
    def steady_rate(fn, a, reps):
        # the runtime input must flow through the loop (a closed-over array
        # would be embedded as an HLO constant, inviting constant folding);
        # best-of-2 like the headline loop
        g = jax.jit(lambda v: lax.fori_loop(0, reps, lambda i, c: fn(c), v))
        g(a).block_until_ready()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            g(a).block_until_ready()
            best = min(best, (time.perf_counter() - t0) / reps)
        return best

    # the public route with the presorted guard off, like the headline
    noguard = rst.SortConfig(detect_presorted=False)
    mask = 0xF0F00000
    xm = x & np.uint32(mask)

    def masked_once(c):
        s = rst.sort(c, value_mask=mask, config=noguard)
        return c ^ (s[0] & np.uint32(1)) ^ np.uint32(1)

    dt_masked = steady_rate(masked_once, xm, 10)

    # 16-bit full-domain keys (a 2^16-value COUNTING domain)
    xu16 = (x & np.uint32(0xFFFF)).astype(jnp.uint16)

    def u16_once(c):
        s = rst.sort(c, config=noguard)
        dep = s[0] & np.uint16(1)
        return c ^ dep ^ np.uint16(1)

    dt_u16 = steady_rate(u16_once, xu16, 8)

    ROW = 4096
    xb = x[: (n // ROW) * ROW].reshape(-1, ROW)

    def batched_once(c):
        (s,) = lax.sort((c,), dimension=1, is_stable=False, num_keys=1)
        # consume EVERY row's output so no row sort is dead code
        dep = jnp.bitwise_xor.reduce(s[:, 0]) & np.uint32(1)
        return c ^ dep ^ np.uint32(1)

    dt_batched = steady_rate(batched_once, xb, 10)

    # dense group-by tier: sum of i32 values over 2^10 dense keys — one
    # scatter-add, no sort at all
    from radix_sorting.extras import group_reduce

    def group_once(c):
        k = c & np.uint32(1023)
        v = (c >> np.uint32(10)).astype(jnp.int32)
        _, red, _ = group_reduce(k, v, reduce="sum", groups=1024, size=1024)
        # consume EVERY group's sum so no part of the reduction is dead code
        dep = jnp.bitwise_xor.reduce(lax.bitcast_convert_type(
            red, jnp.uint32)) & np.uint32(1)
        return c ^ dep ^ np.uint32(1)

    dt_group = steady_rate(group_once, x, 8)

    # Speed-of-light normalization (BASELINE north-star #2): one SAME-PROCESS
    # stream-bandwidth probe, then each case reports its effective GB/s under
    # an explicit minimum-traffic model and the fraction of delivered stream
    # bandwidth it reaches — the bytes/s-next-to-every-row discipline of the
    # reference's counters (`radix_bench.cpp:72-77`).
    from radix_sorting.utils.timing import stream_gbps
    bw = stream_gbps(x=x)

    def sol(bytes_min, dt_):
        eff = bytes_min / dt_ / 1e9
        return {"eff_GBps": round(eff, 2),
                "sol_fraction": round(eff / bw, 4)}

    mkeys = n / dt / 1e6
    rec = {
        "metric": "sort 40M u32 keys/s/chip",
        "value": round(mkeys, 1),
        "unit": "Mkeys/s",
        "vs_baseline": round(mkeys / BASELINE_MKEYS, 3),
        "ms_per_sort": round(dt * 1e3, 2),
        "verified_bit_exact": ok,
        "masked_8bit_Mkeys": round(n / dt_masked / 1e6, 1),
        "u16_full_Mkeys": round(n / dt_u16 / 1e6, 1),
        "batched_rows_Mkeys": round(xb.size / dt_batched / 1e6, 1),
        "group_dense_1024_Mrows": round(n / dt_group / 1e6, 1),
        "stream_GBps": round(bw, 1),
        # per-case minimum-traffic models: sorts/counting move one read + one
        # write of the element stream (u16 elements are 2 B); the group-by
        # reads keys+values (8 B/row) and writes only O(G)
        "sol": {
            "headline": dict(traffic="2*4n read+write key stream",
                             **sol(8 * n, dt)),
            "masked_8bit": dict(traffic="2*4n", **sol(8 * n, dt_masked)),
            "u16_full": dict(traffic="2*2n", **sol(4 * n, dt_u16)),
            "batched_rows": dict(traffic="2*4n",
                                 **sol(8 * xb.size, dt_batched)),
            "group_dense_1024": dict(traffic="8n keys+values read",
                                     **sol(8 * n, dt_group)),
        },
        "device": device,
        "n": n,
        "ok": ok,
    }
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
