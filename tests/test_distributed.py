"""Distributed shuffle tests on the 8-device host-local CPU mesh.

The reference has no multi-node code; these tests validate the net-new
scale-out layer (SURVEY §2 parallelism statement) the idiomatic way: a
virtual mesh via xla_force_host_platform_device_count (SURVEY §4).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from radix_sorting.parallel import (
    distributed_argsort_u32,
    distributed_sort_pairs_u32,
    distributed_sort_u32,
    gather_sorted,
    global_digit_histogram,
    global_live_bit_mask,
    make_sort_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    return make_sort_mesh(8)


def test_mesh_has_8(mesh):
    assert mesh.shape["shards"] == 8


def test_distributed_sort_uniform(rng, mesh):
    n = 1 << 17
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh)
    assert int(np.asarray(ovf)[0]) == 0
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, np.sort(x))
    # balance: no shard wildly above uniform share
    c = np.asarray(counts)
    assert c.sum() == n
    assert c.max() <= int(n / 8 * 1.5)


def test_distributed_sort_skewed_exact(rng, mesh):
    # adversarial skew: 90% of keys in one narrow range + constant block
    n = 1 << 16
    x = np.concatenate([
        np.full(n // 2, 0x0000BEEF, np.uint32),
        (rng.integers(0, 1 << 12, size=n // 4, dtype=np.uint32) + 0x10).astype(np.uint32),
        rng.integers(0, 1 << 32, size=n // 4, dtype=np.uint32),
    ])
    rng.shuffle(x)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh, exact=True)
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, np.sort(x))


def test_distributed_sort_all_equal_bypass(mesh):
    # all keys identical: the all-equal bypass keeps data in place — no
    # exchange hotspot, no overflow
    n = 1 << 15
    x = np.full(n, 0xABCD1234, np.uint32)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh)
    assert int(np.asarray(ovf)[0]) == 0
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, x)


def test_distributed_sort_overflow_detected(rng, mesh):
    # two distinct values on 8 devices: two devices receive ~n/2 each; the
    # default capacity must overflow and the flag must say so (never silent)
    n = 1 << 15
    x = rng.integers(0, 2, size=n, dtype=np.uint32)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh)
    assert int(np.asarray(ovf)[0]) != 0
    with pytest.raises(RuntimeError):
        gather_sorted(sp, counts, ovf)
    # exact mode handles it
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh, exact=True)
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, np.sort(x))


def test_distributed_sort_presorted_and_reverse(mesh):
    n = 1 << 15
    for x in [np.arange(n, dtype=np.uint32) * 7,
              (np.arange(n, dtype=np.uint32) * 13)[::-1].copy()]:
        sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh)
        out = gather_sorted(sp, counts, ovf)
        assert np.array_equal(out, np.sort(x))


def test_global_histogram(rng, mesh):
    n = 1 << 15
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    h = np.asarray(global_digit_histogram(jnp.asarray(x), mesh, pass_index=3))
    assert np.array_equal(h, np.bincount(x >> 24, minlength=256))


def test_global_live_mask(rng, mesh):
    base = np.uint32(0x90000001)
    x = ((rng.integers(0, 16, size=1 << 15, dtype=np.uint32) << 12) | base).astype(np.uint32)
    m = global_live_bit_mask(jnp.asarray(x), mesh)
    assert int(m) == 0xF000


def test_distributed_sort_ragged_n(rng, mesh):
    # n not divisible by D^2: driver pads with sentinels and adjusts counts
    n = (1 << 15) + 1234
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh)
    out = gather_sorted(sp, counts, ovf)
    assert out.shape[0] == n
    assert np.array_equal(out, np.sort(x))
    # sentinel-heavy tail: real 0xFFFFFFFF keys must survive padding logic
    x2 = np.concatenate([x[: n - 100], np.full(100, 0xFFFFFFFF, np.uint32)])
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x2), mesh)
    out2 = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out2, np.sort(x2))


def test_splitter_bits_variants(rng, mesh):
    x = rng.integers(0, 1 << 32, size=1 << 15, dtype=np.uint32)
    for sb in (8, 10, 12):
        sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh, splitter_bits=sb)
        out = gather_sorted(sp, counts, ovf)
        assert np.array_equal(out, np.sort(x))


def test_distributed_argsort(rng, mesh):
    # duplicate-heavy keys: the permutation must be exactly the stable one
    n = 1 << 15
    x = rng.integers(0, 1000, size=n, dtype=np.uint32)
    sk, perm, counts, ovf = distributed_argsort_u32(jnp.asarray(x), mesh)
    keys_sorted = gather_sorted(sk, counts, ovf)
    perm_g = gather_sorted(perm, counts, ovf)
    assert np.array_equal(perm_g, np.argsort(x, kind="stable").astype(np.uint32))
    assert np.array_equal(keys_sorted, np.sort(x))


def test_distributed_argsort_presorted(rng, mesh):
    n = 1 << 14
    x = np.repeat(np.arange(n // 4, dtype=np.uint32), 4)  # sorted with dups
    sk, perm, counts, ovf = distributed_argsort_u32(jnp.asarray(x), mesh)
    perm_g = gather_sorted(perm, counts, ovf)
    assert np.array_equal(perm_g, np.arange(n, dtype=np.uint32))


def test_distributed_sort_pairs(rng, mesh):
    n = (1 << 14) + 321  # ragged: exercises padding with payload
    x = rng.integers(0, 512, size=n, dtype=np.uint32)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sk, pl, counts, ovf = distributed_sort_pairs_u32(
        jnp.asarray(x), jnp.asarray(payload), mesh)
    keys_sorted = gather_sorted(sk, counts, ovf)
    payload_sorted = gather_sorted(pl, counts, ovf)
    order = np.argsort(x, kind="stable")
    assert np.array_equal(keys_sorted, x[order])
    assert np.array_equal(payload_sorted, payload[order])


def test_distributed_sort_rejects_stray_kwargs(rng, mesh):
    from radix_sorting.parallel import distributed_sort
    x = jnp.asarray(rng.integers(0, 1 << 32, size=1 << 10, dtype=np.uint32))
    # shuffle-only knobs must not be silently dropped by the balanced default
    with pytest.raises(TypeError, match="does not accept"):
        distributed_sort(x, mesh, exact=True)
    with pytest.raises(TypeError, match="does not accept"):
        distributed_sort(x, mesh, method="shuffle", chunk=64)
    with pytest.raises(ValueError, match="unknown method"):
        distributed_sort(x, mesh, method="bogus")


@pytest.mark.parametrize("method", ["balanced", "shuffle"])
def test_distributed_sort_generic_dtypes(rng, mesh, method):
    from radix_sorting.parallel import distributed_sort
    n = 1 << 14
    # float32 (KDF order incl. negatives)
    xf = rng.standard_normal(n).astype(np.float32)
    vals, counts, ovf = distributed_sort(jnp.asarray(xf), mesh, method=method)
    out = gather_sorted(jnp.asarray(vals).view(jnp.uint32), counts, ovf).view(np.float32)
    assert np.array_equal(out, np.sort(xf))
    # int32 descending
    xi = rng.integers(-1 << 31, 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    vals, counts, ovf = distributed_sort(jnp.asarray(xi), mesh, descending=True,
                                         method=method)
    out = gather_sorted(jnp.asarray(vals).view(jnp.uint32), counts, ovf).view(np.int32)
    assert np.array_equal(out, np.sort(xi)[::-1])
    # uint64 (two-plane keys)
    x64 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    vals, counts, ovf = distributed_sort(x64, mesh, method=method)
    v = np.asarray(vals, dtype=np.uint64)
    counts_np = np.asarray(counts)
    D = counts_np.shape[0]
    flat = v.reshape(D, -1)
    out = np.concatenate([flat[d, : counts_np[d]] for d in range(D)])
    assert np.array_equal(out, np.sort(x64))


def test_distributed_pairs_all_equal_exact(rng, mesh):
    # all-equal keys with payload: bypass is disabled; exact mode must keep
    # the stable (index) order end-to-end
    n = 1 << 13
    x = np.full(n, 7, np.uint32)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sk, pl, counts, ovf = distributed_sort_pairs_u32(
        jnp.asarray(x), jnp.asarray(payload), mesh, exact=True)
    payload_sorted = gather_sorted(pl, counts, ovf)
    assert np.array_equal(payload_sorted, payload)


def test_device_of_bucket_exact_at_large_n(rng):
    # `_device_of_bucket` must stay exact for totals approaching 2^31
    # (int32 threshold arithmetic; a float32 formulation loses integer
    # precision above ~2^24 and can shift bucket->device boundaries).
    from radix_sorting.parallel.shuffle import _device_of_bucket

    B = 4096
    for D in (2, 8, 64):
        for total in (2**31 - 1, 2**31 - B, 2**24 + 17, 1000):
            base = total // B
            hist = np.full(B, base, np.int64)
            hist[: total - base * B] += 1
            rng.shuffle(hist)
            assert hist.sum() == total
            dev = np.asarray(_device_of_bucket(jnp.asarray(hist, jnp.int32), D))
            excl = np.cumsum(hist) - hist
            expect = np.minimum(excl * D // total, D - 1)  # int64 oracle
            assert np.array_equal(dev, expect), (D, total)
            # contract: monotone, starts at 0, loads within one bucket of n/D
            assert dev[0] == 0 and np.all(np.diff(dev) >= 0)


def test_distributed_pairs_generic_shuffle(rng, mesh):
    # shuffle-path record sort with a pytree payload + non-u32 keys
    from radix_sorting.parallel import distributed_sort_pairs
    n = (1 << 14) + 77
    x = rng.standard_normal(n).astype(np.float32)
    payload = {"w": rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
               "b": rng.integers(0, 2, size=n).astype(bool),
               "h": rng.standard_normal(n).astype(np.float16)}
    order = np.argsort(x, kind="stable")
    sk, pv, counts, ovf = distributed_sort_pairs(
        jnp.asarray(x), payload, mesh, method="shuffle", exact=True)
    assert int(np.asarray(ovf)[0]) == 0
    keys_g = gather_sorted(jnp.asarray(sk).view(jnp.uint32), counts, ovf)
    assert np.array_equal(keys_g.view(np.float32), x[order])
    w = np.asarray(pv["w"], dtype=np.uint64)
    D = np.asarray(counts).shape[0]
    wg = np.concatenate([w.reshape(D, -1)[d, : np.asarray(counts)[d]]
                         for d in range(D)])
    assert np.array_equal(wg, payload["w"][order])
    bg = gather_sorted(jnp.asarray(pv["b"]).astype(jnp.uint32), counts)
    assert np.array_equal(bg.astype(bool), payload["b"][order])
    hg = gather_sorted(jnp.asarray(pv["h"]).view(jnp.uint16), counts)
    assert np.array_equal(hg, payload["h"][order].view(np.uint16))


def test_distributed_argsort_generic_both_methods(rng, mesh):
    from radix_sorting.parallel import distributed_argsort
    n = 1 << 14
    x = rng.integers(-100, 100, size=n, dtype=np.int64)  # ties + 2-plane keys
    expect = np.argsort(x, kind="stable").astype(np.uint32)
    expect_desc = np.argsort(-x, kind="stable").astype(np.uint32)
    for method, kw in (("balanced", {"chunk": 41}),
                       ("shuffle", {"exact": True})):
        vals, perm, counts, ovf = distributed_argsort(
            x, mesh, method=method, **kw)
        assert np.array_equal(gather_sorted(perm, counts), expect), method
        vals, perm, counts, ovf = distributed_argsort(
            x, mesh, descending=True, method=method, **kw)
        assert np.array_equal(gather_sorted(perm, counts), expect_desc), method


def test_distributed_pairs_shuffle_skew_overflow_detected(rng, mesh):
    # the shuffle path must still DETECT capacity overflow with payloads
    from radix_sorting.parallel import distributed_sort_pairs
    n = 1 << 14
    x = np.full(n, 3, np.uint32)
    x[: n // 8] = rng.integers(0, 1 << 32, size=n // 8, dtype=np.uint32)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sk, pv, counts, ovf = distributed_sort_pairs(
        jnp.asarray(x), payload, mesh, method="shuffle", slack=0.0)
    # deterministic with slack=0: ~7/8 of the keys target one peer whose
    # capacity is ~n/D^2; losing the flag = silently dropped keys, so a
    # zero flag here must FAIL, not skip the assertion
    assert int(np.asarray(ovf)[0]) != 0, \
        "expected capacity overflow was not detected"
    with pytest.raises(RuntimeError, match="capacity"):
        gather_sorted(sk, counts, ovf)
    # exact mode is the always-correct fallback
    sk, pv, counts, ovf = distributed_sort_pairs(
        jnp.asarray(x), payload, mesh, method="shuffle", exact=True)
    order = np.argsort(x, kind="stable")
    assert np.array_equal(gather_sorted(pv, counts, ovf), payload[order])


def test_distributed_ragged_all_sentinel_keys(rng, mesh):
    # regression (found by the differential soak): ragged n with EVERY key
    # equal to the sentinel value routes the whole array (pads included) to
    # one device; the pad adjustment must shed pad mass from the tail device
    # with data, not blindly from device D-1 (which went negative).
    n = (1 << 12) + 1237
    x = np.full(n, 0xFFFFFFFF, np.uint32)
    sp, counts, ovf = distributed_sort_u32(jnp.asarray(x), mesh, exact=True)
    c = np.asarray(counts)
    assert (c >= 0).all() and c.sum() == n
    assert np.array_equal(gather_sorted(sp, counts, ovf), x)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sk, pl, counts, ovf = distributed_sort_pairs_u32(
        jnp.asarray(x), jnp.asarray(payload), mesh, exact=True)
    assert np.array_equal(gather_sorted(pl, counts, ovf), payload)


def test_global_histogram_pass_index_validated(rng, mesh):
    from radix_sorting.parallel import global_digit_histogram
    x = jnp.asarray(rng.integers(0, 1 << 32, size=1 << 12, dtype=np.uint32))
    with pytest.raises(ValueError, match="pass_index"):
        global_digit_histogram(x, mesh, pass_index=4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_distributed_sort_ml_dtypes(rng, mesh, dtype):
    # the "any dtype" claim must cover ml_dtypes keys (encode-based
    # genericity; numpy-kind dispatch would misroute them — round-3 fix)
    from radix_sorting.parallel import distributed_sort
    from radix_sorting.ops import kdf
    bits = 16 if dtype == "bfloat16" else 8
    raw = rng.integers(0, 1 << bits, size=20_000,
                       dtype=np.dtype(f"uint{bits}"))
    x = jnp.asarray(raw).view(jnp.dtype(dtype))
    out = distributed_sort(x, mesh)
    res = gather_sorted(*out) if isinstance(out, tuple) else out
    k = np.asarray(kdf.encode(x)[0])
    kr = np.asarray(kdf.encode(jnp.asarray(res))[0])
    assert np.array_equal(np.sort(k), kr)


@pytest.mark.parametrize("call", ["sort_u32", "argsort_u32", "balanced_u32",
                                  "sort_method_kw"])
def test_exchange_option_removed(mesh, call):
    # the exchange is lax.all_to_all (NCCL on GPUs); the former remote-DMA
    # backend and its `exchange=` option are gone, so passing it is an error
    from radix_sorting.parallel import (distributed_sort,
                                        distributed_sort_balanced_u32)
    x = jnp.arange(1024, dtype=jnp.uint32)
    fn = {"sort_u32": lambda: distributed_sort_u32(x, mesh, exchange="xla"),
          "argsort_u32": lambda: distributed_argsort_u32(x, mesh,
                                                         exchange="xla"),
          "balanced_u32": lambda: distributed_sort_balanced_u32(
              x, mesh, exchange="xla"),
          "sort_method_kw": lambda: distributed_sort(x, mesh, method="shuffle",
                                                     exchange="xla")}[call]
    with pytest.raises(TypeError):
        fn()
