"""Balanced distributed sort tests: exact-quantile partition, multi-round exchange.

Adversarial distributions that overflow the single-collective shuffle's
capacity (two-value, all-equal, presorted, heavy skew) must all produce
perfectly balanced shards here, with zero overflow, on the 8-device mesh.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from radix_sorting.parallel import (
    distributed_argsort_balanced_u32,
    distributed_sort_balanced,
    distributed_sort_balanced_u32,
    distributed_sort_pairs_balanced_u32,
    gather_sorted,
    make_sort_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    return make_sort_mesh(8)


def _check(x, mesh, **kw):
    sp, counts, ovf = distributed_sort_balanced_u32(jnp.asarray(x), mesh, **kw)
    assert int(np.asarray(ovf).sum()) == 0
    c = np.asarray(counts)
    n_local = -(-x.shape[0] // 8)
    # exact balance by construction: every shard full except the padded tail
    assert np.array_equal(c, np.clip(x.shape[0] - np.arange(8) * n_local, 0, n_local))
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, np.sort(x))


def test_balanced_uniform(rng, mesh):
    _check(rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint32), mesh)


def test_balanced_two_values(rng, mesh):
    # the distribution that overflows the bucket shuffle's default capacity:
    # exact quantiles split each value's run across devices by count
    _check(rng.integers(0, 2, size=1 << 15, dtype=np.uint32), mesh)


def test_balanced_all_equal(mesh):
    _check(np.full(1 << 14, 0xABCD1234, np.uint32), mesh)


def test_balanced_heavy_skew(rng, mesh):
    n = 1 << 15
    x = np.concatenate([
        np.full(n // 2, 0x0000BEEF, np.uint32),
        (rng.integers(0, 1 << 12, size=n // 4, dtype=np.uint32) + 0x10).astype(np.uint32),
        rng.integers(0, 1 << 32, size=n // 4, dtype=np.uint32),
    ])
    rng.shuffle(x)
    _check(x, mesh)


def test_balanced_presorted_and_reverse(mesh):
    n = 1 << 14
    _check(np.arange(n, dtype=np.uint32) * 7, mesh)
    _check((np.arange(n, dtype=np.uint32) * 13)[::-1].copy(), mesh)


def test_balanced_ragged_n_with_sentinels(rng, mesh):
    n = (1 << 14) + 1237
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    # real maximal keys must survive the sentinel padding logic
    x[: 300] = 0xFFFFFFFF
    _check(x, mesh)


def test_balanced_small_n(rng, mesh):
    for n in (8, 9, 64, 200):
        _check(rng.integers(0, 1 << 32, size=n, dtype=np.uint32), mesh)


def test_balanced_chunk_forces_many_rounds(rng, mesh):
    # tiny chunk => every run ships over many rounds; result must be identical
    x = rng.integers(0, 4, size=1 << 12, dtype=np.uint32)
    _check(x, mesh, chunk=37)


def test_balanced_argsort_stable(rng, mesh):
    n = 1 << 14
    x = rng.integers(0, 100, size=n, dtype=np.uint32)  # heavy ties
    sk, perm, counts, ovf = distributed_argsort_balanced_u32(jnp.asarray(x), mesh)
    perm_g = gather_sorted(perm, counts, ovf)
    assert np.array_equal(perm_g, np.argsort(x, kind="stable").astype(np.uint32))
    assert np.array_equal(gather_sorted(sk, counts, ovf), np.sort(x))


def test_balanced_argsort_all_equal(rng, mesh):
    # all-equal keys: stable perm is the identity, and balance is still exact
    n = 1 << 13
    x = np.full(n, 42, np.uint32)
    _, perm, counts, ovf = distributed_argsort_balanced_u32(jnp.asarray(x), mesh)
    assert np.array_equal(gather_sorted(perm, counts, ovf),
                          np.arange(n, dtype=np.uint32))


def test_balanced_pairs(rng, mesh):
    n = (1 << 13) + 321
    x = rng.integers(0, 64, size=n, dtype=np.uint32)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    order = np.argsort(x, kind="stable")
    for chunk in (None, 29):  # default and many-round exchange
        sk, pl, counts, ovf = distributed_sort_pairs_balanced_u32(
            jnp.asarray(x), jnp.asarray(payload), mesh, chunk=chunk)
        assert np.array_equal(gather_sorted(sk, counts, ovf), x[order])
        assert np.array_equal(gather_sorted(pl, counts, ovf), payload[order])


def test_balanced_generic_dtypes(rng, mesh):
    n = 1 << 13
    xf = rng.standard_normal(n).astype(np.float32)
    vals, counts, ovf = distributed_sort_balanced(jnp.asarray(xf), mesh)
    out = gather_sorted(jnp.asarray(vals).view(jnp.uint32), counts, ovf).view(np.float32)
    assert np.array_equal(out, np.sort(xf))
    # half floats ride the same path
    xh = rng.standard_normal(n).astype(np.float16)
    vals, counts, ovf = distributed_sort_balanced(jnp.asarray(xh), mesh)
    out = gather_sorted(jnp.asarray(vals).view(jnp.uint16).astype(jnp.uint32),
                        counts, ovf).astype(np.uint16)
    assert np.array_equal(out, np.sort(xh).view(np.uint16))
    # int32 descending
    xi = rng.integers(-1 << 31, 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    vals, counts, ovf = distributed_sort_balanced(jnp.asarray(xi), mesh, descending=True)
    out = gather_sorted(jnp.asarray(vals).view(jnp.uint32), counts, ovf).view(np.int32)
    assert np.array_equal(out, np.sort(xi)[::-1])


def test_balanced_u64_constant_high_word(rng, mesh):
    # constant high word: the bucket shuffle degrades to one bucket here
    # (overflow/exact), the balanced path partitions on both planes — exact
    n = 1 << 13
    x64 = (np.uint64(0xDEAD << 48)
           | rng.integers(0, 1 << 32, size=n, dtype=np.uint64))
    vals, counts, ovf = distributed_sort_balanced(x64, mesh)
    v = np.asarray(vals, dtype=np.uint64)
    counts_np = np.asarray(counts)
    flat = v.reshape(8, -1)
    out = np.concatenate([flat[d, : counts_np[d]] for d in range(8)])
    assert np.array_equal(out, np.sort(x64))
    assert int(np.asarray(ovf).sum()) == 0


def test_balanced_generic_argsort(rng, mesh):
    from radix_sorting.parallel import distributed_argsort_balanced
    n = 1 << 13
    x = rng.standard_normal(n).astype(np.float32)
    x[:: 7] = x[0]  # ties
    vals, perm, counts, ovf = distributed_argsort_balanced(jnp.asarray(x), mesh)
    perm_g = gather_sorted(perm, counts, ovf)
    assert np.array_equal(perm_g, np.argsort(x, kind="stable").astype(np.uint32))
    # descending stable argsort
    vals, perm, counts, ovf = distributed_argsort_balanced(
        jnp.asarray(x), mesh, descending=True)
    perm_g = gather_sorted(perm, counts, ovf)
    oracle = np.argsort(-x.astype(np.float64), kind="stable")
    assert np.array_equal(perm_g, oracle.astype(np.uint32))


def test_balanced_generic_pairs_pytree(rng, mesh):
    from radix_sorting.parallel import distributed_sort_pairs_balanced
    n = (1 << 12) + 77
    k = rng.integers(-40, 40, size=n, dtype=np.int32)  # heavy ties, signed
    payload = {
        "f": jnp.asarray(rng.standard_normal(n).astype(np.float32)),
        "small": jnp.asarray(rng.integers(0, 2, size=n).astype(np.bool_)),
        "half": jnp.asarray(rng.standard_normal(n).astype(np.float16)),
        "wide": rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
    }
    sk, pv, counts, ovf = distributed_sort_pairs_balanced(
        jnp.asarray(k), payload, mesh)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(
        gather_sorted(jnp.asarray(sk).view(jnp.uint32), counts, ovf).view(np.int32),
        k[order])
    got_f = gather_sorted(jnp.asarray(pv["f"]).view(jnp.uint32), counts, ovf).view(np.float32)
    assert np.array_equal(got_f, np.asarray(payload["f"])[order])
    got_b = gather_sorted(jnp.asarray(pv["small"]).astype(jnp.uint32), counts, ovf)
    assert np.array_equal(got_b.astype(bool), np.asarray(payload["small"])[order])
    got_h = gather_sorted(jnp.asarray(pv["half"]).view(jnp.uint16).astype(jnp.uint32),
                          counts, ovf).astype(np.uint16)
    assert np.array_equal(got_h, np.asarray(payload["half"]).view(np.uint16)[order])
    got_w = np.asarray(pv["wide"], dtype=np.uint64)
    counts_np = np.asarray(counts)
    flat = got_w.reshape(8, -1)
    got_w = np.concatenate([flat[d, : counts_np[d]] for d in range(8)])
    assert np.array_equal(got_w, payload["wide"][order])


# ---------------------------------------------------------------------------
# distributed_unique_sorted


def test_distributed_unique(rng, mesh):
    from radix_sorting.parallel import distributed_unique_sorted
    n = (1 << 14) + 55
    x = rng.integers(0, 300, size=n, dtype=np.uint32)  # heavy duplicates
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(x), mesh)
    got = gather_sorted(vals, counts, ovf)
    assert np.array_equal(got, np.unique(x))


def test_distributed_unique_boundary_runs(rng, mesh):
    from radix_sorting.parallel import distributed_unique_sorted
    # one value's run spans several shards: must be emitted exactly once
    n = 1 << 13
    x = np.concatenate([
        np.full(n // 2, 7, np.uint32),
        rng.integers(100, 200, size=n // 2, dtype=np.uint32),
    ])
    rng.shuffle(x)
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(x), mesh)
    got = gather_sorted(vals, counts, ovf)
    assert np.array_equal(got, np.unique(x))
    # all-equal: exactly one unique
    eq = np.full(n, 0xFFFFFFFF, np.uint32)  # the sentinel value itself
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(eq), mesh)
    got = gather_sorted(vals, counts, ovf)
    assert np.array_equal(got, np.asarray([0xFFFFFFFF], np.uint32))


def test_distributed_unique_floats_and_u64(rng, mesh):
    from radix_sorting.parallel import distributed_unique_sorted
    n = 1 << 12
    xf = np.repeat(rng.standard_normal(50).astype(np.float32), n // 50)
    rng.shuffle(xf)
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(xf), mesh)
    got = gather_sorted(jnp.asarray(vals).view(jnp.uint32), counts, ovf).view(np.float32)
    assert np.array_equal(got, np.unique(xf))
    x64 = np.repeat(rng.integers(0, 1 << 64, size=40, dtype=np.uint64), n // 40)
    rng.shuffle(x64)
    vals, counts, ovf = distributed_unique_sorted(x64, mesh)
    v = np.asarray(vals, dtype=np.uint64).reshape(8, -1)
    cn = np.asarray(counts)
    got = np.concatenate([v[d, : cn[d]] for d in range(8)])
    assert np.array_equal(got, np.unique(x64))


def test_distributed_unique_single_device(rng):
    from radix_sorting.parallel import distributed_unique_sorted
    mesh1 = make_sort_mesh(1)
    x = rng.integers(0, 40, size=777, dtype=np.uint32)
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(x), mesh1)
    got = gather_sorted(vals, counts, ovf)
    assert np.array_equal(got, np.unique(x))


@pytest.mark.parametrize("D", [2, 3, 5, 7])
def test_balanced_odd_device_counts(rng, D):
    # non-power-of-two meshes: quantile targets, padding, and the chunked
    # exchange must not assume D divides anything
    m = make_sort_mesh(D)
    n = (1 << 12) + 77
    x = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)  # dup-heavy
    sp, counts, ovf = distributed_sort_balanced_u32(jnp.asarray(x), m)
    assert int(np.asarray(ovf).sum()) == 0
    assert np.array_equal(gather_sorted(sp, counts, ovf), np.sort(x))
    n_local = -(-n // D)
    assert np.array_equal(np.asarray(counts),
                          np.clip(n - np.arange(D) * n_local, 0, n_local))


def test_balanced_single_device(rng):
    mesh1 = make_sort_mesh(1)
    x = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    sp, counts, ovf = distributed_sort_balanced_u32(jnp.asarray(x), mesh1)
    assert np.array_equal(gather_sorted(sp, counts, ovf), np.sort(x))


# ---------------------------------------------------------------------------
# distributed_select: exact order statistics without a full sort


def test_distributed_select_u32(rng, mesh):
    from radix_sorting.parallel import distributed_select
    n = (1 << 14) + 333
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    ranks = [0, 1, n // 4, n // 2, n - 2, n - 1]
    got = np.asarray(distributed_select(jnp.asarray(x), ranks, mesh))
    assert np.array_equal(got, np.sort(x)[ranks])


def test_distributed_select_skewed_floats(rng, mesh):
    from radix_sorting.parallel import distributed_select
    n = 1 << 13
    x = rng.standard_normal(n).astype(np.float32)
    x[: n // 2] = -1.5  # heavy duplicate mass around a quantile
    ranks = [0, n // 2 - 1, n // 2, n // 2 + 1, n - 1]
    got = np.asarray(distributed_select(jnp.asarray(x), ranks, mesh))
    assert np.array_equal(got, np.sort(x)[ranks])
    # descending: rank 0 is the max
    got = np.asarray(distributed_select(jnp.asarray(x), [0, 1, n - 1], mesh,
                                        descending=True))
    s = np.sort(x)[::-1]
    assert np.array_equal(got, s[[0, 1, n - 1]])


def test_distributed_select_u64_and_all_equal(rng, mesh):
    from radix_sorting.parallel import distributed_select
    n = 1 << 12
    x64 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    got = np.asarray(distributed_select(x64, [7, n // 2], mesh), dtype=np.uint64)
    assert np.array_equal(got, np.sort(x64)[[7, n // 2]])
    eq = np.full(n, 0xDECAF, np.uint32)
    got = np.asarray(distributed_select(jnp.asarray(eq), [0, n - 1], mesh))
    assert np.array_equal(got, [0xDECAF, 0xDECAF])


def test_distributed_select_bounds(rng, mesh):
    from radix_sorting.parallel import distributed_select
    x = jnp.arange(100, dtype=jnp.uint32)
    with pytest.raises(ValueError):
        distributed_select(x, [100], mesh)
    with pytest.raises(ValueError):
        distributed_select(x, [], mesh)
    # single-device path
    mesh1 = make_sort_mesh(1)
    got = np.asarray(distributed_select(x, [0, 50, 99], mesh1))
    assert np.array_equal(got, [0, 50, 99])


def test_balanced_argsort_ragged_maximal_keys(rng, mesh):
    # Adversarial strict-mode padding case: n not a multiple of D AND every
    # real key is the sentinel value. Pad rows must carry DISTINCT tiebreak
    # values (not all-sentinel composites) so the quantile targets inside the
    # pad run stay exact and device D-1's accumulator never overfills.
    D = mesh.shape["shards"]
    n = (1 << 12) + D - 1  # maximal pad (D-1 pad rows)
    x = np.full(n, 0xFFFFFFFF, np.uint32)
    sk, perm, counts, ovf = distributed_argsort_balanced_u32(
        jnp.asarray(x), mesh, chunk=17)
    assert np.array_equal(gather_sorted(perm, counts, ovf),
                          np.arange(n, dtype=np.uint32))
    assert np.array_equal(gather_sorted(sk, counts, ovf), x)


def test_balanced_pairs_ragged_tie_tail(rng, mesh):
    # ragged n with a tied maximal tail: stability across the pad boundary
    D = mesh.shape["shards"]
    n = (1 << 12) + 3
    x = rng.integers(0, 16, size=n, dtype=np.uint32)
    x[-200:] = 0xFFFFFFFF
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    order = np.argsort(x, kind="stable")
    sk, pl, counts, ovf = distributed_sort_pairs_balanced_u32(
        jnp.asarray(x), jnp.asarray(payload), mesh)
    assert np.array_equal(gather_sorted(sk, counts, ovf), x[order])
    assert np.array_equal(gather_sorted(pl, counts, ovf), payload[order])


def test_balanced_overlap_mode_identical(rng, mesh):
    # double-buffered (compute/comm overlap) exchange must be result-identical
    # to the phase-sequential rounds, including multi-round + ragged cases
    n = (1 << 14) + 1237
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    x[:50] = 0xFFFFFFFF
    for chunk in (None, 37):
        a, ca, _ = distributed_sort_balanced_u32(jnp.asarray(x), mesh,
                                                 chunk=chunk, overlap=False)
        b, cb, _ = distributed_sort_balanced_u32(jnp.asarray(x), mesh,
                                                 chunk=chunk, overlap=True)
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.array_equal(np.asarray(ca), np.asarray(cb))
        assert np.array_equal(gather_sorted(b, cb), np.sort(x))


def test_balanced_overlap_pairs_and_generic(rng, mesh):
    from radix_sorting.parallel import distributed_sort_pairs_balanced
    n = (1 << 13) + 3
    x = rng.integers(0, 64, size=n, dtype=np.uint32).astype(np.int32)
    payload = {"a": rng.standard_normal(n).astype(np.float32),
               "b": rng.integers(0, 1 << 16, size=n, dtype=np.uint16)}
    order = np.argsort(x, kind="stable")
    sk, pv, counts, ovf = distributed_sort_pairs_balanced(
        x, payload, mesh, chunk=29, overlap=True)
    assert np.array_equal(gather_sorted(jnp.asarray(sk).view(jnp.uint32),
                                        counts).view(np.int32), x[order])
    assert np.array_equal(
        gather_sorted(jnp.asarray(pv["a"]).view(jnp.uint32), counts)
        .view(np.float32), payload["a"][order])
    assert np.array_equal(
        gather_sorted(jnp.asarray(pv["b"]).astype(jnp.uint32), counts)
        .astype(np.uint16), payload["b"][order])


def test_balanced_pairs_bytes_field(rng, mesh):
    # fixed-width byte-string payload (matches api.sort_pairs): numpy S in ->
    # numpy S out; device (n, W) uint8 in -> device matrix out. Output is
    # padded per device, so slice rows by counts like the wide-leaf case.
    from radix_sorting.parallel import distributed_sort_pairs_balanced
    n = (1 << 12) + 19
    k = rng.integers(0, 50, size=n, dtype=np.uint32)  # heavy ties
    names = np.array([f"n{i:05d}".encode() for i in range(n)], dtype="S6")
    mat = rng.integers(0, 256, size=(n, 5), dtype=np.uint8)
    sk, pv, counts, ovf = distributed_sort_pairs_balanced(
        jnp.asarray(k), {"s": names, "m": jnp.asarray(mat)}, mesh)
    order = np.argsort(k, kind="stable")
    counts_np = np.asarray(counts)

    def unpad(rows):
        flat = rows.reshape(8, -1, *rows.shape[1:])
        return np.concatenate([flat[d, : counts_np[d]] for d in range(8)])

    assert pv["s"].dtype == names.dtype
    assert np.array_equal(unpad(pv["s"]), names[order])
    assert pv["m"].dtype == jnp.uint8
    assert np.array_equal(unpad(np.asarray(pv["m"])), mat[order])


# ------------------------------------------------- distributed_group_reduce

def _np_group_oracle(k, v, reduce):
    uq, inv = np.unique(k, return_inverse=True)
    if reduce == "count":
        return uq, np.bincount(inv)
    if reduce == "sum":
        out = np.zeros(len(uq), np.int64 if v.dtype.kind in "iub"
                       else np.float64)
        np.add.at(out, inv, v.astype(out.dtype))
        return uq, out
    if reduce == "mean":
        s = np.zeros(len(uq), np.float64)
        np.add.at(s, inv, v.astype(np.float64))
        return uq, (s / np.bincount(inv)).astype(np.float32)
    op = np.minimum if reduce == "min" else np.maximum
    out = np.full(len(uq), v[0], v.dtype)
    out[:] = v.max() if reduce == "min" else v.min()
    getattr(op, "at")(out, inv, v)
    return uq, out


@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max", "count"])
def test_distributed_group_reduce(rng, mesh, reduce):
    from radix_sorting.parallel import distributed_group_reduce
    n = (1 << 13) + 101
    k = rng.integers(0, 150, size=n, dtype=np.uint32)   # runs span shards
    v = rng.integers(0, 1000, size=n, dtype=np.int32)
    vals = None if reduce == "count" else jnp.asarray(v)
    uk, red, counts, ovf = distributed_group_reduce(
        jnp.asarray(k), vals, mesh, reduce=reduce)
    assert int(np.asarray(ovf).sum()) == 0
    got_k = gather_sorted(uk, counts)
    got_r = gather_sorted(red, counts)
    uq, want = _np_group_oracle(k, v, reduce)
    assert np.array_equal(got_k, uq)
    if reduce == "mean":
        assert np.allclose(got_r, want, rtol=1e-6)
    else:
        assert np.array_equal(got_r.astype(want.dtype), want)


def test_distributed_group_reduce_spanning_runs(rng, mesh):
    # one giant group spanning ALL shards plus a tail of small groups: the
    # carry must chain through every single-run shard and the run must be
    # emitted exactly once, with the exact global sum
    from radix_sorting.parallel import distributed_group_reduce
    n = 1 << 13
    k = np.concatenate([np.zeros(n - 64, np.uint32),
                        rng.integers(1, 9, size=64, dtype=np.uint32)])
    v = rng.integers(0, 100, size=n, dtype=np.uint32)
    pairs = rng.permutation(n)
    k, v = k[pairs], v[pairs]
    for reduce in ("sum", "min", "max"):
        uk, red, counts, ovf = distributed_group_reduce(
            jnp.asarray(k), jnp.asarray(v), mesh, reduce=reduce)
        got_k = gather_sorted(uk, counts)
        got_r = gather_sorted(red, counts)
        uq, want = _np_group_oracle(k, v, reduce)
        assert np.array_equal(got_k, uq)
        assert np.array_equal(got_r.astype(want.dtype), want)
    # all-equal input: exactly one group
    uk, red, counts, ovf = distributed_group_reduce(
        jnp.asarray(np.full(n, 3, np.uint32)),
        jnp.asarray(np.ones(n, np.uint32)), mesh, reduce="sum")
    assert np.array_equal(gather_sorted(uk, counts), [3])
    assert np.array_equal(gather_sorted(red, counts), [n])


def test_distributed_group_reduce_dtypes(rng, mesh):
    from radix_sorting.parallel import distributed_group_reduce
    n = 4_096
    # u64 keys (two planes), f32 values, min/max under the KDF order
    k = rng.integers(0, 40, size=n, dtype=np.uint64) << np.uint64(40)
    v = rng.standard_normal(n).astype(np.float32)
    for reduce in ("min", "max"):
        uk, red, counts, _ = distributed_group_reduce(
            k, jnp.asarray(v), mesh, reduce=reduce)
        uq, want = _np_group_oracle(k, v, reduce)
        assert np.array_equal(gather_sorted(uk, counts).astype(np.uint64), uq)
        assert np.array_equal(gather_sorted(red, counts), want)
    # f16 values accumulate in f32
    vh = jnp.ones((n,), jnp.float16)
    uk, red, counts, _ = distributed_group_reduce(
        jnp.asarray((np.arange(n) % 3).astype(np.uint8)), vh, mesh,
        reduce="sum")
    assert red.dtype == jnp.float32
    assert np.array_equal(gather_sorted(red, counts),
                          np.bincount(np.arange(n) % 3).astype(np.float32))


def test_distributed_group_reduce_small_and_errors(rng, mesh):
    from radix_sorting.parallel import distributed_group_reduce
    # n < D: trailing shards are empty, links must not fire across them
    k = np.asarray([5, 5, 1], np.uint32)
    v = np.asarray([10, 20, 7], np.int32)
    uk, red, counts, _ = distributed_group_reduce(
        jnp.asarray(k), jnp.asarray(v), mesh, reduce="sum")
    assert np.array_equal(gather_sorted(uk, counts), [1, 5])
    assert np.array_equal(gather_sorted(red, counts), [7, 30])
    with pytest.raises(ValueError):
        distributed_group_reduce(jnp.asarray(k), jnp.asarray(v), mesh,
                                 reduce="prod")
    with pytest.raises(ValueError):
        distributed_group_reduce(
            jnp.asarray(k),
            rng.integers(0, 10, size=3, dtype=np.uint64), mesh, reduce="sum")
    with pytest.raises(ValueError):
        distributed_group_reduce(jnp.asarray(k), jnp.asarray(v), mesh,
                                 reduce="count")


@pytest.mark.parametrize("reduce", ["sum", "mean", "count"])
def test_distributed_group_reduce_dense_tier(rng, mesh, reduce):
    # groups promise: NO distributed sort — per-shard weighted histograms
    # + one psum; output contract identical to the sort-backed route
    from radix_sorting.parallel import distributed_group_reduce
    n, G = (1 << 13) + 55, 1 << 9
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    v = rng.integers(-(1 << 20), 1 << 20, size=n, dtype=np.int32)
    vals = None if reduce == "count" else jnp.asarray(v)
    uk_d, red_d, cnt_d, ovf = distributed_group_reduce(
        jnp.asarray(k), vals, mesh, reduce=reduce, groups=G)
    assert int(np.asarray(ovf).sum()) == 0
    uk_s, red_s, cnt_s, _ = distributed_group_reduce(
        jnp.asarray(k), vals, mesh, reduce=reduce)
    assert np.array_equal(gather_sorted(uk_d, cnt_d),
                          gather_sorted(uk_s, cnt_s))
    a, b = gather_sorted(red_d, cnt_d), gather_sorted(red_s, cnt_s)
    if reduce == "mean":
        assert np.allclose(a, b, rtol=1e-6)
    else:
        assert np.array_equal(a, b)


def test_distributed_group_reduce_dense_f32(rng, mesh):
    # FLOAT dense tier (round 5): per-shard fused count+bf16x2-sum
    # histograms + one f32 psum — no distributed sort
    from radix_sorting.parallel import distributed_group_reduce
    n, G = (1 << 13) + 55, 1 << 9
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    v = (rng.standard_normal(n) * 10).astype(np.float32)
    ref = np.zeros(G, np.float64)
    np.add.at(ref, k, v.astype(np.float64))
    cntv = np.bincount(k, minlength=G)
    for reduce in ("sum", "mean"):
        uk, red, cnt, ovf = distributed_group_reduce(
            jnp.asarray(k), jnp.asarray(v), mesh, reduce=reduce, groups=G)
        assert int(np.asarray(ovf).sum()) == 0
        got_k = gather_sorted(uk, cnt)
        got_r = gather_sorted(red, cnt)
        assert np.array_equal(got_k, np.unique(k))
        want = (ref[got_k] if reduce == "sum"
                else ref[got_k] / np.maximum(cntv[got_k], 1))
        assert np.allclose(got_r, want, rtol=1e-3, atol=1e-3)


def test_distributed_group_reduce_dense_narrow_and_validate(rng, mesh):
    from radix_sorting.parallel import distributed_group_reduce
    n, G = 3_333, 37  # non-power-of-two G, n not divisible by D
    k = rng.integers(0, G, size=n, dtype=np.int16)
    v = rng.integers(-128, 127, size=n, dtype=np.int8)  # signed-bias path
    uk, red, cnt, _ = distributed_group_reduce(
        jnp.asarray(k), jnp.asarray(v), mesh, reduce="sum", groups=G)
    ref = np.zeros(G, np.int64)
    np.add.at(ref, k, v.astype(np.int64))
    got_k = gather_sorted(uk, cnt)
    assert np.array_equal(got_k, np.unique(k))
    assert np.array_equal(gather_sorted(red, cnt),
                          ref[got_k].astype(np.int32))
    bad = k.copy(); bad[0] = G + 5
    with pytest.raises(ValueError, match="outside"):
        distributed_group_reduce(jnp.asarray(bad), jnp.asarray(v), mesh,
                                 reduce="sum", groups=G, validate=True)
    # min/max ignore the promise (sort-backed route, same numbers)
    uk, red, cnt, _ = distributed_group_reduce(
        jnp.asarray(k), jnp.asarray(v), mesh, reduce="max", groups=G)
    uq, want = _np_group_oracle(k, v, "max")
    assert np.array_equal(gather_sorted(red, cnt).astype(want.dtype), want)


# ---------------------------------------------------------------------------
# distributed_quantile / distributed_median / distributed_bincount


@pytest.mark.parametrize("method",
                         ("linear", "lower", "higher", "nearest", "midpoint"))
def test_distributed_quantile_vs_numpy(rng, mesh, method):
    from radix_sorting.parallel import distributed_quantile
    n = (1 << 14) + 77
    x = rng.standard_normal(n).astype(np.float32)
    qs = [0.0, 0.05, 0.25, 0.5, 0.9, 1.0]
    got = np.asarray(distributed_quantile(jnp.asarray(x), qs, mesh,
                                          method=method))
    exp = np.quantile(x.astype(np.float64), qs, method=method)
    assert np.allclose(got, exp, rtol=1e-5, atol=1e-6), method


def test_distributed_quantile_matches_single_chip(rng, mesh):
    # the distributed form must agree with stats.quantile exactly
    from radix_sorting.parallel import distributed_quantile
    from radix_sorting.stats import quantile
    x = rng.integers(0, 1 << 20, size=9_999, dtype=np.uint32)
    qs = [0.13, 0.5, 0.77]
    got = np.asarray(distributed_quantile(jnp.asarray(x), qs, mesh))
    want = np.asarray(quantile(jnp.asarray(x), qs))
    assert np.array_equal(got, want)


def test_distributed_median_u64_host_path(rng, mesh):
    from radix_sorting.parallel import distributed_median
    x = rng.integers(0, 1 << 62, size=8_192, dtype=np.int64)
    got = distributed_median(x, mesh)
    assert np.isclose(float(got), np.median(x).astype(np.float64))


def test_distributed_quantile_scalar_and_errors(rng, mesh):
    from radix_sorting.parallel import distributed_quantile
    x = rng.standard_normal(1_024).astype(np.float32)
    m = distributed_quantile(jnp.asarray(x), 0.5, mesh)
    assert np.ndim(m) == 0
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        distributed_quantile(jnp.asarray(x), -0.1, mesh)
    with pytest.raises(ValueError, match="empty"):
        distributed_quantile(jnp.zeros((0,), jnp.float32), 0.5, mesh)
    with pytest.raises(ValueError, match="method"):
        distributed_quantile(jnp.asarray(x), 0.5, mesh, method="cubic")


def test_distributed_bincount(rng, mesh):
    from radix_sorting.parallel import distributed_bincount
    n = (1 << 13) + 55  # ragged: exercises the sentinel padding
    x = rng.integers(0, 777, size=n, dtype=np.uint32)
    got = np.asarray(distributed_bincount(jnp.asarray(x), mesh, 777))
    assert np.array_equal(got, np.bincount(x, minlength=777))
    # out-of-range values drop (documented), sentinel padding never counts
    x2 = np.where(x % 7 == 0, np.uint32(4_000_000_000), x)
    got = np.asarray(distributed_bincount(jnp.asarray(x2), mesh, 777))
    want = np.bincount(x2[x2 < 777], minlength=777)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="positive"):
        distributed_bincount(jnp.asarray(x), mesh, 0)


# ---------------------------------------------------------- distributed top-k

def test_distributed_top_k_vs_local(rng, mesh):
    from radix_sorting.extras import top_k
    from radix_sorting.parallel import distributed_top_k
    x = rng.integers(0, 1 << 32, size=1 << 15, dtype=np.uint32)
    for largest in (True, False):
        vals, idx = distributed_top_k(jnp.asarray(x), 100, mesh,
                                      largest=largest)
        ref_v, ref_i = top_k(jnp.asarray(x), 100, largest=largest)
        assert np.array_equal(np.asarray(vals), np.asarray(ref_v))
        assert np.array_equal(np.asarray(idx), np.asarray(ref_i))


def test_distributed_top_k_ties_and_ragged(rng, mesh):
    from radix_sorting.extras import top_k
    from radix_sorting.parallel import distributed_top_k
    # heavy ties: tie -> lower global index, exactly like extras.top_k;
    # n not divisible by 8 exercises the sentinel padding
    x = rng.integers(0, 7, size=(1 << 14) + 13, dtype=np.uint32)
    vals, idx = distributed_top_k(jnp.asarray(x), 64, mesh)
    ref_v, ref_i = top_k(jnp.asarray(x), 64)
    assert np.array_equal(np.asarray(vals), np.asarray(ref_v))
    assert np.array_equal(np.asarray(idx), np.asarray(ref_i))
    # indices really are original positions
    assert np.array_equal(x[np.asarray(idx)], np.asarray(vals))


def test_distributed_top_k_floats_and_u64(rng, mesh):
    from radix_sorting.extras import top_k
    from radix_sorting.parallel import distributed_top_k
    f = rng.standard_normal(1 << 14).astype(np.float32)
    f[:16] = [np.nan, np.inf, -np.inf, -0.0] * 4
    vals, idx = distributed_top_k(jnp.asarray(f), 50, mesh)
    ref_v, ref_i = top_k(jnp.asarray(f), 50)
    assert np.array_equal(np.asarray(vals), np.asarray(ref_v), equal_nan=True)
    assert np.array_equal(np.asarray(idx), np.asarray(ref_i))
    # 64-bit numpy keys, no x64: two-plane composite
    u = rng.integers(0, 1 << 63, size=1 << 14, dtype=np.uint64)
    vals64, idx64 = distributed_top_k(u, 33, mesh, largest=False)
    ref64, refi64 = top_k(u, 33, largest=False)
    assert np.array_equal(np.asarray(vals64), np.asarray(ref64))
    assert np.array_equal(np.asarray(idx64), np.asarray(refi64))


def test_distributed_top_k_errors(rng, mesh):
    from radix_sorting.parallel import distributed_top_k
    x = jnp.asarray(rng.integers(0, 100, size=1 << 10, dtype=np.uint32))
    with pytest.raises(ValueError, match="k must be"):
        distributed_top_k(x, 0, mesh)
    with pytest.raises(ValueError, match="shard size"):
        distributed_top_k(x, 200, mesh)  # 200 > 1024/8
