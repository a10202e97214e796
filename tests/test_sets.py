"""Set routines (sets.py) vs numpy oracles: unique flags, isin, 1d set ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import radix_sorting as rst
from radix_sorting import SortConfig
from radix_sorting.sets import (intersect1d, isin, setdiff1d, setxor1d,
                                    union1d, unique)


def _np64(x):
    """Materialize a possibly-two-plane 64-bit result for oracle compare."""
    return np.asarray(x)


# ---------------------------------------------------------------- unique

def test_unique_all_flags_u32(rng):
    x = rng.integers(0, 300, size=20_000, dtype=np.uint32)
    r = unique(jnp.asarray(x), return_index=True, return_inverse=True,
               return_counts=True)
    uq, idx, inv, cnt = np.unique(x, return_index=True, return_inverse=True,
                                  return_counts=True)
    k = len(uq)
    assert int(r.num_unique) == k
    assert np.array_equal(np.asarray(r.values)[:k], uq)
    assert np.array_equal(np.asarray(r.index)[:k], idx)
    assert np.array_equal(np.asarray(r.inverse), inv)
    assert np.array_equal(np.asarray(r.counts)[:k], cnt)
    # padding: values past num_unique hold the domain maximum, counts 0
    assert np.all(np.asarray(r.values)[k:] == np.uint32(0xFFFFFFFF))
    assert np.all(np.asarray(r.counts)[k:] == 0)


def test_unique_reconstructs_input(rng):
    x = rng.standard_normal(5_000).astype(np.float32)
    x = np.repeat(x[:500], 10)
    rng.shuffle(x)
    r = unique(jnp.asarray(x), return_inverse=True)
    assert np.array_equal(np.asarray(r.values)[np.asarray(r.inverse)], x)


def test_unique_first_occurrence_index_ties(rng):
    # many duplicates: index must be the FIRST occurrence (stable rank)
    x = rng.integers(0, 8, size=4_000, dtype=np.int32)
    r = unique(jnp.asarray(x), return_index=True)
    uq, idx = np.unique(x, return_index=True)
    k = len(uq)
    assert np.array_equal(np.asarray(r.index)[:k], idx)


def test_unique_signed_and_floats(rng):
    for x in (rng.integers(-1000, 1000, size=10_000, dtype=np.int32),
              np.repeat(rng.standard_normal(777).astype(np.float32), 3)):
        r = unique(jnp.asarray(x), return_counts=True)
        uq, cnt = np.unique(x, return_counts=True)
        k = len(uq)
        assert int(r.num_unique) == k
        assert np.array_equal(np.asarray(r.values)[:k], uq)
        assert np.array_equal(np.asarray(r.counts)[:k], cnt)


def test_unique_u64_no_x64(rng):
    x = rng.integers(0, 1 << 64, size=6_000, dtype=np.uint64)
    x = np.concatenate([x, x[:1_000]])  # force duplicates
    r = unique(x, return_counts=True, size=7_000)
    uq, cnt = np.unique(x, return_counts=True)
    k = len(uq)
    assert int(r.num_unique) == k
    assert np.array_equal(_np64(r.values)[:k].astype(np.uint64), uq)
    assert np.array_equal(np.asarray(r.counts)[:k], cnt)


def test_unique_descending(rng):
    x = rng.integers(0, 100, size=3_000, dtype=np.uint16)
    r = unique(jnp.asarray(x), config=SortConfig(descending=True))
    uq = np.unique(x)[::-1]
    assert np.array_equal(np.asarray(r.values)[: len(uq)], uq)


def test_unique_truncated_size(rng):
    x = rng.integers(0, 1000, size=10_000, dtype=np.uint32)
    r = unique(jnp.asarray(x), size=10, return_counts=True)
    uq = np.unique(x)
    assert int(r.num_unique) == len(uq)       # exact regardless of size
    assert np.array_equal(np.asarray(r.values), uq[:10])


def test_unique_bitwise_zero_semantics():
    # KDF order: -0.0 and +0.0 are DISTINCT values (numpy collapses them)
    x = jnp.asarray(np.array([0.0, -0.0, 1.0, -0.0, 0.0], np.float32))
    r = unique(x, return_counts=True)
    assert int(r.num_unique) == 3
    v = np.asarray(r.values)[:3]
    assert np.signbit(v[0]) and v[0] == 0.0    # -0.0 sorts first
    assert not np.signbit(v[1]) and v[1] == 0.0
    assert np.array_equal(np.asarray(r.counts)[:3], [2, 2, 1])


def test_unique_equal_nan(rng):
    # equal_nan=True collapses every NaN payload/sign into ONE (numpy's
    # 1.24+ default); equal_nan=False keeps the bitwise KDF contract
    nan_payloads = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000,
                             0x7F800001], np.uint32).view(np.float32)
    base = np.round(rng.standard_normal(500).astype(np.float32), 2) + 9.0
    x = np.concatenate([base, np.tile(nan_payloads, 3)])
    rng.shuffle(x)
    r = unique(jnp.asarray(x), return_index=True, return_counts=True,
               equal_nan=True)
    want = np.unique(x[~np.isnan(x)])
    m = int(r.num_unique)
    assert m == len(want) + 1
    got = np.asarray(r.values)[:m]
    assert np.array_equal(got[:-1], want) and np.isnan(got[-1])
    assert int(np.asarray(r.counts)[m - 1]) == 12      # all NaNs, one run
    first_nan = int(np.flatnonzero(np.isnan(x))[0])    # numpy index rule
    assert int(np.asarray(r.index)[m - 1]) == first_nan
    # inverse reconstructs x up to NaN identity
    r2 = unique(jnp.asarray(x), return_inverse=True, equal_nan=True)
    rec = np.asarray(r2.values)[np.asarray(r2.inverse)]
    assert np.array_equal(rec, x, equal_nan=True)
    # default stays bitwise: 4 distinct NaN payloads survive
    r3 = unique(jnp.asarray(x), return_counts=True)
    assert int(r3.num_unique) == len(want) + 4
    # int dtypes: equal_nan is a no-op
    xi = rng.integers(0, 99, size=1_000, dtype=np.int32)
    ri = unique(jnp.asarray(xi), equal_nan=True)
    assert np.array_equal(np.asarray(ri.values)[: int(ri.num_unique)],
                          np.unique(xi))
    # numpy float64 host path (no x64): canonicalized on host
    xf64 = np.concatenate([base.astype(np.float64),
                           np.array([np.nan, -np.nan, np.nan])])
    r64 = unique(xf64, return_counts=True, equal_nan=True)
    m64 = int(r64.num_unique)
    assert m64 == len(np.unique(base.astype(np.float64))) + 1
    assert int(np.asarray(r64.counts)[m64 - 1]) == 3
    # plain-list input (pre-array callers) survives the canonicalization
    rl = unique([3.0, float("nan"), 1.0, float("nan")], equal_nan=True,
                return_counts=True)
    assert int(rl.num_unique) == 3
    assert int(np.asarray(rl.counts)[2]) == 2


def test_unique_empty_and_jit(rng):
    r = unique(jnp.zeros((0,), jnp.uint32), return_inverse=True,
               return_counts=True, size=4)
    assert int(r.num_unique) == 0 and r.inverse.shape == (0,)
    x = rng.integers(0, 50, size=2_000, dtype=np.uint32)
    f = jax.jit(lambda a: unique(a, return_index=True, return_inverse=True,
                                 return_counts=True, size=64))
    r = f(jnp.asarray(x))
    uq = np.unique(x)
    assert int(r.num_unique) == len(uq)
    assert np.array_equal(np.asarray(r.values)[: len(uq)], uq)


# ---------------------------------------------------------------- set ops

def test_unique_axis0_rows_full_flags(rng):
    a = rng.integers(-50, 50, size=(2_000, 3), dtype=np.int32)
    r = unique(jnp.asarray(a), axis=0, return_index=True,
               return_inverse=True, return_counts=True)
    wv, wi, winv, wc = np.unique(a, axis=0, return_index=True,
                                 return_inverse=True, return_counts=True)
    k = int(r.num_unique)
    assert k == len(wv)
    assert np.array_equal(np.asarray(r.values)[:k], wv)
    assert np.array_equal(np.asarray(r.index)[:k], wi)
    assert np.array_equal(np.asarray(r.inverse), winv)
    assert np.array_equal(np.asarray(r.counts)[:k], wc)
    # reconstruction through the inverse (numpy's axis contract)
    assert np.array_equal(np.asarray(r.values)[np.asarray(r.inverse)], a)


def test_unique_axis1_and_floats(rng):
    a = rng.normal(size=(4, 500)).round(1).astype(np.float32)
    a = np.where(a == 0.0, np.float32(0.25), a)  # keep off numpy's -0==0 corner
    r = unique(jnp.asarray(a), axis=1)
    want = np.unique(a, axis=1)
    k = int(r.num_unique)
    assert k == want.shape[1]
    assert np.array_equal(np.asarray(r.values)[:, :k], want)


def test_unique_axis0_u64_and_jit(rng):
    u = rng.integers(0, 1 << 63, size=(800, 2)).astype(np.uint64)
    u[: 200] = u[200:400]  # force duplicate rows
    r = unique(u, axis=0, return_counts=True)
    wv, wc = np.unique(u, axis=0, return_counts=True)
    k = int(r.num_unique)
    assert np.array_equal(np.asarray(r.values)[:k], wv)
    assert np.array_equal(np.asarray(r.counts)[:k], wc)
    au = rng.integers(0, 9, size=(300, 2), dtype=np.uint32)
    f = jax.jit(lambda m: unique(m, axis=0, size=128, return_counts=True))
    rj = f(jnp.asarray(au))
    wv, wc = np.unique(au, axis=0, return_counts=True)
    k = len(wv)
    assert int(rj.num_unique) == k
    assert np.array_equal(np.asarray(rj.values)[:k], wv)
    assert np.array_equal(np.asarray(rj.counts)[:k], wc)


def test_unique_axis_edges(rng):
    # empty rows / zero columns / validation
    r = unique(jnp.zeros((0, 3), jnp.int32), axis=0, return_inverse=True)
    assert int(r.num_unique) == 0 and r.inverse.shape == (0,)
    r = unique(jnp.zeros((5, 0), jnp.uint32), axis=0, return_counts=True)
    assert int(r.num_unique) == 1  # numpy: all zero-width rows are equal
    assert np.asarray(r.counts)[0] == 5
    # num_unique stays EXACT when size truncates everything (1-D contract)
    r0 = unique(jnp.zeros((5, 0), jnp.uint32), axis=0, size=0)
    assert int(r0.num_unique) == 1 and r0.values.shape == (0, 0)
    assert np.unique(np.zeros((5, 0), np.uint32), axis=0).shape[0] == 1
    with pytest.raises(ValueError):
        unique(jnp.zeros((4,), jnp.uint32), axis=0)
    with pytest.raises(ValueError):
        unique(jnp.zeros((4, 2), jnp.uint32), axis=2)
    # 2-D without axis still raises (and now hints at axis=0)
    with pytest.raises(ValueError):
        unique(jnp.zeros((4, 2), jnp.uint32))


_OPS = [(union1d, np.union1d), (intersect1d, np.intersect1d),
        (setdiff1d, np.setdiff1d), (setxor1d, np.setxor1d)]


@pytest.mark.parametrize("op,ref", _OPS, ids=[o.__name__ for o, _ in _OPS])
def test_setops_u32(op, ref, rng):
    a = rng.integers(0, 400, size=5_000, dtype=np.uint32)
    b = rng.integers(200, 600, size=3_000, dtype=np.uint32)
    vals, cnt = op(jnp.asarray(a), jnp.asarray(b))
    want = ref(a, b)
    assert int(cnt) == len(want)
    assert np.array_equal(np.asarray(vals)[: len(want)], want)
    assert np.all(np.asarray(vals)[len(want):] == np.uint32(0xFFFFFFFF))


def test_intersect1d_return_indices(rng):
    # duplicates on both sides: indices must be FIRST occurrences (numpy)
    a = rng.integers(0, 200, size=3_000, dtype=np.uint32)
    b = rng.integers(100, 300, size=2_000, dtype=np.uint32)
    vals, comm1, comm2, cnt = intersect1d(
        jnp.asarray(a), jnp.asarray(b), return_indices=True)
    want_v, want_1, want_2 = np.intersect1d(a, b, return_indices=True)
    k = len(want_v)
    assert int(cnt) == k
    assert np.array_equal(np.asarray(vals)[:k], want_v)
    assert np.array_equal(np.asarray(comm1)[:k], want_1)
    assert np.array_equal(np.asarray(comm2)[:k], want_2)
    assert np.all(np.asarray(comm1)[k:] == len(a))
    assert np.all(np.asarray(comm2)[k:] == len(b))
    # the indices actually index the common values (numpy's contract)
    assert np.array_equal(a[want_1], want_v) and np.array_equal(
        b[np.asarray(comm2)[:k]], want_v)


def test_intersect1d_return_indices_i64_jit_empty(rng):
    a = rng.integers(-(1 << 62), 1 << 62, size=1_000).astype(np.int64)
    b = np.concatenate([rng.permutation(a)[:200],
                        rng.integers(-(1 << 62), 1 << 62,
                                     size=300).astype(np.int64)])
    # i64 stays NUMPY in/out (two u32 word planes, no x64 — jnp.asarray
    # would silently truncate to int32); jit coverage below uses u32
    vals, c1, c2, cnt = intersect1d(a, b, return_indices=True, size=256)
    want_v, want_1, want_2 = np.intersect1d(a, b, return_indices=True)
    k = len(want_v)
    assert int(cnt) == k and k <= 256
    assert np.array_equal(np.asarray(vals)[:k], want_v)
    assert np.array_equal(np.asarray(c1)[:k], want_1)
    assert np.array_equal(np.asarray(c2)[:k], want_2)
    au = rng.integers(0, 1 << 20, size=800, dtype=np.uint32)
    bu = rng.integers(0, 1 << 20, size=600, dtype=np.uint32)
    f = jax.jit(lambda x, y: intersect1d(x, y, return_indices=True,
                                         size=128))
    valsu, c1u, c2u, cntu = f(jnp.asarray(au), jnp.asarray(bu))
    wv, w1, w2 = np.intersect1d(au, bu, return_indices=True)
    ku = len(wv)
    assert int(cntu) == ku and np.array_equal(np.asarray(valsu)[:ku], wv)
    assert np.array_equal(np.asarray(c1u)[:ku], w1)
    assert np.array_equal(np.asarray(c2u)[:ku], w2)
    # empty side: exact zero count, index pads = len(a)/len(b)
    e = np.zeros((0,), np.int64)
    vals, c1, c2, cnt = intersect1d(a, e, size=4, return_indices=True)
    assert int(cnt) == 0 and np.all(np.asarray(c2) == 0)
    assert np.all(np.asarray(c1) == len(a))
    # assume_unique accepted (and unlike numpy, duplicate-safe)
    vals2, cnt2 = intersect1d(a, b, assume_unique=True)
    assert np.array_equal(np.asarray(vals2)[:int(cnt2)], want_v)


@pytest.mark.parametrize("op,ref", _OPS, ids=[o.__name__ for o, _ in _OPS])
def test_setops_floats(op, ref, rng):
    # shifted positive: np.round can emit -0.0, which numpy's set ops
    # collapse with +0.0 while the KDF bitwise order keeps them distinct
    a = np.abs(np.round(rng.standard_normal(4_000).astype(np.float32), 2)) + 1
    b = np.abs(np.round(rng.standard_normal(4_000).astype(np.float32), 2)) + 1
    vals, cnt = op(jnp.asarray(a), jnp.asarray(b))
    want = ref(a, b)
    assert int(cnt) == len(want)
    assert np.array_equal(np.asarray(vals)[: len(want)], want)


@pytest.mark.parametrize("op,ref", _OPS, ids=[o.__name__ for o, _ in _OPS])
def test_setops_i64_no_x64(op, ref, rng):
    a = rng.integers(-(1 << 62), 1 << 62, size=3_000, dtype=np.int64)
    b = np.concatenate([a[:1_000],
                        rng.integers(-(1 << 62), 1 << 62, size=2_000,
                                     dtype=np.int64)])
    vals, cnt = op(a, b)
    want = ref(a, b)
    assert int(cnt) == len(want)
    assert np.array_equal(_np64(vals)[: len(want)].astype(np.int64), want)


@pytest.mark.parametrize("op,ref", _OPS, ids=[o.__name__ for o, _ in _OPS])
def test_setops_one_side_empty(op, ref, rng):
    a = rng.integers(0, 50, size=1_000, dtype=np.int32)
    e = np.zeros((0,), np.int32)
    for x, y in ((a, e), (e, a), (e, e)):
        vals, cnt = op(jnp.asarray(x), jnp.asarray(y))
        want = ref(x, y)
        assert int(cnt) == len(want)
        assert np.array_equal(np.asarray(vals)[: len(want)], want)


def test_setops_jit_and_size(rng):
    a = rng.integers(0, 100, size=2_000, dtype=np.uint32)
    b = rng.integers(50, 150, size=2_000, dtype=np.uint32)
    f = jax.jit(lambda x, y: intersect1d(x, y, size=64))
    vals, cnt = f(jnp.asarray(a), jnp.asarray(b))
    want = np.intersect1d(a, b)
    assert int(cnt) == len(want)
    assert np.array_equal(np.asarray(vals)[: len(want)], want)
    # oversized output: padded with the domain maximum
    vals, cnt = union1d(jnp.asarray(a[:10]), jnp.asarray(b[:10]), size=100)
    k = int(cnt)
    assert np.array_equal(np.asarray(vals)[:k], np.union1d(a[:10], b[:10]))
    assert np.all(np.asarray(vals)[k:] == np.uint32(0xFFFFFFFF))


def test_setops_dtype_mismatch():
    with pytest.raises(TypeError):
        union1d(jnp.zeros(4, jnp.uint32), jnp.zeros(4, jnp.int32))


def test_setops_descending(rng):
    a = rng.integers(0, 30, size=500, dtype=np.uint8)
    b = rng.integers(15, 45, size=500, dtype=np.uint8)
    vals, cnt = setdiff1d(jnp.asarray(a), jnp.asarray(b),
                          config=SortConfig(descending=True))
    want = np.setdiff1d(a, b)[::-1]
    assert int(cnt) == len(want)
    assert np.array_equal(np.asarray(vals)[: len(want)], want)


# ---------------------------------------------------------------- isin

def test_isin_vs_numpy(rng):
    el = rng.integers(0, 1000, size=8_000, dtype=np.uint32)
    te = rng.integers(500, 1500, size=4_000, dtype=np.uint32)
    got = np.asarray(isin(jnp.asarray(el), jnp.asarray(te)))
    assert np.array_equal(got, np.isin(el, te))


def test_isin_floats_and_u64(rng):
    el = np.abs(np.round(rng.standard_normal(3_000).astype(np.float32), 2)) + 1
    te = np.abs(np.round(rng.standard_normal(3_000).astype(np.float32), 2)) + 1
    assert np.array_equal(np.asarray(isin(jnp.asarray(el), jnp.asarray(te))),
                          np.isin(el, te))
    el64 = rng.integers(0, 1 << 64, size=2_000, dtype=np.uint64)
    te64 = np.concatenate([el64[:500],
                           rng.integers(0, 1 << 64, size=1_500,
                                        dtype=np.uint64)])
    assert np.array_equal(np.asarray(isin(el64, te64)), np.isin(el64, te64))


def test_isin_empty(rng):
    el = rng.integers(0, 10, size=100, dtype=np.int32)
    assert np.asarray(isin(jnp.asarray(el), jnp.zeros((0,), jnp.int32))).sum() == 0
    assert isin(jnp.zeros((0,), jnp.int32), jnp.asarray(el)).shape == (0,)


def test_isin_invert_and_in1d(rng):
    from radix_sorting import in1d
    el = rng.integers(0, 1000, size=8_000, dtype=np.uint32)
    te = rng.integers(500, 1500, size=4_000, dtype=np.uint32)
    want = np.isin(el, te, invert=True)
    got = np.asarray(isin(jnp.asarray(el), jnp.asarray(te), invert=True))
    assert np.array_equal(got, want)
    # in1d is the legacy alias; assume_unique is accepted and semantics-free
    got2 = np.asarray(in1d(el, te, assume_unique=True, invert=True))
    assert np.array_equal(got2, want)
    assert np.array_equal(np.asarray(in1d(el, te)), np.isin(el, te))
    # empty-test invert: everything is a non-member
    empty = jnp.zeros((0,), jnp.uint32)
    assert np.asarray(isin(jnp.asarray(el), empty, invert=True)).all()


# ------------------------------------------------------------- group_reduce

def _np_group(keys, values, reduce):
    uq, inv = np.unique(keys, return_inverse=True)
    if reduce == "sum":
        out = np.zeros(len(uq), np.result_type(values.dtype, np.int32)
                       if values.dtype.kind in "iub" else values.dtype)
        np.add.at(out, inv, values)
    elif reduce == "mean":
        s = np.zeros(len(uq), np.float64)
        np.add.at(s, inv, values.astype(np.float64))
        out = (s / np.bincount(inv)).astype(np.float32)
    elif reduce == "min":
        out = np.full(len(uq), values.max(), values.dtype)
        np.minimum.at(out, inv, values)
    else:
        out = np.full(len(uq), values.min(), values.dtype)
        np.maximum.at(out, inv, values)
    return uq, out


@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max"])
def test_group_reduce_u32_keys(reduce, rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 200, size=20_000, dtype=np.uint32)
    v = rng.integers(0, 1000, size=20_000, dtype=np.int32)
    uk, out, ng = group_reduce(jnp.asarray(k), jnp.asarray(v), reduce=reduce)
    uq, want = _np_group(k, v, reduce)
    assert int(ng) == len(uq)
    assert np.array_equal(np.asarray(uk)[: len(uq)], uq)
    got = np.asarray(out)[: len(uq)]
    if reduce == "mean":
        assert np.allclose(got, want, rtol=1e-5)
    else:
        assert np.array_equal(got, want)
    assert np.all(np.asarray(out)[len(uq):] == 0)


def test_group_reduce_float_values(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 50, size=5_000, dtype=np.int16)
    v = rng.standard_normal(5_000).astype(np.float32)
    for reduce in ("min", "max"):
        uk, out, ng = group_reduce(jnp.asarray(k), jnp.asarray(v),
                                   reduce=reduce)
        uq, want = _np_group(k, v, reduce)
        assert np.array_equal(np.asarray(out)[: len(uq)], want)
    uk, out, ng = group_reduce(jnp.asarray(k), jnp.asarray(v), reduce="sum")
    uq, want = _np_group(k, v, "sum")
    assert np.allclose(np.asarray(out)[: len(uq)], want, rtol=1e-4, atol=1e-3)


def test_group_reduce_f16_accumulates_f32(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 4, size=8_192, dtype=np.uint8)
    v = jnp.ones((8_192,), jnp.float16)  # f16 cumsum would saturate at 2048
    uk, out, ng = group_reduce(jnp.asarray(k), v, reduce="sum")
    assert out.dtype == jnp.float32
    assert np.allclose(np.asarray(out)[: int(ng)],
                       np.bincount(k).astype(np.float32))


def test_group_reduce_u64_values_no_x64(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 30, size=3_000, dtype=np.uint32)
    v = rng.integers(0, 1 << 63, size=3_000, dtype=np.uint64)
    uk, out, ng = group_reduce(jnp.asarray(k), v, reduce="max")
    uq, want = _np_group(k, v, "max")
    assert np.array_equal(np.asarray(out)[: len(uq)].astype(np.uint64), want)
    uk, out, ng = group_reduce(jnp.asarray(k), v, reduce="sum")
    sums = np.zeros(len(uq), np.uint64)
    np.add.at(sums, np.unique(k, return_inverse=True)[1], v)
    assert np.array_equal(np.asarray(out)[: len(uq)].astype(np.uint64), sums)


def test_group_reduce_jit_and_edges(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 20, size=1_000, dtype=np.uint32)
    v = rng.integers(0, 100, size=1_000, dtype=np.uint32)
    f = jax.jit(lambda a, b: group_reduce(a, b, reduce="mean", size=32))
    uk, out, ng = f(jnp.asarray(k), jnp.asarray(v))
    uq, want = _np_group(k, v, "mean")
    assert int(ng) == len(uq)
    assert np.allclose(np.asarray(out)[: len(uq)], want, rtol=1e-5)
    uk, out, ng = group_reduce(jnp.zeros((0,), jnp.uint32),
                               jnp.zeros((0,), jnp.int32), size=4)
    assert int(ng) == 0 and out.shape == (4,)
    with pytest.raises(ValueError):
        group_reduce(jnp.zeros(4, jnp.uint32), jnp.zeros(3, jnp.int32))
    with pytest.raises(ValueError):
        group_reduce(jnp.zeros(4, jnp.uint32), jnp.zeros(4, jnp.int32),
                     reduce="prod")


# ------------------------------------------------------ dense group tier

@pytest.mark.parametrize("vdtype", [np.int32, np.uint32, np.int8, np.uint16,
                                    np.bool_])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_group_reduce_dense_matches_sort_native(vdtype, reduce, rng):
    from radix_sorting.extras import group_reduce
    n, G = 30_000, 1 << 9
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    if vdtype == np.bool_:
        v = (rng.integers(0, 2, size=n) > 0)
    else:
        v = rng.integers(np.iinfo(vdtype).min, np.iinfo(vdtype).max,
                         size=n, dtype=vdtype)
    for desc in (False, True):
        cfg = SortConfig(descending=desc)
        uk_d, rv_d, ng_d = group_reduce(k, v, reduce=reduce, groups=G,
                                        config=cfg)
        m = int(ng_d)
        uk_s, rv_s, ng_s = group_reduce(k, v, reduce=reduce, size=m,
                                        config=cfg)
        assert int(ng_s) == m
        assert rv_d.dtype == rv_s.dtype
        assert uk_d.shape == (min(n, G),)  # size defaults to min(n, groups)
        assert np.array_equal(np.asarray(uk_d)[:m], np.asarray(uk_s)[:m])
        a, b = np.asarray(rv_d)[:m], np.asarray(rv_s)[:m]
        if reduce == "mean":
            assert np.allclose(a, b, rtol=1e-5)
        else:
            assert np.array_equal(a, b)
        assert np.all(np.asarray(rv_d)[m:] == 0)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_group_reduce_dense_f32(vdtype, reduce, rng):
    # FLOAT values ride the dense tier (round 5): fused count+bf16x2-sum
    # histogram, vs a float64 oracle within the documented bound
    from radix_sorting.extras import group_reduce
    n, G = 30_000, 1 << 9
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    v = (rng.standard_normal(n) * 10).astype(vdtype)
    uk_d, rv_d, ng_d = group_reduce(k, v, reduce=reduce, groups=G)
    assert rv_d.dtype == jnp.float32
    assert uk_d.shape == (min(n, G),)
    m = int(ng_d)
    ref = np.zeros(G, np.float64)
    np.add.at(ref, k, v.astype(np.float64))
    cnt = np.bincount(k, minlength=G)
    assert m == int((cnt > 0).sum())
    ids = np.asarray(uk_d)[:m]
    want = ref[ids] if reduce == "sum" else ref[ids] / np.maximum(cnt[ids], 1)
    assert np.allclose(np.asarray(rv_d)[:m], want, rtol=1e-3, atol=1e-3)
    assert np.all(np.asarray(rv_d)[m:] == 0)
    # past the 3-plane gate (3 * 2^16 > 2^17) the promise falls back to the
    # sort-native route — same contract, still correct
    uk_f, rv_f, ng_f = group_reduce(k, v, reduce=reduce, groups=1 << 16,
                                    size=m)
    assert int(ng_f) == m
    assert np.array_equal(np.asarray(uk_f)[:m], ids)
    assert np.allclose(np.asarray(rv_f)[:m], want, rtol=1e-3, atol=1e-3)
    # f64 numpy values keep the host-exact sort-native route
    uk_h, rv_h, ng_h = group_reduce(k, v.astype(np.float64), reduce=reduce,
                                    groups=G)
    assert np.allclose(np.asarray(rv_h)[:m], want, rtol=1e-9, atol=1e-9)
    # descending key order through the same tier
    cfg = SortConfig(descending=True)
    uk_r, rv_r, ng_r = group_reduce(k, v, reduce=reduce, groups=G,
                                    config=cfg)
    assert int(ng_r) == m
    assert np.array_equal(np.asarray(uk_r)[:m], ids[::-1])
    assert np.allclose(np.asarray(rv_r)[:m], want[::-1],
                       rtol=1e-3, atol=1e-3)


def test_group_reduce_dense_mod32_wrap(rng):
    # integer sums are exact mod 2^32 — the 32-bit accumulation contract
    from radix_sorting.extras import group_reduce
    n, G = 50_000, 64
    k = rng.integers(0, G, size=n, dtype=np.int32)
    v = rng.integers(1 << 28, (1 << 31) - 1, size=n, dtype=np.int32)
    uk, rv, ng = group_reduce(k, v, reduce="sum", groups=G)
    ref = np.zeros(G, np.int64)
    np.add.at(ref, k, v.astype(np.int64))
    want = (ref & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
    assert np.array_equal(np.asarray(rv)[: int(ng)],
                          want[np.asarray(uk)[: int(ng)]])


def test_group_reduce_dense_promise_and_fallbacks(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 40, size=2_000, dtype=np.uint32)
    k[::200] = 77  # promise violations
    v = np.ones(2_000, np.int32)
    uk, rv, ng = group_reduce(k, v, reduce="sum", groups=40)
    assert int(np.asarray(rv).sum()) == 2_000 - 10  # dense tier drops them
    with pytest.raises(ValueError, match="outside"):
        group_reduce(k, v, reduce="sum", groups=40, validate=True)
    with pytest.raises(TypeError, match="integer"):
        group_reduce(k.astype(np.float32), v, reduce="sum", groups=40)
    with pytest.raises(ValueError, match="groups"):
        group_reduce(k, v, reduce="sum", groups=0)
    # min/max with a groups promise keep the sort-native route (and keep
    # out-of-range keys as ordinary keys)
    uk, rv, ng = group_reduce(k, v, reduce="max", groups=128)
    assert int(ng) == 41
    # float values fall through to sort-native under the same size default
    fv = rng.standard_normal(2_000).astype(np.float32)
    uk_f, rv_f, ng_f = group_reduce(k, fv, reduce="sum", groups=128)
    assert uk_f.shape == (128,)
    # gate: (bytes+1)*bins > 2^17 falls back to sort-native, same answers
    big_g = 1 << 16  # i32 values: 5 * 2^16 > 2^17
    uk_g, rv_g, ng_g = group_reduce(k, v, reduce="sum", groups=big_g,
                                    size=64)
    uk_r, rv_r, ng_r = group_reduce(k, v, reduce="sum", size=64)
    assert np.array_equal(np.asarray(rv_g)[: int(ng_r)],
                          np.asarray(rv_r)[: int(ng_r)])


def test_group_reduce_dense_jit_and_empty(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 16, size=4_096, dtype=np.uint8)
    v = rng.integers(0, 100, size=4_096, dtype=np.uint8)
    f = jax.jit(lambda a, b: group_reduce(a, b, reduce="mean", groups=16))
    uk, rv, ng = f(jnp.asarray(k), jnp.asarray(v))
    uq, want = _np_group(k, v, "mean")
    assert int(ng) == len(uq)
    assert np.allclose(np.asarray(rv)[: len(uq)], want, rtol=1e-5)
    uk, rv, ng = group_reduce(jnp.zeros((0,), jnp.uint32),
                              jnp.zeros((0,), jnp.int32), groups=8)
    assert int(ng) == 0 and rv.shape == (0,)


# ------------------------------------------------- review-fix regressions

def test_unique_counts_only_routes_through_api_sort(rng, monkeypatch):
    # the no-permutation path must ride api.sort's strategy dispatch
    # (counting/bitmap tiers), not the raw word sorter
    import radix_sorting.api as api_mod
    calls = []
    orig = api_mod.sort
    monkeypatch.setattr(api_mod, "sort",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x = rng.integers(0, 200, size=5_000, dtype=np.uint16)
    r = unique(jnp.asarray(x), return_counts=True)
    assert calls, "counts-only unique must delegate to api.sort"
    uq, cnt = np.unique(x, return_counts=True)
    assert int(r.num_unique) == len(uq)
    assert np.array_equal(np.asarray(r.values)[: len(uq)], uq)
    assert np.array_equal(np.asarray(r.counts)[: len(uq)], cnt)
    # padding stays the domain maximum on the delegated path too
    assert np.all(np.asarray(r.values)[len(uq):] == np.uint16(0xFFFF))


def test_setops_empty_side_validates_and_pads(rng):
    a = rng.integers(0, 50, size=100, dtype=np.uint32)
    e = jnp.zeros((0,), jnp.uint32)
    # dtype mismatch must raise even when one side is empty
    with pytest.raises(TypeError):
        union1d(e, jnp.zeros(4, jnp.int32))
    with pytest.raises(TypeError):
        isin(jnp.zeros((0,), jnp.uint32), jnp.zeros(4, jnp.int32))
    # 0-d input: typed ValueError, not IndexError
    with pytest.raises(ValueError):
        setdiff1d(jnp.uint32(3), jnp.asarray(a))
    # empty-side results keep the domain-max padding convention
    vals, cnt = intersect1d(jnp.asarray(a), e, size=8)
    assert int(cnt) == 0
    assert np.all(np.asarray(vals) == np.uint32(0xFFFFFFFF))
    vals, cnt = union1d(e, e, size=3)
    assert int(cnt) == 0
    assert np.all(np.asarray(vals) == np.uint32(0xFFFFFFFF))


def test_isin_duplicate_heavy_runs(rng):
    # runs mixing many tests and many queries at the same value — the
    # prefix-algebra membership (T > U) must hold for every query in a run
    el = np.repeat(rng.integers(0, 40, size=200, dtype=np.int32), 20)
    te = np.repeat(rng.integers(20, 60, size=150, dtype=np.int32), 13)
    rng.shuffle(el)
    got = np.asarray(isin(jnp.asarray(el), jnp.asarray(te)))
    assert np.array_equal(got, np.isin(el, te))


def test_group_reduce_mean_64bit_exact(rng):
    from radix_sorting.extras import group_reduce
    k = rng.integers(0, 4, size=64, dtype=np.uint32)
    base = np.int64(1) << 40
    v = base + rng.integers(0, 1000, size=64).astype(np.int64)
    uk, out, ng = group_reduce(jnp.asarray(k), v, reduce="mean")
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    uq, inv = np.unique(k, return_inverse=True)
    want = np.zeros(len(uq), np.float64)
    np.add.at(want, inv, v.astype(np.float64))
    want /= np.bincount(inv)
    assert np.array_equal(out[: len(uq)], want)  # exact in f64, f32 rounds


# --------------------------------------------- numpy-2.0 unique_* quartet

def test_unique_quartet_vs_numpy(rng):
    from radix_sorting.sets import (unique_all, unique_counts,
                                        unique_inverse, unique_values)
    x = rng.integers(0, 500, size=30_000, dtype=np.uint32)
    uq, idx, inv, cnt = np.unique(x, return_index=True, return_inverse=True,
                                  return_counts=True)
    k = len(uq)

    rv = unique_values(jnp.asarray(x))
    assert int(rv.num_unique) == k
    assert np.array_equal(np.asarray(rv.values)[:k], uq)

    rc = unique_counts(jnp.asarray(x))
    assert np.array_equal(np.asarray(rc.values)[:k], uq)
    assert np.array_equal(np.asarray(rc.counts)[:k], cnt)

    ri = unique_inverse(jnp.asarray(x))
    assert np.array_equal(np.asarray(ri.values)[:k], uq)
    assert np.array_equal(np.asarray(ri.values)[np.asarray(ri.inverse_indices)], x)

    ra = unique_all(jnp.asarray(x))
    assert np.array_equal(np.asarray(ra.values)[:k], uq)
    assert np.array_equal(np.asarray(ra.indices)[:k], idx)
    assert np.array_equal(np.asarray(ra.counts)[:k], cnt)
    assert np.array_equal(np.asarray(ra.values)[np.asarray(ra.inverse_indices)], x)


def test_unique_quartet_jit_and_i64(rng):
    from radix_sorting.sets import unique_all, unique_counts
    x = rng.integers(-(1 << 40), 1 << 40, size=4_000).astype(np.int64)
    x = np.repeat(x[:400], 10)
    rng.shuffle(x)
    uq, cnt = np.unique(x, return_counts=True)
    rc = unique_counts(x)  # numpy 64-bit in, numpy out, no x64
    k = len(uq)
    assert int(rc.num_unique) == k
    assert np.array_equal(np.asarray(rc.values[:k], dtype=np.int64), uq)
    assert np.array_equal(np.asarray(rc.counts)[:k], cnt)

    y = rng.integers(0, 64, size=2_048, dtype=np.uint32)
    ra = jax.jit(lambda a: unique_all(a))(jnp.asarray(y))
    uq2, idx2, inv2, cnt2 = np.unique(y, return_index=True,
                                      return_inverse=True, return_counts=True)
    k2 = len(uq2)
    assert np.array_equal(np.asarray(ra.values)[:k2], uq2)
    assert np.array_equal(np.asarray(ra.indices)[:k2], idx2)
    assert np.array_equal(np.asarray(ra.inverse_indices), inv2)
    assert np.array_equal(np.asarray(ra.counts)[:k2], cnt2)
