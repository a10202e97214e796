"""Order statistics / ranking (stats.py) vs numpy and scipy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as scipy_stats

from radix_sorting import SortConfig
from radix_sorting.stats import (argpartition, digitize, histogram,
                                     histogram_bin_edges, median, partition,
                                     percentile, quantile, rankdata)

METHODS = ("average", "min", "max", "dense", "ordinal")
QMETHODS = ("linear", "lower", "higher", "nearest", "midpoint")


# ---------------------------------------------------------------- rankdata

@pytest.mark.parametrize("method", METHODS)
def test_rankdata_ties_vs_scipy(rng, method):
    x = rng.integers(0, 25, size=5_000, dtype=np.int32)  # heavy ties
    got = np.asarray(rankdata(jnp.asarray(x), method=method))
    exp = scipy_stats.rankdata(x, method=method)
    assert np.array_equal(got.astype(np.float64), exp.astype(np.float64))


@pytest.mark.parametrize("method", METHODS)
def test_rankdata_floats_vs_scipy(rng, method):
    x = np.repeat(rng.standard_normal(700).astype(np.float32), 3)
    rng.shuffle(x)
    got = np.asarray(rankdata(jnp.asarray(x), method=method))
    exp = scipy_stats.rankdata(x, method=method)
    assert np.array_equal(got.astype(np.float64), exp.astype(np.float64))


def test_rankdata_descending(rng):
    x = rng.integers(0, 50, size=3_000, dtype=np.uint32)
    got = np.asarray(rankdata(jnp.asarray(x), method="average",
                              config=SortConfig(descending=True)))
    # descending ranks == ranks of the order-reversing transform
    exp = scipy_stats.rankdata(-x.astype(np.int64), method="average")
    assert np.array_equal(got.astype(np.float64), exp)


def test_rankdata_ordinal_is_stable_inverse(rng):
    # ordinal ranks are exactly argsort-of-argsort + 1 (stable)
    x = rng.integers(0, 10, size=2_000, dtype=np.int32)
    got = np.asarray(rankdata(jnp.asarray(x), method="ordinal"))
    perm = np.argsort(x, kind="stable")
    exp = np.empty_like(perm)
    exp[perm] = np.arange(1, len(x) + 1)
    assert np.array_equal(got, exp)


def test_rankdata_u64_numpy_input(rng):
    x = rng.integers(0, 1 << 63, size=4_000, dtype=np.uint64)
    x[::7] = x[0]  # inject ties across the plane boundary
    got = np.asarray(rankdata(x, method="min"))
    exp = scipy_stats.rankdata(x, method="min")
    assert np.array_equal(got.astype(np.float64), exp)


def test_rankdata_all_equal_and_empty():
    x = jnp.full((100,), 7, jnp.int32)
    assert np.all(np.asarray(rankdata(x, method="average")) == 50.5)
    assert np.all(np.asarray(rankdata(x, method="dense")) == 1)
    assert np.all(np.asarray(rankdata(x, method="max")) == 100)
    assert rankdata(jnp.zeros((0,), jnp.int32)).shape == (0,)


def test_rankdata_jittable(rng):
    x = rng.integers(0, 9, size=1_000, dtype=np.int32)
    f = jax.jit(lambda a: rankdata(a, method="average"))
    assert np.array_equal(np.asarray(f(jnp.asarray(x))),
                          scipy_stats.rankdata(x))


def test_rankdata_bad_method():
    with pytest.raises(ValueError, match="method"):
        rankdata(jnp.arange(4), method="median")


# ---------------------------------------------------------------- quantile

@pytest.mark.parametrize("method", QMETHODS)
def test_quantile_vs_numpy(rng, method):
    x = rng.standard_normal(2_001).astype(np.float32)
    q = [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0]
    got = np.asarray(quantile(jnp.asarray(x), q, method=method))
    exp = np.quantile(x.astype(np.float64), q, method=method)
    assert np.allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_quantile_scalar_and_median(rng):
    x = rng.standard_normal(500).astype(np.float32)
    m = median(jnp.asarray(x))
    assert np.ndim(m) == 0
    assert np.isclose(float(m), np.median(x), rtol=1e-6)
    assert np.isclose(float(percentile(jnp.asarray(x), 75)),
                      np.percentile(x.astype(np.float64), 75), rtol=1e-5)


def test_quantile_int_discrete_keeps_dtype(rng):
    x = rng.integers(0, 1000, size=999, dtype=np.uint32)
    got = quantile(jnp.asarray(x), [0.25, 0.5], method="lower")
    assert got.dtype == jnp.uint32
    exp = np.quantile(x, [0.25, 0.5], method="lower")
    assert np.array_equal(np.asarray(got).astype(np.float64), exp)


def test_quantile_f64_numpy_host_path(rng):
    x = rng.standard_normal(1_234)  # float64, no x64: host-side exact path
    got = quantile(x, [0.3, 0.62])
    exp = np.quantile(x, [0.3, 0.62])
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert np.allclose(got, exp, rtol=0, atol=0)


def test_quantile_narrow_domain_counting_tier(rng):
    # u8 keys ride the counting-tier sort; quantiles must still be exact
    x = rng.integers(0, 256, size=50_000, dtype=np.uint8)
    got = np.asarray(quantile(jnp.asarray(x), [0.5], method="higher"))
    exp = np.quantile(x, [0.5], method="higher")
    assert np.array_equal(got.astype(np.float64), exp)


def test_quantile_errors():
    with pytest.raises(ValueError, match="empty"):
        quantile(jnp.zeros((0,), jnp.float32), 0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        quantile(jnp.arange(4), 1.5)
    with pytest.raises(ValueError, match="method"):
        quantile(jnp.arange(4), 0.5, method="cubic")


def test_quantile_jittable(rng):
    x = rng.standard_normal(512).astype(np.float32)
    f = jax.jit(lambda a: quantile(a, [0.1, 0.9]))
    exp = np.quantile(x.astype(np.float64), [0.1, 0.9])
    assert np.allclose(np.asarray(f(jnp.asarray(x))), exp, rtol=1e-5)


# ---------------------------------------------------------------- digitize

@pytest.mark.parametrize("right", (False, True))
def test_digitize_vs_numpy(rng, right):
    bins = np.array([-2.0, -1.0, -0.25, 0.0, 0.5, 1.75], np.float32)
    x = np.concatenate([rng.standard_normal(3_000).astype(np.float32), bins])
    got = np.asarray(digitize(jnp.asarray(x), jnp.asarray(bins), right=right))
    exp = np.digitize(x, bins, right=right)
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("right", (False, True))
def test_digitize_decreasing_bins(rng, right):
    bins = np.array([9, 6, 4, 1, 0], np.int32)
    x = rng.integers(-2, 12, size=2_000, dtype=np.int32)
    got = np.asarray(digitize(jnp.asarray(x), jnp.asarray(bins), right=right))
    exp = np.digitize(x, bins, right=right)
    assert np.array_equal(got, exp)


def test_digitize_explicit_descending_under_jit(rng):
    bins = np.array([50, 20, 10], np.int32)
    x = rng.integers(0, 60, size=500, dtype=np.int32)
    f = jax.jit(lambda xx, bb: digitize(xx, bb, descending=True))
    got = np.asarray(f(jnp.asarray(x), jnp.asarray(bins)))
    assert np.array_equal(got, np.digitize(x, bins))


# ---------------------------------------------------------------- histogram

def test_histogram_uniform_vs_numpy(rng):
    # grid-aligned data (0.01 steps) keeps every point far from the f32
    # binning's ~1-ulp edge band (the documented precision contract), so
    # numpy's f64 oracle applies bit-for-bit
    x = np.round(rng.standard_normal(10_000), 2).astype(np.float32)
    c, e = histogram(jnp.asarray(x), bins=16, range=(-4.0, 4.0))
    ce, ee = np.histogram(x, bins=16, range=(-4.0, 4.0))
    assert np.array_equal(np.asarray(c), ce)
    assert np.allclose(e, ee, rtol=1e-6)


def test_histogram_uniform_data_extent_edges(rng):
    # no range: edges span the integer data's extent; integer points stay
    # >= ~0.1 from the rational interior edges, f32-exact
    x = rng.integers(0, 97, size=20_000).astype(np.float32)
    c, e = histogram(jnp.asarray(x), bins=10)
    ce, ee = np.histogram(x, bins=10)
    assert np.array_equal(np.asarray(c), ce)
    assert np.allclose(e, ee)
    assert int(jnp.sum(c)) == len(x)


def test_histogram_f32_arithmetic_contract(rng):
    # irrational bin widths + raw normals: verify the DOCUMENTED f32
    # contract exactly — replicate floor((x - lo) * scale) in numpy f32
    x = rng.standard_normal(50_000).astype(np.float32)
    nb, lo, hi = 7, -1.0, 1.0
    c, _ = histogram(jnp.asarray(x), bins=nb, range=(lo, hi))
    scale = np.float32(nb / (hi - lo))
    idx = np.floor((x - np.float32(lo)) * scale).astype(np.int64)
    idx = np.where(idx == nb, nb - 1, idx)
    keep = (x >= lo) & (x <= hi)
    want = np.bincount(idx[keep], minlength=nb)[:nb]
    assert np.array_equal(np.asarray(c), want)


def test_histogram_range_drops_outside(rng):
    x = np.round(rng.standard_normal(8_000), 2).astype(np.float32)
    c, e = histogram(jnp.asarray(x), bins=8, range=(-1.0, 1.0))
    ce, ee = np.histogram(x, bins=8, range=(-1.0, 1.0))
    assert np.array_equal(np.asarray(c), ce)
    assert np.allclose(e, ee)


def test_histogram_edge_array_vs_numpy(rng):
    edges = np.array([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 3.0])
    x = np.concatenate([rng.standard_normal(5_000),
                        edges, [np.nan, 10.0, -10.0]]).astype(np.float32)
    c, e = histogram(jnp.asarray(x), bins=edges)
    ce, _ = np.histogram(x, bins=edges)
    assert np.array_equal(np.asarray(c), ce)
    assert np.array_equal(e, edges)


def test_histogram_weighted(rng):
    x = np.round(rng.standard_normal(4_000), 2).astype(np.float32)
    w = rng.random(4_000).astype(np.float32)
    c, _ = histogram(jnp.asarray(x), bins=12, range=(-2, 2), weights=jnp.asarray(w))
    ce, _ = np.histogram(x, bins=12, range=(-2, 2), weights=w.astype(np.float64))
    assert np.allclose(np.asarray(c), ce, rtol=1e-4, atol=1e-4)


def test_histogram_density(rng):
    # 16 bins over (-4, 4): width 0.5 is exactly representable, so the
    # grid-aligned data stays clear of every edge in both f32 and f64
    x = np.round(rng.standard_normal(6_000), 2).astype(np.float32)
    c, _ = histogram(jnp.asarray(x), bins=16, range=(-4.0, 4.0), density=True)
    ce, _ = np.histogram(x, bins=16, range=(-4.0, 4.0), density=True)
    assert np.allclose(np.asarray(c), ce, rtol=1e-5)


def test_histogram_int_keys_counting_path(rng):
    x = rng.integers(0, 100, size=30_000, dtype=np.uint8)
    c, e = histogram(jnp.asarray(x), bins=10, range=(0, 100))
    ce, _ = np.histogram(x, bins=10, range=(0, 100))
    assert np.array_equal(np.asarray(c), ce)


def test_histogram_empty_and_errors():
    c, e = histogram(jnp.zeros((0,), jnp.float32), bins=4, range=(0, 1))
    assert np.all(np.asarray(c) == 0) and len(e) == 5
    with pytest.raises(ValueError, match="increasing"):
        histogram(jnp.arange(4.0), bins=np.array([1.0, 0.0]))
    with pytest.raises(ValueError, match="shape"):
        histogram(jnp.arange(4.0), bins=4, weights=jnp.zeros((3,)))
    assert np.allclose(histogram_bin_edges(jnp.zeros((0,), jnp.float32), 2),
                       [0.0, 0.5, 1.0])


def test_histogram_jittable_with_range(rng):
    x = np.round(rng.standard_normal(2_000), 2).astype(np.float32)
    f = jax.jit(lambda a: histogram(a, bins=8, range=(-2.0, 2.0))[0])
    ce, _ = np.histogram(x, bins=8, range=(-2.0, 2.0))
    assert np.array_equal(np.asarray(f(jnp.asarray(x))), ce)


# ---------------------------------------------------------------- partition

def test_partition_contract(rng):
    x = rng.integers(0, 1 << 31, size=9_999, dtype=np.uint32)
    for kth in (0, 17, 5_000, 9_998):
        p = np.asarray(partition(jnp.asarray(x), kth))
        s = np.sort(x)
        assert p[kth] == s[kth]
        assert np.all(p[:kth] <= p[kth]) and np.all(p[kth:] >= p[kth])
    assert np.array_equal(np.asarray(partition(jnp.asarray(x), [3, 44])), s)


def test_argpartition_contract(rng):
    x = rng.standard_normal(5_000).astype(np.float32)
    ap = np.asarray(argpartition(jnp.asarray(x), 2_500))
    assert np.array_equal(np.sort(ap), np.arange(len(x)))
    assert np.array_equal(x[ap], np.sort(x))


def test_partition_kth_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        partition(jnp.arange(10), 10)
    with pytest.raises(ValueError, match="out of range"):
        argpartition(jnp.arange(10), [-11])


# ---------------------------------------------------------------- mode

def test_mode_vs_scipy(rng):
    from radix_sorting.stats import mode
    x = rng.integers(0, 40, size=10_000, dtype=np.int32)
    mv, mc = mode(jnp.asarray(x))
    exp = scipy_stats.mode(x)
    assert int(mv) == int(exp.mode) and int(mc) == int(exp.count)
    # tie resolution: smallest value wins
    t = np.array([5, 5, 5, 2, 2, 2, 9], np.int32)
    mv, mc = mode(jnp.asarray(t))
    assert int(mv) == 2 and int(mc) == 3
    # 64-bit numpy host path
    x64 = np.repeat(rng.integers(0, 1 << 60, size=50, dtype=np.uint64), 7)
    mv, mc = mode(x64)
    e = scipy_stats.mode(x64)
    assert np.uint64(mv) == np.uint64(e.mode) and int(mc) == int(e.count)
    with pytest.raises(ValueError, match="empty"):
        mode(jnp.zeros((0,), jnp.int32))
