"""Native runtime tests: build, IO round-trip, verifier, and cross-checking
the device engines against the independent native oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.runtime import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def test_keyfile_roundtrip(tmp_path, rng):
    p = tmp_path / "keys.dat"
    native.generate_keyfile(p, 100_000, seed=42)
    a = native.read_keyfile(p, 100_000)
    assert a.shape == (100_000,)
    # deterministic: same seed, same keys
    native.generate_keyfile(p, 100_000, seed=42)
    b = native.read_keyfile(p, 100_000)
    assert np.array_equal(a, b)
    # short read truncates
    c = native.read_keyfile(p, 200_000)
    assert c.shape == (100_000,)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "uint8"])
def test_native_is_sorted(rng, dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        x = rng.standard_normal(10_000).astype(d)
    else:
        x = rng.integers(np.iinfo(d).min, int(np.iinfo(d).max) + 1, 10_000, dtype=d)
    assert not native.is_sorted(x) or np.array_equal(x, np.sort(x))
    assert native.is_sorted(np.sort(x))
    assert native.is_sorted(np.sort(x)[::-1].copy(), descending=True)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "uint64", "uint8",
                                   "float32", "float64", "int64", "int16",
                                   "uint16", "int8"])
def test_oracle_matches_numpy(rng, dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        x = rng.standard_normal(30_000).astype(d)
    else:
        x = rng.integers(np.iinfo(d).min, int(np.iinfo(d).max) + 1, 30_000, dtype=d)
    assert np.array_equal(native.oracle_sort(x), np.sort(x, kind="stable"))
    assert np.array_equal(native.oracle_rank(x),
                          np.argsort(x, kind="stable").astype(np.uint32))


def test_device_engines_match_native_oracle(rng):
    # three-way agreement: device hw engine == device LSD == native oracle
    x = rng.integers(0, 1 << 32, size=30_000, dtype=np.uint32)
    dev = np.asarray(rst.sort(jnp.asarray(x)))
    lsd = np.asarray(rst.sort(jnp.asarray(x),
                              config=rst.SortConfig(strategy=rst.Strategy.LSD)))
    nat = native.oracle_sort(x)
    assert np.array_equal(dev, nat)
    assert np.array_equal(lsd, nat)
    # rank agreement (unique stable permutation)
    perm_dev = np.asarray(rst.rank_sort(jnp.asarray(x)))
    assert np.array_equal(perm_dev, native.oracle_rank(x))


def test_oracle_float_specials():
    x = np.array([np.nan, -np.inf, 0.5, -0.0, 0.0, np.inf, -1.5], np.float32)
    s = native.oracle_sort(x)
    expect = np.array([-np.inf, -1.5, -0.0, 0.0, 0.5, np.inf, np.nan], np.float32)
    assert np.array_equal(s.view(np.uint32), expect.view(np.uint32))
