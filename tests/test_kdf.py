"""KDF property tests: the derived key must be a monotone bijection into uints.

Mirrors the contract of `radix_sort_basic_kdf.hpp:10-48` for every supported
dtype, including the float edge cases of `radix_tests.cpp:157`.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from radix_sorting.ops import kdf


def _np_words(words):
    return [np.asarray(w) for w in words]


def _lex(words):
    """Sortable composite numpy key from word planes (MSW first)."""
    ws = _np_words(words)
    acc = ws[0].astype(np.uint64)
    for w in ws[1:]:
        acc = (acc << np.uint64(32)) | w.astype(np.uint64)
    return acc


INT_DTYPES = ["uint8", "uint16", "uint32", "int8", "int16", "int32"]
FLOAT_DTYPES = ["float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
_ML_FLOATS = {"bfloat16": 16, "float8_e4m3fn": 8, "float8_e5m2": 8}


def _random_values(rng, dtype, n=4096):
    d = np.dtype(dtype) if dtype not in _ML_FLOATS else None
    if dtype in _ML_FLOATS:
        bits = _ML_FLOATS[dtype]
        raw = rng.integers(0, 1 << bits, size=n, dtype=np.dtype(f"uint{bits}"))
        return jnp.asarray(raw).view(jnp.dtype(dtype))
    if d.kind == "f":
        raw = rng.integers(0, 1 << (8 * d.itemsize), size=n,
                           dtype=np.dtype(f"u{d.itemsize}"))
        return jnp.asarray(raw.view(d))
    info = np.iinfo(d)
    return jnp.asarray(rng.integers(info.min, int(info.max) + 1, size=n, dtype=d))


@pytest.mark.parametrize("dtype", INT_DTYPES + FLOAT_DTYPES)
def test_roundtrip(rng, dtype):
    from jax import lax
    x = _random_values(rng, dtype)
    words = kdf.encode(x)
    back = kdf.decode(words, x.dtype)
    # expected bits: the input's own, NaN payloads included (the KDF is
    # bit-faithful)
    expect = np.asarray(
        lax.bitcast_convert_type(x, jnp.dtype(f"uint{x.dtype.itemsize * 8}")))
    assert np.array_equal(
        np.asarray(back).view(np.dtype(f"u{x.dtype.itemsize}")), expect
    )


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_monotone_ints(rng, dtype):
    x = _random_values(rng, dtype)
    xs = np.sort(np.asarray(x))
    k = _lex(kdf.encode(jnp.asarray(xs)))
    assert np.all(k[:-1] <= k[1:])


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
def test_monotone_floats_random_bits(rng, dtype):
    # every float dtype (incl. the 8-bit ML dtypes): sorting by derived key
    # must order the finite values by float value (NaNs sort to the ends of
    # the KDF total order; dropping them preserves the finite subsequence)
    x = _random_values(rng, dtype)
    k = np.asarray(_lex(kdf.encode(x)))
    order = np.argsort(k, kind="stable")
    f = np.asarray(x).astype(np.float32)[order]
    fin = f[~np.isnan(f)]
    assert np.all(fin[:-1] <= fin[1:])


@pytest.mark.parametrize("dtype", ["float32"])
def test_monotone_float_with_specials(dtype):
    # the `radix_tests.cpp:157` fixture ordering: -NaN < -inf < ... < -0 < +0
    # < ... < +inf < +NaN under the KDF total order
    vals = np.array(
        [-np.inf, -646464.25, -128.5, -0.5, -0.0, 0.0, 0.5, 128.5, 646464.25, np.inf],
        dtype=np.float32,
    )
    k = _lex(kdf.encode(jnp.asarray(vals)))
    assert np.all(k[:-1] <= k[1:])
    # -0 and +0 map to adjacent but distinct keys (KDF is a bijection)
    assert k[4] < k[5]
    # NaN with positive sign bit sorts after +inf; negative NaN before -inf
    pnan = _lex(kdf.encode(jnp.asarray(np.array([np.nan], np.float32))))[0]
    nnan = _lex(kdf.encode(jnp.asarray(np.array([-np.nan], np.float32))))[0]
    assert pnan > k[-1]
    assert nnan < k[0]


@pytest.mark.parametrize("dtype", INT_DTYPES + ["float32"])
def test_descending_is_complement_order(rng, dtype):
    x = _random_values(rng, dtype)
    asc = _lex(kdf.encode(x))
    desc = _lex(kdf.encode(x, descending=True))
    o_asc = np.argsort(asc, kind="stable")
    o_desc = np.argsort(desc, kind="stable")
    # descending keys sort in exactly the reverse value order; with random data
    # (possible duplicates in narrow dtypes) compare the gathered key ranks
    assert np.array_equal(asc[o_desc], asc[o_asc][::-1])


def test_u64_pair_words(rng):
    x = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    from radix_sorting.api import _as_words
    words, dt = _as_words(x, False)
    assert len(words) == 2 and dt == np.dtype("uint64")
    k = _lex(words)
    assert np.array_equal(np.sort(k), np.sort(x))  # identity KDF for u64


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_64bit_signed_float_monotone(rng, dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        raw = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
        x = raw.view(np.float64)
        x = x[~np.isnan(x)]  # NaN ordering vs numpy sort differs; tested via k-order
    else:
        x = rng.integers(np.iinfo(d).min, np.iinfo(d).max, size=4096, dtype=d)
    from radix_sorting.api import _as_words
    xs = np.sort(x)
    words, _ = _as_words(xs, False)
    k = _lex(words)
    assert np.all(k[:-1] <= k[1:])


def test_kdf_metadata_helpers():
    from radix_sorting.ops import kdf
    assert kdf.num_words("uint64") == 2 and kdf.num_words("float32") == 1
    assert kdf.key_bits("int16") == 16 and kdf.key_bits("float64") == 64
    with pytest.raises(TypeError):
        kdf.key_bits("complex64")


def test_split_join64_np_roundtrip(rng):
    from radix_sorting.ops import kdf
    for dt in (np.uint64, np.int64, np.float64):
        x = rng.integers(0, 1 << 64, size=257, dtype=np.uint64).view(dt)
        hi, lo = kdf.split64_np(x)
        back = kdf.join64_np(hi, lo, dt)
        assert np.array_equal(back.view(np.uint64), x.view(np.uint64))


def test_word_lt_lexicographic(rng):
    from radix_sorting.ops.probes import word_lt
    a = (np.array([1, 2, 2, 2], np.uint32), np.array([9, 1, 5, 5], np.uint32))
    b = (np.array([2, 2, 2, 2], np.uint32), np.array([0, 2, 5, 4], np.uint32))
    got = np.asarray(word_lt(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b))))
    assert got.tolist() == [True, True, False, False]
