"""Fixed-width byte-string KEYS (numpy ``S<W>``).

Beyond-reference capability: the reference's record demo sorts BY a one-byte
key and carries a char name (`counting_sort_rec_sk.c:10-12`); here the byte
string itself is a key dtype. Big-endian u32 plane packing makes multi-word
plane order identical to numpy's ``S`` ordering, so the oracle is plain
``np.sort`` / stable python ``sorted``.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst

WIDTHS = [1, 3, 4, 5, 8, 11, 16]


def _random_bytes(rng, n, W, alphabet=256):
    """Random S<W> array; small alphabets force duplicates, NULs included."""
    u8 = rng.integers(0, alphabet, size=(n, W), dtype=np.uint8)
    # random trailing-NUL truncation so padding semantics are exercised
    keep = rng.integers(0, W + 1, size=(n, 1))
    u8 = np.where(np.arange(W)[None, :] < keep, u8, 0).astype(np.uint8)
    return np.ascontiguousarray(u8).view(f"S{W}").reshape(-1)


@pytest.mark.parametrize("W", WIDTHS)
def test_sort_matches_numpy(rng, W):
    x = _random_bytes(rng, 4097, W)
    out = rst.sort(x)
    assert isinstance(out, np.ndarray) and out.dtype == x.dtype
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("W", [1, 5, 8])
def test_sort_descending(rng, W):
    x = _random_bytes(rng, 2048, W, alphabet=7)
    out = rst.sort(x, config=rst.SortConfig(descending=True))
    np.testing.assert_array_equal(out, np.sort(x)[::-1])


@pytest.mark.parametrize("W", [2, 4, 9])
def test_argsort_stable(rng, W):
    x = _random_bytes(rng, 1500, W, alphabet=4)  # heavy duplicates
    perm = np.asarray(rst.argsort(x))
    np.testing.assert_array_equal(perm, np.argsort(x, kind="stable"))


def test_argsort_descending_stable(rng):
    x = _random_bytes(rng, 1000, 3, alphabet=3)
    perm = np.asarray(rst.argsort(x, config=rst.SortConfig(descending=True)))
    # python sorted(reverse=True) keeps equal elements in original order —
    # exactly the unique stable descending permutation
    expect = np.array(sorted(range(len(x)), key=lambda i: x[i], reverse=True))
    np.testing.assert_array_equal(perm, expect)


@pytest.mark.parametrize("W", [1, 6, 12])
def test_sort_pairs_bytes_keys(rng, W):
    n = 2000
    x = _random_bytes(rng, n, W, alphabet=5)
    vals = jnp.arange(n, dtype=jnp.uint32)
    sk, sv = rst.sort_pairs(x, vals)
    perm = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(sk, x[perm])
    np.testing.assert_array_equal(np.asarray(sv), perm)


def test_bytes_key_with_bytes_payload(rng):
    # keys and a byte-string payload field in one sort (record parity:
    # `radix_tests.cpp` sortrec fixture generalized)
    n = 512
    keys = _random_bytes(rng, n, 4, alphabet=3)
    names = _random_bytes(rng, n, 7)
    sk, sv = rst.sort_pairs(keys, {"name": names})
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[perm])
    np.testing.assert_array_equal(sv["name"], names[perm])


def test_interior_and_trailing_nuls():
    x = np.array([b"a\x00b", b"a", b"a\x00", b"ab", b"", b"\x00a"], dtype="S3")
    np.testing.assert_array_equal(rst.sort(x), np.sort(x))


def test_presorted_and_constant(rng):
    x = np.sort(_random_bytes(rng, 777, 5))
    np.testing.assert_array_equal(rst.sort(x), x)
    c = np.full(100, b"zz", dtype="S2")
    np.testing.assert_array_equal(rst.sort(c), c)


def test_tiny_and_empty():
    e = np.array([], dtype="S4")
    out = rst.sort(e)
    assert out.dtype == e.dtype and out.shape == (0,)
    one = np.array([b"q"], dtype="S4")
    np.testing.assert_array_equal(rst.sort(one), one)


def test_lsd_strategy_bytes(rng):
    x = _random_bytes(rng, 300, 6, alphabet=9)
    out = rst.sort(x, config=rst.SortConfig(strategy=rst.Strategy.LSD))
    np.testing.assert_array_equal(out, np.sort(x))


def test_value_mask_rejected(rng):
    x = _random_bytes(rng, 10, 4)
    with pytest.raises(ValueError, match="value_mask"):
        rst.sort(x, value_mask=0xFF)
    with pytest.raises(ValueError, match="value_mask"):
        rst.argsort(x, value_mask=0xFF)
    with pytest.raises(ValueError, match="value_mask"):
        rst.sort_pairs(x, jnp.arange(10, dtype=jnp.uint32), value_mask=0xFF)


def test_counting_strategy_rejected(rng):
    x = _random_bytes(rng, 10, 2)
    with pytest.raises(ValueError):
        rst.sort(x, config=rst.SortConfig(strategy=rst.Strategy.COUNTING))


def test_width_bounds():
    # (numpy silently promotes S0 arrays to S1, so the zero-width guard in
    # kdf._check_bytes_width is defensive-only and untestable from here)
    wide = np.zeros(4, dtype="S260")
    with pytest.raises(ValueError, match="width"):
        rst.sort(wide)
    from radix_sorting.ops.kdf import _check_bytes_width
    with pytest.raises(ValueError, match="width"):
        _check_bytes_width(0)


def test_nd_rejected(rng):
    x = _random_bytes(rng, 12, 2).reshape(3, 4)
    with pytest.raises(ValueError, match="1-D"):
        rst.sort(x)


def test_dynamic_probe_short_bytes(rng):
    # S<=8 keys fit the <=2-plane probe gates; narrow alphabets may ride the
    # counting tier — result must be identical either way
    x = _random_bytes(rng, 5000, 2, alphabet=3)
    out = rst.sort(x, config=rst.SortConfig(dynamic_probe=True))
    np.testing.assert_array_equal(out, np.sort(x))


def test_kdf_bytes_roundtrip(rng):
    from radix_sorting.ops import kdf
    for W in (1, 4, 7, 8, 13):
        x = _random_bytes(rng, 257, W)
        for desc in (False, True):
            words = kdf.encode_bytes_np(x, desc)
            assert len(words) == kdf.num_words(x.dtype) == -(-W // 4)
            back = kdf.decode_bytes_np(words, x.dtype, desc)
            np.testing.assert_array_equal(back, x)
        assert kdf.kind(x.dtype) == "S"
        assert kdf.key_bits(x.dtype) == 8 * W


def test_kdf_bytes_order_preserving(rng):
    # encoded plane tuples must order exactly as numpy orders the strings
    from radix_sorting.ops import kdf
    x = _random_bytes(rng, 400, 6, alphabet=5)
    words = [np.asarray(w) for w in kdf.encode_bytes_np(x)]
    tuples = list(zip(*[w.tolist() for w in words]))
    order_np = np.argsort(x, kind="stable")
    order_words = np.array(sorted(range(len(x)),
                                  key=lambda i: (tuples[i], i)))
    np.testing.assert_array_equal(order_words, order_np)
