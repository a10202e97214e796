"""Engine-level tests: probes, histograms, scans, counting, bitmap, and
cross-engine equivalence (every engine must produce the identical stable
result — stability makes it unique, `README.md:471-473`)."""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.ops import histogram, hw_engine, lsd_engine, probes, scan
from radix_sorting.ops.bitmap import bitmap_unique_sort


# ---------------------------------------------------------------- probes

def test_presorted_probe(rng):
    x = (jnp.arange(1000, dtype=jnp.uint32),)
    assert bool(probes.is_sorted_words(x))
    y = (jnp.asarray(rng.integers(0, 1 << 32, 1000, dtype=np.uint32)),)
    assert not bool(probes.is_sorted_words(y))
    # two-word lexicographic order
    hi = jnp.asarray(np.array([1, 1, 2], np.uint32))
    lo = jnp.asarray(np.array([5, 9, 0], np.uint32))
    assert bool(probes.is_sorted_words((hi, lo)))
    lo_bad = jnp.asarray(np.array([9, 5, 0], np.uint32))  # (1,9) > (1,5)
    assert not bool(probes.is_sorted_words((hi, lo_bad)))


def test_live_bit_mask(rng):
    base = np.uint32(0xA0000005)
    x = jnp.asarray((rng.integers(0, 4, 1000, dtype=np.uint32) << 8) | base)
    (m,) = probes.live_bit_mask((x,))
    assert int(m) == 0x300
    flags = probes.live_digit_mask((m,), 8)
    assert np.array_equal(np.asarray(flags), [False, True, False, False])


def test_pext_pdep_roundtrip(rng):
    mask = 0xF0F00000
    w = jnp.asarray(rng.integers(0, 1 << 32, 1000, dtype=np.uint32) & mask)
    c = probes.compact_live_bits(w, mask)
    assert int(jnp.max(c)) < (1 << 8)
    back = probes.expand_live_bits(c, mask)
    assert np.array_equal(np.asarray(back), np.asarray(w))


# ---------------------------------------------------------------- histogram/scan

def test_digit_histogram(rng):
    x = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint32)
    for p in range(4):
        d = histogram.extract_digit((jnp.asarray(x),), p, 8)
        h = histogram.digit_histogram(d, 256)
        expect = np.bincount((x >> (8 * p)) & 0xFF, minlength=256)
        assert np.array_equal(np.asarray(h), expect)


def test_multi_digit_histogram(rng):
    x = rng.integers(0, 1 << 32, size=10_000, dtype=np.uint32)
    hs = np.asarray(histogram.multi_digit_histogram((jnp.asarray(x),), 8))
    assert hs.shape == (4, 256)
    for p in range(4):
        assert np.array_equal(hs[p], np.bincount((x >> (8 * p)) & 0xFF, minlength=256))


def test_scatter_bases(rng):
    ch = jnp.asarray(rng.integers(0, 50, size=(6, 16), dtype=np.int64).astype(np.int32))
    bases = np.asarray(scan.scatter_bases(ch))
    chn = np.asarray(ch)
    total = chn.sum(0)
    gstart = np.concatenate([[0], np.cumsum(total)[:-1]])
    for c in range(6):
        for b in range(16):
            assert bases[c, b] == gstart[b] + chn[:c, b].sum()


# ---------------------------------------------------------------- counting

_COUNTING = rst.SortConfig(strategy=rst.Strategy.COUNTING)


def test_counting_sort_compact(rng):
    c = jnp.asarray(rng.integers(0, 256, 70_000, dtype=np.uint32))
    out = rst.sort(c, value_mask=0xFF, config=_COUNTING)
    assert np.array_equal(np.asarray(out), np.sort(np.asarray(c)))


def test_sort_word_counting_masked(rng):
    mask = 0x0F0F0000
    w = jnp.asarray(rng.integers(0, 1 << 32, 50_000, dtype=np.uint32) & mask | np.uint32(0x13))
    out = rst.sort(w, value_mask=mask | 0x13, config=_COUNTING)
    assert np.array_equal(np.asarray(out), np.sort(np.asarray(w)))


# ---------------------------------------------------------------- bitmap

def test_bitmap_unique_sort(rng):
    # the `bitmap_sort_16.c` demo semantics: sorted uniques
    x = rng.integers(0, 1 << 16, size=5_000, dtype=np.uint16)
    values, count = bitmap_unique_sort(jnp.asarray(x))
    uniq = np.unique(x)
    assert int(count) == len(uniq)
    assert np.array_equal(np.asarray(values)[: len(uniq)], uniq)


def test_bitmap_unique_sort_u8():
    x = np.array([3, 1, 3, 200, 1, 0], np.uint8)
    values, count = bitmap_unique_sort(jnp.asarray(x), size=8, fill_value=255)
    assert int(count) == 4
    assert np.array_equal(np.asarray(values)[:4], [0, 1, 3, 200])


# ---------------------------------------------------------------- cross-engine

@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 10_000])
def test_engines_agree(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    words = (jnp.asarray(x),)
    p = (jnp.asarray(payload),)
    hw_w, hw_p = hw_engine.sort_words(words, p)
    lsd_w, lsd_p = lsd_engine.sort_words_lsd(words, p, radix_bits=8, chunk=512)
    assert np.array_equal(np.asarray(hw_w[0]), np.asarray(lsd_w[0]))
    assert np.array_equal(np.asarray(hw_p[0]), np.asarray(lsd_p[0]))
    # and both equal the numpy stable oracle
    order = np.argsort(x, kind="stable")
    assert np.array_equal(np.asarray(hw_w[0]), x[order])
    assert np.array_equal(np.asarray(hw_p[0]), payload[order])


def test_two_word_lsd(rng):
    n = 5_000
    hi = rng.integers(0, 4, size=n, dtype=np.uint32)  # few distinct: exercises skip
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    words = (jnp.asarray(hi), jnp.asarray(lo))
    (shi, slo), _ = lsd_engine.sort_words_lsd(words, (), radix_bits=8, chunk=512)
    k = (hi.astype(np.uint64) << 32) | lo
    ks = np.sort(k)
    assert np.array_equal(np.asarray(shi), (ks >> 32).astype(np.uint32))
    assert np.array_equal(np.asarray(slo), ks.astype(np.uint32))


def test_presort_guard_identity(rng):
    x = jnp.arange(1000, dtype=jnp.uint32)
    (w,), _ = hw_engine.sort_words_presort_guard((x,))
    assert np.array_equal(np.asarray(w), np.asarray(x))
    y = jnp.asarray(rng.integers(0, 1 << 32, 1000, dtype=np.uint32))
    (w2,), _ = hw_engine.sort_words_presort_guard((y,))
    assert np.array_equal(np.asarray(w2), np.sort(np.asarray(y)))


def test_lsd_engine_checkified_no_oob(rng):
    # SURVEY §5 race/sanitizer row: the valgrind-memcheck analog on device is
    # checkify's index checks — the LSD engine's stable scatter must never
    # write out of bounds, including on ragged (padded) inputs.
    import jax
    from jax.experimental import checkify
    from radix_sorting.ops import lsd_engine

    x = jnp.asarray(rng.integers(0, 1 << 32, size=10_000 + 137, dtype=np.uint32))

    def run(a):
        (sw,), _ = lsd_engine.sort_words_lsd((a,), (), radix_bits=8, chunk=2048)
        return sw

    checked = checkify.checkify(run, errors=checkify.index_checks)
    err, out = jax.jit(checked)(x)
    err.throw()  # raises if any indexed write was out of bounds
    assert np.array_equal(np.asarray(out), np.sort(np.asarray(x)))
