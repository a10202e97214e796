"""Histograms, PEXT/PDEP compaction and the COUNTING strategy vs numpy.

Histograms are scatter-adds (``ops.histogram.digit_histogram``); masked keys
compact/expand through ``ops.probes`` (PEXT/PDEP, which the 64-bit
plane-compaction route relies on); the COUNTING strategy sorts keys-only
under a static live-bit promise, through the public ``rst.sort``. Sizes are
chosen so that n is not a multiple of any power-of-two block.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.ops import histogram, hw_engine, probes

_COUNTING = rst.SortConfig(strategy=rst.Strategy.COUNTING, counting_max_bits=32)


def _counting(planes, masks, descending=False):
    """The COUNTING strategy on one u32 plane, or on a (hi, lo) pair of
    planes as numpy u64 keys; returns the sorted planes."""
    cfg = _COUNTING.replace(descending=descending)
    if len(planes) == 1:
        (x,), (m,) = planes, masks
        return (np.asarray(rst.sort(jnp.asarray(x), value_mask=m, config=cfg)),)
    hi, lo = planes
    keys = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    out = np.asarray(rst.sort(keys, value_mask=(masks[0] << 32) | masks[1],
                              config=cfg), dtype=np.uint64)
    return (out >> np.uint64(32)).astype(np.uint32), out.astype(np.uint32)


def _dense_sort(x, bins):
    (out,) = _counting((x,), (bins - 1,))
    return out


def _host_pext(x: np.ndarray, mask: int) -> np.ndarray:
    c = np.zeros_like(x)
    pos = 0
    for bit in range(32):
        if mask & (1 << bit):
            c |= ((x >> np.uint32(bit)) & 1).astype(np.uint32) << np.uint32(pos)
            pos += 1
    return c


@pytest.mark.parametrize("pass_index", [0, 3])
def test_digit_histogram_pass(rng, pass_index):
    x = rng.integers(0, 1 << 32, size=200_000, dtype=np.uint32)
    d = histogram.extract_digit((jnp.asarray(x),), pass_index, 8)
    h = np.asarray(histogram.digit_histogram(d, 256))
    assert np.array_equal(
        h, np.bincount((x >> (8 * pass_index)) & 0xFF, minlength=256))


@pytest.mark.parametrize("radix_bits", [4, 8, 11])
def test_multi_digit_histogram(rng, radix_bits):
    x = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint32)
    hs = np.asarray(histogram.multi_digit_histogram((jnp.asarray(x),),
                                                    radix_bits))
    num_passes = -(-32 // radix_bits)
    mask = (1 << radix_bits) - 1
    assert hs.shape == (num_passes, 1 << radix_bits)
    for p in range(num_passes):
        expect = np.bincount((x >> (radix_bits * p)) & mask,
                             minlength=1 << radix_bits)
        assert np.array_equal(hs[p], expect), p


def test_histogram_unaligned_n(rng):
    x = rng.integers(0, 1 << 32, size=65_536 + 777, dtype=np.uint32)
    h = np.asarray(histogram.digit_histogram(jnp.asarray(x & 0xFF), 256))
    assert np.array_equal(h, np.bincount(x & 0xFF, minlength=256))
    assert h.sum() == x.size and h.dtype == np.int32


@pytest.mark.parametrize("bins", [16, 256, 1024])
def test_counting_dense_domain(rng, bins):
    n = 150_000
    c = rng.integers(0, bins, size=n, dtype=np.uint32)
    out = _dense_sort(c, bins)
    assert out.dtype == np.uint32
    assert np.array_equal(out, np.sort(c))


def test_counting_single_value():
    # one bucket holds everything
    out = _dense_sort(np.ones(5000, np.uint32), 4)
    assert np.all(out == 1)


def test_compact_word_planes_pext(rng):
    # device PEXT compaction == host-compacted values, so its histogram is
    # the bincount of the host PEXT
    mask = 0xF0F00000
    x = (rng.integers(0, 1 << 32, size=200_000, dtype=np.uint32)
         & np.uint32(mask)).astype(np.uint32)
    c = probes.compact_word_planes((jnp.asarray(x),), (mask,))
    assert np.array_equal(np.asarray(c), _host_pext(x, mask))
    h = np.asarray(histogram.digit_histogram(c, 1 << 8))
    assert np.array_equal(h, np.bincount(_host_pext(x, mask), minlength=256))


def test_expand_word_planes_pdep(rng):
    # compaction is order-preserving under the mask promise: sorting the
    # compacted word and expanding it (PDEP + dead-bit restore) sorts x
    mask = 0x0000FF00
    dead = np.uint32(0x40000001)
    x = ((rng.integers(0, 256, size=150_000, dtype=np.uint32) << 8)
         | dead).astype(np.uint32)
    xj = jnp.asarray(x)
    c = probes.compact_word_planes((xj,), (mask,))
    (out,) = probes.expand_word_planes(jnp.sort(c), (xj,), (mask,))
    assert np.array_equal(np.asarray(out), np.sort(x))


def test_counting_end_to_end(rng):
    import radix_sorting as rst
    mask = 0xF0F00000
    x = (rng.integers(0, 1 << 32, size=100_000, dtype=np.uint32)
         & np.uint32(mask)).astype(np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(x), value_mask=mask))
    assert np.array_equal(out, np.sort(x))


def test_counting_two_plane_u64(rng):
    # live bits in BOTH planes of a 64-bit key, constant bits set in each
    mask_hi, mask_lo = 0x000000F0, 0xF0000000
    hi = (rng.integers(0, 1 << 32, size=120_000, dtype=np.uint32)
          & np.uint32(mask_hi)) | np.uint32(0x01000000)
    lo = (rng.integers(0, 1 << 32, size=120_000, dtype=np.uint32)
          & np.uint32(mask_lo)) | np.uint32(0x00000007)
    shi, slo = _counting((hi, lo), (mask_hi | 0x01000000, mask_lo | 7))
    full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    got = (np.asarray(shi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(slo).astype(np.uint64)
    assert np.array_equal(got, np.sort(full))


def test_counting_wide_domains(rng):
    for bins, n in ((1 << 11, 400_000), (1 << 13, 800_000)):
        x = rng.integers(0, bins, size=n, dtype=np.uint32)
        assert np.array_equal(_dense_sort(x, bins), np.sort(x)), (bins, n)


def test_counting_skewed_and_boundaries(rng):
    bins, n = 1 << 11, 600_000
    # heavy skew: half the mass in one bin, plus empty ranges
    x = np.concatenate([
        np.full(n // 2, 17, np.uint32),
        rng.integers(bins - 64, bins, size=n // 4, dtype=np.uint32),
        rng.integers(0, bins, size=n - n // 2 - n // 4, dtype=np.uint32),
    ])
    assert np.array_equal(_dense_sort(rng.permutation(x), bins), np.sort(x))


def test_counting_sparse_huge_domain(rng):
    # tiny n over a huge sparse domain: most bins empty, every key distinct
    bins, n = 1 << 16, 30_000
    x = (rng.permutation(bins)[:n] & 0xFFFF).astype(np.uint32)
    assert np.array_equal(_dense_sort(x, bins), np.sort(x))


def test_counting_wide_bins(rng):
    for bins in (1 << 12, 1 << 16, 1 << 17):
        x = rng.integers(0, bins, size=120_000, dtype=np.uint32)
        assert np.array_equal(_dense_sort(x, bins), np.sort(x)), bins


def test_counting_masked_12bit_dead_bits(rng):
    mask = 0xF0F0F000  # 12 live bits -> 4096 bins
    n = 500_000
    dead = np.uint32(0x01010041)
    x = ((rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mask))
         | dead)
    (out,) = _counting((x,), (mask | int(dead),))
    assert np.array_equal(out, np.sort(x))


def test_counting_two_plane_13bit(rng):
    mask_hi, mask_lo = 0x00000F00, 0xFF000001  # 4 + 9 = 13 live bits
    n = 800_000
    hi = (rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
          & np.uint32(mask_hi)) | np.uint32(0x10000000)
    lo = (rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
          & np.uint32(mask_lo)) | np.uint32(0x00000100)
    shi, slo = _counting((hi, lo), (mask_hi | 0x10000000, mask_lo | 0x100))
    comp = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    order = np.argsort(comp, kind="stable")
    assert np.array_equal(np.asarray(shi), hi[order])
    assert np.array_equal(np.asarray(slo), lo[order])


def test_counting_rejects_wide_domain():
    # 33 live bits: past the budget of one u32 operand
    with pytest.raises(ValueError, match="32"):
        _counting((np.zeros(8, np.uint32),) * 2, (0xFFFFFFFF, 0x1))


def test_counting_graph_is_one_sort():
    # the strategy is one library sort of the derived word: no histogram
    # (scatter) and, for a one-word key, no PEXT compaction in the program
    x = jnp.zeros((4096,), jnp.uint32)
    cfg = _COUNTING.replace(detect_presorted=False)
    jaxpr = jax.make_jaxpr(lambda w: rst.sort(w, value_mask=0xFF << 3,
                                              config=cfg))(x)
    sorts = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "sort"]
    assert len(sorts) == 1 and sorts[0].params["num_keys"] == 1
    assert all(e.primitive.name in ("sort", "bitcast_convert_type")
               for e in jaxpr.jaxpr.eqns), jaxpr


def test_counting_trailing_empty_bins(rng):
    # mass only in the low bins of a wider domain
    bins, n = 1 << 11, 200_000
    x = rng.integers(0, 256, size=n, dtype=np.uint32)
    assert np.array_equal(_dense_sort(x, bins), np.sort(x))


@pytest.mark.parametrize("n", [1, 65_536 + 777, 1_500_001])
def test_counting_ragged_n(rng, n):
    bins = 1 << 11
    x = rng.integers(0, bins, size=n, dtype=np.uint32)
    assert np.array_equal(_dense_sort(x, bins), np.sort(x))


def test_sort_words_counting_masked_desc(rng):
    mask = 0x1FFF << 7  # 13 contiguous live bits at position 7
    n = 700_000
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mask)
    (out,) = _counting((x,), (mask,))
    assert np.array_equal(out, np.sort(x))
    (outd,) = _counting((x,), (mask,), descending=True)
    assert np.array_equal(outd, np.sort(x)[::-1])


# ---------------------------------------------------------------------------
# counting-path edge cases across the whole bin range, through the public API


@pytest.mark.parametrize("nbits", [1, 2, 4, 8, 11, 16, 17])
def test_counting_bins_sweep(rng, nbits):
    # 2 .. 2^17 bins; n = 100_003 is not a multiple of any block
    mask = ((1 << nbits) - 1) << 5
    x = rng.integers(0, 1 << 32, size=100_003, dtype=np.uint32) & np.uint32(mask)
    (out,) = _counting((x,), (mask,))
    assert np.array_equal(out, np.sort(x))


@pytest.mark.parametrize("nbits", [2, 9, 16])
def test_counting_bins_sweep_descending(rng, nbits):
    mask = ((1 << nbits) - 1) << 11
    x = rng.integers(0, 1 << 32, size=50_001, dtype=np.uint32) & np.uint32(mask)
    (out,) = _counting((x,), (mask,), descending=True)
    assert np.array_equal(out, np.sort(x)[::-1])


@pytest.mark.parametrize("masks", [(0x1, 0x80000000), (0xF000, 0x0F0F),
                                   (0x3, 0xFFFF0000)])
def test_counting_two_plane_masks(rng, masks):
    mh, ml = masks
    n = 30_011
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(mh)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(ml)
    shi, slo = _counting((hi, lo), (mh, ml))
    comp = np.sort(hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64))
    assert np.array_equal(np.asarray(shi), (comp >> np.uint64(32)).astype(np.uint32))
    assert np.array_equal(np.asarray(slo), comp.astype(np.uint32))


def test_counting_all_equal_and_two_values():
    x = np.full(10_007, 0xF0F00000, np.uint32)
    (out,) = _counting((x,), (0xF0F00000,))
    assert np.array_equal(out, x)
    y = np.where(np.arange(10_007) % 3 == 0, 0xF0000000, 0x00F00000)
    y = y.astype(np.uint32)
    (out,) = _counting((y,), (0xF0F00000,))
    assert np.array_equal(out, np.sort(y))


@pytest.mark.parametrize("guard", [False, True])
def test_two_word_probe_both_branches(rng, guard):
    # constant hi plane sorts lo as one operand; a varying hi plane takes
    # the two-key sort; both exact (the probe decides on device)
    n = 60_001
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    for hi in (np.full(n, 7, np.uint32),
               rng.integers(0, 3, size=n, dtype=np.uint32)):
        shi, slo = hw_engine.sort_words2_range_probe(
            jnp.asarray(hi), jnp.asarray(lo), guard=guard)
        comp = np.sort(hi.astype(np.uint64) << np.uint64(32)
                       | lo.astype(np.uint64))
        assert np.array_equal(np.asarray(shi),
                              (comp >> np.uint64(32)).astype(np.uint32))
        assert np.array_equal(np.asarray(slo), comp.astype(np.uint32))
