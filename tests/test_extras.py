"""lexsort / unique_sorted tests vs numpy oracles, plus 64-bit pair sorts."""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.extras import lexsort, unique_sorted


def test_lexsort_two_keys(rng):
    a = rng.integers(0, 16, size=10_000, dtype=np.uint32)   # secondary
    b = rng.integers(0, 16, size=10_000, dtype=np.int32)    # primary (last)
    perm = np.asarray(lexsort([jnp.asarray(a), jnp.asarray(b)]))
    assert np.array_equal(perm, np.lexsort((a, b)).astype(np.uint32))


def test_lexsort_mixed_dtypes(rng):
    a = rng.standard_normal(5_000).astype(np.float32)
    b = rng.integers(0, 4, size=5_000, dtype=np.uint8)
    perm = np.asarray(lexsort([jnp.asarray(a), jnp.asarray(b)]))
    assert np.array_equal(perm, np.lexsort((a, b)).astype(np.uint32))


def test_lexsort_u64_key(rng):
    a = rng.integers(0, 1 << 64, size=5_000, dtype=np.uint64)
    perm = np.asarray(lexsort([a]))
    assert np.array_equal(perm, np.argsort(a, kind="stable").astype(np.uint32))


def test_unique_sorted(rng):
    x = rng.integers(0, 500, size=20_000, dtype=np.uint32)
    values, count = unique_sorted(jnp.asarray(x))
    uq = np.unique(x)
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values)[: len(uq)], uq)


def test_unique_sorted_floats(rng):
    x = np.repeat(rng.standard_normal(100).astype(np.float32), 7)
    rng.shuffle(x)
    values, count = unique_sorted(jnp.asarray(x), size=256)
    uq = np.unique(x)
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values)[: len(uq)], uq)


def test_sort_pairs_u64_keys(rng):
    # 64-bit keys with payload: two-word stable pair sort (numpy u64 input
    # works without enabling x64 — keys split into hi/lo planes host-side)
    k = rng.integers(0, 1 << 64, size=8_000, dtype=np.uint64)
    v = rng.integers(0, 1 << 32, size=8_000, dtype=np.uint32)
    sk, sv = rst.sort_pairs(k, jnp.asarray(v))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(sk, dtype=np.uint64), k[order])
    assert np.array_equal(np.asarray(sv), v[order])


def test_unique_sorted_narrow_unsigned_route(rng):
    # u8/u16 route through the presence-histogram path (no sort)
    for dt, hi in ((np.uint8, 256), (np.uint16, 1 << 16)):
        x = rng.integers(0, hi, size=30_000).astype(dt)
        values, count = unique_sorted(jnp.asarray(x))
        uq = np.unique(x)
        assert int(count) == len(uq)
        assert np.array_equal(np.asarray(values)[: len(uq)], uq)
    # descending still takes the generic sorted path
    x = rng.integers(0, 200, size=5_000).astype(np.uint8)
    import radix_sorting as rst
    values, count = unique_sorted(jnp.asarray(x),
                                  config=rst.SortConfig(descending=True))
    uq = np.unique(x)[::-1]
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values)[: len(uq)], uq)


def test_stable_partition(rng):
    from radix_sorting.extras import stable_partition
    n = 5_000
    pred = rng.integers(0, 2, size=n).astype(bool)
    vals = {"a": jnp.asarray(rng.integers(0, 1 << 32, size=n, dtype=np.uint32)),
            "b": jnp.asarray(rng.standard_normal(n).astype(np.float32))}
    out, num_false = stable_partition(jnp.asarray(pred), vals)
    order = np.argsort(pred, kind="stable")  # False first, stable
    assert int(num_false) == int((~pred).sum())
    assert np.array_equal(np.asarray(out["a"]), np.asarray(vals["a"])[order])
    assert np.array_equal(np.asarray(out["b"]), np.asarray(vals["b"])[order])
    with pytest.raises(TypeError):
        stable_partition(jnp.zeros(4, jnp.uint32), vals)


def test_value_counts(rng):
    from radix_sorting.extras import value_counts
    x = rng.integers(0, 50, size=10_000, dtype=np.int32)
    vals, counts, k = value_counts(jnp.asarray(x))
    uq, cnt = np.unique(x, return_counts=True)
    assert int(k) == len(uq)
    assert np.array_equal(np.asarray(vals)[: len(uq)], uq)
    assert np.array_equal(np.asarray(counts)[: len(uq)], cnt)
    assert int(np.asarray(counts)[len(uq):].sum()) == 0
    # floats with duplicates, sized output
    xf = np.repeat(rng.standard_normal(20).astype(np.float32), 13)
    rng.shuffle(xf)
    vals, counts, k = value_counts(jnp.asarray(xf), size=64)
    uq, cnt = np.unique(xf, return_counts=True)
    assert int(k) == len(uq)
    assert np.array_equal(np.asarray(vals)[: len(uq)], uq)
    assert np.array_equal(np.asarray(counts)[: len(uq)], cnt)


def test_value_counts_u64_no_truncation(rng):
    # regression: jnp.asarray of the numpy-u64 sort result truncated to 32 bits
    from radix_sorting.extras import unique_sorted, value_counts
    x = np.array([1, (1 << 40) + 1, (1 << 40) + 1, 7], np.uint64)
    vals, counts, k = value_counts(x)
    uq, cnt = np.unique(x, return_counts=True)
    assert int(k) == len(uq)
    assert np.array_equal(np.asarray(vals, dtype=np.uint64)[: len(uq)], uq)
    assert np.array_equal(np.asarray(counts)[: len(uq)], cnt)
    values, count = unique_sorted(x)
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values, dtype=np.uint64)[: len(uq)], uq)


def test_unique_sorted_rejects_2d():
    import radix_sorting as rst
    with pytest.raises(ValueError, match="1-D"):
        unique_sorted(jnp.zeros((3, 4), jnp.uint8))
    with pytest.raises(ValueError, match="1-D"):
        rst.value_counts(jnp.zeros((3, 4), jnp.uint32))


def test_empty_and_2d_contracts_64bit():
    from radix_sorting.extras import unique_sorted, value_counts
    e = np.array([], np.uint64)
    values, count = unique_sorted(e, size=4)
    assert values.dtype == np.uint64 and int(count) == 0
    vals, counts, k = value_counts(e, size=4)
    assert vals.dtype == np.uint64 and int(k) == 0
    with pytest.raises(ValueError, match="1-D"):
        value_counts(np.zeros((3, 4), np.uint64))


def test_top_k_batched(rng):
    x = rng.integers(0, 100, size=(8, 512), dtype=np.uint32)  # heavy ties
    vals, idx = rst.top_k_batched(jnp.asarray(x), 9)
    for r in range(8):
        order = np.argsort(-x[r].astype(np.int64), kind="stable")[:9]
        assert np.array_equal(np.asarray(vals)[r], x[r][order])
        assert np.array_equal(np.asarray(idx)[r], order.astype(np.uint32))
    # smallest-first along axis 0, float keys with specials
    xf = rng.standard_normal((256, 4)).astype(np.float32)
    xf[0, :] = np.nan
    vals, idx = rst.top_k_batched(jnp.asarray(xf), 3, axis=0, largest=False)
    for c in range(4):
        order = np.argsort(xf[:, c], kind="stable")[:3]  # nan sorts last
        assert np.array_equal(np.asarray(vals)[:, c], xf[order, c])
    # 64-bit two-plane keys: exact stable-descending oracle via the
    # complemented key (checks the index plane too — review finding)
    x64 = rng.integers(0, 1 << 64, size=(4, 64), dtype=np.uint64)
    vals, idx = rst.top_k_batched(x64, 5)
    for r in range(4):
        order = np.argsort(~x64[r], kind="stable")[:5]
        assert np.array_equal(np.asarray(vals, dtype=np.uint64)[r], x64[r][order])
        assert np.array_equal(np.asarray(idx)[r], order.astype(np.uint32))
    with pytest.raises(ValueError):
        rst.top_k_batched(jnp.asarray(x), 0)


def test_lexsort_narrow_keys_pack(rng):
    # four u8 columns pack into ONE u32 sort operand (round-3 word packing);
    # result must still be the exact stable numpy lexsort order
    cols = [rng.integers(0, 256, size=5003, dtype=np.uint8) for _ in range(4)]
    perm = np.asarray(lexsort([jnp.asarray(c) for c in cols]))
    assert np.array_equal(perm, np.lexsort(tuple(cols)).astype(np.uint32))
    # packing really happened: 4 u8 words -> 1 plane
    from radix_sorting.extras import _pack_narrow_words
    pairs = [(jnp.zeros(4, jnp.uint32), 8)] * 4
    packed, layout = _pack_narrow_words(pairs)
    assert len(packed) == 1
    assert [(g, s) for g, s, _ in layout] == [(0, 24), (0, 16), (0, 8), (0, 0)]


def test_lexsort_mixed_widths_pack(rng):
    # (i16 primary, u8, f16) with signed/float KDF fields packed across one
    # word boundary; numpy oracle built on the encoded composites
    n = 4001
    a8 = rng.integers(0, 256, size=n, dtype=np.uint8)      # least significant
    b16 = rng.integers(-3000, 3000, size=n, dtype=np.int16)
    # finite f16 bit patterns of both signs
    c16 = ((rng.integers(0, 0x7C00, size=n, dtype=np.uint16))
           | (rng.integers(0, 2, size=n, dtype=np.uint16) << np.uint16(15))
           ).view(np.float16)
    perm = np.asarray(lexsort([jnp.asarray(a8), jnp.asarray(b16),
                               jnp.asarray(c16)]))
    # oracle: stable sort by the same KDF composite (float16 total order)
    def f16_key(v):
        b = v.view(np.uint16).astype(np.uint32)
        sign = b >> 15
        return np.where(sign == 1, (~b) & 0xFFFF, b | 0x8000)
    comp = (f16_key(c16).astype(np.uint64) << np.uint64(24)) \
        | ((b16.view(np.uint16).astype(np.uint64) ^ np.uint64(0x8000)) << np.uint64(8)) \
        | a8.astype(np.uint64)
    assert np.array_equal(perm, np.argsort(comp, kind="stable").astype(np.uint32))


def test_lexsort_descending_packed(rng):
    n = 3003
    a = rng.integers(0, 256, size=n, dtype=np.uint8)
    b = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    from radix_sorting import SortConfig
    perm = np.asarray(lexsort([jnp.asarray(a), jnp.asarray(b)],
                              config=SortConfig(descending=True)))
    comp = (b.astype(np.uint64) << np.uint64(8)) | a.astype(np.uint64)
    # descending stable == ascending stable on complemented fields
    oracle = np.argsort(~comp & np.uint64((1 << 24) - 1), kind="stable")
    assert np.array_equal(perm, oracle.astype(np.uint32))


def test_lexsort_u64_with_narrow(rng):
    # 64-bit key contributes two full planes; the u8 secondary still packs
    n = 2005
    a8 = rng.integers(0, 256, size=n, dtype=np.uint8)
    b64 = rng.integers(0, 1 << 63, size=n).astype(np.uint64)
    perm = np.asarray(lexsort([a8, b64]))
    assert np.array_equal(perm, np.lexsort((a8, b64)).astype(np.uint32))


def test_segmented_sort_packed_narrow(rng):
    # u16 keys + u8 segment ids pack into one sort operand; oracle per segment
    from radix_sorting.extras import segmented_sort
    n = 6007
    seg = np.sort(rng.integers(0, 40, size=n, dtype=np.uint8))
    k = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    sk, sid = segmented_sort(jnp.asarray(k), jnp.asarray(seg))
    order = np.lexsort((k, seg))
    assert np.array_equal(np.asarray(sid), seg[order])
    assert np.array_equal(np.asarray(sk), k[order])


def test_segmented_sort_descending_keys_only(rng):
    # descending applies to KEYS only: the key field complements in place,
    # segment order stays ascending
    from radix_sorting import SortConfig
    from radix_sorting.extras import segmented_sort
    n = 5005
    seg = rng.integers(0, 12, size=n, dtype=np.uint8)
    k = rng.integers(-900, 900, size=n, dtype=np.int16)
    sk, sid = segmented_sort(jnp.asarray(k), jnp.asarray(seg),
                             config=SortConfig(descending=True))
    order = np.lexsort((-k.astype(np.int64), seg))
    assert np.array_equal(np.asarray(sid), seg[order])
    assert np.array_equal(np.asarray(sk), k[order])


def test_segmented_argsort_packed(rng):
    from radix_sorting import SortConfig
    from radix_sorting.extras import segmented_argsort
    n = 4009
    seg = rng.integers(0, 300, size=n, dtype=np.uint16)
    k = rng.integers(0, 256, size=n, dtype=np.uint8)
    perm = np.asarray(segmented_argsort(jnp.asarray(k), jnp.asarray(seg)))
    assert np.array_equal(perm, np.lexsort((k, seg)).astype(np.uint32))
    permd = np.asarray(segmented_argsort(jnp.asarray(k), jnp.asarray(seg),
                                         config=SortConfig(descending=True)))
    assert np.array_equal(
        permd, np.lexsort((255 - k, seg)).astype(np.uint32))


def test_segmented_sort_wide_dtypes_unpacked(rng):
    # f32 keys + u32 segments: no packing possible, route must still be exact
    from radix_sorting.extras import segmented_sort
    n = 3001
    seg = rng.integers(0, 1 << 20, size=n, dtype=np.uint32)
    k = rng.normal(size=n).astype(np.float32)
    sk, sid = segmented_sort(jnp.asarray(k), jnp.asarray(seg))
    order = np.lexsort((k, seg))
    assert np.array_equal(np.asarray(sid), seg[order])
    assert np.array_equal(np.asarray(sk), k[order])


# ---------------------------------------------------------------------------
# searchsorted


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_u32(rng, side):
    from radix_sorting.extras import searchsorted
    a = np.sort(rng.integers(0, 1000, size=20_000, dtype=np.uint32))
    v = rng.integers(0, 1000, size=5_000, dtype=np.uint32)
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v), side=side))
    assert np.array_equal(got, np.searchsorted(a, v, side=side))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_f32_specials(side):
    from radix_sorting.extras import searchsorted
    from oracles import kdf_key
    a = np.array([-np.inf, -2.0, -0.0, 0.0, 1.5, 1.5, np.inf, np.nan],
                 np.float32)
    v = np.array([np.nan, -np.nan, 1.5, 0.0, -0.0, 3.0, -np.inf], np.float32)
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v), side=side))
    expect = np.searchsorted(kdf_key(a), kdf_key(v), side=side)
    assert np.array_equal(got, expect)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_u64_two_word(rng, side):
    from radix_sorting.extras import searchsorted
    # duplicates + values straddling the 32-bit plane boundary
    base = rng.integers(0, 1 << 64, size=3_000, dtype=np.uint64)
    a = np.sort(np.concatenate([base, base[:500]]))
    v = np.concatenate([base[::3], rng.integers(0, 1 << 64, size=1_000,
                                                dtype=np.uint64)])
    got = np.asarray(searchsorted(a, v, side=side))
    assert np.array_equal(got, np.searchsorted(a, v, side=side))


def test_searchsorted_descending(rng):
    from radix_sorting.extras import searchsorted
    from oracles import kdf_key
    a = np.sort(rng.integers(0, 100, size=5_000, dtype=np.uint32))[::-1].copy()
    v = rng.integers(0, 100, size=1_000, dtype=np.uint32)
    cfg = rst.SortConfig(descending=True)
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v), config=cfg))
    ks = (~kdf_key(a)) & np.uint64(0xFFFFFFFF)
    kv = (~kdf_key(v)) & np.uint64(0xFFFFFFFF)
    assert np.array_equal(got, np.searchsorted(ks, kv, side="left"))


def test_searchsorted_edges(rng):
    from radix_sorting.extras import searchsorted
    a = np.array([5, 5, 5], np.uint32)
    assert np.asarray(searchsorted(jnp.asarray(a),
                                   jnp.asarray(np.array([4, 5, 6], np.uint32)),
                                   side="left")).tolist() == [0, 0, 3]
    assert np.asarray(searchsorted(jnp.asarray(a),
                                   jnp.asarray(np.array([4, 5, 6], np.uint32)),
                                   side="right")).tolist() == [0, 3, 3]
    # empty queries / empty array
    assert searchsorted(jnp.asarray(a), jnp.zeros((0,), jnp.uint32)).shape == (0,)
    out = searchsorted(jnp.zeros((0,), jnp.uint32),
                       jnp.asarray(np.array([1], np.uint32)))
    assert np.asarray(out).tolist() == [0]
    with pytest.raises(ValueError):
        searchsorted(jnp.asarray(a), jnp.asarray(a), side="middle")
    with pytest.raises(TypeError):
        searchsorted(jnp.asarray(a), jnp.asarray(a).astype(jnp.int32))


@pytest.mark.parametrize("method", ["auto", "scan", "scan_unrolled", "sort",
                                    "compare_all"])
def test_searchsorted_methods_agree(rng, method):
    from radix_sorting.extras import searchsorted
    a = np.sort(rng.integers(0, 500, size=4_000, dtype=np.uint32))
    v = rng.integers(0, 500, size=1_500, dtype=np.uint32)
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v),
                                  side="right", method=method))
    assert np.array_equal(got, np.searchsorted(a, v, side="right"))


def test_searchsorted_bad_method(rng):
    from radix_sorting.extras import searchsorted
    a = jnp.asarray(np.arange(4, dtype=np.uint32))
    with pytest.raises(ValueError):
        searchsorted(a, a, method="bisect")


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_sorter(rng, side):
    # numpy's sorter= (unsorted keys + a sorting permutation); the route
    # replaces the a[sorter] gather with one sort — element-wise
    # identical because any sorting permutation of a yields sort(a)
    from radix_sorting.extras import searchsorted
    a = rng.integers(0, 300, size=3_000, dtype=np.uint32)
    v = rng.integers(0, 300, size=900, dtype=np.uint32)
    sorter = np.argsort(a, kind="stable")
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v),
                                  side=side, sorter=jnp.asarray(sorter)))
    assert np.array_equal(got, np.searchsorted(a, v, side=side,
                                               sorter=sorter))


def test_searchsorted_sorter_u64_and_floats(rng):
    from radix_sorting.extras import searchsorted
    a64 = rng.integers(0, 1 << 63, size=2_000).astype(np.uint64)
    v64 = rng.integers(0, 1 << 63, size=500).astype(np.uint64)
    s64 = np.argsort(a64, kind="stable")
    got = np.asarray(searchsorted(a64, v64, sorter=s64))
    assert np.array_equal(got, np.searchsorted(a64, v64, sorter=s64))
    af = rng.normal(size=1_000).astype(np.float32)
    vf = rng.normal(size=300).astype(np.float32)
    sf = np.argsort(af, kind="stable")
    got = np.asarray(searchsorted(af, vf, side="right", sorter=sf))
    assert np.array_equal(got, np.searchsorted(af, vf, side="right",
                                               sorter=sf))


def test_searchsorted_sorter_validation(rng):
    from radix_sorting.extras import searchsorted
    a = jnp.asarray(np.arange(8, dtype=np.uint32))
    with pytest.raises(TypeError):
        searchsorted(a, a, sorter=jnp.zeros((8,), jnp.float32))
    with pytest.raises(ValueError):
        searchsorted(a, a, sorter=jnp.zeros((4,), jnp.int32))


@pytest.mark.parametrize("dtype", ["int4", "uint4"])
def test_unique_sorted_sub_byte(rng, dtype):
    # regression (round-3 review): a jnp sub-byte array's uint8 view is the
    # PACKED nibble buffer, so boundary detection ran in packed index space
    from radix_sorting.extras import value_counts
    d = jnp.dtype(dtype)
    lo = -8 if dtype == "int4" else 0
    raw = rng.integers(lo, lo + 16, size=5_000, dtype=np.int8)
    x = jnp.asarray(raw).astype(d)
    vals, count = unique_sorted(x, size=16)
    exp = np.unique(raw)
    assert int(count) == exp.size
    assert np.array_equal(np.asarray(vals.astype(jnp.int32))[: exp.size], exp)
    v, c, k = value_counts(x, size=16)
    assert int(k) == exp.size
    assert np.array_equal(np.asarray(v.astype(jnp.int32))[: exp.size], exp)
    assert np.array_equal(np.asarray(c)[: exp.size],
                          np.unique(raw, return_counts=True)[1])


# ---------------------------------------------------------------------------
# bincount


def test_bincount_vs_numpy(rng):
    from radix_sorting.extras import bincount
    for x, length in [
        (rng.integers(0, 256, size=30_000, dtype=np.uint8), None),
        (rng.integers(0, 1 << 16, size=30_000, dtype=np.uint16), None),
        (rng.integers(0, 1000, size=30_000, dtype=np.int32), 1000),
        (rng.integers(0, 3, size=7, dtype=np.uint32), 5),  # trailing empty bins
    ]:
        want_len = length or (1 << (8 * x.dtype.itemsize))
        got = np.asarray(bincount(jnp.asarray(x), length=length))
        assert got.dtype == np.int32
        assert np.array_equal(got, np.bincount(x, minlength=want_len))


def test_bincount_out_of_range_drops_not_aliases(rng):
    # a histogram that extracted the bin through a digit MASK would alias
    # value mod bins into a real bin (762 -> 250 at 256 bins); numpy
    # semantics = dropped
    from radix_sorting.extras import bincount
    x = np.array([5, 250 + 2 * 256, 3, 5], dtype=np.uint32)
    got = np.asarray(bincount(jnp.asarray(x), length=251))
    assert np.array_equal(got, np.bincount(np.array([5, 3, 5]), minlength=251))
    # power-of-two length: value == length must not wrap into bin 0
    y = np.array([0, 256, 1, 511, 7], dtype=np.uint32)
    got2 = np.asarray(bincount(jnp.asarray(y), length=256))
    assert np.array_equal(got2,
                          np.bincount(np.array([0, 1, 7]), minlength=256))
    # negatives drop through the u32 wrap on the same path
    z = np.array([-1, 2, 2, -5], dtype=np.int32)
    got3 = np.asarray(bincount(jnp.asarray(z), length=8))
    assert np.array_equal(got3, np.bincount(np.array([2, 2]), minlength=8))


@pytest.mark.parametrize("bad", [1000, 1024, 0x7FFFFFFF, 0xFFFFFFFF])
def test_bincount_far_out_of_range_dropped(bad):
    from radix_sorting.extras import bincount
    x = np.array([3, bad, 999, bad, 0], dtype=np.uint32)
    got = np.asarray(bincount(jnp.asarray(x), length=1000))
    assert np.array_equal(got, np.bincount(np.array([3, 999, 0]),
                                           minlength=1000))


@pytest.mark.parametrize("vdtype", ["int32", "float32", None])
def test_dense_group_reduce_drops_out_of_range(rng, vdtype):
    # keys >= groups (including the u32 maximum) are dropped by the dense
    # tier, never aliased into a live group
    from radix_sorting.extras import group_reduce, value_counts
    G = 64
    k = rng.integers(0, G, size=5000, dtype=np.uint32)
    k[::7] = G
    k[::11] = 0xFFFFFFFF
    live = k < G
    if vdtype is None:
        uk, cnt, ng = value_counts(jnp.asarray(k), groups=G)
        want = np.bincount(k[live], minlength=G)
        m = int(ng)
        assert np.array_equal(np.asarray(cnt)[:m], want[want > 0])
        return
    v = rng.integers(-1000, 1000, size=5000).astype(vdtype)
    uk, tot, ng = group_reduce(jnp.asarray(k), jnp.asarray(v), reduce="sum",
                               groups=G)
    want = np.zeros(G, np.float64)
    np.add.at(want, k[live], v[live].astype(np.float64))
    present = np.flatnonzero(np.bincount(k[live], minlength=G))
    m = int(ng)
    assert m == len(present)
    assert np.array_equal(np.asarray(uk)[:m], present)
    assert np.array_equal(np.asarray(tot)[:m].astype(np.float64),
                          want[present])


def test_bincount_validate_and_errors(rng):
    from radix_sorting.extras import bincount
    with pytest.raises(ValueError):
        bincount(jnp.asarray(np.array([-1, 2], np.int32)), length=10,
                 validate=True)
    with pytest.raises(ValueError):
        bincount(jnp.asarray(np.array([11], np.uint32)), length=10,
                 validate=True)
    with pytest.raises(ValueError):  # length required for wide dtypes
        bincount(jnp.asarray(np.array([1], np.uint32)))
    with pytest.raises(TypeError):
        bincount(jnp.asarray(np.array([1.0], np.float32)), length=4)
    with pytest.raises(ValueError):
        bincount(jnp.asarray(np.zeros((2, 2), np.uint8)))
    # empty input, bool default length, uint4 domain default
    assert int(np.asarray(bincount(jnp.zeros((0,), jnp.uint8))).sum()) == 0
    assert np.asarray(
        bincount(jnp.asarray(np.array([True, False, True])))).tolist() == [1, 2]
    x4 = jnp.asarray(rng.integers(0, 16, size=500,
                                  dtype=np.int8)).astype(jnp.uint4)
    got = np.asarray(bincount(x4))
    assert np.array_equal(
        got, np.bincount(np.asarray(x4.astype(jnp.int32)), minlength=16))


def test_lexsort_int4_packing(rng):
    # int4 fields must pack at their LOGICAL 4-bit width (kdf.key_bits);
    # mixed with a u16 and two u8 columns all four keys fit ONE u32 operand
    a = rng.integers(-8, 8, size=8_000, dtype=np.int8)
    b = rng.integers(0, 1 << 16, size=8_000, dtype=np.uint16)
    c = rng.integers(0, 256, size=8_000, dtype=np.uint8)
    ja = jnp.asarray(a).astype(jnp.int4)
    from radix_sorting.extras import _pack_narrow_words, _word_pairs
    from radix_sorting.api import _as_words
    pairs = []
    for k in [ja, jnp.asarray(b), jnp.asarray(c), ja]:
        w, dt = _as_words(k, False)
        pairs += _word_pairs(w, dt)
    packed, _ = _pack_narrow_words(pairs)
    assert len(packed) == 1  # 4 + 16 + 8 + 4 = 32 bits: one operand
    perm = np.asarray(lexsort([ja, jnp.asarray(b), jnp.asarray(c)]))
    assert np.array_equal(perm, np.lexsort((a, b, c)).astype(np.uint32))


# ------------------------------------------------------------- sort_complex

def test_sort_complex_vs_numpy(rng):
    from radix_sorting.extras import sort_complex
    # heavy real-part ties so the imag tiebreak is load-bearing
    re = rng.integers(-50, 50, size=20_000).astype(np.float32)
    im = rng.standard_normal(20_000).astype(np.float32)
    x = (re + 1j * im).astype(np.complex64)
    got = sort_complex(x)
    assert got.dtype == np.complex64
    assert np.array_equal(got, np.sort_complex(x).astype(np.complex64))


def test_sort_complex_128_and_promotion(rng):
    from radix_sorting.extras import sort_complex
    re = rng.integers(-9, 9, size=5_000).astype(np.float64) * 1e300
    im = rng.standard_normal(5_000) * 1e-300
    x = re + 1j * im
    got = sort_complex(x)
    assert got.dtype == np.complex128
    assert np.array_equal(got, np.sort_complex(x))
    # real input promotes like np.sort_complex
    r = rng.standard_normal(1_000).astype(np.float64)
    assert np.array_equal(sort_complex(r), np.sort_complex(r))
    ri = rng.integers(0, 1000, size=1_000).astype(np.int32)
    got_i = sort_complex(ri)
    assert got_i.dtype == np.complex128
    assert np.array_equal(got_i, np.sort_complex(ri))
    # numpy's exact promotion rule: 'bhBH' -> complex64, all else -> complex128
    rf = rng.standard_normal(512).astype(np.float32)
    got_f = sort_complex(rf)
    assert got_f.dtype == np.sort_complex(rf).dtype == np.complex128
    assert np.array_equal(got_f, np.sort_complex(rf))
    rh = rng.integers(-300, 300, size=512).astype(np.int16)
    got_h = sort_complex(rh)
    assert got_h.dtype == np.sort_complex(rh).dtype == np.complex64
    assert np.array_equal(got_h, np.sort_complex(rh))


def test_sort_complex_specials_and_errors(rng):
    from radix_sorting.extras import sort_complex
    from radix_sorting import SortConfig
    x = np.array([1 + 1j, 1 - 1j, -np.inf + 0j, np.inf + 0j,
                  0 + 0j, -1 + 5j, 1 + 0j], np.complex64)
    got = sort_complex(x)
    assert np.array_equal(got, np.sort_complex(x).astype(np.complex64))
    # descending = exact reverse for distinct finite values
    gd = sort_complex(x, config=SortConfig(descending=True))
    assert np.array_equal(gd, got[::-1])
    assert sort_complex(np.zeros(0, np.complex64)).shape == (0,)
    with pytest.raises(TypeError, match="NUMPY"):
        sort_complex(jnp.zeros((4,), jnp.float32))
    with pytest.raises(ValueError, match="1-D"):
        sort_complex(np.zeros((2, 2), np.complex64))


def test_searchsorted_auto_crossover(rng, monkeypatch):
    """auto is a binary search per query ('scan') at every query count,
    with results identical to numpy."""
    from radix_sorting.extras import searchsorted
    a = np.sort(rng.integers(0, 1 << 32, size=4096, dtype=np.uint32))
    chosen = []
    real = jnp.searchsorted

    def spy(sk, qk, side="left", method=None, **kw):
        chosen.append(method)
        return real(sk, qk, side=side, method=method, **kw)

    monkeypatch.setattr(jnp, "searchsorted", spy)
    for q in (64, 256, 8192):
        v = rng.integers(0, 1 << 32, size=q, dtype=np.uint32)
        got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v)))
        assert np.array_equal(got, np.searchsorted(a, v)) and chosen[-1] == "scan"


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_chunked_queries(rng, side, monkeypatch):
    """Query batches past the block size run as lax.map chunks (the q=40M
    worker-fault guard) — identical results on every path."""
    import radix_sorting.extras as ex
    monkeypatch.setattr(ex, "_SEARCHSORTED_QBLOCK", 1024)
    a = np.sort(rng.integers(0, 1 << 20, size=5_000, dtype=np.uint32))
    v = rng.integers(0, 1 << 20, size=4_321, dtype=np.uint32)  # 5 blocks
    want = np.searchsorted(a, v, side=side)
    for method in ("scan", "sort"):
        got = np.asarray(ex.searchsorted(jnp.asarray(a), jnp.asarray(v),
                                         side=side, method=method))
        assert np.array_equal(got, want), method
    # exact block multiple (no padding)
    v2 = v[:4096]
    got = np.asarray(ex.searchsorted(jnp.asarray(a), jnp.asarray(v2),
                                     side=side))
    assert np.array_equal(got, np.searchsorted(a, v2, side=side))
    # two-word (u64) tagged-union path, chunked
    a64 = np.sort(rng.integers(0, 1 << 60, size=3_000, dtype=np.uint64))
    v64 = rng.integers(0, 1 << 60, size=2_500, dtype=np.uint64)
    v64[:100] = a64[:100]  # exercise ties across the side semantics
    got = np.asarray(ex.searchsorted(a64, v64, side=side))
    assert np.array_equal(got, np.searchsorted(a64, v64, side=side))


def test_value_counts_dense_groups(rng):
    """groups promise: histogram + compaction, no sort — same contract as
    the sort-native route."""
    from radix_sorting.extras import value_counts
    k = rng.integers(0, 500, size=30_000, dtype=np.uint32)
    for desc in (False, True):
        cfg = rst.SortConfig(descending=desc)
        v_d, c_d, nu_d = value_counts(k, groups=512, config=cfg)
        m = int(nu_d)
        v_s, c_s, nu_s = value_counts(jnp.asarray(k), size=m, config=cfg)
        assert int(nu_s) == m
        assert v_d.shape == (512,)  # size defaults to min(n, groups)
        assert np.array_equal(np.asarray(v_d)[:m], np.asarray(v_s)[:m])
        assert np.array_equal(np.asarray(c_d)[:m], np.asarray(c_s)[:m])
        assert np.all(np.asarray(c_d)[m:] == 0)
    # promise violation drops; float keys are rejected
    kb = k.copy(); kb[0] = 1000
    v_d, c_d, nu_d = value_counts(kb, groups=512)
    assert int(np.asarray(c_d).sum()) == 30_000 - 1
    with pytest.raises(TypeError):
        value_counts(kb.astype(np.float32), groups=512)
