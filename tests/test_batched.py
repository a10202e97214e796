"""Batched (multi-row), segmented, and top-k sorts vs numpy oracles.

The reference is strictly 1-D; these cover the framework's batched extensions
(one fused device sort over a whole batch — ROADMAP "batched sort API" item).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.extras import segmented_argsort, segmented_sort, top_k


@pytest.mark.parametrize("dtype", [np.uint32, np.int16, np.float32])
def test_sort_batched_rows(rng, dtype):
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal((17, 513)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, size=(17, 513)).astype(dtype)
    out = np.asarray(rst.sort_batched(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x, axis=-1))


def test_sort_batched_axis0(rng):
    x = rng.integers(0, 1 << 32, size=(300, 9), dtype=np.uint32)
    out = np.asarray(rst.sort_batched(jnp.asarray(x), axis=0))
    assert np.array_equal(out, np.sort(x, axis=0))


def test_sort_batched_descending(rng):
    x = rng.integers(-50, 50, size=(8, 100), dtype=np.int32)
    cfg = rst.SortConfig(descending=True)
    out = np.asarray(rst.sort_batched(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, -np.sort(-x, axis=-1))


def test_sort_batched_u64_numpy(rng):
    # 64-bit numpy keys, batched, without x64: hi/lo planes split host-side
    x = rng.integers(0, 1 << 64, size=(5, 64), dtype=np.uint64)
    out = np.asarray(rst.sort_batched(x), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x, axis=-1))


def test_sort_batched_3d(rng):
    x = rng.standard_normal((3, 40, 5)).astype(np.float32)
    out = np.asarray(rst.sort_batched(jnp.asarray(x), axis=1))
    assert np.array_equal(out, np.sort(x, axis=1))


def test_argsort_batched_stable(rng):
    # few distinct values => ties; stable means equal keys keep input order
    x = rng.integers(0, 7, size=(11, 400), dtype=np.uint8)
    perm = np.asarray(rst.argsort_batched(jnp.asarray(x)))
    assert np.array_equal(perm, np.argsort(x, axis=-1, kind="stable"))


def test_argsort_batched_axis0(rng):
    x = rng.standard_normal((123, 6)).astype(np.float32)
    perm = np.asarray(rst.argsort_batched(jnp.asarray(x), axis=0))
    assert np.array_equal(perm, np.argsort(x, axis=0, kind="stable"))


def test_sort_pairs_batched(rng):
    k = rng.integers(0, 50, size=(9, 257), dtype=np.int32)
    v1 = rng.integers(0, 1 << 32, size=(9, 257), dtype=np.uint32)
    v2 = rng.standard_normal((9, 257)).astype(np.float32)
    sk, (s1, s2) = rst.sort_pairs_batched(jnp.asarray(k), (jnp.asarray(v1), jnp.asarray(v2)))
    order = np.argsort(k, axis=-1, kind="stable")
    assert np.array_equal(np.asarray(sk), np.take_along_axis(k, order, -1))
    assert np.array_equal(np.asarray(s1), np.take_along_axis(v1, order, -1))
    assert np.array_equal(np.asarray(s2), np.take_along_axis(v2, order, -1))


def test_sort_batched_1d_degenerates_to_sort(rng):
    x = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    assert np.array_equal(np.asarray(rst.sort_batched(jnp.asarray(x))), np.sort(x))


# ---------------------------------------------------------------------------
# segmented


def test_segmented_sort_grouped_layout(rng):
    # contiguous ascending segments: layout preserved, rows sorted in place
    sizes = [0, 17, 1, 300, 45]
    seg = np.repeat(np.arange(len(sizes), dtype=np.uint32), sizes)
    keys = rng.standard_normal(seg.shape[0]).astype(np.float32)
    sk, sid = segmented_sort(jnp.asarray(keys), jnp.asarray(seg))
    assert np.array_equal(np.asarray(sid), seg)
    out = np.asarray(sk)
    off = 0
    for s in sizes:
        assert np.array_equal(out[off:off + s], np.sort(keys[off:off + s]))
        off += s


def test_segmented_sort_scattered_ids(rng):
    seg = rng.integers(0, 5, size=2_000, dtype=np.uint16)
    keys = rng.integers(-100, 100, size=2_000, dtype=np.int32)
    sk, sid = segmented_sort(jnp.asarray(keys), jnp.asarray(seg))
    order = np.lexsort((keys, seg))
    assert np.array_equal(np.asarray(sid), seg[order])
    assert np.array_equal(np.asarray(sk), keys[order])


def test_segmented_sort_descending_keys(rng):
    seg = rng.integers(0, 4, size=500, dtype=np.uint8)
    keys = rng.integers(0, 1000, size=500, dtype=np.uint32)
    cfg = rst.SortConfig(descending=True)
    sk, sid = segmented_sort(jnp.asarray(keys), jnp.asarray(seg), config=cfg)
    order = np.lexsort((-keys.astype(np.int64), seg))
    assert np.array_equal(np.asarray(sid), seg[order])
    assert np.array_equal(np.asarray(sk), keys[order])


def test_segmented_argsort_stable(rng):
    seg = rng.integers(0, 6, size=3_000, dtype=np.uint32)
    keys = rng.integers(0, 9, size=3_000, dtype=np.uint8)  # heavy ties
    perm = np.asarray(segmented_argsort(jnp.asarray(keys), jnp.asarray(seg)))
    assert np.array_equal(perm, np.lexsort((np.arange(3_000), keys, seg)).astype(np.uint32))


# ---------------------------------------------------------------------------
# top_k


def test_top_k_largest_stable(rng):
    x = rng.integers(0, 40, size=5_000, dtype=np.int32)  # ties certain
    v, i = top_k(jnp.asarray(x), 100)
    # oracle: stable descending = argsort of (-x) with stable kind
    order = np.argsort(-x.astype(np.int64), kind="stable")[:100]
    assert np.array_equal(np.asarray(i), order.astype(np.uint32))
    assert np.array_equal(np.asarray(v), x[order])


def test_top_k_smallest_floats(rng):
    x = rng.standard_normal(2_000).astype(np.float32)
    v, i = top_k(jnp.asarray(x), 7, largest=False)
    order = np.argsort(x, kind="stable")[:7]
    assert np.array_equal(np.asarray(i), order.astype(np.uint32))
    assert np.array_equal(np.asarray(v), x[order])


def test_top_k_u64(rng):
    x = rng.integers(0, 1 << 64, size=1_000, dtype=np.uint64)
    v, i = top_k(x, 13)
    # exact stable-DESCENDING oracle: sort by complemented key (order
    # reversal for unsigned), stable ties -> lower index first. (A reversed
    # stable-ascending argsort reverses tie order and could not check the
    # index plane — review finding; the two-plane index plane was untested.)
    order = np.argsort(~x, kind="stable")[:13]
    assert np.array_equal(np.asarray(i), order.astype(np.uint32))
    assert np.array_equal(np.asarray(v, dtype=np.uint64), x[order])


def test_top_k_bounds(rng):
    x = jnp.arange(10, dtype=jnp.uint32)
    with pytest.raises(ValueError):
        top_k(x, 0)
    with pytest.raises(ValueError):
        top_k(x, 11)


# ---------------------------------------------------------------------------
# merge_sorted


def test_merge_sorted(rng):
    from radix_sorting.extras import merge_sorted
    a = np.sort(rng.integers(0, 1000, size=700, dtype=np.uint32))
    b = np.sort(rng.integers(0, 1000, size=1300, dtype=np.uint32))
    out = np.asarray(merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(out, np.sort(np.concatenate([a, b])))
    with pytest.raises(TypeError):
        merge_sorted(jnp.asarray(a), jnp.asarray(b).astype(jnp.int32))


def test_merge_sorted_floats_descending(rng):
    from radix_sorting.extras import merge_sorted
    import radix_sorting as rst
    cfg = rst.SortConfig(descending=True)
    a = np.sort(rng.standard_normal(500).astype(np.float32))[::-1].copy()
    b = np.sort(rng.standard_normal(400).astype(np.float32))[::-1].copy()
    out = np.asarray(merge_sorted(jnp.asarray(a), jnp.asarray(b), config=cfg))
    assert np.array_equal(out, np.sort(np.concatenate([a, b]))[::-1])


# ---------------------------------------------------------------------------
# transform compatibility: public ops under jit and vmap


def test_sort_under_jit_and_vmap(rng):
    import jax
    import radix_sorting as rst
    x = rng.integers(0, 1 << 32, size=(6, 500), dtype=np.uint32)
    cfg = rst.SortConfig(detect_presorted=False)
    out = np.asarray(jax.vmap(lambda r: rst.sort(r, config=cfg))(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x, axis=-1))
    out2 = np.asarray(jax.jit(lambda r: rst.sort(r, config=cfg))(jnp.asarray(x[0])))
    assert np.array_equal(out2, np.sort(x[0]))


def test_argsort_under_vmap(rng):
    import jax
    import radix_sorting as rst
    x = rng.integers(0, 50, size=(4, 300), dtype=np.int32)
    cfg = rst.SortConfig(detect_presorted=False)
    perm = np.asarray(jax.vmap(lambda r: rst.argsort(r, config=cfg))(jnp.asarray(x)))
    assert np.array_equal(perm, np.argsort(x, axis=-1, kind="stable"))


def test_nth_element(rng):
    from radix_sorting.extras import nth_element
    import radix_sorting as rst
    n = 10_000
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(nth_element(jnp.asarray(x), [0, n // 2, n - 1]))
    assert np.array_equal(got, np.sort(x)[[0, n // 2, n - 1]])
    cfg = rst.SortConfig(descending=True)
    got = np.asarray(nth_element(jnp.asarray(x), [0], config=cfg))
    assert got[0] == np.max(x)
    x64 = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)
    got = np.asarray(nth_element(x64, [7]), dtype=np.uint64)
    assert got[0] == np.sort(x64)[7]
    with pytest.raises(ValueError):
        nth_element(jnp.asarray(x), [n])


def test_merge_sorted_u64_numpy(rng):
    # regression: jnp.asarray would silently truncate 64-bit numpy inputs
    from radix_sorting.extras import merge_sorted
    a = np.array([1, (1 << 40) + 5], np.uint64)
    b = np.array([3, (1 << 40) + 1], np.uint64)
    out = np.asarray(merge_sorted(a, b), dtype=np.uint64)
    assert np.array_equal(out, np.sort(np.concatenate([a, b])))


def test_index_width_guards(rng):
    # every index-plane entry point rejects a too-narrow index dtype
    from radix_sorting.extras import segmented_argsort, top_k
    x = jnp.zeros((1 << 17,), jnp.uint32)
    with pytest.raises(ValueError, match="cannot index"):
        rst.argsort(x, index_dtype=jnp.uint16)
    with pytest.raises(ValueError, match="cannot index"):
        rst.argsort_batched(x.reshape(1, -1), index_dtype=jnp.uint16)
    with pytest.raises(ValueError, match="cannot index"):
        top_k(x, 3, index_dtype=jnp.uint16)
    with pytest.raises(ValueError, match="cannot index"):
        segmented_argsort(x, jnp.zeros_like(x), index_dtype=jnp.uint16)


def test_batched_single_row_fast_path(rng):
    # degenerate 1-batch inputs take the 1-D sort; results must be identical
    x = rng.integers(0, 1 << 32, size=(1, 4096), dtype=np.uint32)
    assert np.array_equal(np.asarray(rst.sort_batched(jnp.asarray(x))),
                          np.sort(x, axis=1))
    assert np.array_equal(np.asarray(rst.argsort_batched(jnp.asarray(x))),
                          np.argsort(x, axis=1, kind="stable"))
    xc = rng.integers(0, 8, size=(4096, 1), dtype=np.uint32)  # ties, axis 0
    p = rng.integers(0, 1 << 32, size=(4096, 1), dtype=np.uint32)
    sk, sv = rst.sort_pairs_batched(jnp.asarray(xc), p, axis=0)
    order = np.argsort(xc[:, 0], kind="stable")
    assert np.array_equal(np.asarray(sk)[:, 0], xc[order, 0])
    assert np.array_equal(np.asarray(sv)[:, 0], p[order, 0])
