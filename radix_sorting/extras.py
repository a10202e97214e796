"""Sort-adjacent operations built on the engine stack.

Not part of the reference's surface, but natural capabilities of a sort
framework and trivial over the existing machinery: multi-key lexicographic
sorting (the generalization of the reference's record sort) and sorted-unique
extraction (the generalization of `bitmap_sort_16.c` to wide domains).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .api import _as_words
from .config import DEFAULT_CONFIG, SortConfig
from .ops import hw_engine, kdf

__all__ = ["lexsort", "unique_sorted", "segmented_sort", "segmented_argsort",
           "top_k_batched", "searchsorted", "bincount",
           "top_k", "merge_sorted", "nth_element", "stable_partition",
           "value_counts", "group_reduce", "sort_complex"]


def _word_pairs(words, dtype):
    """[(derived word, live width), ...] for one key's planes.

    The KDF maps a b-bit dtype into a b-bit derived domain, so a narrow
    dtype's single plane is bounded by 2**b; 64-bit keys contribute two
    full-width planes.
    """
    words = tuple(words)
    if len(words) == 2:
        return [(words[0], 32), (words[1], 32)]
    return [(words[0], min(32, kdf.key_bits(dtype)))]


def _pack_narrow_words(pairs):
    """Pack width-bounded derived words into the fewest u32 sort operands.

    ``pairs`` is [(word, live_bits), ...] most significant first; every word
    is < 2**live_bits, so concatenating fields within a u32 preserves the
    lexicographic order exactly. The sorter is operand-width-bound
    (ROADMAP round-2 experiment 4 / round-3 compaction table), so a lexsort
    of four u8 columns runs as ONE key operand instead of four.

    Returns ``(packed_words, layout)`` with ``layout[i] = (word_idx, shift,
    bits)`` locating pair i's field — callers unpack fields after sorting,
    or XOR a field's in-place mask to order it descending (a b-bit field's
    complement is ``field ^ (2^b - 1)``, applied without disturbing its
    neighbors).
    """
    groups, cur, cur_bits = [], [], 0
    for w, bits in pairs:
        if cur and cur_bits + bits > 32:
            groups.append(cur)
            cur, cur_bits = [], 0
        cur.append((w, bits))
        cur_bits += bits
    groups.append(cur)
    packed, layout = [], []
    for gi, g in enumerate(groups):
        shift = sum(b for _, b in g)
        acc = None
        for w, bits in g:
            shift -= bits
            term = (w << np.uint32(shift)) if shift else w
            acc = term if acc is None else acc | term
            layout.append((gi, shift, bits))
        packed.append(acc)
    return tuple(packed), layout


def _field_masks(layout, indices, num_words):
    """Per-packed-word u32 masks covering the fields named by ``indices``."""
    masks = [0] * num_words
    for i in indices:
        gi, shift, bits = layout[i]
        masks[gi] |= ((1 << bits) - 1) << shift
    return masks


def _xor_masks(words, masks):
    return tuple(w ^ np.uint32(m) if m else w for w, m in zip(words, masks))


def _unpack_fields(sorted_words, layout):
    """Recover each original plane from the sorted packed words."""
    planes = []
    for gi, shift, bits in layout:
        w = sorted_words[gi]
        if shift:
            w = w >> np.uint32(shift)
        if bits < 32:
            w = w & np.uint32((1 << bits) - 1)
        planes.append(w)
    return planes


def lexsort(keys: Sequence, *, config: SortConfig = DEFAULT_CONFIG) -> jax.Array:
    """Stable argsort by multiple keys, last key most significant (numpy order).

    Each key may be any supported dtype; all are KDF-encoded, narrow derived
    words are bit-packed into the fewest u32 planes (`_pack_narrow_words` —
    the operand-count win of round-3 plane compaction, here with static
    dtype widths so no PEXT is even needed), and one fused sort orders the
    result — the multi-word generalization of the reference's KDF
    composition. Descending complements the PACKED planes (complement
    distributes over concatenated fields bitwise).
    """
    keys = list(keys)
    if not keys:
        raise ValueError("lexsort needs at least one key")
    pairs = []
    n = None
    for k in reversed(keys):  # numpy: last key is primary
        w, dt = _as_words(k, False)
        if n is None:
            n = int(w[0].shape[0])
        elif int(w[0].shape[0]) != n:
            raise ValueError("lexsort keys must share a common length")
        pairs += _word_pairs(w, dt)
    packed, _ = _pack_narrow_words(pairs)
    if config.descending:
        packed = kdf.complement(packed)
    _, perm = hw_engine.argsort_words(packed)
    return perm


def _sorted_boundaries(s, size: int):
    """(boundary_values, run_lengths, num_unique) of a SORTED array, fixed shape.

    Handles the no-x64 numpy 64-bit result of :func:`api.sort` host-side
    (``jnp.asarray`` would silently truncate it to 32 bits). Uniqueness is
    bitwise under the KDF total order: -0.0 and +0.0 are distinct values, as
    are NaNs with different payloads — consistent with how the sorts
    themselves order floats.
    """
    if isinstance(s, np.ndarray):
        n = s.shape[0]
        raw = np.ascontiguousarray(s).view(f"u{s.dtype.itemsize}")
        is_new = np.concatenate([[True], raw[1:] != raw[:-1]])
        idx = np.flatnonzero(is_new)
        k = idx.shape[0]
        vals = np.full((size,), s[-1], s.dtype)
        vals[: min(k, size)] = s[idx[:size]]
        lens = np.zeros((size,), np.int32)
        bounded = np.concatenate([idx[:size], [n]])
        lens[: min(k, size)] = (bounded[1:] - bounded[:-1])[: min(k, size)]
        return vals, lens, np.int32(k)
    sj = jnp.asarray(s)
    n = int(sj.shape[0])
    # Integer/bool dtypes compare directly (bitwise equality IS value
    # equality); floats compare on the kdf-encoded plane so NaNs with
    # distinct payloads stay distinct. kdf.kind, not numpy's dtype.kind:
    # ml_dtypes report 'V', and a jnp sub-byte (int4) array's uint view is
    # the PACKED nibble buffer (length n/2) — the round-3 review bug.
    if kdf.kind(sj.dtype) != "f":
        raw = sj
    elif kdf.key_bits(sj.dtype) == 64:
        raw = sj.view(jnp.uint64)    # x64-mode f64: byte-backed, view is safe
    else:
        raw = kdf.encode(sj)[0]
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), raw[1:] != raw[:-1]])
    num_unique = jnp.sum(is_new.astype(jnp.int32))
    starts, = jnp.nonzero(is_new, size=size, fill_value=n)
    bounded = jnp.concatenate([starts, jnp.full((1,), n, starts.dtype)])
    lens = (bounded[1:] - bounded[:-1]).astype(jnp.int32)
    live = jnp.arange(size) < num_unique
    vals = sj[jnp.clip(starts, 0, n - 1)]
    return vals, jnp.where(live, lens, 0), num_unique


def unique_sorted(x, *, size: Optional[int] = None,
                  config: SortConfig = DEFAULT_CONFIG) -> Tuple[jax.Array, jax.Array]:
    """Sorted unique values with a fixed-shape contract: (values, count).

    ``values`` has static length ``size`` (default n); slots past ``count``
    hold a maximal padding value (the domain maximum for narrow unsigned
    keys, the array maximum otherwise). The wide-domain generalization of
    the bitmap unique-sort (`bitmap_sort_16.c`): narrow unsigned dtypes take
    the presence-histogram path directly (no sort); everything else sorts
    and keeps boundary elements. Uniqueness is bitwise under the KDF total
    order (see :func:`_sorted_boundaries`).
    """
    from . import api
    from .ops.bitmap import bitmap_unique_sort

    xa = x if hasattr(x, "dtype") else jnp.asarray(x)
    if np.ndim(xa) != 1:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(xa)}")
    n = int(jnp.shape(xa)[0])
    if size is None:
        size = n
    if (not config.descending
            and jnp.dtype(xa.dtype) in (jnp.uint8, jnp.uint16)
            and n > 0):
        # narrow unsigned domains: presence-histogram path, no sort at all
        return bitmap_unique_sort(jnp.asarray(xa), size=size)

    if n == 0:
        if isinstance(xa, np.ndarray):  # preserve 64-bit dtypes without x64
            return np.zeros((size,), xa.dtype), np.int32(0)
        return jnp.zeros((size,), jnp.asarray(xa).dtype), jnp.int32(0)
    s = api.sort(x, config=config)
    vals, _, count = _sorted_boundaries(s, size)
    return vals, count


def segmented_sort(keys, segment_ids, *, config: SortConfig = DEFAULT_CONFIG):
    """Sort keys within segments: one fused sort by the (segment, key) composite.

    ``segment_ids`` is an integer array of the keys' length. Returns
    ``(sorted_keys, sorted_segment_ids)`` ordered by segment id first, then by
    key within each segment (``config.descending`` applies to the *keys* only).
    If the input segments are already grouped and in ascending id order —
    the contiguous-offsets layout of classic segmented sorts — the segment
    layout is preserved exactly and only intra-segment order changes.
    """
    from .api import _as_words, _decode

    seg_words, seg_dtype = _as_words(segment_ids, False)
    key_words, key_dtype = _as_words(keys, False)
    if seg_words[0].shape != key_words[0].shape:
        raise ValueError("segment_ids must match the keys' length")
    # Pack the (segment, key) composite into the fewest u32 operands
    # (narrow fields concatenate; a u16-keyed u16-segmented sort is ONE
    # operand instead of two). Descending applies to the KEYS only, so the
    # key fields complement IN PLACE via their field masks — the segment
    # fields stay ascending untouched.
    seg_pairs = _word_pairs(seg_words, seg_dtype)
    key_pairs = _word_pairs(key_words, key_dtype)
    packed, layout = _pack_narrow_words(seg_pairs + key_pairs)
    kmasks = _field_masks(layout, range(len(seg_pairs), len(layout)),
                          len(packed))
    if config.descending:
        packed = _xor_masks(packed, kmasks)
    sw, _ = hw_engine.sort_words(packed, (), stable=False)
    if config.descending:
        sw = _xor_masks(sw, kmasks)
    planes = _unpack_fields(sw, layout)
    sorted_ids = _decode(tuple(planes[: len(seg_pairs)]), seg_dtype, False)
    sorted_keys = _decode(tuple(planes[len(seg_pairs):]), key_dtype, False)
    return sorted_keys, sorted_ids


def segmented_argsort(keys, segment_ids, *, config: SortConfig = DEFAULT_CONFIG,
                      index_dtype=jnp.uint32):
    """Stable argsort by (segment, key): the permutation form of
    :func:`segmented_sort`, ties within a segment resolve to the lower index.
    """
    from .api import _as_words, _check_index_width

    seg_words, seg_dtype = _as_words(segment_ids, False)
    key_words, key_dtype = _as_words(keys, False)
    if seg_words[0].shape != key_words[0].shape:
        raise ValueError("segment_ids must match the keys' length")
    _check_index_width(int(key_words[0].shape[0]), index_dtype)
    seg_pairs = _word_pairs(seg_words, seg_dtype)
    packed, layout = _pack_narrow_words(
        seg_pairs + _word_pairs(key_words, key_dtype))
    if config.descending:
        # keys-descending in place; segments stay ascending (see
        # segmented_sort)
        packed = _xor_masks(packed, _field_masks(
            layout, range(len(seg_pairs), len(layout)), len(packed)))
    _, perm = hw_engine.argsort_words(packed, index_dtype=index_dtype)
    return perm


def merge_sorted(a, b, *, config: SortConfig = DEFAULT_CONFIG):
    """Merge two sorted arrays into one sorted array (``std::merge`` semantics).

    Keys-only, so the observable result is fully determined by the multiset.
    The merge is realized as one fused unstable sort of the concatenation
    (a dedicated merge is ROADMAP queue 3 item 5).
    """
    from .api import _as_words, _decode

    a = a if hasattr(a, "dtype") else np.asarray(a)
    b = b if hasattr(b, "dtype") else np.asarray(b)
    da, db = np.dtype(a.dtype), np.dtype(b.dtype)
    if da != db:
        raise TypeError(f"merge_sorted inputs must share a dtype, got {da} and {db}")
    if (isinstance(a, np.ndarray) and da.itemsize == 8
            and not jax.config.jax_enable_x64):
        # concatenate host-side so the (hi, lo)-plane split sees full width
        # (jnp.asarray would silently truncate 64-bit numpy input to 32 bits)
        cat = np.concatenate([np.asarray(a), np.asarray(b)])
    else:
        cat = jnp.concatenate([jnp.asarray(a), jnp.asarray(b)])
    words, dtype = _as_words(cat, config.descending)
    sw, _ = hw_engine.sort_words(tuple(words), (), stable=False)
    return _decode(tuple(sw), dtype, config.descending)


def bincount(x, *, length: Optional[int] = None, validate: bool = False):
    """Occurrence counts of non-negative integer values (``np.bincount``).

    One scatter-add (:func:`.ops.histogram.digit_histogram`).

    Precondition (like the counting engines): every value lies in
    ``[0, length)``. Out-of-range values are silently DROPPED (numpy raises
    on negatives instead) — pass ``validate=True``
    to pay one min/max reduce plus a host sync and get a ValueError.

    ``length`` defaults to the dtype's domain size for narrow unsigned/bool
    keys and is required otherwise. Returns an int32 array of ``length``.
    """
    xa = jnp.asarray(x)
    if xa.ndim != 1:
        raise ValueError(f"bincount input must be 1-D, got shape {xa.shape}")
    k = kdf.kind(xa.dtype)
    if k == "f":
        raise TypeError(f"bincount needs integer/bool values, got {xa.dtype}")
    bits = kdf.key_bits(xa.dtype)
    if length is None:
        if k in ("u", "b") and bits <= 16:
            length = 2 if k == "b" else (1 << bits)
        else:
            raise ValueError(
                f"length is required for {xa.dtype} (domain too wide to default)")
    length = int(length)
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    w = xa.astype(jnp.uint32)  # negatives wrap out of [0, length): dropped
    if validate and int(xa.shape[0]):
        # negatives wrap past any sane length in the u32 view, so one max
        # reduce (single host sync) covers both failure modes
        hi = int(jnp.max(w))
        if hi >= length:
            raise ValueError(
                f"bincount values outside [0, {length}): max raw bits 0x{hi:X}")
    if int(xa.shape[0]) == 0:
        return jnp.zeros((length,), jnp.int32)
    from .ops.histogram import digit_histogram
    return digit_histogram(w, length)


# searchsorted query-batch block size: larger batches run as lax.map chunks
# of this size, bounding every intermediate. Module-level so tests can shrink
# it to cover the chunked path.
_SEARCHSORTED_QBLOCK = 1 << 22


def searchsorted(sorted_keys, queries, *, side: str = "left",
                 method: str = "auto", sorter=None,
                 config: SortConfig = DEFAULT_CONFIG):
    """Insertion positions of ``queries`` into a sorted array (``np.searchsorted``).

    Positions are under the KDF total order (floats with NaN/±0 place
    consistently with this framework's sorts; ``config.descending`` searches
    a descending-sorted array). ``sorted_keys`` must already be sorted in
    that order — a precondition, not verified (like numpy's).

    Two-word (64-bit) keys have no lexicographic binary search, so they run
    ONE unstable sort of the tagged union plus an inverse-permutation sort.
    Single-word (<= 32-bit) keys pick by ``method``: ``'scan'`` /
    ``'scan_unrolled'`` / ``'compare_all'`` / ``'sort'`` pass through to
    ``jnp.searchsorted`` on the encoded plane; ``'auto'`` is ``'scan'``
    (a binary search per query).

    Query batches past 4M run as ``lax.map`` blocks (every path); blocking
    bounds each dispatch's intermediates with identical results.

    ``sorter`` (numpy parity, `np.searchsorted`'s third positional):
    an integer permutation that sorts ``sorted_keys`` under this call's
    order. Any permutation of ``a`` that is sorted IS element-wise equal to
    ``sort(a)``, so the route sorts the keys and searches that. Like numpy, the
    "``sorter`` actually sorts ``a``" precondition is the caller's;
    length/dtype are validated.

    Returns an int32 array of ``len(queries)`` positions in ``[0, n]``.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if sorter is not None:
        sdt = sorter.dtype if hasattr(sorter, "dtype") else \
            np.asarray(sorter).dtype
        if not jnp.issubdtype(sdt, jnp.integer):
            raise TypeError(
                f"sorter must be an integer permutation, got {sdt}")
        # shape-only checks: no device transfer (sorted_keys may be a large
        # host numpy u64 array that must not round-trip through jnp)
        if tuple(jnp.shape(sorter)) != tuple(jnp.shape(sorted_keys)):
            raise ValueError(
                f"sorter.shape {tuple(jnp.shape(sorter))} must equal "
                f"sorted_keys.shape {tuple(jnp.shape(sorted_keys))}")
        from .api import sort as _sort
        sorted_keys = _sort(sorted_keys, config=config)
    _METHODS = ("auto", "scan", "scan_unrolled", "compare_all", "sort")
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    sw, sd = _as_words(sorted_keys, config.descending)
    qw, qd = _as_words(queries, config.descending)
    if jnp.dtype(sd) != jnp.dtype(qd):
        raise TypeError(
            f"searchsorted inputs must share a dtype, got {sd} and {qd}")
    n = int(sw[0].shape[0])
    q = int(qw[0].shape[0])
    if q == 0:
        return jnp.zeros((0,), jnp.int32)
    if n == 0:
        return jnp.zeros((q,), jnp.int32)

    # Large query batches are processed in <= 4M-query blocks (lax.map):
    # blocking bounds every intermediate (scan gather chains, tagged-union
    # sort operands) with no accuracy cost — padded queries are sliced off.
    QBLOCK = _SEARCHSORTED_QBLOCK

    def _chunked(fn, qwords):
        pad = (-q) % QBLOCK
        qp = tuple(jnp.concatenate([w, jnp.zeros((pad,), jnp.uint32)])
                   if pad else w for w in qwords)
        out = jax.lax.map(fn, tuple(w.reshape(-1, QBLOCK) for w in qp))
        return out.reshape(-1)[:q]

    if len(sw) == 1:
        if method == "auto":
            method = "scan"
        if q > QBLOCK:
            return _chunked(
                lambda qb: jnp.searchsorted(sw[0], qb[0], side=side,
                                            method=method),
                (qw[0],)).astype(jnp.int32)
        return jnp.searchsorted(sw[0], qw[0], side=side,
                                method=method).astype(jnp.int32)

    # 64-bit keys: tagged-union sort. At equal (hi, lo), side='left' places
    # queries BEFORE sorted elements (their equals are not counted),
    # side='right' after (counted). The tie-break is FUSED into the index
    # plane instead of a separate flag operand (the sorter is measured
    # operand-width-bound — one fewer operand is a direct win): for 'left'
    # queries take indices 0..q-1 and sorted elements q..q+n-1, for 'right'
    # the reverse, so the unique index plane alone orders every tie.
    def _tagged_union(qb):
        qb_hi, qb_lo = qb
        m = int(qb_hi.shape[0])
        if side == "left":
            idx_q = jnp.arange(m, dtype=jnp.uint32)
            idx_s = jnp.arange(m, m + n, dtype=jnp.uint32)
        else:
            idx_s = jnp.arange(n, dtype=jnp.uint32)
            idx_q = jnp.arange(n, n + m, dtype=jnp.uint32)
        words = tuple(jnp.concatenate([s, w])
                      for s, w in zip(sw, (qb_hi, qb_lo)))
        idx = jnp.concatenate([idx_s, idx_q])
        (_, _, sidx), _ = hw_engine.sort_words(words + (idx,), (),
                                               stable=False)
        is_sorted_elem = ((sidx >= m) if side == "left"
                          else (sidx < n)).astype(jnp.int32)
        before = jnp.cumsum(is_sorted_elem) - is_sorted_elem  # exclusive
        # restore original query order: one inverse-permutation sort on sidx
        # (strictly unique keys carrying the counts as payload — the
        # engine's payload path requires the stable sorter, which unique
        # keys make observationally identical); the query block sits at the
        # front ('left') or back ('right') of the restored order
        _, (restored,) = hw_engine.sort_words(
            (sidx,), (before.astype(jnp.uint32),), stable=True)
        return restored[:m] if side == "left" else restored[n:]

    if q > QBLOCK:
        return _chunked(_tagged_union, tuple(qw)).astype(jnp.int32)
    return _tagged_union(tuple(qw)).astype(jnp.int32)


def stable_partition(pred, values):
    """Stable partition of a payload pytree by a boolean predicate.

    Rows where ``pred`` is False come first, then rows where it is True,
    each group keeping input order (``std::stable_partition`` with the
    False-first convention of ascending bool order). Returns
    ``(partitioned_values, num_false)``. One fused stable pairs sort by the
    {0,1} derived key.
    """
    from .api import sort_pairs

    p = jnp.asarray(pred)
    if p.dtype != jnp.bool_:
        raise TypeError(f"pred must be boolean, got {p.dtype}")
    sorted_pred, out = sort_pairs(p, values)
    del sorted_pred  # grouped predicate is implied by num_false
    num_false = jnp.sum(~p, dtype=jnp.int32)
    return out, num_false


def value_counts(x, *, size: Optional[int] = None,
                 groups: Optional[int] = None,
                 config: SortConfig = DEFAULT_CONFIG):
    """Sorted unique values with their multiplicities (run-length encode).

    Fixed-shape contract: ``(values, counts, num_unique)`` with static length
    ``size`` (default n); slots past ``num_unique`` hold a maximal padding
    value with count 0. One sort plus boundary differencing. ``size`` should
    be >= the number of uniques: a truncated result folds the dropped runs'
    mass into the last kept count. Uniqueness is bitwise under the KDF total
    order (-0.0 and +0.0 are distinct, NaN payloads are distinct) —
    consistent with how the sorts order floats.

    ``groups=G`` (integer keys promised in [0, G), G <= 2^17): NO sort —
    one scatter-add (the `bincount` machinery) + compaction, the count
    form of :func:`group_reduce`'s dense tier. ``size`` then defaults to
    ``min(n, groups)``; the promise semantics (drop on violation) match
    `group_reduce`.
    """
    from . import api

    if np.ndim(x) != 1:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    n = int(jnp.shape(x)[0])
    if groups is not None:
        groups = int(groups)
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        if not _dense_ok(x):
            raise TypeError(
                "groups promises non-negative integer keys < groups; "
                f"got dtype {getattr(x, 'dtype', type(x))}")
        if size is None:
            size = min(n, groups)
        if n > 0 and groups <= (1 << 17):
            xa = jnp.asarray(x)
            counts = bincount(xa.astype(jnp.uint32), length=groups)
            return _dense_emit(counts, None, "count", groups, size,
                               xa.dtype, config.descending)
    if size is None:
        size = n
    if n == 0:
        if isinstance(x, np.ndarray):  # preserve 64-bit dtypes without x64
            return (np.zeros((size,), x.dtype), np.zeros((size,), np.int32),
                    np.int32(0))
        d = jnp.asarray(x).dtype
        return jnp.zeros((size,), d), jnp.zeros((size,), jnp.int32), jnp.int32(0)
    return _sorted_boundaries(api.sort(x, config=config), size)


def nth_element(x, ranks, *, config: SortConfig = DEFAULT_CONFIG):
    """Values at the given sorted ranks (exact order statistics).

    ``ranks`` is a static sequence of ints in [0, n); rank order follows
    ``config.descending``. The single-device counterpart of
    :func:`..parallel.distributed_select` (which needs no full sort); this
    runs the whole strategy-dispatched sort and takes. Returns a
    (len(ranks),) array of x's dtype.
    """
    from . import api

    n = int(jnp.shape(x)[0]) if np.ndim(x) == 1 else -1
    if n < 0:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    ranks = [int(r) for r in ranks]
    if not ranks:
        raise ValueError("ranks must be non-empty")
    if not all(0 <= r < n for r in ranks):
        raise ValueError(f"ranks must be in [0, {n})")
    s = api.sort(x, config=config)
    idx = np.asarray(ranks, dtype=np.int32)
    return s[idx] if isinstance(s, np.ndarray) else s[jnp.asarray(idx)]


def top_k(x, k: int, *, largest: bool = True, index_dtype=jnp.uint32):
    """Top-k values of ``x`` with their stable original indices.

    Returns ``(values, indices)`` of static length ``k``, ordered best-first
    (descending for ``largest=True``); ties resolve to the lower original
    index. Any supported key dtype, including the 64-bit two-plane keys that
    ``lax.top_k`` cannot express — the selection rides the same derived-key
    sorter as everything else.
    """
    from .api import _as_words, _decode

    words, dtype = _as_words(x, largest)
    n = int(words[0].shape[0])
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    from .api import _check_index_width
    _check_index_width(n, index_dtype)
    sw, perm = hw_engine.argsort_words(tuple(words), index_dtype=index_dtype)
    top_words = tuple(w[:k] for w in sw)
    return _decode(top_words, dtype, largest), perm[:k]


def top_k_batched(x, k: int, *, axis: int = -1, largest: bool = True,
                  index_dtype=jnp.uint32):
    """Top-k of every 1-D slice along ``axis``, stable original indices.

    The batched form of :func:`top_k` — one fused device sort for the whole
    batch, any supported dtype including 64-bit two-plane keys.
    Returns ``(values, indices)`` with ``k`` replacing the size of ``axis``,
    ordered best-first; ties resolve to the lower index per slice.
    """
    from .api import (_as_words, _check_index_width, _decode, _moveaxis_last,
                      _restore_axis, _single_batch)

    xm, axis = _moveaxis_last(x, axis)
    if _single_batch(xm):
        # (1, n) dimension-1 sorts lower ~6x slower than the identical 1-D
        # sort (see api._single_batch); collapse and route through top_k
        vals, idx = top_k(xm.reshape(-1), k, largest=largest,
                          index_dtype=index_dtype)
        shape = xm.shape[:-1] + (k,)
        return (_restore_axis(vals.reshape(shape), axis),
                _restore_axis(idx.reshape(shape), axis))
    words, dtype = _as_words(xm, largest, allow_nd=True)
    dim = words[0].ndim - 1
    n = int(words[0].shape[dim])
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    _check_index_width(n, index_dtype)
    iota = jax.lax.broadcasted_iota(index_dtype, words[0].shape, dim)
    out = jax.lax.sort(tuple(words) + (iota,), dimension=dim, is_stable=False,
                       num_keys=len(words) + 1)
    top_words = tuple(w[..., :k] for w in out[: len(words)])
    vals = _decode(top_words, dtype, largest)
    return _restore_axis(vals, axis), _restore_axis(out[-1][..., :k], axis)


def _dense_ok(arr, bits_cap: int = 32) -> bool:
    """True when ``arr`` can ride the dense group-by tier as a plain device
    u32 plane: a jax-compatible integer/bool array of <= 32 bits (numpy
    64-bit and byte-string inputs keep their host-side handling)."""
    if isinstance(arr, np.ndarray) and (arr.dtype.kind == "S"
                                        or arr.dtype.itemsize == 8):
        return False
    d = jnp.asarray(arr).dtype if not hasattr(arr, "dtype") else arr.dtype
    d = jnp.dtype(d)
    return kdf.kind(d) in ("u", "i", "b") and kdf.key_bits(d) <= bits_cap


def _dense_value_bytes(vdtype) -> int:
    bits = kdf.key_bits(vdtype)
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


def _dense_f32_ok(arr) -> bool:
    """True when ``arr`` can ride the FLOAT dense group-by tier: a
    jax-compatible float of <= 32 bits (f32/bf16/f16/float8 — all exact
    under one cast to f32). 64-bit floats keep the sort-native route (their
    sums need f64 accumulation the 32-bit device path cannot provide)."""
    if isinstance(arr, np.ndarray) and (arr.dtype.kind == "S"
                                        or arr.dtype.itemsize == 8):
        return False
    d = jnp.asarray(arr).dtype if not hasattr(arr, "dtype") else arr.dtype
    d = jnp.dtype(d)
    return kdf.kind(d) == "f" and kdf.key_bits(d) <= 32


def _dense_counts_sums(w, v, G: int):
    """Per-group row counts and value sums of u32 keys ``w`` by scatter-add.

    Keys outside [0, G) clamp into an overflow bucket that is dropped (the
    `bincount` promise semantics). ``v`` None gives ``(counts, None)``.
    Integer sums wrap mod 2^32 like any u32 add. Float sums accumulate in
    f32; on a GPU the adds are atomics whose order changes from run to run,
    so the last bits of a float sum may differ between runs.
    """
    ki = jnp.where(w < jnp.uint32(G), w, jnp.uint32(G)).astype(jnp.int32)
    counts = jax.ops.segment_sum(jnp.ones_like(ki), ki,
                                 num_segments=G + 1)[:G]
    if v is None:
        return counts, None
    return counts, jax.ops.segment_sum(v, ki, num_segments=G + 1)[:G]


def _group_reduce_dense_f32(keys, values, *, reduce: str, groups: int,
                            size: int, config: SortConfig):
    """Float dense group-by tier: sum/mean of <= 32-bit float values over
    keys promised in [0, groups) — one scatter-add of counts and f32 sums,
    no sort at all.

    Accuracy (vs a float64 oracle): each group's total is a DIRECT f32 sum
    of its own values, so the error grows with the group's own size and
    magnitude: |err| <= count_g * 2^-23 * max|v| per group (the bound the
    tests and the on-card check hold it to). The order of the adds is not
    fixed (GPU atomics), so the last bits can change between runs. The
    sort-native fallback computes group sums as differences of a
    whole-array f32 prefix sum, whose rounding scales with the PREFIX
    magnitude — the dense tier's bound is the tighter one. Non-finite values
    poison their group's sum.

    Keys outside [0, groups) are DROPPED (bincount promise semantics),
    matching the integer dense tier.
    """
    ka = jnp.asarray(keys)
    kdtype = ka.dtype
    G = int(groups)
    counts, tot = _dense_counts_sums(
        ka.astype(jnp.uint32), jnp.asarray(values).astype(jnp.float32), G)
    return _dense_emit(counts, tot, reduce, G, size, kdtype,
                       config.descending)


def _group_reduce_dense(keys, values, *, reduce: str, groups: int, size: int,
                        config: SortConfig):
    """Dense group-by tier: keys promised in [0, groups) — sum/mean become
    one scatter-add of counts and u32 sums (no sort at all).

    Exactness: integer group sums are exact mod 2^32 (the same 32-bit
    accumulation contract as the sort-native route). Signed values ride a
    +2^(bits-1) bias, corrected with ``count * bias`` afterwards — still
    exact mod 2^32. Keys outside [0, groups) are DROPPED (the `bincount`
    promise-violation semantics).
    """
    ka = jnp.asarray(keys)
    va = jnp.asarray(values)
    kdtype = ka.dtype
    vdtype = va.dtype
    G = int(groups)
    w = ka.astype(jnp.uint32)

    vbits = kdf.key_bits(vdtype)
    vkind = kdf.kind(vdtype)
    bias = np.uint32((1 << (vbits - 1)) & 0xFFFFFFFF) if vkind == "i" else None
    vu = va.astype(jnp.uint32)
    if bias is not None:
        vu = vu + bias  # u32 wrap: v + 2^(bits-1) mod 2^32
    counts, tot = _dense_counts_sums(w, vu, G)
    if bias is not None:
        tot = tot - counts.astype(jnp.uint32) * bias  # undo bias, mod 2^32

    acc = _accum_dtype(vdtype)
    tot = lax_bitcast(tot, acc) if jnp.dtype(acc) == jnp.int32 else tot

    return _dense_emit(counts, tot, reduce, G, size, kdtype,
                       config.descending)


def _dense_emit(counts, tot, reduce, G, size, kdtype, desc):
    """Compact a dense (G,) histogram tier result to the fixed-shape
    ``(unique_keys, reduced, num_groups)`` group-by contract (present keys
    sorted, maximal padding key + zero reduction past num_groups)."""
    from .api import _decode

    present = counts > 0
    num_groups = jnp.sum(present, dtype=jnp.int32)
    pm = present[::-1] if desc else present
    pos, = jnp.nonzero(pm, size=size, fill_value=G)
    live = jnp.arange(size) < num_groups
    gid = jnp.clip((G - 1) - pos if desc else pos, 0, G - 1).astype(jnp.uint32)

    ones = np.uint32(0xFFFFFFFF)
    enc = kdf.encode(gid.astype(kdtype), descending=desc)
    ukeys = _decode(tuple(jnp.where(live, we, ones) for we in enc),
                    kdtype, desc)

    if reduce == "count":
        return ukeys, jnp.where(live, counts[gid], 0), num_groups
    gtot = tot[gid]
    if reduce == "mean":
        lens = jnp.maximum(counts[gid], 1)
        mean = jnp.asarray(gtot, jnp.float32) / lens.astype(jnp.float32)
        return ukeys, jnp.where(live, mean, 0.0), num_groups
    return ukeys, jnp.where(live, gtot, 0), num_groups


def lax_bitcast(x, dtype):
    """Exact bit-pattern cast (u32<->i32): astype would be a value convert
    whose out-of-range behavior is backend-defined; bitcast is total."""
    return jax.lax.bitcast_convert_type(x, dtype)


def group_reduce(keys, values, *, reduce: str = "sum",
                 size: Optional[int] = None,
                 groups: Optional[int] = None,
                 validate: bool = False,
                 config: SortConfig = DEFAULT_CONFIG):
    """Per-unique-key reduction of ``values`` (a sort-native group-by).

    Returns ``(unique_keys, reduced, num_groups)`` with the fixed-shape
    contract of :func:`value_counts`: static length ``size`` (default n),
    group keys sorted (``config.descending`` applies to the keys), slots
    past ``num_groups`` hold a maximal padding key with a zero reduction.
    ``reduce`` is ``'sum'``, ``'mean'``, ``'min'`` or ``'max'`` (for counts
    use :func:`value_counts`).

    Sort-native route: ONE unstable keys-only sort of the ``(key, value)``
    composite word planes serves every reduction — within each equal-key run
    the values land value-sorted, so ``min``/``max`` are the run's boundary
    elements and ``sum`` is a cumulative-sum difference at the boundaries.

    **Dense tier** (``groups=G``): a promise that every key is a
    non-negative integer < ``G``. ``sum``/``mean`` over integer/bool values
    then skip the sort entirely — one scatter-add of counts and sums
    (`_dense_counts_sums`). Applies when ``(value_bytes + 1) * G <= 2^17``;
    float values of <= 32 bits take the same tier when ``3 * G <= 2^17``,
    with a TIGHTER f32 error bound than the fallback's whole-array
    prefix-sum differences — see `_group_reduce_dense_f32` for the bound.
    (Both gates date from an earlier byte-plane histogram and have not been
    re-derived for the scatter-add; ROADMAP queue 1.)
    Wider promises, 64-bit values and ``min``/``max`` keep the sort-native
    route. With ``groups`` given,
    ``size`` defaults to ``min(n, groups)`` (route-independent shapes).
    ``groups`` is a PROMISE like ``value_mask``: violations give
    route-dependent results (the dense tier drops out-of-range keys, the
    sort-native fallback keeps them as ordinary keys) — pass
    ``validate=True`` to pay one max reduce + host sync and get a
    ValueError instead.

    ``min``/``max`` follow the KDF total order (a NaN payload in the values
    is greater than +inf; -0.0 < +0.0). ``sum``/``mean`` accumulate
    sub-32-bit inputs in 32-bit (f32 / i32 / u32) and return that
    accumulator dtype; 32/64-bit inputs accumulate natively. ``mean`` is
    float32 on the device path (values of magnitude past 2^24 round) and
    exact float64 for 64-bit numpy values (which reduce host-side). The running
    cumulative sum spans the whole array: integer group sums stay exact for
    any input (two's-complement differences cancel the prefix), but float
    group sums see the rounding of a prefix that can be much larger than the
    group — for tight float sums over huge arrays, accumulate in f64 on the
    host or segment the input.
    """
    from .api import _decode

    if reduce not in ("sum", "mean", "min", "max"):
        raise ValueError(
            f"reduce must be sum|mean|min|max, got {reduce!r}")
    if groups is not None:
        groups = int(groups)
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        if not _dense_ok(keys):
            raise TypeError(
                "groups promises non-negative integer keys < groups; "
                f"got key dtype {getattr(keys, 'dtype', type(keys))}")
        if validate and int(jnp.asarray(keys).shape[0]):
            hi = int(jnp.max(jnp.asarray(keys).astype(jnp.uint32)))
            if hi >= groups:
                raise ValueError(
                    f"group keys outside [0, {groups}): max raw bits 0x{hi:X}")
    kw, kdtype = _as_words(keys, config.descending)
    vw, vdtype = _as_words(values, False)
    if kw[0].shape != vw[0].shape:
        raise ValueError("values must match the keys' length")
    n = int(kw[0].shape[0])
    if size is None:
        size = min(n, groups) if groups is not None else n
    if groups is not None and n > 0 and reduce in ("sum", "mean"):
        bins = 1 << max(2, (groups - 1).bit_length())
        if (_dense_ok(values)
                and (_dense_value_bytes(jnp.asarray(values).dtype) + 1)
                * bins <= (1 << 17)):
            return _group_reduce_dense(keys, values, reduce=reduce,
                                       groups=groups, size=size,
                                       config=config)
        if _dense_f32_ok(values) and 3 * bins <= (1 << 17):
            return _group_reduce_dense_f32(keys, values, reduce=reduce,
                                           groups=groups, size=size,
                                           config=config)
    host64 = (isinstance(vdtype, np.dtype) and vdtype.itemsize == 8
              and not jax.config.jax_enable_x64)
    if n == 0:
        zk = unique_sorted(keys, size=size, config=config)[0]
        if reduce == "mean":
            zv = jnp.zeros((size,), jnp.float32)
        elif host64:
            zv = np.zeros((size,), vdtype)
        else:
            acc = _accum_dtype(vdtype) if reduce == "sum" else vdtype
            zv = jnp.zeros((size,), acc)
        return zk, zv, jnp.int32(0)

    sw = hw_engine.sort_words(kw + vw, (), stable=False)[0]
    skw, svw = sw[: len(kw)], sw[len(kw):]

    neq = functools.reduce(jnp.logical_or,
                           [w[1:] != w[:-1] for w in skw])
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    num_groups = jnp.sum(is_new, dtype=jnp.int32)
    starts, = jnp.nonzero(is_new, size=size, fill_value=n)
    live = jnp.arange(size) < num_groups
    at_start = jnp.clip(starts, 0, n - 1)
    ones = np.uint32(0xFFFFFFFF)
    ukeys = _decode(tuple(jnp.where(live, w[at_start], ones) for w in skw),
                    kdtype, config.descending)

    sv = _decode(svw, vdtype, False)
    bounded = jnp.concatenate([starts, jnp.full((1,), n, starts.dtype)])
    ends = jnp.clip(bounded[1:] - 1, 0, n - 1)  # last index of each run

    if reduce in ("min", "max"):
        pos = at_start if reduce == "min" else ends
        if host64:  # 64-bit values without x64: numpy gather host-side
            out = sv[np.asarray(pos)]
            out[~np.asarray(live)] = 0
            return ukeys, out, num_groups
        return ukeys, jnp.where(live, sv[pos], 0), num_groups

    if host64:
        c = np.concatenate([np.zeros((1,), sv.dtype), np.cumsum(sv)])
        tot = c[np.asarray(ends) + 1] - c[np.asarray(at_start)]
        tot[~np.asarray(live)] = 0
    else:
        acc = _accum_dtype(vdtype)
        c = jnp.concatenate([jnp.zeros((1,), acc),
                             jnp.cumsum(sv.astype(acc))])
        tot = jnp.where(live, c[ends + 1] - c[at_start], 0)
    if reduce == "sum":
        return ukeys, tot, num_groups
    lens = jnp.maximum(bounded[1:] - bounded[:-1], 1)
    if host64:  # exact sums exist host-side: divide in f64, don't round away
        mean = tot.astype(np.float64) / np.asarray(lens, np.float64)
        mean[~np.asarray(live)] = 0.0
        return ukeys, mean, num_groups
    mean = jnp.asarray(tot, jnp.float32) / lens.astype(jnp.float32)
    return ukeys, jnp.where(live, mean, 0.0), num_groups


def _accum_dtype(vdtype):
    """32-bit accumulator for sub-32-bit inputs; native width otherwise."""
    d = np.dtype(vdtype) if isinstance(vdtype, np.dtype) else jnp.dtype(vdtype)
    if kdf.kind(d) == "f":
        return d if kdf.key_bits(d) >= 32 else jnp.float32
    if d.itemsize >= 4 or d == jnp.dtype(jnp.bool_):
        return jnp.int32 if d == jnp.dtype(jnp.bool_) else d
    return jnp.uint32 if d.kind == "u" else jnp.int32


def sort_complex(x, *, config: SortConfig = DEFAULT_CONFIG) -> np.ndarray:
    """``np.sort_complex``: sort by real part, ties by imaginary part.

    Complex dtypes never touch the device: the host splits the numpy
    input into real/imag float planes, the KDF
    encodes each (f32: one u32 plane; f64: two planes, no x64), and ONE
    fused multi-operand device sort of the ``(real…, imag…)`` composite
    runs on the ordinary u32 word machinery — the same design as every
    other 64-bit+ key in this package. numpy in, numpy out.

    Ordering is the KDF total order per component (like numpy: real
    first, imaginary breaking ties; unlike numpy's comparison sort,
    -0.0 < +0.0 and NaNs order by sign/payload — consistent with this
    package's float sorts). ``config.descending`` reverses the order
    (numpy's is ascending-only). Real/integer numpy input is promoted to
    complex first, like ``np.sort_complex``.
    """
    if not isinstance(x, np.ndarray):
        raise TypeError(
            "sort_complex takes a NUMPY array: the host splits it into "
            "real/imag planes for the u32 word sort")
    if x.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {x.shape}")
    if x.dtype.kind != "c":
        # match np.sort_complex's promotion exactly: int8/int16/uint8/
        # uint16 ('bhBH') -> complex64, everything else (all floats
        # incl. f16/f32, wider ints) -> complex128
        x = x.astype(np.complex64 if x.dtype.char in "bhBH"
                     else np.complex128)
    if x.shape[0] == 0:
        return x.copy()
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    desc = config.descending
    if x.dtype == np.complex64:
        rw = kdf.encode(jnp.asarray(re), desc)
        iw = kdf.encode(jnp.asarray(im), desc)
    else:
        rw = kdf.encode64_np(re, desc)
        iw = kdf.encode64_np(im, desc)
    out = hw_engine.sort_words(tuple(rw) + tuple(iw), (), stable=False)[0]
    nr = len(rw)
    if x.dtype == np.complex64:
        re_s = np.asarray(kdf.decode(out[:nr], jnp.float32, desc))
        im_s = np.asarray(kdf.decode(out[nr:], jnp.float32, desc))
    else:
        re_s = kdf.decode64_np(out[:nr], np.float64, desc)
        im_s = kdf.decode64_np(out[nr:], np.float64, desc)
    res = np.empty(x.shape, x.dtype)
    res.real, res.imag = re_s, im_s
    return res
