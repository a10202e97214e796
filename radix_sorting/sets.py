"""numpy-style set routines, realized as fused derived-key sorts.

The reference stops at the bitmap unique-sort (`bitmap_sort_16.c`); this
module carries the same "sort once, read the boundaries" idea to the full
numpy set API: :func:`unique` (with index/inverse/counts), :func:`isin`,
:func:`union1d`, :func:`intersect1d`, :func:`setdiff1d`, :func:`setxor1d`.

Design notes
------------
- Everything is one or two fused multi-operand device sorts, with no
  per-element gather/scatter formulations (whether a gather beats a second
  sort on a GPU is ROADMAP queue 3 item 5).
- The binary set ops sort the *concatenation* of the two inputs once, with a
  side-flag u32 plane appended as the lowest-priority sort key: within every
  run of equal keys the A-side elements sort first, so "does this run touch
  A / touch B" reads off the run's first and last elements — no second
  membership pass.
- Fixed-shape contracts throughout (`size` static, `count` dynamic), so every
  routine is jit-compatible. Padding slots hold the KDF-order domain maximum
  (all-ones encoded words), consistent with the sorts' padding conventions.
- Equality is *bitwise under the KDF total order*, exactly like the sorts
  themselves: -0.0 and +0.0 are distinct, NaNs with different payloads are
  distinct. (numpy instead collapses NaNs in `unique` since 1.21; callers
  who want that behavior can canonicalize NaNs first.)
- 64-bit dtypes work without x64 (two u32 word planes, numpy in / numpy out),
  like everywhere else in the package.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_CONFIG, SortConfig
from .ops import hw_engine


def _as_words(x, descending: bool):
    from .api import _as_words as f
    return f(x, descending)


def _decode(words, dtype, descending: bool):
    from .api import _decode as f
    return f(words, dtype, descending)


def _neq_prev(words):
    """words[i] != words[i-1] (any plane), shape (n-1,)."""
    return functools.reduce(
        jnp.logical_or, [w[1:] != w[:-1] for w in words])


_ONES = np.uint32(0xFFFFFFFF)


def _max_pad(x, size: int, config: SortConfig):
    """(size,) array of the KDF-order-last value of x's dtype.

    All-ones encoded words decode to the value that sorts last under the
    configured order — the padding convention of every fixed-shape result in
    this module, kept even by the empty-input early returns so that padded
    outputs always sort after real values when composed downstream.
    """
    words, dtype = _as_words(x, config.descending)
    if isinstance(dtype, np.dtype) and dtype.itemsize == 8 \
            and not jax.config.jax_enable_x64:
        planes = tuple(np.full((size,), _ONES, np.uint32) for _ in words)
    else:
        planes = tuple(jnp.full((size,), _ONES, jnp.uint32) for _ in words)
    return _decode(planes, dtype, config.descending)


def _dtype_of(x):
    """Input dtype without encoding (64-bit numpy stays 64-bit)."""
    return x.dtype if isinstance(x, np.ndarray) else jnp.asarray(x).dtype


class UniqueResult(NamedTuple):
    """Fixed-shape :func:`unique` result; unrequested fields are ``None``.

    ``values`` has static length ``size``; slots past ``num_unique`` hold a
    maximal padding value. ``index``/``counts`` share that shape (padded with
    0); ``inverse`` has the input's length.
    """
    values: jax.Array
    index: Optional[jax.Array]
    inverse: Optional[jax.Array]
    counts: Optional[jax.Array]
    num_unique: jax.Array


def _unique_core(words, n: int, size: int, decode_rep,
                 return_index: bool, return_inverse: bool,
                 return_counts: bool, index_dtype) -> UniqueResult:
    """Shared run-boundary pipeline over an arbitrary composite-key tuple.

    ``words`` is the ordered word-plane tuple (highest priority first);
    ``decode_rep`` maps a same-length tuple of representative planes (one
    entry per run, padding slots all-ones) to the caller's value space —
    a dtype decode for 1-D keys, a per-column decode + stack for rows.
    """
    if return_index or return_inverse:
        from .api import _check_index_width
        _check_index_width(n, index_dtype)
        sw, perm = hw_engine.argsort_words(words, index_dtype=index_dtype)
    else:
        sw, _ = hw_engine.sort_words(words, (), stable=False)
        perm = None

    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), _neq_prev(sw)])
    num_unique = jnp.sum(is_new, dtype=jnp.int32)
    starts, = jnp.nonzero(is_new, size=size, fill_value=n)
    live = jnp.arange(size) < num_unique
    at = jnp.clip(starts, 0, n - 1)
    values = decode_rep(tuple(jnp.where(live, w[at], _ONES) for w in sw))

    index = inverse = counts = None
    if return_index:
        index = jnp.where(live, perm[at], jnp.zeros((), index_dtype))
    if return_inverse:
        run_id = (jnp.cumsum(is_new.astype(jnp.int32)) - 1).astype(jnp.uint32)
        _, (inv,) = hw_engine.sort_words(
            (perm.astype(jnp.uint32),), (run_id,), stable=True)
        inverse = inv.astype(jnp.int32)
    if return_counts:
        bounded = jnp.concatenate(
            [starts, jnp.full((1,), n, starts.dtype)])
        counts = jnp.where(live, (bounded[1:] - bounded[:-1]), 0) \
                    .astype(jnp.int32)
    return UniqueResult(values, index, inverse, counts, num_unique)


def _collapse_nans(x):
    """Map every NaN in a float array to the dtype's canonical quiet NaN.

    The ``equal_nan=True`` preprocessing: after this, all NaNs are
    bit-identical, so the bitwise KDF total order collapses them into one
    run exactly like ``np.unique``'s NaN-aware tail merge. Host numpy
    arrays canonicalize on host (keeps the no-x64 float64 plane path
    intact); everything else canonicalizes in-graph.
    """
    dt = _dtype_of(x)
    if not jnp.issubdtype(jnp.dtype(dt), jnp.floating):
        return x
    if isinstance(x, np.ndarray):
        return np.where(np.isnan(x), np.array(np.nan, x.dtype), x)
    x = jnp.asarray(x)  # lists/tuples: same conversion the sort path does
    return jnp.where(jnp.isnan(x), jnp.asarray(jnp.nan, x.dtype), x)


def unique(x, *, return_index: bool = False, return_inverse: bool = False,
           return_counts: bool = False, size: Optional[int] = None,
           axis: Optional[int] = None, equal_nan: bool = False,
           config: SortConfig = DEFAULT_CONFIG,
           index_dtype=jnp.uint32) -> UniqueResult:
    """``np.unique`` with the full flag surface, fixed-shape and jittable.

    Sorted unique values plus, on request, the first-occurrence index of
    each unique value (``index``), the per-input-element unique slot
    (``inverse``, so ``values[inverse]`` reconstructs ``x``), and run
    multiplicities (``counts``). ``config.descending`` orders the uniques
    descending (numpy is ascending-only).

    One stable rank sort when ``index``/``inverse`` are requested (the
    first-occurrence index is exactly the stable permutation's value at each
    run start), else one unstable keys-only sort. ``inverse`` is restored to
    input order by a second sort on the permutation plane — the
    inverse-permutation-as-sort trick from :func:`..extras.searchsorted`
    (scatter formulations lose to the sorter on this hardware).

    ``size`` (default ``len(x)``) must be >= the number of uniques for exact
    ``values``/``index``/``counts``; a smaller size keeps the first ``size``
    runs and, like :func:`..extras.value_counts`, folds the dropped runs'
    mass into the last kept count. ``inverse`` and ``num_unique`` are exact
    regardless of ``size``.

    ``axis=0`` (``np.unique(a, axis=0)``): unique ROWS of a 2-D array,
    lexicographically sorted (leftmost column most significant), with the
    full flag surface; ``axis=1`` dedups columns (computed on the
    transpose). Design: each column encodes to its KDF word planes and
    the row is ONE composite key of the concatenated planes — a single
    fused multi-operand sort, no void-dtype views or per-row hashing.
    Equality is bitwise under the KDF order like 1-D :func:`unique`
    (numpy's axis path instead collapses ``-0.0 == 0.0`` while keeping
    bit-identical NaN rows distinct — a void-view artifact).

    ``equal_nan=True`` collapses ALL NaNs (any payload or sign) into one
    — ``np.unique``'s default since numpy 1.24, done here by canonicalizing
    NaNs in-graph before the sort so index/inverse/counts semantics follow
    for free (``index`` is the first NaN's position, numpy-style). The
    default is ``False`` because this framework's documented contract is
    the bitwise KDF total order (distinct NaN payloads are distinct keys);
    pass ``True`` for drop-in numpy behavior on float data.
    """
    if equal_nan:
        x = _collapse_nans(x)
    if axis is not None:
        return _unique_rows(x, axis, return_index, return_inverse,
                            return_counts, size, config, index_dtype)
    if np.ndim(x) != 1:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)} "
                         f"(pass axis=0 for row-wise unique)")
    n = int(jnp.shape(x)[0])
    if size is None:
        size = n
    if n == 0:
        z32 = jnp.zeros((size,), jnp.int32)
        return UniqueResult(
            _max_pad(x, size, config),
            jnp.zeros((size,), index_dtype) if return_index else None,
            jnp.zeros((0,), jnp.int32) if return_inverse else None,
            z32 if return_counts else None,
            jnp.int32(0))

    if not (return_index or return_inverse):
        # no permutation requested: ride api.sort's full strategy dispatch
        # (counting/bitmap tiers for narrow domains) instead of the raw
        # sorter, and the shared run-boundary machinery
        from . import api
        from .extras import _sorted_boundaries
        vals, lens, k = _sorted_boundaries(api.sort(x, config=config), size)
        pad = _max_pad(x, size, config)
        if isinstance(vals, np.ndarray):
            live = np.arange(size) < int(k)
            vals = np.where(live, vals, pad)
        else:
            vals = jnp.where(jnp.arange(size) < k, vals, pad)
        return UniqueResult(vals, None, None,
                            lens if return_counts else None, k)

    words, dtype = _as_words(x, config.descending)
    return _unique_core(
        words, n, size,
        lambda reps: _decode(reps, dtype, config.descending),
        return_index, return_inverse, return_counts, index_dtype)


def _unique_rows(x, axis: int, return_index: bool, return_inverse: bool,
                 return_counts: bool, size: Optional[int],
                 config: SortConfig, index_dtype) -> UniqueResult:
    """Row-wise :func:`unique` (``axis=0``/``1``) — see its docstring."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be None, 0 or 1, got {axis}")
    if np.ndim(x) != 2:
        raise ValueError(
            f"axis={axis} needs a 2-D array, got shape {jnp.shape(x)}")
    if axis == 1:
        xt = x.T if isinstance(x, np.ndarray) else jnp.asarray(x).T
        r = _unique_rows(xt, 0, return_index, return_inverse,
                         return_counts, size, config, index_dtype)
        return UniqueResult(r.values.T, r.index, r.inverse, r.counts,
                            r.num_unique)

    n, k = (int(s) for s in jnp.shape(x))
    if size is None:
        size = n

    def stack(cols1d):
        if cols1d and isinstance(cols1d[0], np.ndarray):
            return np.stack(cols1d, axis=1)
        return jnp.stack(cols1d, axis=1) if cols1d else \
            jnp.zeros((size, 0), jnp.dtype(_dtype_of(x)))

    if n == 0 or k == 0:
        # numpy: zero columns makes every row equal (one unique when n>0).
        # num_unique stays EXACT regardless of size (the 1-D contract).
        num = jnp.int32(0 if n == 0 else 1)
        vals = stack([_max_pad(x[:, j], size, config) for j in range(k)])
        z32 = jnp.zeros((size,), jnp.int32)
        cnt = (z32.at[0].set(jnp.int32(n)) if (k == 0 and n and size)
               else z32)
        return UniqueResult(
            vals,
            jnp.zeros((size,), index_dtype) if return_index else None,
            jnp.zeros((n,), jnp.int32) if return_inverse else None,
            cnt if return_counts else None, num)

    cols = [_as_words(x[:, j] if isinstance(x, np.ndarray)
                      else jnp.asarray(x)[:, j], config.descending)
            for j in range(k)]
    dtype = cols[0][1]
    p = len(cols[0][0])  # planes per element (2 for 64-bit dtypes)
    words = tuple(w for ws, _ in cols for w in ws)

    def decode_rep(reps):
        return stack([_decode(reps[j * p:(j + 1) * p], dtype,
                              config.descending) for j in range(k)])

    return _unique_core(words, n, size, decode_rep,
                        return_index, return_inverse, return_counts,
                        index_dtype)


class UniqueValuesResult(NamedTuple):
    """numpy-2.0 ``unique_values`` plus the live count (fixed-shape needs it)."""
    values: jax.Array
    num_unique: jax.Array


class UniqueCountsResult(NamedTuple):
    values: jax.Array
    counts: jax.Array
    num_unique: jax.Array


class UniqueInverseResult(NamedTuple):
    values: jax.Array
    inverse_indices: jax.Array
    num_unique: jax.Array


class UniqueAllResult(NamedTuple):
    values: jax.Array
    indices: jax.Array
    inverse_indices: jax.Array
    counts: jax.Array
    num_unique: jax.Array


def unique_values(x, *, size: Optional[int] = None,
                  config: SortConfig = DEFAULT_CONFIG) -> UniqueValuesResult:
    """numpy-2.0 / array-API ``np.unique_values``, fixed-shape and jittable.

    Identical semantics to :func:`unique` with no flags; the result carries
    ``num_unique`` as a trailing field because the fixed-shape contract pads
    ``values`` to ``size`` (numpy returns a data-dependent shape, which jit
    cannot). Field names follow the array-API spec otherwise.
    """
    r = unique(x, size=size, config=config)
    return UniqueValuesResult(r.values, r.num_unique)


def unique_counts(x, *, size: Optional[int] = None,
                  config: SortConfig = DEFAULT_CONFIG) -> UniqueCountsResult:
    """numpy-2.0 ``np.unique_counts`` (values + multiplicities); see
    :func:`unique_values` for the fixed-shape contract."""
    r = unique(x, return_counts=True, size=size, config=config)
    return UniqueCountsResult(r.values, r.counts, r.num_unique)


def unique_inverse(x, *, size: Optional[int] = None,
                   config: SortConfig = DEFAULT_CONFIG,
                   index_dtype=jnp.uint32) -> UniqueInverseResult:
    """numpy-2.0 ``np.unique_inverse``. The inverse indices themselves are
    exact regardless of ``size``; reconstructing ``x`` as
    ``values[inverse_indices]`` additionally requires ``size >=
    num_unique`` (a truncated ``values`` drops slots the inverse still
    references). See :func:`unique_values` for the fixed-shape contract."""
    r = unique(x, return_inverse=True, size=size, config=config,
               index_dtype=index_dtype)
    return UniqueInverseResult(r.values, r.inverse, r.num_unique)


def unique_all(x, *, size: Optional[int] = None,
               config: SortConfig = DEFAULT_CONFIG,
               index_dtype=jnp.uint32) -> UniqueAllResult:
    """numpy-2.0 ``np.unique_all``: values, first-occurrence indices, inverse,
    counts — one stable rank sort serves all four (see :func:`unique`); the
    trailing ``num_unique`` interprets the fixed-shape padding."""
    r = unique(x, return_index=True, return_inverse=True, return_counts=True,
               size=size, config=config, index_dtype=index_dtype)
    return UniqueAllResult(r.values, r.index, r.inverse, r.counts,
                           r.num_unique)


def _merged_runs(a, b, config: SortConfig):
    """One fused sort of concat(a, b) with a side-flag plane.

    Returns ``(sorted_words, dtype, has_a, has_b, starts, num_runs, n)``
    where ``has_a``/``has_b`` are per-run membership masks over the first
    ``n = len(a) + len(b)`` runs (compressed, ascending-value order) and
    ``starts`` are the runs' positions in the sorted order (fill ``n``).

    The flag plane (A=0, B=1) rides as the lowest-priority sort key, so the
    first element of every run is A-side iff the run contains any A element
    and the last is B-side iff it contains any B — two boundary gathers
    replace a whole membership pass.
    """
    aw, da = _as_words(a, config.descending)
    bw, db = _as_words(b, config.descending)
    if jnp.dtype(da) != jnp.dtype(db):
        raise TypeError(
            f"set-op inputs must share a dtype, got {da} and {db}")
    na, nb = int(aw[0].shape[0]), int(bw[0].shape[0])
    n = na + nb
    flag = jnp.concatenate([jnp.zeros((na,), jnp.uint32),
                            jnp.ones((nb,), jnp.uint32)])
    words = tuple(jnp.concatenate([wa, wb]) for wa, wb in zip(aw, bw))
    out = hw_engine.sort_words(words + (flag,), (), stable=False)[0]
    sw, sflag = out[:-1], out[-1]

    neq = _neq_prev(sw)
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    is_last = jnp.concatenate([neq, jnp.ones((1,), jnp.bool_)])
    num_runs = jnp.sum(is_new, dtype=jnp.int32)
    starts, = jnp.nonzero(is_new, size=n, fill_value=n)
    ends, = jnp.nonzero(is_last, size=n, fill_value=n)
    live = jnp.arange(n) < num_runs
    has_a = live & (sflag[jnp.clip(starts, 0, n - 1)] == 0)
    has_b = live & (sflag[jnp.clip(ends, 0, n - 1)] == 1)
    return sw, da, has_a, has_b, starts, num_runs, n


def _compact_runs(sw, dtype, starts, emit, n, size, config: SortConfig):
    """Emit the runs selected by ``emit`` as a fixed-shape ``(values, count)``.

    Gathers each run's representative words at ``starts``, overwrites
    non-emitted slots with all-ones (the KDF-order domain maximum, the
    padding convention), and compacts emitted runs to the front with one
    stable 1-bit-key pairs sort — the :func:`..extras.stable_partition`
    formulation. Emitted runs are already in value order, so the stable
    compaction preserves sortedness.
    """
    at = jnp.clip(starts, 0, n - 1)
    reps = tuple(jnp.where(emit, w[at], _ONES) for w in sw)
    key = (~emit).astype(jnp.uint32)
    _, out = hw_engine.sort_words((key,), reps, stable=True)
    if size > n:  # extend with explicit padding slots
        out = tuple(jnp.concatenate([w, jnp.full((size - n,), _ONES)])
                    for w in out)
    values = _decode(tuple(w[:size] for w in out), dtype, config.descending)
    return values, jnp.sum(emit, dtype=jnp.int32)


def _binary_setop(a, b, which: str, size: Optional[int],
                  config: SortConfig):
    if np.ndim(a) != 1 or np.ndim(b) != 1:
        raise ValueError("set-op inputs must be 1-D")
    if jnp.dtype(_dtype_of(a)) != jnp.dtype(_dtype_of(b)):
        raise TypeError(f"set-op inputs must share a dtype, "
                        f"got {_dtype_of(a)} and {_dtype_of(b)}")
    na, nb = int(jnp.shape(a)[0]), int(jnp.shape(b)[0])
    default = {"union": na + nb, "intersect": min(na, nb),
               "diff": na, "xor": na + nb}[which]
    if size is None:
        size = default
    if na == 0 or nb == 0:
        # one side empty: the op degenerates to unique() of one side or to
        # an empty result — no merged sort needed
        if which == "intersect" or (na == 0 and which == "diff"):
            return _max_pad(a, size, config), jnp.int32(0)
        keep = a if nb == 0 else b
        if int(jnp.shape(keep)[0]) == 0:
            return _max_pad(keep, size, config), jnp.int32(0)
        u = unique(keep, size=size, config=config)
        return u.values, u.num_unique

    sw, dtype, has_a, has_b, starts, _, n = _merged_runs(a, b, config)
    emit = {"union": has_a | has_b,
            "intersect": has_a & has_b,
            "diff": has_a & ~has_b,
            "xor": has_a ^ has_b}[which]
    return _compact_runs(sw, dtype, starts, emit, n, size, config)


def union1d(a, b, *, size: Optional[int] = None,
            config: SortConfig = DEFAULT_CONFIG):
    """Sorted union of two arrays: fixed-shape ``(values, count)``.

    ``values`` has static length ``size`` (default ``len(a) + len(b)``, the
    exact-result bound); slots past ``count`` hold a maximal padding value.
    ``count`` is always the exact result cardinality: with a ``size`` below
    it, ``values`` keeps only the first ``size`` results (the order-first
    ones) — index with ``min(count, size)``, like :func:`unique`'s
    ``num_unique``. Same contract for all four set ops.
    """
    return _binary_setop(a, b, "union", size, config)


def intersect1d(a, b, *, assume_unique: bool = False,
                return_indices: bool = False,
                size: Optional[int] = None,
                config: SortConfig = DEFAULT_CONFIG):
    """Sorted intersection (values present in both): ``(values, count)``.

    ``size`` defaults to ``min(len(a), len(b))``, the exact-result bound;
    count/truncation contract as :func:`union1d`.

    ``assume_unique`` is accepted for numpy-signature parity and ignored:
    numpy uses it to skip its pre-`unique` passes, but the fused
    merged-runs sort here is duplicate-correct at no extra cost (and
    unlike numpy, passing it with non-unique inputs stays well-defined).

    ``return_indices=True`` (``np.intersect1d``) additionally returns the
    FIRST-occurrence positions of each common value in ``a`` and in ``b``:
    ``(values, comm1, comm2, count)``, int32 indices, slots past ``count``
    padded with ``len(a)`` / ``len(b)``. Design: the original position
    rides the fused sort as the lowest-priority composite key (after the
    side flag), so within every equal-value run the first A element sits at
    the run start and the first B element at ``start + (A count in run)``
    — one prefix sum over the flag plane, run-granular gathers only, no
    per-element search.
    """
    if not return_indices:
        return _binary_setop(a, b, "intersect", size, config)

    if np.ndim(a) != 1 or np.ndim(b) != 1:
        raise ValueError("set-op inputs must be 1-D")
    aw, da = _as_words(a, config.descending)
    bw, db = _as_words(b, config.descending)
    if jnp.dtype(da) != jnp.dtype(db):
        raise TypeError(
            f"set-op inputs must share a dtype, got {da} and {db}")
    na, nb = int(aw[0].shape[0]), int(bw[0].shape[0])
    n = na + nb
    if size is None:
        size = min(na, nb)
    if na == 0 or nb == 0:
        return (_max_pad(a if na else b, size, config),
                jnp.full((size,), na, jnp.int32),
                jnp.full((size,), nb, jnp.int32), jnp.int32(0))

    flag = jnp.concatenate([jnp.zeros((na,), jnp.uint32),
                            jnp.ones((nb,), jnp.uint32)])
    idx = jnp.concatenate([jnp.arange(na, dtype=jnp.uint32),
                           jnp.arange(nb, dtype=jnp.uint32)])
    words = tuple(jnp.concatenate([wa, wb]) for wa, wb in zip(aw, bw))
    out = hw_engine.sort_words(words + (flag, idx), (), stable=False)[0]
    sw, sflag, sidx = out[:-2], out[-2], out[-1]

    neq = _neq_prev(sw)
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    is_last = jnp.concatenate([neq, jnp.ones((1,), jnp.bool_)])
    num_runs = jnp.sum(is_new, dtype=jnp.int32)
    starts, = jnp.nonzero(is_new, size=n, fill_value=n)
    ends, = jnp.nonzero(is_last, size=n, fill_value=n)
    at_s = jnp.clip(starts, 0, n - 1)
    at_e = jnp.clip(ends, 0, n - 1)
    live = jnp.arange(n) < num_runs
    emit = live & (sflag[at_s] == 0) & (sflag[at_e] == 1)

    # first B element of a run = run start + (A elements in the run):
    # cum_a[i] = count of A-side elements in sorted positions [0, i)
    cum_a = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             jnp.cumsum((sflag == 0).astype(jnp.int32))])
    count_a = cum_a[jnp.clip(ends + 1, 0, n)] - cum_a[at_s]
    at_b = jnp.clip(starts + count_a, 0, n - 1)

    comm1 = jnp.where(emit, sidx[at_s], np.uint32(na))
    comm2 = jnp.where(emit, sidx[at_b], np.uint32(nb))
    reps = tuple(jnp.where(emit, w[at_s], _ONES) for w in sw)
    key = (~emit).astype(jnp.uint32)
    _, packed = hw_engine.sort_words((key,), reps + (comm1, comm2),
                                     stable=True)
    vals, comm1, comm2 = packed[:-2], packed[-2], packed[-1]
    if size > n:
        vals = tuple(jnp.concatenate([w, jnp.full((size - n,), _ONES)])
                     for w in vals)
        comm1 = jnp.concatenate(
            [comm1, jnp.full((size - n,), na, jnp.uint32)])
        comm2 = jnp.concatenate(
            [comm2, jnp.full((size - n,), nb, jnp.uint32)])
    values = _decode(tuple(w[:size] for w in vals), da, config.descending)
    return (values, comm1[:size].astype(jnp.int32),
            comm2[:size].astype(jnp.int32), jnp.sum(emit, dtype=jnp.int32))


def setdiff1d(a, b, *, size: Optional[int] = None,
              config: SortConfig = DEFAULT_CONFIG):
    """Sorted values of ``a`` not present in ``b``: ``(values, count)``.

    ``size`` defaults to ``len(a)``, the exact-result bound;
    count/truncation contract as :func:`union1d`.
    """
    return _binary_setop(a, b, "diff", size, config)


def setxor1d(a, b, *, size: Optional[int] = None,
             config: SortConfig = DEFAULT_CONFIG):
    """Sorted values present in exactly one input: ``(values, count)``.

    ``size`` defaults to ``len(a) + len(b)``, the exact-result bound;
    count/truncation contract as :func:`union1d`.
    """
    return _binary_setop(a, b, "xor", size, config)


def isin(element, test, *, assume_unique: bool = False,
         invert: bool = False, config: SortConfig = DEFAULT_CONFIG):
    """Per-element membership of ``element`` in ``test`` (``np.isin``, 1-D).

    Membership is bitwise under the KDF total order (a NaN query matches
    only a bit-identical NaN). Returns a bool array of ``len(element)``;
    ``invert=True`` negates it in-graph (``np.isin``'s kwarg).
    ``assume_unique`` is accepted for signature compatibility and ignored:
    the two-sort prefix-algebra formulation is already duplicate-oblivious,
    so the hint buys nothing here (numpy uses it to skip a dedup pass).

    Design: TWO fused sorts total, no gathers. Sort 1 orders the tagged
    concatenation by ``(value, index)`` with test indices in ``[0, n)`` and
    query indices in ``[n, n+q)`` — one fused plane carries both the
    tie-break (tests sort before queries within an equal-value run) and the
    identity for the restore. Membership then falls out of pure prefix
    algebra: with ``T`` the running count of test elements and ``U`` the
    value of ``T`` just before each run's start (a cummax carries it across
    the run, valid because ``T`` is non-decreasing), a query is a member iff
    ``T > U`` at its position — every test in its run precedes it. Sort 2
    restores input order (the inverse-permutation-as-sort trick). Compare:
    membership via two :func:`..extras.searchsorted` passes costs 3 sorts
    for 32-bit keys and 5 for two-word 64-bit keys.
    """
    if np.ndim(element) != 1 or np.ndim(test) != 1:
        raise ValueError("isin inputs must be 1-D")
    if jnp.dtype(_dtype_of(element)) != jnp.dtype(_dtype_of(test)):
        raise TypeError(f"isin inputs must share a dtype, got "
                        f"{_dtype_of(element)} and {_dtype_of(test)}")
    del assume_unique  # duplicate-oblivious formulation; hint not needed
    q = int(jnp.shape(element)[0])
    n = int(jnp.shape(test)[0])
    if q == 0:
        return jnp.zeros((0,), jnp.bool_)
    if n == 0:
        return jnp.full((q,), invert, jnp.bool_)
    ew, _ = _as_words(element, config.descending)
    tw, _ = _as_words(test, config.descending)
    words = tuple(jnp.concatenate([t, e]) for t, e in zip(tw, ew))
    idx = jnp.arange(n + q, dtype=jnp.uint32)
    out = hw_engine.sort_words(words + (idx,), (), stable=False)[0]
    sw, sidx = out[:-1], out[-1]

    is_test = (sidx < n).astype(jnp.int32)
    T = jnp.cumsum(is_test)
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), _neq_prev(sw)])
    t_before = jnp.concatenate([jnp.zeros((1,), T.dtype), T[:-1]])
    U = jax.lax.cummax(jnp.where(is_new, t_before, 0), axis=0)
    member = (T <= U) if invert else (T > U)
    _, (restored,) = hw_engine.sort_words((sidx,), (member,), stable=True)
    return restored[n:]


def in1d(ar1, ar2, *, assume_unique: bool = False, invert: bool = False,
         config: SortConfig = DEFAULT_CONFIG):
    """Legacy ``np.in1d`` spelling of :func:`isin` (numpy < 2.0 callers)."""
    return isin(ar1, ar2, assume_unique=assume_unique, invert=invert,
                config=config)
