"""Order-statistics and ranking operations built on the sort engines.

The statistical face of the framework: tie-aware rank transforms
(``scipy.stats.rankdata``), exact quantiles (``np.quantile`` /
``np.percentile`` / ``np.median``), value binning (``np.digitize`` /
``np.histogram``), and the numpy partition pair. None of these exist in the
reference (its scope stops at the sort itself — `README.md:1-40`), but every
one is a thin theorem over a sorted order, and the reference's own rank sort
(`radix_sort_rank.hpp:22-92`) is the primitive they generalize.

Design notes shared by the module:

- Everything reduces to the framework's derived-key sorts plus dense prefix
  algebra (cumsum / cummax / boundary flags). No per-element gather
  formulations except O(#quantiles)- and O(#bins)-sized takes.
- Rank restoration to input order is ONE unstable composite sort with the
  permutation as the leading (unique) key.
- Float orderings are the KDF total order: -0.0 < +0.0, NaNs sort above
  +inf with payload order. numpy's NaN-propagating quantile semantics are
  NOT replicated — filter NaNs first if you need them (documented per-op).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .api import _as_words, _check_index_width, _decode
from .config import DEFAULT_CONFIG, SortConfig
from .ops import hw_engine

__all__ = ["rankdata", "quantile", "percentile", "median", "mode", "digitize",
           "histogram", "histogram_bin_edges", "partition", "argpartition"]

_RANK_METHODS = ("average", "min", "max", "dense", "ordinal")


def rankdata(x, *, method: str = "average",
             config: SortConfig = DEFAULT_CONFIG):
    """Tie-aware ranks of ``x`` (``scipy.stats.rankdata``), 1-based.

    ``method`` resolves ties exactly as scipy's: ``'average'`` assigns the
    mean of the tied positions, ``'min'``/``'max'`` the first/last,
    ``'dense'`` consecutive group numbers, ``'ordinal'`` distinct ranks with
    ties broken by input position (the stable rank-sort order — the
    reference's `radix_sort_rank.hpp` semantics, inverted). Ranking order
    follows ``config.descending``; ties group bitwise under the KDF total
    order (distinct NaN payloads are distinct values).

    Returns int32 ranks, except ``'average'`` which returns float32 (exact
    while ranks stay below 2^23; scipy returns float64 — cast host-side if
    you need the wider carrier). Accepts every supported key dtype,
    including 64-bit numpy inputs without x64.

    Design: one stable argsort (index-as-last-key composite), dense
    boundary algebra in sorted order (run starts via cummax of flagged
    positions, run ends via the same scan on the reversed array — no
    gathers), then one unstable composite sort restores input order with
    the unique permutation as the leading key.
    """
    if method not in _RANK_METHODS:
        raise ValueError(f"method must be one of {_RANK_METHODS}, got {method!r}")
    words, _ = _as_words(x, config.descending)
    n = int(words[0].shape[0])
    if n == 0:
        d = jnp.float32 if method == "average" else jnp.int32
        return jnp.zeros((0,), d)
    _check_index_width(n, jnp.uint32)
    sw, perm = hw_engine.argsort_words(tuple(words))

    neq = sw[0][1:] != sw[0][:-1]
    for w in sw[1:]:
        neq = neq | (w[1:] != w[:-1])
    i = jnp.arange(n, dtype=jnp.int32)
    if method == "ordinal":
        num = 2 * i + 2  # rank numerators: 2*rank, halved on the way out
    elif method == "dense":
        is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
        num = 2 * jnp.cumsum(is_new.astype(jnp.int32))
    else:
        is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
        # Per-element run START: positions are increasing, so a running max
        # of (is_new ? position : 0) is exactly the latest run start.
        starts = jax.lax.cummax(jnp.where(is_new, i, 0))
        if method == "min":
            num = 2 * starts + 2
        else:
            # Per-element run END: the same scan over the reversed array —
            # a run's end is the first is_last at-or-after each position.
            is_last = jnp.concatenate([neq, jnp.ones((1,), jnp.bool_)])
            g = jax.lax.cummax(jnp.where(jnp.flip(is_last), i, 0))
            ends = (n - 1) - jnp.flip(g)
            if method == "max":
                num = 2 * ends + 2
            else:  # average: exact integer numerator, halved after restore
                num = starts + ends + 2

    # Restore input order: perm is a unique u32 key, so the unstable
    # composite sort with num as the trailing key is exact and fastest.
    out, _ = hw_engine.sort_words((perm, num.astype(jnp.uint32)), (),
                                  stable=False)
    num = out[1].astype(jnp.int32)
    if method == "average":
        return num.astype(jnp.float32) * jnp.float32(0.5)
    return num // 2


_Q_METHODS = ("linear", "lower", "higher", "nearest", "midpoint")


def _quantile_positions(qs, n: int, method: str):
    """(lo_idx, hi_idx, frac) int64/float64 take positions for quantiles
    ``qs`` over ``n`` sorted elements — shared with the distributed form."""
    h = qs * (n - 1)
    lo_i = np.floor(h).astype(np.int64)
    hi_i = np.ceil(h).astype(np.int64)
    frac = h - lo_i
    if method == "lower":
        hi_i = lo_i
    elif method == "higher":
        lo_i = hi_i
    elif method == "nearest":
        # numpy rounds half to the EVEN neighbouring index
        lo_i = hi_i = np.rint(h).astype(np.int64)
    return lo_i, hi_i, frac


def _quantile_combine(lo, hi, frac, method: str):
    """Interpolate gathered (lo, hi) order statistics. numpy arrays combine
    in float64 with numpy's own ``_lerp`` rounding form (bit-for-bit parity
    on the host path); device arrays combine in float32."""
    if method in ("lower", "higher", "nearest"):
        return lo
    if isinstance(lo, np.ndarray):
        a, b = lo.astype(np.float64), hi.astype(np.float64)
        if method == "midpoint":
            return a * 0.5 + b * 0.5
        t = frac
        return np.where(t >= 0.5, b - (b - a) * (1.0 - t), a + (b - a) * t)
    if method == "midpoint":
        return (lo.astype(jnp.float32) + hi.astype(jnp.float32)) * jnp.float32(0.5)
    f = jnp.asarray(frac, jnp.float32)
    one = jnp.float32(1.0)
    return lo.astype(jnp.float32) * (one - f) + hi.astype(jnp.float32) * f


def quantile(x, q, *, method: str = "linear",
             config: SortConfig = DEFAULT_CONFIG):
    """Exact quantiles of ``x`` at static probabilities ``q`` (``np.quantile``).

    ``q`` is a Python float or sequence of floats in [0, 1] (STATIC — the
    take positions are compile-time constants). ``method`` is numpy's
    ``'linear'`` (default) / ``'lower'`` / ``'higher'`` / ``'nearest'`` /
    ``'midpoint'``. Returns a scalar for scalar ``q``, else a (len(q),)
    array: the INPUT dtype for the exact methods (numpy promotes integers
    to float64 even there; keeping the input dtype is lossless and stays
    device-native), float32 for the interpolating ones (float64 end-to-end
    for 64-bit numpy inputs, which sort host-side without x64).

    NaN semantics differ from numpy: NaNs sort above +inf under the KDF
    order and are simply the top order statistics, where numpy propagates
    NaN to every quantile. Filter NaNs first (``x[~isnan(x)]``) for numpy's
    behavior — on this framework that is one sort either way.

    Design: the selection is the full strategy-dispatched sort; the
    per-quantile cost after the sort is two static takes and a lerp. The
    distributed counterpart that avoids the full sort is
    :func:`..parallel.distributed_select`.
    """
    from . import api

    if method not in _Q_METHODS:
        raise ValueError(f"method must be one of {_Q_METHODS}, got {method!r}")
    scalar = np.ndim(q) == 0
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if qs.ndim != 1:
        raise ValueError(f"q must be a scalar or 1-D sequence, got shape {qs.shape}")
    if qs.size and (np.min(qs) < 0.0 or np.max(qs) > 1.0):
        raise ValueError("quantile probabilities must lie in [0, 1]")
    n = int(jnp.shape(x)[0]) if np.ndim(x) == 1 else -1
    if n < 0:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    if n == 0:
        raise ValueError("quantile of an empty array is undefined")

    s = api.sort(x, config=config)
    lo_i, hi_i, frac = _quantile_positions(qs, n, method)
    if isinstance(s, np.ndarray):  # 64-bit numpy path: exact f64 host math
        out = _quantile_combine(s[lo_i], s[hi_i], frac, method)
    else:
        out = _quantile_combine(s[jnp.asarray(lo_i, jnp.int32)],
                                s[jnp.asarray(hi_i, jnp.int32)], frac, method)
    return out[0] if scalar else out


def percentile(x, q, *, method: str = "linear",
               config: SortConfig = DEFAULT_CONFIG):
    """``np.percentile``: :func:`quantile` at ``q / 100``."""
    return quantile(x, np.asarray(q, np.float64) / 100.0 if np.ndim(q)
                    else float(q) / 100.0, method=method, config=config)


def median(x, *, config: SortConfig = DEFAULT_CONFIG):
    """``np.median``: the linear-interpolated 0.5 quantile (see
    :func:`quantile` for dtype and NaN semantics)."""
    return quantile(x, 0.5, config=config)


def digitize(x, bins, *, right: bool = False,
             descending: Optional[bool] = None):
    """Bin index of each value against monotonic ``bins`` (``np.digitize``).

    For increasing bins: index ``i`` satisfies ``bins[i-1] <= x < bins[i]``
    (``right=True`` flips to ``bins[i-1] < x <= bins[i]``); decreasing bins
    reverse both inequalities, numpy-identically. The mapping is one
    :func:`..extras.searchsorted` call — numpy's own equivalence — with the
    equal-value side ``'right'`` exactly when ``right == descending``
    (ascending ``right=False`` counts bins <= x, so equals count; the
    decreasing form counts bins strictly > x, so they don't — the side
    flips with the order).

    ``descending`` selects the bin order; ``None`` auto-detects from
    concrete bins host-side (one comparison of the end values) and defaults
    to increasing for traced bins — pass it explicitly under ``jit``.
    Monotonicity itself is a precondition, unverified (numpy checks only
    the endpoints too).
    """
    from .extras import searchsorted

    if descending is None:
        descending = False
        nb = int(jnp.shape(bins)[0]) if np.ndim(bins) == 1 else -1
        if nb < 0:
            raise ValueError(f"bins must be 1-D, got shape {jnp.shape(bins)}")
        if nb >= 2 and not isinstance(bins, jax.core.Tracer):
            b = np.asarray(bins) if isinstance(bins, np.ndarray) else bins
            descending = bool(b[0] > b[nb - 1])
    cfg = SortConfig(descending=bool(descending))
    side = "right" if bool(right) == bool(descending) else "left"
    return searchsorted(bins, x, side=side, config=cfg)


def histogram_bin_edges(x, bins: int = 10,
                        range: Optional[Tuple[float, float]] = None):
    """Uniform bin edges for :func:`histogram` (``np.histogram_bin_edges``
    for integer ``bins``). Without ``range`` the data min/max is taken —
    one device reduce + host sync; pass ``range`` to stay sync-free."""
    if bins <= 0:
        raise ValueError(f"bins must be positive, got {bins}")
    if range is None:
        xa = jnp.asarray(x)
        if int(xa.shape[0]) == 0:
            lo, hi = 0.0, 1.0
        else:
            lo = float(jnp.min(xa))
            hi = float(jnp.max(xa))
    else:
        lo, hi = float(range[0]), float(range[1])
        if not lo <= hi:
            raise ValueError(f"range must be increasing, got {(lo, hi)}")
    if lo == hi:  # numpy widens a degenerate range by ±0.5
        lo, hi = lo - 0.5, hi + 0.5
    return np.linspace(lo, hi, bins + 1)


def histogram(x, bins: Union[int, Sequence] = 10,
              range: Optional[Tuple[float, float]] = None,
              weights=None, density: bool = False):
    """``np.histogram``: counts (or weighted sums) per bin, plus the edges.

    ``bins`` is an int (uniform edges over ``range`` or the data extent —
    see :func:`histogram_bin_edges` for the sync note) or an explicit
    increasing edge array. Values outside the edges are dropped (numpy
    semantics); the last bin is closed on the right. Returns
    ``(counts, edges)`` — int32 counts, float32 weighted sums (f32
    accumulation: magnitudes past 2^24 round), density in the widest
    device float (f64 under x64, else f32).

    Precision contract: binning is float32 (the device-native float — the
    inputs are typically f32 themselves). Uniform bins use f32 edge
    arithmetic ``floor((x - lo) * scale)``: a value within ~1 f32 ulp of
    an interior edge may land one bin off numpy's float64 arithmetic —
    below the input's own quantization noise, but visible to bit-exact
    count comparisons on large arrays. Edge-ARRAY bins use pure
    comparisons against the f32-cast edges, which match numpy bit-for-bit
    whenever the edges are f32-representable.

    Uniform bins take the arithmetic bin index (one fused elementwise pass
    — no search at all); edge arrays take one :func:`..extras.searchsorted`.
    Unweighted counts ride :func:`..extras.bincount`; weighted sums are one
    f32 scatter-add per bin (direct per-bin sums: *tighter* f32 error than a
    whole-array cumsum; GPU atomics add in a run-dependent order, so the
    last bits can change between runs). Non-finite weights poison their
    bin.
    """
    from .extras import _dense_counts_sums, bincount

    xa = jnp.asarray(x)
    if xa.ndim != 1:
        raise ValueError(f"histogram input must be 1-D, got shape {xa.shape}")
    n = int(xa.shape[0])
    if isinstance(bins, (int, np.integer)):
        edges = histogram_bin_edges(xa, int(bins), range)
        nb = int(bins)
        xf = xa.astype(jnp.float32)
        lo = jnp.float32(edges[0])
        scale = jnp.float32(nb / (edges[-1] - edges[0]))
        idx = jnp.floor((xf - lo) * scale).astype(jnp.int32)
        # close the last bin on the right; spill everything outside [lo, hi]
        # (including NaN, which fails both comparisons) to a drop bin
        idx = jnp.where(idx == nb, nb - 1, idx)
        in_range = (xf >= edges[0]) & (xf <= edges[-1])
        idx = jnp.where(in_range, idx, nb)
    else:
        edges = np.asarray(bins, np.float64)
        if edges.ndim != 1 or edges.shape[0] < 2:
            raise ValueError("bin edges must be a 1-D array of length >= 2")
        if np.any(edges[1:] < edges[:-1]):
            raise ValueError("bin edges must be increasing")
        nb = edges.shape[0] - 1
        xf = xa.astype(jnp.float32)
        pos = digitize(xf, jnp.asarray(edges, jnp.float32), descending=False)
        idx = pos.astype(jnp.int32) - 1
        last = jnp.float32(edges[-1])
        idx = jnp.where(xf == last, nb - 1, idx)  # right-closed last bin
        # pos == 0 means strictly below edges[0] (side='right' counts equals)
        oob = (pos == 0) | (xf > last) | jnp.isnan(xf)
        idx = jnp.where(oob, nb, idx)

    if weights is None:
        counts = bincount(idx.astype(jnp.uint32), length=nb + 1)[:nb]
    elif n == 0:
        counts = jnp.zeros((nb,), jnp.float32)
    else:
        w = jnp.asarray(weights)
        if w.shape != xa.shape:
            raise ValueError("weights must match the input's shape")
        # idx == nb is the drop bin: out of [0, nb), so the scatter drops it
        _, counts = _dense_counts_sums(idx.astype(jnp.uint32),
                                       w.astype(jnp.float32), nb)
    if density:
        dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        widths = jnp.asarray(np.diff(edges), dt)
        total = jnp.sum(counts).astype(dt)
        return counts.astype(dt) / (total * widths), edges
    return counts, edges


def mode(x, *, config: SortConfig = DEFAULT_CONFIG):
    """Most frequent value and its count (``scipy.stats.mode`` semantics:
    ties resolve to the smallest value). One run-length encode
    (:func:`..extras.value_counts` — a single sort + boundary differencing);
    the winning run is ``argmax`` over the counts, which lands on the
    smallest tied value because the runs are value-sorted. Returns
    ``(mode_value, count)`` — both 0-d (count int32)."""
    from .extras import value_counts

    n = int(jnp.shape(x)[0]) if np.ndim(x) == 1 else -1
    if n < 0:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    if n == 0:
        raise ValueError("mode of an empty array is undefined")
    vals, counts, _ = value_counts(x, config=config)
    win = jnp.argmax(counts)  # first max = smallest value (runs sorted)
    if isinstance(vals, np.ndarray):  # 64-bit numpy path
        w = int(win)
        return vals[w], np.int32(counts[w])
    return vals[win], counts[win].astype(jnp.int32)


def partition(x, kth, *, config: SortConfig = DEFAULT_CONFIG):
    """``np.partition``: every element before ``kth`` is <= every element
    after, with the kth element in its sorted place.

    Design decision: the result is the FULLY SORTED array — the strongest
    ordering satisfying the contract; one library sort. ``kth`` (int or
    ints, numpy-style) is validated against [0, n) and otherwise unused.
    """
    n = int(jnp.shape(x)[0]) if np.ndim(x) == 1 else -1
    if n < 0:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    for k in np.atleast_1d(np.asarray(kth, np.int64)):
        if not -n <= k < n:
            raise ValueError(f"kth {int(k)} out of range for {n} elements")
    from . import api
    return api.sort(x, config=config)


def argpartition(x, kth, *, config: SortConfig = DEFAULT_CONFIG,
                 index_dtype=jnp.uint32):
    """``np.argpartition``: index form of :func:`partition` — returns the
    full stable argsort permutation (see :func:`partition` for why the
    complete sort is the right engine here)."""
    n = int(jnp.shape(x)[0]) if np.ndim(x) == 1 else -1
    if n < 0:
        raise ValueError(f"keys must be 1-D, got shape {jnp.shape(x)}")
    for k in np.atleast_1d(np.asarray(kth, np.int64)):
        if not -n <= k < n:
            raise ValueError(f"kth {int(k)} out of range for {n} elements")
    from . import api
    return api.argsort(x, config=config, index_dtype=index_dtype)
