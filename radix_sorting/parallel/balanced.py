"""Balanced distributed sort: exact-quantile partition + bounded-memory exchange.

The single-collective shuffle (:mod:`.shuffle`) partitions on top-digit
buckets, so adversarial skew can overload a device past its exchange capacity
— detected, never silent, but the recovery (``exact=True``) costs D-fold
exchange memory. This module is the principled fix (ROADMAP "multi-round
exchange" item): a partition that is *perfectly balanced by construction* for
every input distribution, paired with a chunked multi-round exchange whose
transient memory is O(n/D) per device no matter how skewed the data is.

Design (SPMD over a 1-D mesh, one `shard_map`):

1. **Strict composite order.** Partitioning happens on a composite key that is
   globally *strict*: the sort-key planes followed by a tiebreak plane (the
   global index for rank/record sorts, which already ride one; a synthetic
   global-slot plane — never shipped — for keys-only sorts). Strictness is
   what makes exact balance possible: equal keys are split *by count* across
   the boundary devices, the distributed generalization of the reference's
   stable within-bucket order (`counting_sort_8s.c:23-34`). All-equal and
   two-value degenerate inputs need no special casing at all.

2. **Exact quantile selection** (distributed k-th smallest): the splitter for
   device d is the composite of global rank d*(n/D), found by a bitwise
   binary search over the composite's bit-string — the greedy invariant
   "largest v with #{x < v} <= target" — with one `psum` per bit. Counting
   #{x < v} is a vectorized lower-bound binary search on the locally sorted
   shard, so each of the 32*planes rounds costs O(D log n_local) scalar work
   plus one (D-1,)-wide `psum`. Unlike sampling-based splitters there is no
   distribution assumption and no failure mode: every device receives
   *exactly* n/D keys.

3. **Multi-round chunked all-to-all.** Each device's outgoing keys for a
   destination form one contiguous run of its sorted shard. Runs ship in
   chunks of ``chunk`` keys per peer per round (`lax.fori_loop` over
   ceil(max_run/chunk) rounds, a replicated value), so the transient exchange
   buffer is D*chunk instead of the worst-case D*n_local. Receivers place
   each source's chunks at precomputed offsets (from one counts all-to-all);
   a final local sort of the accumulator restores order. Total per-device
   memory: n/D keys received (exact) + D*chunk transient — bounded for any
   input, with zero overflow paths.

The result contract matches :mod:`.shuffle` (padded shards + counts +
overflow), but ``counts`` is *static* — device d holds global ranks
[d*ceil(n/D), (d+1)*ceil(n/D)) by construction — and ``overflow`` is
identically zero.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

__all__ = [
    "distributed_sort_balanced",
    "distributed_argsort_balanced",
    "distributed_sort_pairs_balanced",
    "distributed_sort_balanced_u32",
    "distributed_argsort_balanced_u32",
    "distributed_sort_pairs_balanced_u32",
    "distributed_select",
    "distributed_unique_sorted",
    "distributed_group_reduce",
]

from ..ops.probes import word_lt

_SENTINEL = np.uint32(0xFFFFFFFF)


def _lower_bound(sorted_planes, piv_planes, n_local: int) -> jax.Array:
    """#{elements < pivot} for each pivot, via binary search on the sorted shard.

    sorted_planes: tuple of (n_local,) u32, ascending in composite order.
    piv_planes: tuple of (Q,) u32. Returns (Q,) int32 in [0, n_local].
    """
    q = piv_planes[0].shape[0]
    steps = max(1, int(n_local).bit_length())
    lo = jnp.zeros((q,), jnp.int32)
    hi = jnp.full((q,), n_local, jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        elem = tuple(jnp.take(p, jnp.clip(mid, 0, n_local - 1)) for p in sorted_planes)
        less = word_lt(elem, piv_planes)  # element < pivot -> answer right of mid
        active = lo < hi
        lo2 = jnp.where(active & less, mid + 1, lo)
        hi2 = jnp.where(active & ~less, mid, hi)
        return lo2, hi2

    lo, _ = lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def _select_pivots(part_sorted, targets, axis_name, n_local: int):
    """Exact global-rank selection: pivot[q] = composite of global rank targets[q].

    Greedy MSB-first over the concatenated planes, TWO bits per round: with
    count_less monotone in the trial value, the passing candidates among
    {acc|1<<p, acc|2<<p, acc|3<<p} form a prefix, so one batched
    lower-bound + one psum decides both bits — 16 scalar-latency collectives
    per plane instead of 32 (the psum chain dominates selection latency
    across devices). Composites are strict (distinct), so the greedy maximum IS
    the element at that rank.
    """
    npp = len(part_sorted)
    q = targets.shape[0]
    fixed = []
    for plane_i in range(npp):
        zeros_after = tuple(jnp.zeros((3 * q,), jnp.uint32)
                            for _ in range(npp - plane_i - 1))
        fixed3 = tuple(jnp.tile(f, 3) for f in fixed)
        targets3 = jnp.tile(targets, 3)
        cand = jnp.repeat(jnp.arange(1, 4, dtype=jnp.uint32), q)  # (3q,)

        def pair_body(i, acc, _fixed3=fixed3, _after=zeros_after, _cand=cand,
                      _t3=targets3):
            pos = (jnp.int32(30) - 2 * i).astype(jnp.uint32)
            trial_pl = jnp.tile(acc, 3) | (_cand << pos)
            trial = _fixed3 + (trial_pl,) + _after
            cnt = _lower_bound(part_sorted, trial, n_local)
            gcnt = lax.psum(cnt, axis_name)
            # number of passing candidates = the largest passing value (prefix)
            m = jnp.sum((gcnt <= _t3).astype(jnp.uint32).reshape(3, q), axis=0)
            return acc | (m << pos)

        fixed.append(lax.fori_loop(0, 16, pair_body, jnp.zeros((q,), jnp.uint32)))
    return tuple(fixed)


def _balanced_body(planes, axis_name, num_devices, num_key_planes, strict,
                   chunk, n_local, overlap=False):
    """Per-shard SPMD body. planes = key planes (MSW first) + payload planes.

    strict=True means the key planes alone form a strict total order (rank and
    record sorts carry the global-index plane); otherwise a synthetic
    global-slot plane joins the local sort and the partition but is not
    shipped.

    overlap=True double-buffers the multi-round exchange: iteration r places
    round r's received chunks while the all_to_all for round r+1 is already
    in flight (the collective depends only on the sorted shard and the round
    index, never on the accumulator, so the scheduler is free to run them
    concurrently — SURVEY §7 hard part #3). Costs one extra (empty,
    sentinel-only) exchange round of traffic; result-identical.
    """
    D = num_devices
    c = chunk
    my_dev = lax.axis_index(axis_name)

    # 1. local sort by the strict composite; payload rides along
    if strict:
        sorted_all = lax.sort(planes, dimension=0, is_stable=False,
                              num_keys=num_key_planes)
        part_sorted = sorted_all[:num_key_planes]
        shipped = sorted_all
    else:
        gslot = (my_dev.astype(jnp.uint32) * np.uint32(n_local)
                 + lax.broadcasted_iota(jnp.uint32, (n_local,), 0))
        ops = planes[:num_key_planes] + (gslot,) + planes[num_key_planes:]
        sorted_all = lax.sort(ops, dimension=0, is_stable=False,
                              num_keys=num_key_planes + 1)
        part_sorted = sorted_all[: num_key_planes + 1]
        shipped = sorted_all[:num_key_planes] + sorted_all[num_key_planes + 1:]
    nship = len(shipped)

    # 2. exact quantile pivots at global ranks d*n_local, d = 1..D-1
    targets = jnp.arange(1, D, dtype=jnp.int32) * n_local
    piv = _select_pivots(part_sorted, targets, axis_name, n_local)

    # 3. contiguous outgoing runs per destination
    starts_mid = _lower_bound(part_sorted, piv, n_local)
    starts = jnp.concatenate([
        jnp.zeros((1,), jnp.int32), starts_mid, jnp.full((1,), n_local, jnp.int32)
    ])
    out_starts = starts[:-1]
    out_counts = starts[1:] - starts[:-1]  # (D,), sums to n_local

    # 4. receive bookkeeping: one counts all-to-all tells every device how
    # much arrives from each source. The composite is strict everywhere
    # (including pad rows — `_run_balanced` pads the tiebreak plane with
    # distinct values), so sum(recv_total) == n_local exactly; rounding each
    # source up to whole chunks gives sum(padded) <= n_local + D*(c-1), and
    # the accumulator A = n_local + (D+1)*c places the dustbin at
    # A - c = n_local + D*c >= sum(padded), with >= D slack elements.
    recv_total = lax.all_to_all(out_counts, axis_name, split_axis=0,
                                concat_axis=0, tiled=True)
    rounds_from = (recv_total + c - 1) // c
    padded = rounds_from * c
    acc_start = jnp.cumsum(padded) - padded
    A = n_local + (D + 1) * c  # >= sum(padded) + dustbin chunk (see above)
    dustbin = A - c
    acc0 = tuple(jnp.full((A,), _SENTINEL) for _ in range(nship))

    gmax = lax.pmax(jnp.max(out_counts), axis_name)
    num_rounds = (gmax + c - 1) // c
    j = jnp.arange(c, dtype=jnp.int32)

    def exchange_round(r):
        """Gather + all_to_all round r's chunks. Depends only on the sorted
        shard and r — never on the accumulator — which is what lets the
        overlap mode run it concurrently with placement."""
        this_count = jnp.clip(out_counts - r * c, 0, c)              # (D,)
        idx = jnp.clip(out_starts[:, None] + r * c + j[None, :], 0, n_local - 1)
        valid = j[None, :] < this_count[:, None]
        send = jnp.stack([jnp.where(valid, jnp.take(p, idx), _SENTINEL)
                          for p in shipped])                         # (P, D, c)
        return lax.all_to_all(send, axis_name, split_axis=1, concat_axis=1,
                              tiled=True)

    def place(r, recv, acc):
        # place each source's chunk at its reserved offset; a traced loop over
        # sources keeps the program size O(1) in D (large meshes)
        def write_source(s, acc_t):
            off = jnp.where(r < rounds_from[s], acc_start[s] + r * c, dustbin)
            return tuple(
                lax.dynamic_update_slice(
                    acc_t[pi],
                    lax.dynamic_index_in_dim(recv[pi], s, axis=0, keepdims=False),
                    (off,))
                for pi in range(nship)
            )

        return lax.fori_loop(0, D, write_source, acc)

    if overlap:
        # software pipeline: recv for round r in hand, all_to_all for r+1
        # issued before placing r (round num_rounds prefetches an all-empty
        # sentinel exchange that is never placed)
        def round_body(r, carry):
            acc, recv_r = carry
            recv_next = exchange_round(r + 1)
            return place(r, recv_r, acc), recv_next

        acc, _ = lax.fori_loop(0, num_rounds, round_body,
                               (acc0, exchange_round(0)))
    else:
        def round_body(r, acc):
            return place(r, exchange_round(r), acc)

        acc = lax.fori_loop(0, num_rounds, round_body, acc0)

    # 5. final local order; sentinel filler sorts to the tail, and exactly
    # n_local received rows are valid, so the head slice is the shard
    merged = lax.sort(acc, dimension=0, is_stable=False, num_keys=num_key_planes)
    return tuple(m[:n_local] for m in merged)


def _check_selection_width(n_padded: int) -> None:
    """The selection machinery counts ranks in int32 (x64 is off by default):
    targets, psum'd counts, and the u32 slot plane all require n < 2^31.
    Fail loudly instead of wrapping silently at extreme sizes."""
    if n_padded >= 1 << 31:
        raise ValueError(
            f"balanced partition supports n < 2^31 keys (got {n_padded}); "
            "rank arithmetic is int32 — shard the problem or use the "
            "bucket-shuffle path for larger arrays"
        )


def _run_balanced(planes, mesh, axis_name, num_key_planes, strict, chunk,
                  overlap=False):
    """Pad to D shards, shard_map the balanced body, return static counts.

    Strict-mode convention: the LAST key plane (``planes[num_key_planes-1]``)
    is the global-index tiebreak (all strict callers construct it that way).
    """
    # Non-strict mode is keys-only by construction: the final merge sorts by
    # the key planes with the unstable network, which would scramble payload
    # rows among equal keys. Payload callers must ride the strict (index
    # tiebreak) mode.
    assert strict or len(planes) == num_key_planes, \
        "payload planes require strict=True (index tiebreak)"
    D = mesh.shape[axis_name]
    n = int(planes[0].shape[0])
    if n < 1:
        raise ValueError("balanced distributed sort needs n >= 1")
    _check_selection_width(n + (-n) % D)
    pad_total = (-n) % D
    if pad_total:
        # Pad rows must (a) sort strictly after every real row and (b) keep
        # the composite STRICT — the selection's exactness ("every device
        # receives exactly n_local rows") assumes distinct composites. All-
        # sentinel pad rows would tie with each other (and with real maximal
        # keys), routing every pad row past the last pivot and overfilling
        # device D-1's accumulator. So in strict mode the tiebreak plane pads
        # with distinct values n..n+pad-1 — beyond every real index (< n),
        # hence after all real rows, and pairwise distinct. (Non-strict mode
        # is immune: the synthetic per-slot plane in the body is distinct.)
        def _pad_fill(i: int) -> jax.Array:
            if strict and i == num_key_planes - 1:
                return jnp.arange(n, n + pad_total, dtype=jnp.uint32)
            return jnp.full((pad_total,), _SENTINEL)

        planes = tuple(jnp.concatenate([p, _pad_fill(i)])
                       for i, p in enumerate(planes))
    n_local = (n + pad_total) // D
    counts = jnp.asarray(np.clip(n - np.arange(D) * n_local, 0, n_local)
                         .astype(np.int32))
    overflow = jnp.zeros((D,), jnp.int32)

    if D == 1:
        # unstable in both modes: strict key sets are total orders, and
        # keys-only stability is vacuous (CLAUDE.md invariant)
        out = lax.sort(planes, dimension=0, is_stable=False,
                       num_keys=num_key_planes)
        return tuple(out), counts, overflow

    if chunk is None:
        chunk = -(-n_local // D)
    chunk = max(1, min(int(chunk), n_local))

    body = partial(
        _balanced_body,
        axis_name=axis_name,
        num_devices=D,
        num_key_planes=num_key_planes,
        strict=strict,
        chunk=chunk,
        n_local=n_local,
        overlap=overlap,
    )
    nplanes = len(planes)
    mapped = jax.shard_map(
        lambda *ps: body(ps),
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(nplanes)),
        out_specs=tuple(P(axis_name) for _ in range(nplanes)),
        check_vma=False,
    )
    return mapped(*planes), counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "chunk", "overlap"))
def distributed_sort_balanced_u32(
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    chunk: Optional[int] = None,
    overlap: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Keys-only balanced distributed sort of a u32 array over a 1-D mesh.

    Perfectly load-balanced for ANY input distribution (exact quantile
    partition with a global-slot tiebreak): every shard holds exactly
    ceil(n/D) keys of the globally sorted order, transient memory is bounded
    by D*chunk, and there is no overflow mode. Returns
    (sorted_padded, counts, overflow) with the same contract as
    :func:`..shuffle.distributed_sort_u32`; counts are static, overflow is
    identically zero.
    """
    (sp,), counts, overflow = _run_balanced(
        (x,), mesh, axis_name, num_key_planes=1, strict=False, chunk=chunk,
        overlap=overlap)
    return sp, counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "chunk", "overlap"))
def distributed_argsort_balanced_u32(
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    chunk: Optional[int] = None,
    overlap: bool = False,
):
    """Balanced distributed stable rank sort (argsort) of a u32 array.

    The global-index plane is the strict tiebreak, so the permutation is
    exactly the unique stable one (`radix_sort_rank.hpp:97-112` semantics).
    Returns (sorted_keys_padded, perm_padded, counts, overflow).
    """
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    (sk, sp), counts, overflow = _run_balanced(
        (x, idx), mesh, axis_name, num_key_planes=2, strict=True, chunk=chunk,
        overlap=overlap)
    return sk, sp, counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "chunk", "overlap"))
def distributed_sort_pairs_balanced_u32(
    x: jax.Array,
    payload: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    chunk: Optional[int] = None,
    overlap: bool = False,
):
    """Balanced distributed stable record sort: u32 keys + one u32 payload plane.

    Returns (sorted_keys_padded, payload_padded, counts, overflow).
    """
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    (sk, _, pl), counts, overflow = _run_balanced(
        (x, idx, payload.astype(jnp.uint32)), mesh, axis_name,
        num_key_planes=2, strict=True, chunk=chunk, overlap=overlap)
    return sk, pl, counts, overflow


def distributed_sort_balanced(
    x,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    chunk: Optional[int] = None,
    overlap: bool = False,
):
    """Dtype-generic balanced distributed sort: any supported dtype, either order.

    64-bit dtypes partition on BOTH word planes (plus the slot tiebreak), so —
    unlike the single-collective shuffle, which only sees the high word — a
    constant high word costs nothing: balance is exact for every distribution.
    Returns (sorted_padded_values, counts, overflow[=0]).
    """
    from ..api import _as_words, _decode

    words, dtype = _as_words(x, descending)
    out_words, counts, overflow = _run_balanced(
        tuple(words), mesh, axis_name, num_key_planes=len(words),
        strict=False, chunk=chunk, overlap=overlap)
    vals = _decode(tuple(out_words), dtype, descending)
    return vals, counts, overflow


# ---------------------------------------------------------------------------
# dtype-generic rank and record sorts
#
# Payload planes are *value-preserving* u32 encodings (bitcasts / zero
# extensions with exact inverses) — unlike key planes they carry no order
# semantics, they just have to survive the exchange bit-exactly. The codec
# is shared with the shuffle backend (`._payload`).

from ._payload import encode_payload_tree, decode_payload_tree


def distributed_argsort_balanced(
    x,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    chunk: Optional[int] = None,
    overlap: bool = False,
):
    """Dtype-generic balanced distributed stable rank sort.

    Returns (sorted_values_padded, perm_padded, counts, overflow[=0]); the
    permutation is exactly the unique stable one for the requested order.
    """
    from ..api import _as_words, _decode

    words, dtype = _as_words(x, descending)
    n = int(words[0].shape[0])
    idx = jnp.arange(n, dtype=jnp.uint32)
    out, counts, overflow = _run_balanced(
        tuple(words) + (idx,), mesh, axis_name,
        num_key_planes=len(words) + 1, strict=True, chunk=chunk,
        overlap=overlap)
    vals = _decode(tuple(out[: len(words)]), dtype, descending)
    return vals, out[len(words)], counts, overflow


def distributed_sort_pairs_balanced(
    keys,
    values,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    chunk: Optional[int] = None,
    overlap: bool = False,
):
    """Dtype-generic balanced distributed stable record sort.

    ``values`` is a pytree of 1-D arrays of any fixed-width dtype (64-bit
    leaves ride as two planes). Returns
    (sorted_keys_padded, permuted_values_padded, counts, overflow[=0]);
    padding rows decode from sentinel bits and must be dropped via counts.
    """
    from ..api import _as_words, _decode

    words, dtype = _as_words(keys, descending)
    n = int(words[0].shape[0])
    idx = jnp.arange(n, dtype=jnp.uint32)
    payload_planes, ctx = encode_payload_tree(values, n)
    nk = len(words) + 1
    out, counts, overflow = _run_balanced(
        tuple(words) + (idx,) + payload_planes, mesh, axis_name,
        num_key_planes=nk, strict=True, chunk=chunk, overlap=overlap)
    sorted_keys = _decode(tuple(out[: len(words)]), dtype, descending)
    return (sorted_keys, decode_payload_tree(out[nk:], ctx), counts, overflow)


# ---------------------------------------------------------------------------
# exact distributed order statistics (no full sort)


def distributed_unique_sorted(x, mesh: Mesh, axis_name: str = "shards",
                              chunk: Optional[int] = None):
    """Sorted unique values of a mesh-sharded array, fixed-shape contract.

    The distributed generalization of the bitmap unique-sort capability
    (`bitmap_sort_16.c:6-28` → `extras.unique_sorted`): balanced distributed
    sort, then per-shard boundary dedup — each shard compares its first
    element against its left neighbor's last valid element (one `ppermute`)
    and compacts its new-value boundaries to the front.

    Returns (values_padded, counts, overflow[=0]): shard d's first
    ``counts[d]`` entries are its slice of the global sorted uniques; the
    global result is their concatenation (``gather_sorted`` applies).
    """
    from ..api import _as_words, _decode

    words, dtype = _as_words(x, False)
    out_words, sort_counts, overflow = _run_balanced(
        tuple(words), mesh, axis_name, num_key_planes=len(words),
        strict=False, chunk=chunk)
    D = mesh.shape[axis_name]
    n_local = int(out_words[0].shape[0]) // D
    nplanes = len(out_words)

    def dedup_body(*args):
        planes, valid = args[:nplanes], args[nplanes]
        me = lax.axis_index(axis_name)
        nv = valid[0]
        # left neighbor's last valid row (device 0's incoming value is unused)
        last = tuple(p[jnp.maximum(nv - 1, 0)] for p in planes)
        prev = tuple(
            lax.ppermute(v, axis_name, [(d, (d + 1) % D) for d in range(D)])
            for v in last
        )
        slot = lax.broadcasted_iota(jnp.int32, (n_local,), 0)
        in_valid = slot < nv
        differs_prev_row = jnp.zeros((n_local,), jnp.bool_)
        differs_left = jnp.zeros((), jnp.bool_)
        for p, q in zip(planes, prev):
            differs_prev_row = differs_prev_row | jnp.concatenate(
                [jnp.zeros((1,), jnp.bool_), p[1:] != p[:-1]])
            differs_left = differs_left | (p[0] != q)
        first_is_new = jnp.where(me == 0, True, differs_left) & (nv > 0)
        is_new = jnp.where(slot == 0, first_is_new, differs_prev_row) & in_valid
        count = jnp.sum(is_new.astype(jnp.int32))
        idx, = jnp.nonzero(is_new, size=n_local, fill_value=n_local - 1)
        outs = tuple(jnp.where(jnp.arange(n_local) < count,
                               jnp.take(p, idx), _SENTINEL) for p in planes)
        return (*outs, count[None])

    # One dedup implementation for every D: on a 1-device mesh the ppermute
    # is a self-send whose value device 0 ignores (first_is_new path).
    mapped = jax.shard_map(
        dedup_body,
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(nplanes + 1)),
        out_specs=tuple(P(axis_name) for _ in range(nplanes + 1)),
        check_vma=False,
    )
    out = mapped(*out_words, sort_counts)
    uniq_words, counts = out[:nplanes], out[nplanes]
    vals = _decode(tuple(uniq_words), dtype, False)
    return vals, counts, overflow


def _distributed_group_reduce_dense(keys, values, mesh: Mesh, axis_name: str,
                                    reduce: str, groups: int):
    """Dense-key distributed group-by: NO distributed sort at all.

    With keys promised in [0, G), every reduction that has an additive form
    (sum/mean/count) is one LOCAL scatter-add per shard (counts and value
    sums, ``jax.ops.segment_sum``; integer sums wrap mod 2^32) followed by a
    ``psum`` of the (G,) vectors — O(G) bytes on the wire instead of the
    balanced path's O(n/D) all_to_all rounds. The
    psum'd planes are replicated, so each shard compacts the SAME present
    mask and emits its static ``ceil(G/D)`` slice of the globally sorted
    unique keys — the same output contract as the sort-backed path.

    Same exactness recipe as the local dense tier (`extras._group_reduce_dense`):
    signed values ride a +2^(bits-1) bias corrected by ``count * bias``
    after the psum; all arithmetic wraps mod 2^32 coherently. Float values
    of <= 32 bits accumulate in f32 (`extras._group_reduce_dense_f32`
    states the error bound); the psum then adds f32 partials across shards.
    """
    from ..api import _decode
    from ..extras import _accum_dtype, _dense_counts_sums
    from ..ops import kdf

    ka = jnp.asarray(keys)
    kdtype = ka.dtype
    G = int(groups)
    D = mesh.shape[axis_name]
    w = ka.astype(jnp.uint32)
    S = -(-G // D)  # static per-shard output rows
    fmode = False
    if reduce == "count":
        va, bias, acc = None, None, jnp.int32
    else:
        va = jnp.asarray(values)
        fmode = kdf.kind(va.dtype) == "f"
        if fmode:
            va = va.astype(jnp.float32)
            bias, acc = None, jnp.float32
        else:
            vbits = kdf.key_bits(va.dtype)
            bias = (np.uint32((1 << (vbits - 1)) & 0xFFFFFFFF)
                    if kdf.kind(va.dtype) == "i" else None)
            acc = _accum_dtype(va.dtype)
    pad = (-int(w.shape[0])) % D
    if pad:
        w = jnp.concatenate([w, jnp.full((pad,), G, jnp.uint32)])  # dropped
        if va is not None:
            va = jnp.concatenate([va, jnp.zeros((pad,), va.dtype)])

    def body(*args):
        wl = args[0]
        me = lax.axis_index(axis_name)
        if reduce == "count":
            counts, tot = _dense_counts_sums(wl, None, G)
            counts = lax.psum(counts, axis_name)
        elif fmode:
            counts, tot = _dense_counts_sums(wl, args[1], G)  # f32 values
            counts = lax.psum(counts, axis_name)
            tot = lax.psum(tot, axis_name)
        else:
            vl = args[1].astype(jnp.uint32)
            if bias is not None:
                vl = vl + bias
            counts, tot = _dense_counts_sums(wl, vl, G)
            counts = lax.psum(counts, axis_name)
            tot = lax.psum(tot, axis_name)
            if bias is not None:
                tot = tot - counts.astype(jnp.uint32) * bias
            if jnp.dtype(acc) == jnp.int32:
                tot = lax.bitcast_convert_type(tot, jnp.int32)

        present = counts > 0
        R = jnp.sum(present, dtype=jnp.int32)
        # sized D*S so no shard's (start, S) window can run past the end —
        # lax.dynamic_slice CLAMPS out-of-bounds starts, which would silently
        # shift the last shard's slice (start <= (D-1)*q <= (D-1)*S)
        ids_full, = jnp.nonzero(present, size=D * S, fill_value=G)
        q = (R + D - 1) // D            # rows per shard (last may be short)
        start = me * q
        ids = lax.dynamic_slice(jnp.clip(ids_full, 0, G - 1).astype(jnp.uint32),
                                (start,), (S,))
        emit = jnp.clip(R - start, 0, q).astype(jnp.int32)
        slot = lax.broadcasted_iota(jnp.int32, (S,), 0)
        live = slot < emit
        enc = kdf.encode(ids.astype(kdtype), descending=False)
        keys_out = tuple(jnp.where(live, we, _SENTINEL) for we in enc)
        if reduce == "count":
            red = jnp.where(live, counts[ids], 0)
        elif reduce == "mean":
            red = jnp.where(
                live,
                jnp.asarray(tot[ids], jnp.float32)
                / jnp.maximum(counts[ids], 1).astype(jnp.float32), 0.0)
        else:
            red = jnp.where(live, tot[ids], 0)
        return (*keys_out, red, emit[None])

    nk = kdf.num_words(kdtype)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P(axis_name)
                       for _ in range(1 if reduce == "count" else 2)),
        out_specs=tuple(P(axis_name) for _ in range(nk + 2)),
        check_vma=False,
    )
    out = mapped(w) if reduce == "count" else mapped(w, va)
    ukeys = _decode(tuple(out[:nk]), kdtype, False)
    return ukeys, out[nk], out[-1], jnp.zeros((D,), jnp.int32)


def distributed_group_reduce(keys, values, mesh: Mesh,
                             axis_name: str = "shards",
                             reduce: str = "sum",
                             chunk: Optional[int] = None,
                             groups: Optional[int] = None,
                             validate: bool = False):
    """Pod-scale group-by reduction: sum/mean/min/max/count per unique key.

    The distributed form of :func:`..extras.group_reduce`, riding the
    balanced machinery: ONE balanced distributed sort of the ``(key, value)``
    composite, then per-shard boundary algebra plus a cross-shard merge for
    the runs that span shard edges.

    The composite sort makes the cross-shard merge almost free: a run's
    elements are globally ascending *across shards*, so a spanning run's
    ``max`` is simply its last element in the shard where the run ends (no
    combine at all), its ``min`` is the value at the run's global start
    (carried forward), and only ``sum``/``count`` need arithmetic. Each
    shard publishes a tiny edge summary (first/last key, last run's local
    partial, single-run flag) via one ``all_gather``; a replicated
    ``lax.scan`` over the D summaries computes every shard's incoming carry
    (chains through shards whose whole shard is one run), and a run is
    emitted exactly once — by the shard where it ends.

    Returns ``(keys_padded, reduced_padded, counts, overflow[=0])``: shard
    d's first ``counts[d]`` rows are its slice of the globally sorted unique
    keys with their reductions (``gather_sorted`` assembles either array).
    ``reduce='count'`` takes ``values=None``. ``sum``/``mean`` accumulate
    like the local op (sub-32-bit inputs in 32-bit; ``mean`` is float32) and
    require single-plane (<= 32-bit) values; ``min``/``max`` take any
    supported value dtype and follow the KDF total order.

    **Dense tier** (``groups=G``, the distributed form of
    :func:`..extras.group_reduce`'s promise): ``sum``/``mean``/``count``
    skip the distributed sort entirely — per-shard scatter-adds + ONE psum
    of O(G) bytes (see `_distributed_group_reduce_dense`). Gated like the
    local tier (``(value_bytes + 1) * G <= 2^17``); the per-shard
    output length becomes ``ceil(G/D)`` (`gather_sorted` handles either
    layout). ``groups`` is a promise — the dense tier DROPS out-of-range
    keys while the sort-backed fallback keeps them; ``validate=True``
    raises instead (one max reduce + host sync).
    """
    from ..api import _as_words, _decode
    from ..extras import (_accum_dtype, _dense_f32_ok, _dense_ok,
                          _dense_value_bytes)

    if reduce not in ("sum", "mean", "min", "max", "count"):
        raise ValueError(
            f"reduce must be sum|mean|min|max|count, got {reduce!r}")
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
        # the local tier's gate (extras.group_reduce), applied per shard
        planes = (1 if reduce == "count"
                  else _dense_value_bytes(jnp.asarray(values).dtype) + 1
                  if reduce in ("sum", "mean") and _dense_ok(values)
                  else 3
                  if reduce in ("sum", "mean") and _dense_f32_ok(values)
                  else None)
        if (planes is not None
                and planes * (1 << max(2, (groups - 1).bit_length()))
                <= (1 << 17)):
            return _distributed_group_reduce_dense(
                keys, values, mesh, axis_name, reduce, groups)
    kw, kdtype = _as_words(keys, False)
    if reduce == "count":
        if values is not None:
            raise ValueError("reduce='count' takes values=None")
        vw, vdtype = (), None
    else:
        vw, vdtype = _as_words(values, False)
        if kw[0].shape != vw[0].shape:
            raise ValueError("values must match the keys' length")
        if reduce in ("sum", "mean") and len(vw) > 1:
            raise ValueError(
                "distributed sum/mean needs single-plane (<= 32-bit) "
                "values; 64-bit sums would need x64 cross-shard arithmetic "
                "— reduce min/max, or pre-scale to 32 bits")
    nk, nv = len(kw), len(vw)

    out_planes, sort_counts, overflow = _run_balanced(
        tuple(kw) + tuple(vw), mesh, axis_name, num_key_planes=nk + nv,
        strict=False, chunk=chunk)
    D = mesh.shape[axis_name]
    n_local = int(out_planes[0].shape[0]) // D
    acc = _accum_dtype(vdtype) if reduce in ("sum", "mean") else None

    def body(*args):
        kp, vp = args[:nk], args[nk: nk + nv]
        nvalid = args[nk + nv][0]
        me = lax.axis_index(axis_name)
        slot = lax.broadcasted_iota(jnp.int32, (n_local,), 0)
        valid = slot < nvalid
        # roll-based neighbor diffs: n_local can be 1 (n <= D), where a
        # p[1:]-style zero-size slice trips GSPMD sharding inference
        neq = slot == 0
        for p in kp:
            neq = neq | (p != jnp.roll(p, 1))
        is_new = neq & valid
        r = jnp.sum(is_new.astype(jnp.int32))
        starts, = jnp.nonzero(is_new, size=n_local, fill_value=n_local)
        live = slot < r
        at = jnp.clip(starts, 0, n_local - 1)
        nxt = jnp.minimum(
            jnp.where(slot == n_local - 1, n_local, jnp.roll(starts, -1)),
            nvalid)
        ends = jnp.clip(nxt - 1, 0, n_local - 1)
        lens = jnp.where(live, nxt - starts, 0).astype(jnp.int32)
        keys_out = tuple(jnp.where(live, p[at], _SENTINEL) for p in kp)

        # local per-run partials (compressed to the front, length n_local)
        if reduce in ("sum", "mean"):
            v = _decode((vp[0],), vdtype, False).astype(acc)
            c0 = jnp.concatenate([jnp.zeros((1,), acc),
                                  jnp.cumsum(jnp.where(valid, v, 0))])
            sums = jnp.where(live, c0[ends + 1] - c0[at], 0)
        if reduce == "min":
            red_w = tuple(jnp.where(live, p[at], 0) for p in vp)
        elif reduce == "max":
            red_w = tuple(jnp.where(live, p[ends], 0) for p in vp)

        # edge summaries -> one all_gather -> replicated carry scan.
        rl = jnp.clip(r - 1, 0, n_local - 1)  # last run's slot
        gath = lambda s: lax.all_gather(s, axis_name)          # (D,) + shape
        g_nonempty = gath(nvalid > 0)
        g_single = gath(r <= 1)
        g_first = [gath(p[0]) for p in kp]
        g_last = [gath(p[jnp.clip(nvalid - 1, 0, n_local - 1)]) for p in kp]
        link = g_nonempty[1:] & g_nonempty[:-1]                # (D-1,)
        for f, l in zip(g_first, g_last):
            link = link & (l[:-1] == f[1:])

        if reduce in ("sum", "mean", "count"):
            g_tsum = gath(sums[rl]) if reduce != "count" else None
            g_tlen = gath(lens[rl])

            def step(carry, xs):
                lnk, single_prev, *trails = xs
                inc = tuple(
                    jnp.where(lnk, t + jnp.where(single_prev, c, 0), 0)
                    for t, c in zip(trails, carry))
                return inc, inc

            trails = ([g_tsum[:-1], g_tlen[:-1]] if reduce != "count"
                      else [g_tlen[:-1]])
            zeros = tuple(jnp.zeros((), t.dtype) for t in trails)
            _, incs = lax.scan(step, zeros,
                               (link, g_single[:-1], *trails))
            inc_me = tuple(
                jnp.concatenate([jnp.zeros((1,), i.dtype), i])[me]
                for i in incs)
        else:  # min carries the run's global-start value; max carries nothing
            if reduce == "min":
                g_tw = [gath(w[rl]) for w in red_w]

                def step(carry, xs):
                    lnk, single_prev, *tw = xs
                    nw = tuple(jnp.where(single_prev & carry[0], c, t)
                               for t, c in zip(tw, carry[1:]))
                    return (lnk, *nw), (lnk, *nw)

                zero_w = tuple(jnp.zeros((), w.dtype) for w in red_w)
                _, outs = lax.scan(
                    step, (jnp.zeros((), jnp.bool_), *zero_w),
                    (link, g_single[:-1], *[w[:-1] for w in g_tw]))
                has_inc = jnp.concatenate(
                    [jnp.zeros((1,), jnp.bool_), outs[0]])[me]
                inc_w = tuple(
                    jnp.concatenate([jnp.zeros((1,), w.dtype), o])[me]
                    for w, o in zip(red_w, outs[1:]))

        # emit each run exactly once: the shard where it ends keeps it
        link_out = jnp.concatenate(
            [link, jnp.zeros((1,), jnp.bool_)])[me]  # my last run continues
        emit = jnp.maximum(r - link_out.astype(jnp.int32), 0)
        live2 = slot < emit
        keys_out = tuple(jnp.where(live2, w, _SENTINEL) for w in keys_out)
        if reduce in ("sum", "mean"):
            sums = sums.at[0].add(inc_me[0])
            lens = lens.at[0].add(inc_me[1])
            if reduce == "mean":
                red = jnp.where(
                    live2,
                    sums.astype(jnp.float32)
                    / jnp.maximum(lens, 1).astype(jnp.float32), 0.0)
            else:
                red = jnp.where(live2, sums, 0)
            return (*keys_out, red, emit[None])
        if reduce == "count":
            lens = lens.at[0].add(inc_me[0])
            return (*keys_out, jnp.where(live2, lens, 0), emit[None])
        if reduce == "min":
            red_w = tuple(
                w.at[0].set(jnp.where(has_inc, iw, w[0]))
                for w, iw in zip(red_w, inc_w))
        red_w = tuple(jnp.where(live2, w, 0) for w in red_w)
        return (*keys_out, *red_w, emit[None])

    n_red = 1 if reduce in ("sum", "mean", "count") else nv
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(nk + nv + 1)),
        out_specs=tuple(P(axis_name) for _ in range(nk + n_red + 1)),
        check_vma=False,
    )
    out = mapped(*out_planes, sort_counts)
    ukeys = _decode(tuple(out[:nk]), kdtype, False)
    if reduce in ("min", "max"):
        reduced = _decode(tuple(out[nk: nk + nv]), vdtype, False)
    else:
        reduced = out[nk]
    return ukeys, reduced, out[-1], overflow


def _select_body(planes, ranks, axis_name, n_local):
    """Per-shard body: local strict sort, then bitwise selection at ``ranks``."""
    my_dev = lax.axis_index(axis_name)
    gslot = (my_dev.astype(jnp.uint32) * np.uint32(n_local)
             + lax.broadcasted_iota(jnp.uint32, (n_local,), 0))
    part = lax.sort(tuple(planes) + (gslot,), dimension=0, is_stable=False,
                    num_keys=len(planes) + 1)
    piv = _select_pivots(part, ranks, axis_name, n_local)
    # drop the gslot plane; the key planes ARE the value at each rank.
    # The search consumed only psum'd quantities, so the result is identical
    # on every shard — returned replicated (out_specs P()).
    return tuple(piv[: len(planes)])


def distributed_select(x, ranks, mesh: Mesh, axis_name: str = "shards",
                       descending: bool = False):
    """Exact order statistics of a mesh-sharded array — without a full sort.

    Returns the values at the given global ``ranks`` (0-based positions of the
    stably sorted sequence in the requested order), replicated on every
    device. Cost is O(key_bits) scalar-latency collectives (one small psum per
    bit of the strict composite) plus ONE local sort of each shard — no
    exchange, no data movement. The exact-selection machinery is the same
    bitwise distributed k-th-smallest search the balanced partition uses; this
    entry point exposes it directly (medians, percentiles, top-rank cutoffs
    over arrays spread across devices).

    Args:
      x: (n,) array of any supported key dtype.
      ranks: static sequence of ints in [0, n).
      descending: rank 0 = largest when True.

    Returns:
      (len(ranks),) array of x's dtype.
    """
    from ..api import _as_words, _decode

    ranks = [int(r) for r in ranks]
    D = mesh.shape[axis_name]
    words, dtype = _as_words(x, descending)
    n = int(words[0].shape[0])
    if not ranks:
        raise ValueError("ranks must be non-empty")
    if not all(0 <= r < n for r in ranks):
        raise ValueError(f"ranks must be in [0, {n})")
    _check_selection_width(n + (-n) % D)
    pad_total = (-n) % D
    planes = tuple(jnp.concatenate([w, jnp.full((pad_total,), _SENTINEL)])
                   for w in words) if pad_total else tuple(words)
    n_local = (n + pad_total) // D
    targets = jnp.asarray(ranks, dtype=jnp.int32)

    if D == 1:
        s = lax.sort(planes, dimension=0, is_stable=False, num_keys=len(planes))
        sel = tuple(p[targets] for p in s)
        return _decode(sel, dtype, descending)

    body = partial(_select_body, ranks=targets, axis_name=axis_name,
                   n_local=n_local)
    mapped = jax.shard_map(
        lambda *ps: body(ps),
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in planes),
        out_specs=tuple(P() for _ in planes),  # replicated selection result
        check_vma=False,
    )
    sel = mapped(*planes)
    return _decode(tuple(sel), dtype, descending)


def distributed_quantile(x, q, mesh: Mesh, axis_name: str = "shards",
                         method: str = "linear"):
    """Exact quantiles of a mesh-sharded array — without a full sort.

    The distributed form of :func:`..stats.quantile` (same five numpy
    methods, same dtype/NaN contract — interpolating methods in float32 on
    device, bit-for-bit numpy float64 for 64-bit numpy inputs): the needed
    order statistics come from ONE :func:`distributed_select` call over the
    deduplicated take ranks — O(key_bits) scalar-latency psums plus one
    local shard sort, no exchange — and the interpolation runs on the
    replicated O(#quantiles) result. ``q`` is a static float or sequence
    in [0, 1]; the result is replicated on every device.
    """
    from ..stats import _Q_METHODS, _quantile_combine, _quantile_positions

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
    lo_i, hi_i, frac = _quantile_positions(qs, n, method)
    ranks = sorted({*lo_i.tolist(), *hi_i.tolist()})
    sel = distributed_select(x, ranks, mesh, axis_name=axis_name)
    pos = {r: i for i, r in enumerate(ranks)}
    li = np.asarray([pos[int(r)] for r in lo_i], np.int32)
    hi_ = np.asarray([pos[int(r)] for r in hi_i], np.int32)
    if isinstance(sel, np.ndarray):
        out = _quantile_combine(sel[li], sel[hi_], frac, method)
    else:
        out = _quantile_combine(sel[jnp.asarray(li)], sel[jnp.asarray(hi_)],
                                frac, method)
    return out[0] if scalar else out


def distributed_median(x, mesh: Mesh, axis_name: str = "shards"):
    """Pod-scale exact median: :func:`distributed_quantile` at 0.5."""
    return distributed_quantile(x, 0.5, mesh, axis_name=axis_name)


def distributed_top_k(x, k: int, mesh: Mesh, axis_name: str = "shards",
                      largest: bool = True, index_dtype=jnp.uint32):
    """Global top-k of a mesh-sharded array, replicated on every device.

    The distributed form of :func:`..extras.top_k` (same contract: best-first
    values with their stable original indices, ties to the lower global
    index), built on the union-of-local-top-k identity: every globally
    top-k element has local rank < k in its own shard, so one local
    composite sort per shard, one ``all_gather`` of D*k candidate rows, and
    one replicated sort of those candidates select the exact global result.
    Communication is O(D*k) — no exchange, no full distributed sort; the
    right tool whenever k << n/D (leaderboards, thresholding, beam cuts).
    For k approaching the shard size, sort with
    :func:`distributed_sort_balanced` and take a prefix instead.

    Args:
      x: (n,) array of any supported key dtype (64-bit = two u32 planes,
        no x64), n divisible-or-padded across the mesh.
      k: static, 1 <= k <= n/D (each shard holds only n/D candidates).
      largest: rank 0 = largest when True (like ``extras.top_k``).

    Returns:
      ``(values, indices)`` of static length k, identical on every device.
    """
    from ..api import _as_words, _check_index_width, _decode

    words, dtype = _as_words(x, largest)
    n = int(words[0].shape[0])
    D = mesh.shape[axis_name]
    pad_total = (-n) % D
    n_local = (n + pad_total) // D
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if k > n_local:
        raise ValueError(
            f"k={k} exceeds the shard size {n_local}: each shard holds only "
            f"n/D candidates — use distributed_sort_balanced and slice")
    _check_index_width(n + pad_total, index_dtype)
    # pad to a multiple of D with the KDF-order maximum: pads sort last
    # within the final shard and can never displace a real candidate
    # (k <= n). Real elements keep gslot == original index.
    planes = tuple(jnp.concatenate([w, jnp.full((pad_total,), _SENTINEL)])
                   for w in words) if pad_total else tuple(words)
    nw = len(planes)

    if D == 1:
        out = lax.sort(planes + (jnp.arange(n + pad_total, dtype=index_dtype),),
                       dimension=0, is_stable=False, num_keys=nw + 1)
        return (_decode(tuple(w[:k] for w in out[:nw]), dtype, largest),
                out[-1][:k])

    def body(*ps):
        me = lax.axis_index(axis_name)
        gslot = (me.astype(index_dtype) * jnp.asarray(n_local, index_dtype)
                 + lax.broadcasted_iota(index_dtype, (n_local,), 0))
        local = lax.sort(tuple(ps) + (gslot,), dimension=0, is_stable=False,
                         num_keys=nw + 1)
        cand = tuple(lax.all_gather(w[:k], axis_name, tiled=True)
                     for w in local)
        merged = lax.sort(cand, dimension=0, is_stable=False, num_keys=nw + 1)
        return tuple(w[:k] for w in merged)

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in planes),
        out_specs=tuple(P() for _ in range(nw + 1)),  # replicated result
        check_vma=False,
    )
    out = mapped(*planes)
    return _decode(tuple(out[:nw]), dtype, largest), out[-1]
