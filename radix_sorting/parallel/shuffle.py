"""Distributed sort: skew-aware top-digit shuffle across a device mesh.

The reference is strictly single-core (SURVEY §2 "explicit absence statement");
this layer is the net-new scale-out design it calls for: the in-memory
ping-pong of a radix pass generalizes to a **bucket shuffle across devices**
(SURVEY §5 long-context row): every device keeps a shard of the keys, and one
collective exchange re-shards them by key range so local sorts finish the job.

Algorithm (SPMD, inside one `shard_map` over a 1-D mesh axis):

  1. **local sort** of the shard by the full derived key (``lax.sort``).
  2. **global splitter histogram**: each device histograms the top
     ``splitter_bits`` of its keys; `psum` reduces it to the exact global
     distribution — the distributed form of the reference's first-pass
     histogram (`radix_sort.hpp:47-58`).
  3. **skew-aware partition**: buckets are assigned to devices by walking the
     exact global cumulative histogram so every device receives as close to
     n/D keys as bucket granularity allows. Using many more buckets than
     devices (default 4096 vs D) keeps imbalance small under skew — the
     "skew-aware bucket splitting" of BASELINE.json's north star. Degenerate
     distributions (few distinct top-digit values) degrade gracefully: the
     mass concentrates in few buckets and the affected devices receive more
     keys, but correctness is unaffected.
  4. **all-to-all exchange**: because shards are locally sorted, each
     device's outgoing keys for any destination form one contiguous run;
     runs are placed into fixed-capacity slots (padded with the maximal
     sentinel key, which sorts to the end and is sliced off by count) and
     exchanged with a single `lax.all_to_all`, which XLA hands to the
     collective library (NCCL on GPUs).
  5. **local merge**: each device stably sorts its received runs; sentinels
     accumulate at the tail. The result is a globally sorted sequence in mesh
     order, each shard holding ``count`` valid keys.

Static-shape contract: SPMD programs cannot return ragged shards, so the
output shard is padded to ``capacity`` with sentinels and paired with a
``count`` scalar; :func:`gather_sorted` assembles the exact concatenation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.histogram import digit_histogram

__all__ = [
    "distributed_sort",
    "distributed_argsort",
    "distributed_sort_pairs",
    "distributed_sort_u32",
    "distributed_argsort_u32",
    "distributed_sort_pairs_u32",
    "gather_sorted",
    "make_sort_mesh",
]

_SENTINEL = np.uint32(0xFFFFFFFF)


def make_sort_mesh(num_devices: Optional[int] = None, axis_name: str = "shards") -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (default: all)."""
    devs = jax.devices()
    if num_devices is not None:
        if num_devices > len(devs):
            # a silent devs[:n] clip would report results for a smaller mesh
            # than the caller believes it measured
            raise ValueError(
                f"make_sort_mesh: requested {num_devices} devices, only "
                f"{len(devs)} available")
        devs = devs[:num_devices]
    return jax.make_mesh((len(devs),), (axis_name,), devices=devs)


def _device_of_bucket(global_hist: jax.Array, num_devices: int) -> jax.Array:
    """Assign each splitter bucket to a device, balancing exact global mass.

    Bucket b goes to device floor(excl_cum[b] * D / total): contiguous
    ranges, monotone in b (which global sortedness requires), each device's
    load within one bucket's mass of n/D. Deterministic and replicated — every
    device computes the identical table from the psum'd histogram, no host
    sync.

    All arithmetic is *exact* int32 (x64 is off by default): the device of
    bucket b is the number of thresholds t_d = ceil(total*d/D), d=1..D-1,
    that excl_cum[b] reaches. With total = q*D + rem (rem < D),
    t_d = q*d + ceil(rem*d/D); both terms fit int32 for any total < 2^31
    and any D, so — unlike a float32 division, which loses integer precision
    above ~2^24 — boundaries are exact at every supported n.
    """
    counts = global_hist
    excl = jnp.cumsum(counts) - counts                       # (B,) int32
    total = jnp.maximum(jnp.sum(counts), 1)
    d = jnp.arange(1, num_devices, dtype=jnp.int32)          # (D-1,)
    q, rem = total // num_devices, total % num_devices
    thresh = q * d + (rem * d + num_devices - 1) // num_devices
    dev = jnp.sum((excl[:, None] >= thresh[None, :]).astype(jnp.int32), axis=1)
    return dev


def _shard_body(planes, axis_name, num_devices, splitter_bits, capacity_per_peer,
                deal, num_key_planes, valid_total):
    """Per-shard SPMD body.

    planes: tuple of (n_local,) uint32 arrays; planes[:num_key_planes] are
    sort-key planes (most significant first; plane 0 drives the partition),
    the rest are payload. With ``num_key_planes == 2`` the second key plane is
    the global index, which makes the total order strict — the distributed
    form of the stable-rank guarantee. n_local % D == 0.
    """
    w = planes[0]
    n_local = w.shape[0]
    nbuckets = 1 << splitter_bits

    # Live-bit reduction over *valid* keys only, computed pre-deal where each
    # device knows exactly which of its slots are ragged-n sentinel pads
    # (global slot d*n_local+i >= valid_total). Pads would otherwise force the
    # adaptive splitter domain to full 32-bit scale and collapse narrow-range
    # keys into one bucket.
    my_dev = lax.axis_index(axis_name)
    gslot = my_dev * n_local + lax.broadcasted_iota(jnp.int32, (n_local, 1), 0)[:, 0]
    is_valid = gslot < valid_total
    local_or = jnp.bitwise_or.reduce(jnp.where(is_valid, w, np.uint32(0)))
    local_and = jnp.bitwise_and.reduce(jnp.where(is_valid, w, _SENTINEL))
    gor = jnp.bitwise_or.reduce(lax.all_gather(local_or, axis_name))
    gand = jnp.bitwise_and.reduce(lax.all_gather(local_and, axis_name))
    gmask = gor ^ gand
    all_equal = gmask == 0
    lshift = jnp.minimum(lax.clz(gmask), 31).astype(jnp.uint32)

    # 0. optional "deal": a fixed, destination-independent all_to_all that
    # re-interleaves shards so every device holds an even sample of the global
    # array. Decorrelates value clusters from sources — without it, a
    # presorted input sends each source's *entire* shard to a single peer and
    # no per-peer capacity short of n_local suffices. Classic sample-sort
    # pre-balancing; costs one extra pass of exchange traffic.
    if deal:
        planes = tuple(
            lax.all_to_all(
                p.reshape(num_devices, n_local // num_devices),
                axis_name, split_axis=0, concat_axis=0, tiled=True,
            ).reshape(-1)
            for p in planes
        )
        w = planes[0]

    # 1. local sort. Keys-only: unstable is exact.
    # With an index tiebreak plane the order is strict, so stability is
    # irrelevant there too.
    sorted_planes = lax.sort(planes, dimension=0, is_stable=False,
                             num_keys=num_key_planes)
    ws = sorted_planes[0]

    # 2. adaptive splitter domain: buckets left-aligned at the globally
    # highest live bit (computed above), so low-entropy key ranges (e.g. all
    # keys < 2^20) spread over all buckets instead of collapsing into bucket
    # 0; exact global splitter histogram via psum. Sentinel pads saturate to
    # the top bucket and therefore route to device D-1 like any maximal key.
    b = ((ws << lshift) >> np.uint32(32 - splitter_bits)).astype(jnp.uint32)
    local_hist = digit_histogram(b, nbuckets)
    global_hist = lax.psum(local_hist, axis_name)

    # 3. skew-aware bucket -> device assignment (identical on all devices)
    dev_of_bucket = _device_of_bucket(global_hist, num_devices)

    # destination device per local key; non-decreasing because ws is sorted
    dest = jnp.take(dev_of_bucket, b.astype(jnp.int32))
    # outgoing run boundaries per destination: count keys with dest < d
    out_counts = digit_histogram(dest.astype(jnp.uint32), num_devices)
    out_starts = jnp.cumsum(out_counts) - out_counts

    # 4. pack runs into (planes, D, C) slots, sentinel-padded, and exchange
    # with ONE collective. A run larger than C cannot be shipped this round;
    # that is *detected* (never silent) and reported via the overflow flag.
    C = capacity_per_peer
    overflow = lax.psum(jnp.sum((out_counts > C).astype(jnp.int32)), axis_name)
    out_counts = jnp.minimum(out_counts, C)
    j = jnp.arange(C, dtype=jnp.int32)
    flat_idx = jnp.clip(out_starts[:, None] + j[None, :], 0, n_local - 1)
    valid = j[None, :] < out_counts[:, None]
    send = jnp.stack([
        jnp.where(valid, jnp.take(p, flat_idx, axis=0), _SENTINEL)
        for p in sorted_planes
    ])                                                   # (planes, D, C)
    recv = lax.all_to_all(send, axis_name, split_axis=1, concat_axis=1,
                          tiled=True)
    recv_counts = lax.all_to_all(out_counts, axis_name, split_axis=0, concat_axis=0,
                                 tiled=True)

    # 5. local merge of the received runs; sentinels sort to the tail (the
    # sentinel index plane is maximal too, so key-plane ties keep real keys
    # ahead of padding)
    merged = lax.sort(tuple(recv[i].reshape(-1) for i in range(len(planes))),
                      dimension=0, is_stable=False, num_keys=num_key_planes)
    count = jnp.sum(recv_counts)

    # all-equal bypass (keys-only mode, no ragged pads): no movement needed,
    # every shard already holds a sorted run of the single value; avoids the
    # degenerate one-device hotspot. With key+index planes the strict order
    # makes the bypass invalid (indices were dealt), and with ragged-n pads
    # the per-shard counts would miscount scattered sentinels — both flow
    # through the exchange instead (or exact mode).
    if num_key_planes == 1 and len(planes) == 1 and valid_total == num_devices * n_local:
        padv = jnp.full((num_devices * C - n_local,), _SENTINEL)
        bypass = (jnp.concatenate([ws, padv])
                  if num_devices * C > n_local else ws[: num_devices * C])
        merged = (jnp.where(all_equal, bypass, merged[0]),)
        count = jnp.where(all_equal, n_local, count)
        overflow = jnp.where(all_equal, 0, overflow)
    return (*merged, count[None], overflow[None])


def _run_shuffle(planes, mesh, axis_name, splitter_bits, slack, exact,
                 num_key_planes):
    """Pad, shard_map the shuffle body over the mesh, adjust counts."""
    D = mesh.shape[axis_name]
    n = planes[0].shape[0]
    if n < D * D:
        raise ValueError(f"n={n} too small for a {D}-device shuffle (need n >= D^2)")
    # Pad to a multiple of D^2 with maximal sentinel keys: they sort to the
    # global tail (device D-1's range in every path, including the all-equal
    # bypass where keys are then also maximal), so the count adjustment below
    # is exact. Non-key planes pad with the sentinel too, so a padded row is
    # maximal under the (key, index) order.
    pad_total = (-n) % (D * D)
    if pad_total:
        planes = tuple(jnp.concatenate([p, jnp.full((pad_total,), _SENTINEL)])
                       for p in planes)
    n_local = (n + pad_total) // D
    if exact:
        cap = n_local
    else:
        expect = -(-n_local // D)
        cap = min(n_local,
                  int(expect * (1.0 + slack)) + -(-n_local // (1 << splitter_bits)) + 8)
    body = partial(
        _shard_body,
        axis_name=axis_name,
        num_devices=D,
        splitter_bits=splitter_bits,
        capacity_per_peer=cap,
        deal=not exact,
        num_key_planes=num_key_planes,
        valid_total=n,
    )
    nplanes = len(planes)
    mapped = jax.shard_map(
        lambda *ps: body(ps),
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(nplanes)),
        out_specs=tuple(P(axis_name) for _ in range(nplanes + 2)),
        check_vma=False,
    )
    out = mapped(*planes)
    sorted_planes, counts, overflow = out[:nplanes], out[nplanes], out[nplanes + 1]
    if pad_total:
        # Pad rows are globally-maximal composites, so they occupy the TAIL
        # of the valid global sequence — *usually* all on device D-1, but a
        # degenerate input (e.g. every key equal to the sentinel value) can
        # route the whole array, pads included, to one earlier device. So
        # subtract the pad mass from the tail across devices: device d sheds
        # clip(pad_total - (# already shed by devices after d), 0, counts[d]).
        suffix_after = (jnp.cumsum(counts[::-1])[::-1] - counts).astype(jnp.int32)
        shed = jnp.clip(pad_total - suffix_after, 0, counts.astype(jnp.int32))
        counts = (counts.astype(jnp.int32) - shed).astype(counts.dtype)
    return sorted_planes, counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "splitter_bits", "slack",
                                   "exact"))
def distributed_sort_u32(
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    splitter_bits: int = 12,
    slack: float = 0.5,
    exact: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sort a u32 array sharded over a 1-D mesh (keys only).

    Args:
      x: (n,) uint32, n >= D^2 (any remainder is padded internally).
      mesh: 1-D device mesh.
      splitter_bits: top bits used for range partitioning (buckets = 2**bits).
      slack: per-peer capacity headroom over the uniform expectation
        ``n/D**2``. Ample for uniform and mildly skewed data; a run that
        exceeds capacity is *detected* and reported (never silently dropped).
      exact: size the exchange for the adversarial worst case
        (capacity = full local shard). Always correct for any distribution,
        at D-fold exchange memory/traffic — the escape hatch when the
        overflow flag is set.

    Returns:
      (sorted_padded, counts, overflow):
        ``sorted_padded`` — (D * cap,) sharded over the mesh; each shard's
        first ``counts[d]`` entries are its range of the globally sorted
        sequence, the tail is sentinel-padded.
        ``counts`` — (D,) int32 valid lengths.
        ``overflow`` — (D,) int32, nonzero means capacity was exceeded and
        the result is incomplete: retry with ``exact=True`` or more slack.
    """
    (sorted_padded,), counts, overflow = _run_shuffle(
        (x,), mesh, axis_name, splitter_bits, slack, exact, num_key_planes=1)
    return sorted_padded, counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "splitter_bits", "slack",
                                   "exact"))
def distributed_argsort_u32(
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    splitter_bits: int = 12,
    slack: float = 0.5,
    exact: bool = False,
):
    """Distributed stable rank sort: global argsort of a mesh-sharded u32 array.

    The distributed form of the rank sort (`radix_sort_rank.hpp:97-112`): the
    global index rides as a second sort-key plane, making the total order
    strict — so the resulting permutation is exactly the unique stable one,
    independent of how shards, deal rounds, or merges interleaved.

    Returns (sorted_keys_padded, perm_padded, counts, overflow); shard d's
    first counts[d] entries of ``perm_padded`` are the global input indices
    in stable key order.
    """
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    (sk, sp), counts, overflow = _run_shuffle(
        (x, idx), mesh, axis_name, splitter_bits, slack, exact,
        num_key_planes=2)
    return sk, sp, counts, overflow


def distributed_sort(
    x,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    method: str = "balanced",
    **kw,
):
    """Dtype-generic distributed sort: any supported key dtype, either order.

    KDF-encodes (with descending complement), exchanges, decodes. Two
    exchange methods:

    * ``"balanced"`` (default): exact-quantile partition + multi-round
      chunked exchange (:mod:`.balanced`) — perfectly balanced shards for
      any input distribution, bounded memory, overflow impossible.
    * ``"shuffle"``: the single-collective top-digit bucket shuffle — lowest
      latency for benign distributions, but skew can overflow the exchange
      capacity (detected; retry with ``exact=True``), and 64-bit dtypes
      partition on the high word only.

    Returns (sorted_padded_values, counts, overflow); padding slots decode
    from the sentinel key and must be dropped via counts (use
    :func:`gather_sorted` on the *decoded* array).
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_sort_balanced
        return distributed_sort_balanced(
            x, mesh, axis_name, descending=descending, chunk=kw.get("chunk"),
            overlap=kw.get("overlap", False))
    from ..api import _as_words, _decode
    words, dtype = _as_words(x, descending)
    if len(words) == 1:
        (sp,), counts, overflow = _run_shuffle(
            (words[0],), mesh, axis_name,
            kw.get("splitter_bits", 12), kw.get("slack", 0.5),
            kw.get("exact", False), num_key_planes=1)
        vals = _decode((sp,), dtype, descending)
        return vals, counts, overflow
    hi, lo = words
    (shi, slo), counts, overflow = _run_shuffle(
        (hi, lo), mesh, axis_name,
        kw.get("splitter_bits", 12), kw.get("slack", 0.5),
        kw.get("exact", False), num_key_planes=2)
    vals = _decode((shi, slo), dtype, descending)
    return vals, counts, overflow


@partial(jax.jit, static_argnames=("mesh", "axis_name", "splitter_bits", "slack",
                                   "exact"))
def distributed_sort_pairs_u32(
    x: jax.Array,
    payload: jax.Array,
    mesh: Mesh,
    axis_name: str = "shards",
    splitter_bits: int = 12,
    slack: float = 0.5,
    exact: bool = False,
):
    """Distributed stable record sort: keys + one u32 payload plane.

    Stability is realized by the same global-index tiebreak as
    :func:`distributed_argsort_u32`; the payload plane follows the exchange.
    Returns (sorted_keys_padded, payload_padded, counts, overflow).
    """
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    (sk, _, pl), counts, overflow = _run_shuffle(
        (x, idx, payload.astype(jnp.uint32)), mesh, axis_name, splitter_bits,
        slack, exact, num_key_planes=2)
    return sk, pl, counts, overflow


def distributed_argsort(
    x,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    method: str = "balanced",
    **kw,
):
    """Dtype-generic distributed stable rank sort, either exchange backend.

    Returns (sorted_values_padded, perm_padded, counts, overflow); the
    permutation is exactly the unique stable one for the requested order
    (global-index tiebreak plane, `radix_sort_rank.hpp:97-112` semantics).
    ``method`` as in :func:`distributed_sort`; shuffle-path kwargs
    (splitter_bits/slack/exact) and balanced kwargs (chunk/overlap) apply to
    their respective backends. With 64-bit keys the shuffle partitions on the
    high word only (skew on a constant high word degrades balance, never
    correctness); the balanced path partitions on the full composite.
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_argsort_balanced
        return distributed_argsort_balanced(x, mesh, axis_name,
                                            descending=descending, **kw)
    from ..api import _as_words, _decode
    words, dtype = _as_words(x, descending)
    n = int(words[0].shape[0])
    idx = jnp.arange(n, dtype=jnp.uint32)
    out, counts, overflow = _run_shuffle(
        tuple(words) + (idx,), mesh, axis_name,
        kw.get("splitter_bits", 12), kw.get("slack", 0.5),
        kw.get("exact", False), num_key_planes=len(words) + 1)
    vals = _decode(tuple(out[: len(words)]), dtype, descending)
    return vals, out[len(words)], counts, overflow


def distributed_sort_pairs(
    keys,
    values,
    mesh: Mesh,
    axis_name: str = "shards",
    descending: bool = False,
    method: str = "balanced",
    **kw,
):
    """Dtype-generic distributed stable record sort, either exchange backend.

    ``values`` is a pytree of 1-D arrays of any fixed-width dtype (64-bit
    leaves ride as two planes, bitcast-exact). Stability comes from the
    global-index tiebreak plane on both backends. Returns
    (sorted_keys_padded, permuted_values_padded, counts, overflow); padding
    rows decode from sentinel bits and must be dropped via counts.
    """
    _check_method_kwargs(method, kw)
    if method == "balanced":
        from .balanced import distributed_sort_pairs_balanced
        return distributed_sort_pairs_balanced(keys, values, mesh, axis_name,
                                               descending=descending, **kw)
    from ..api import _as_words, _decode
    from ._payload import decode_payload_tree, encode_payload_tree
    words, dtype = _as_words(keys, descending)
    n = int(words[0].shape[0])
    idx = jnp.arange(n, dtype=jnp.uint32)
    payload_planes, ctx = encode_payload_tree(values, n)
    nk = len(words) + 1
    out, counts, overflow = _run_shuffle(
        tuple(words) + (idx,) + payload_planes, mesh, axis_name,
        kw.get("splitter_bits", 12), kw.get("slack", 0.5),
        kw.get("exact", False), num_key_planes=nk)
    sorted_keys = _decode(tuple(out[: len(words)]), dtype, descending)
    return (sorted_keys, decode_payload_tree(out[nk:], ctx), counts, overflow)


def _check_method_kwargs(method: str, kw) -> None:
    _ALLOWED = {"balanced": {"chunk", "overlap"},
                "shuffle": {"splitter_bits", "slack", "exact"}}
    if method not in _ALLOWED:
        raise ValueError(f"unknown method {method!r}; 'balanced' or 'shuffle'")
    stray = set(kw) - _ALLOWED[method]
    if stray:
        raise TypeError(
            f"method={method!r} does not accept {sorted(stray)}; "
            f"valid options: {sorted(_ALLOWED[method])} "
            "(the balanced partition needs no exact/slack escape hatches)")


def gather_sorted(sorted_padded: jax.Array, counts: jax.Array,
                  overflow: Optional[jax.Array] = None) -> np.ndarray:
    """Assemble the exact sorted array on host from padded shards + counts.

    Raises if the shuffle reported capacity overflow (incomplete result).

    Multi-host note: this materializes the full array on the host, so it
    requires a fully-addressable result (single-controller runtimes, or
    after a `jax.experimental.multihost_utils` gather). On a multi-host run the
    idiomatic pattern is to keep consuming the *sharded* result — each
    host's shards hold contiguous global ranks [d*ceil(n/D), ...) with
    `counts[d]` valid rows — rather than gathering at all.
    """
    if overflow is not None and int(np.asarray(overflow)[0]) != 0:
        raise RuntimeError(
            "distributed_sort exchange capacity exceeded (skewed input); "
            "retry with exact=True or a larger slack"
        )
    counts_np = np.asarray(counts)
    D = counts_np.shape[0]
    flat = np.asarray(sorted_padded).reshape(D, -1)
    return np.concatenate([flat[d, : counts_np[d]] for d in range(D)])
