"""LSD engine: the faithful chunked least-significant-digit radix sort.

This engine reproduces the reference's pass mechanics exactly, in their
data-parallel generalization (SURVEY §7 stage 2):

  per live pass (LSB -> MSB, `README.md:316-335`):
    1. per-chunk digit histograms            (`radix_sort_u32.c:24-37`)
    2. exclusive scans -> scatter bases      (`radix_sort_u32.c:39-57`)
       base[c,b] = global bucket start + mass of bucket b in earlier chunks
       — the distributed-memory generalization of ``cnt[k]++``
       (`counting_sort_8s.c:23-34`); within a chunk the j-th key with digit b
       lands at base[c,b]+j, which is the stability invariant
       (`README.md:471-473`).
    3. stable scatter into the ping-pong buffer (`radix_sort_u32.c:59-90`);
       functionally the output of one pass feeds the next (XLA owns buffer
       reuse, the analog of the SWAP macro `radix_sort_u32.c:5`).
  trivial passes are elided by a per-pass `lax.cond` on the live-digit flag
  (column skipping, `radix_sort.hpp:64-70`) — on device, with no host sync.

Role in the framework: this is the *algorithmic blueprint* — the structure the
multi-device shuffle scales up (chunks become devices) — and the oracle the
fast engines are tested against. The dispatcher only selects it explicitly
(``Strategy.LSD``); its speed on a GPU is not measured.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import probes
from .histogram import chunked_digit_histogram, extract_digit
from .scan import scatter_bases

__all__ = ["sort_words_lsd"]


def _rank_and_dest_for_chunk(digits_chunk: jax.Array, base_row: jax.Array, bins: int):
    """Destination index for each key of one chunk.

    digits_chunk: (chunk,) uint32; base_row: (bins,) int32 scatter bases for
    this chunk. Returns (chunk,) int32 destinations.
    """
    binv = jnp.arange(bins, dtype=jnp.uint32)
    onehot = (digits_chunk[:, None] == binv[None, :]).astype(jnp.int32)
    # exclusive cumsum along the chunk axis = stable within-chunk rank per bucket
    rank_all = jnp.cumsum(onehot, axis=0) - onehot          # (chunk, bins)
    rank = jnp.take_along_axis(
        rank_all, digits_chunk[:, None].astype(jnp.int32), axis=1
    )[:, 0]
    start = jnp.take(base_row, digits_chunk.astype(jnp.int32))
    return start + rank


@partial(jax.jit, static_argnames=("radix_bits", "chunk", "skip_trivial", "num_payloads"))
def _sort_padded(
    operands: Tuple[jax.Array, ...],
    live_flags: jax.Array,
    radix_bits: int,
    chunk: int,
    skip_trivial: bool,
    num_payloads: int,
) -> Tuple[jax.Array, ...]:
    nwords = len(operands) - num_payloads
    n = operands[0].shape[0]
    bins = 1 << radix_bits
    num_chunks = n // chunk
    digits_per_word = -(-32 // radix_bits)
    num_passes = digits_per_word * nwords

    def one_pass(p, ops):
        words = ops[:nwords]
        d = extract_digit(words, p, radix_bits)
        dd = d.reshape(num_chunks, chunk)
        chunk_hist = chunked_digit_histogram(d, bins, num_chunks)
        bases = scatter_bases(chunk_hist)                    # (chunks, bins)
        # Sequential-with-batching map keeps the transient one-hot bounded at
        # batch * chunk * bins int32 (a vmap would materialize n * bins).
        batch = max(1, (1 << 23) // (chunk * bins))
        dest = lax.map(
            lambda args: _rank_and_dest_for_chunk(args[0], args[1], bins),
            (dd, bases),
            batch_size=min(batch, num_chunks),
        ).reshape(n)
        return tuple(
            jnp.zeros_like(a).at[dest].set(a, unique_indices=True) for a in ops
        )

    ops = operands
    for p in range(num_passes):
        if skip_trivial:
            ops = lax.cond(live_flags[p], partial(one_pass, p), lambda o: o, ops)
        else:
            ops = one_pass(p, ops)
    return ops


def sort_words_lsd(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    radix_bits: int = 8,
    chunk: int = 8192,
    skip_trivial: bool = True,
) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Stable ascending LSD radix sort of derived-key words, carrying payloads.

    Same contract as :func:`..ops.hw_engine.sort_words`; see module docstring
    for the pass structure. ``radix_bits`` supports the reference's studied
    widths (8 default, 11 experimental — `README.md:781-811`).
    """
    words = tuple(words)
    payloads = tuple(payloads)
    n = words[0].shape[0]
    if n <= 1:
        return words, payloads

    # Live-digit flags from the *unpadded* input (padding must not force passes).
    mask_words = probes.live_bit_mask(words)
    live = probes.live_digit_mask(mask_words, radix_bits)

    chunk = min(chunk, max(256, n))
    pad = (-n) % chunk
    if pad:
        # Sentinel keys of all-ones sort to the end of every pass and are
        # sliced off; payload padding is inert.
        words_p = tuple(
            jnp.concatenate([w, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
            for w in words
        )
        payloads_p = tuple(
            jnp.concatenate([a, jnp.zeros((pad,), a.dtype)]) for a in payloads
        )
    else:
        words_p, payloads_p = words, payloads

    out = _sort_padded(
        words_p + payloads_p, live, radix_bits, chunk, skip_trivial, len(payloads)
    )
    out = tuple(a[:n] for a in out)
    return out[: len(words)], out[len(words):]
