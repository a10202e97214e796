"""Per-digit histograms — the first phase of every radix pass.

Reference: one fused read of the input builds all passes' histograms at once
(`radix_sort_u32.c:24-37`, generic form `radix_sort.hpp:47-58`), with counter
width auto-selected for cache residency (`radix_sort.hpp:98-115`).

Here a histogram is one scatter-add (``jnp.bincount``): on a GPU XLA lowers
it to atomic adds into a ``bins``-long int32 vector, one pass over the
digits. Counter width is always int32.

The module also produces *chunked* histograms ``(num_chunks, bins)`` — the
per-tile counts that make the stable parallel scatter possible (SURVEY §7
hard part #1) and the per-shard counts the distributed shuffle psums.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "extract_digit",
    "digit_histogram",
    "chunked_digit_histogram",
    "multi_digit_histogram",
]


def extract_digit(words: Sequence[jax.Array], pass_index: int, radix_bits: int) -> jax.Array:
    """Digit value of each key for the given LSD pass.

    Digits are numbered least-significant first across the concatenated words
    (words are most-significant first, as produced by :mod:`..ops.kdf`).
    Mirrors the per-pass shift/mask of `radix_sort_u32.c:26-29`.
    """
    nwords = len(words)
    digits_per_word = -(-32 // radix_bits)
    word_idx = pass_index // digits_per_word        # 0 = least significant word
    shift = (pass_index % digits_per_word) * radix_bits
    mask = np.uint32((1 << radix_bits) - 1)
    w = words[nwords - 1 - word_idx]
    return (w >> np.uint32(shift)) & mask


@partial(jax.jit, static_argnames=("bins",))
def digit_histogram(digits: jax.Array, bins: int) -> jax.Array:
    """(bins,) int32 histogram of a digit vector (scatter-add).

    Digits outside ``[0, bins)`` are dropped (``jnp.bincount`` with a static
    ``length``).
    """
    return jnp.bincount(digits, length=bins).astype(jnp.int32)


@partial(jax.jit, static_argnames=("bins", "num_chunks"))
def chunked_digit_histogram(digits: jax.Array, bins: int, num_chunks: int) -> jax.Array:
    """(num_chunks, bins) histogram; chunk c covers digits[c*chunk : (c+1)*chunk].

    Requires ``len(digits) % num_chunks == 0`` (engines pad beforehand). This is
    the tile-major count matrix whose bucket-major exclusive scan yields the
    stable parallel scatter offsets (the distributed generalization of
    `counting_sort_8s.c:23-34`).
    """
    n = digits.shape[0]
    assert n % num_chunks == 0, (n, num_chunks)
    d = digits.reshape(num_chunks, n // num_chunks)
    binv = jnp.arange(bins, dtype=jnp.uint32)
    return jnp.sum(
        (d[:, :, None] == binv[None, None, :]).astype(jnp.int32), axis=1, dtype=jnp.int32
    )


def multi_digit_histogram(words: Sequence[jax.Array], radix_bits: int) -> jax.Array:
    """All passes' histograms from one traversal: (num_passes, bins) int32.

    The fused all-histograms read of `radix_sort_u32.c:24-37` as a standalone
    op (listing parity + histogram analyses): one scatter-add per pass.

    Note it is NOT on the production sort paths: the LSD engine's stable
    parallel scatter needs *chunk-resolved* counts per pass
    (:func:`chunked_digit_histogram` -> scatter bases), which a fused
    global-histogram read cannot provide, and the engines' column skipping
    uses the cheaper live-bit OR/AND reduce (`probes.live_bit_mask`) instead
    of the reference's histogram probe.
    """
    nwords = len(words)
    digits_per_word = -(-32 // radix_bits)
    num_passes = digits_per_word * nwords
    bins = 1 << radix_bits
    hists = []
    for p in range(num_passes):
        hists.append(digit_histogram(extract_digit(words, p, radix_bits), bins))
    return jnp.stack(hists)
