"""Device-side input probes: presorted detection and column-skip analysis.

The reference folds two cheap analyses into its histogram pass
(`radix_sort.hpp:47-70`) and uses them to skip work:

* **presorted detection** — count elements out of order while histogramming;
  if fewer than 2 elements are unsorted, return immediately
  (`radix_sort.hpp:48-62`, `README.md:652-669`).
* **column skipping** — sample the first key and probe each digit's histogram:
  if a digit's histogram has all mass in the sampled bucket, the digit is
  constant across the input and its pass can be elided in O(passes) time
  (`radix_sort.hpp:64-70`, `README.md:671-714`, diagram `data/colskip.dot`).

Here both probes are O(n) *dense reductions* (bandwidth-bound, no histogram
needed):

* presorted: ``all(x[i] <= x[i+1])`` as a vector compare + AND-reduce.
* column skip: a digit is trivial iff it is constant, iff its bits don't vary;
  the **live-bit mask** ``OR(x) ^ AND(x)`` (one OR-reduce + one AND-reduce)
  identifies every varying bit. This subsumes the reference's sample-key probe:
  any digit whose bits are all dead is skippable, and the mask also feeds
  plane compaction (64-bit keys with <= 32 live bits sort as one operand).

Both probes return device scalars, consumed by `lax.cond`/pass masks so the
whole sort stays inside one jitted program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "is_sorted_words",
    "word_lt",
    "live_bit_mask",
    "live_digit_mask",
    "compact_live_bits",
    "expand_live_bits",
    "compact_word_planes",
    "expand_word_planes",
]


def word_lt(a: Sequence[jax.Array], b: Sequence[jax.Array]):
    """Elementwise lexicographic a < b over word tuples (most significant first)."""
    lt = None
    eq = None
    for wa, wb in zip(a, b):
        this_lt = wa < wb
        this_eq = wa == wb
        if lt is None:
            lt, eq = this_lt, this_eq
        else:
            lt = lt | (eq & this_lt)
            eq = eq & this_eq
    return lt


def is_sorted_words(words: Sequence[jax.Array]) -> jax.Array:
    """True iff the derived-key sequence is already non-decreasing.

    Equivalent of the reference's fused unsorted-count (`radix_sort.hpp:49-58`)
    reduced to the early-exit predicate (`:60-62`).
    """
    n = words[0].shape[0]
    if n < 2:
        return jnp.bool_(True)
    heads = tuple(w[:-1] for w in words)
    tails = tuple(w[1:] for w in words)
    # sorted iff no adjacent pair has head > tail  <=>  all(not (tail < head))
    return ~jnp.any(word_lt(tails, heads))


def live_bit_mask(words: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
    """Per-word mask of bits that vary across the input (OR-reduce ^ AND-reduce).

    A zero mask means all keys are equal (every pass trivially skippable); the
    popcount decides whether the planes compact into one operand. The
    dense-reduction replacement for
    the sample-key histogram probe (`radix_sort.hpp:64-70`).
    """
    out = []
    for w in words:
        m = jnp.bitwise_or.reduce(w) ^ jnp.bitwise_and.reduce(w)
        out.append(m)
    return tuple(out)


def live_digit_mask(mask_words: Sequence[jax.Array], radix_bits: int) -> jax.Array:
    """Boolean vector over digit positions: True where the digit varies.

    Digits are numbered least-significant first across the concatenated words
    (the LSD pass order, `README.md:316-335`). A False entry is a trivial pass,
    elided exactly like the reference's column skip (`radix_sort.hpp:82-90`
    loops only over live columns).
    """
    nwords = len(mask_words)
    digits_per_word = -(-32 // radix_bits)
    total = digits_per_word * nwords
    digit_mask = np.uint32((1 << radix_bits) - 1)
    flags = []
    for d in range(total):
        word_idx = d // digits_per_word          # 0 = least significant word
        shift = (d % digits_per_word) * radix_bits
        w = mask_words[nwords - 1 - word_idx]    # words are MSW-first
        flags.append(((w >> np.uint32(shift)) & digit_mask) != 0)
    return jnp.stack(flags)


def compact_live_bits(w: jax.Array, mask: int) -> jax.Array:
    """Gather the live bits of ``w`` (per static ``mask``) into the low positions.

    A vectorized PEXT (the reference discusses exactly this key-compaction idea,
    `README.md:716-758`, as an unimplemented optimization). ``mask`` must be a
    static Python int, so the shift network unrolls at trace time.
    """
    mask = int(mask)
    out = jnp.zeros_like(w)
    pos = 0
    for bit in range(32):
        if mask & (1 << bit):
            out = out | (((w >> np.uint32(bit)) & np.uint32(1)) << np.uint32(pos))
            pos += 1
    return out


def expand_live_bits(c: jax.Array, mask: int) -> jax.Array:
    """Inverse of :func:`compact_live_bits` (vectorized PDEP)."""
    mask = int(mask)
    out = jnp.zeros_like(c)
    pos = 0
    for bit in range(32):
        if mask & (1 << bit):
            out = out | (((c >> np.uint32(pos)) & np.uint32(1)) << np.uint32(bit))
            pos += 1
    return out


def compact_word_planes(words: Sequence[jax.Array],
                        masks: Sequence[int]) -> jax.Array:
    """Merge the live bits of multi-word keys into ONE dense u32 word.

    ``words`` are uint32 planes most-significant first; ``masks`` the static
    per-plane live-bit masks (total popcount <= 32). Per-plane PEXT with the
    MSW plane taking the high positions: for keys obeying the masks (dead
    bits constant) the merged word's numeric order equals the planes'
    lexicographic order, and the map is a bijection on the masked domain —
    so sorting by the merged word alone is EXACTLY sorting by the planes,
    with one sorter operand instead of len(words). The key-compaction idea
    of the reference (`README.md:716-758`), applied to the sort operands
    themselves: on a GPU a one-operand sort is the one XLA hands to the
    library radix sort.
    """
    merged = jnp.zeros_like(words[0])
    shift = 0
    for w, m in zip(reversed(tuple(words)), reversed(tuple(masks))):
        m = int(m)
        if m:
            merged = merged | (compact_live_bits(w, m) << np.uint32(shift))
            shift += bin(m).count("1")
    assert shift <= 32, "compacted live bits must fit one u32 word"
    return merged


def expand_word_planes(merged: jax.Array, words: Sequence[jax.Array],
                       masks: Sequence[int]):
    """Inverse of :func:`compact_word_planes` + dead-bit restore.

    ``words`` supplies the constant dead bits (every key shares them under
    the mask promise; element 0 is as good as any). Returns the full-width
    planes of the merged-word-sorted keys.
    """
    words = tuple(words)
    masks = tuple(int(m) for m in masks)
    nbits = sum(bin(m).count("1") for m in masks)
    out = []
    shift = nbits
    for w, m in zip(words, masks):
        nb = bin(m).count("1")
        shift -= nb
        plane = expand_live_bits(
            (merged >> np.uint32(shift)) & np.uint32((1 << nb) - 1), m) \
            if m else jnp.zeros_like(merged)
        dead = w[0] & np.uint32(~m & 0xFFFFFFFF)
        out.append(plane | dead)
    return tuple(out)
