"""HW_SORT engine: derived-key sorting with ``lax.sort``.

This is the general-purpose execution path. The reference's generic engine
(`rs_sort_main`, `radix_sort.hpp:31-93`) reduces every sort to *stable ordering
by an unsigned derived key*; ``lax.sort`` realizes exactly that contract, and
the radix machinery — KDF, probes, multipass 64-bit composition, plane
compaction — wraps it. On a GPU, XLA hands a sort with one key operand (and
at most one value operand) to CUB's radix sort (at 40M u32 keys on an H100:
1.0-1.3 ms, PERF.md); sorts with more operands run XLA's own sort kernel.

Stability and ping-pong semantics: ``is_stable=True`` gives the same
observable guarantee as the reference's stable counting passes
(`counting_sort_8s.c:32`, `README.md:471-473`); there is no caller-visible
aux buffer because XLA owns the double-buffering (the functional analog of the
reference returning "whichever buffer holds the result",
`radix_sort.hpp:92`).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from . import probes

__all__ = ["sort_words", "argsort_words", "sort_words_presort_guard",
           "sort_words2_range_probe"]


def sort_words(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    stable: bool = True,
) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Ascending sort by multi-word derived keys, carrying payloads.

    ``words`` are uint32 planes, most significant first; all words and payloads
    share a common 1-D shape. Returns (sorted_words, permuted_payloads).

    ``stable=False`` is the keys-only fast path: with no payload, equal keys
    are indistinguishable, so the stability guarantee (`README.md:471-473`)
    is vacuous and the unstable sorter produces the identical result. Every
    payload-carrying or rank sort keeps ``stable=True``.
    """
    words = tuple(words)
    payloads = tuple(payloads)
    if payloads and not stable:
        raise ValueError("unstable sort is only valid for keys-only sorts")
    operands = words + payloads
    out = lax.sort(operands, dimension=0, is_stable=stable, num_keys=len(words))
    return tuple(out[: len(words)]), tuple(out[len(words):])


def argsort_words(words: Sequence[jax.Array],
                  index_dtype=jnp.uint32) -> Tuple[Tuple[jax.Array, ...], jax.Array]:
    """Stable argsort: returns (sorted_words, permutation).

    The permutation is the unique stable rank order — identical to the
    reference rank sort's output (`radix_sort_rank.hpp:22-92`), whose
    stability makes the result well-defined independent of algorithm.

    Implementation: the index rides as the LAST SORT KEY, not as payload —
    (key, index) is a strict total order, so the *unstable* sorter yields
    exactly the stable permutation. (On a GPU this is a two-key sort, so XLA
    runs its own sort kernel, not CUB's; ROADMAP queue 1 item 2.)
    """
    n = words[0].shape[0]
    iota = jnp.arange(n, dtype=index_dtype)
    out = lax.sort(tuple(words) + (iota,), dimension=0, is_stable=False,
                   num_keys=len(words) + 1)
    return tuple(out[:-1]), out[-1]


@functools.partial(jax.jit, static_argnames=("num_words", "stable"))
def _presort_guarded(ops, num_words: int, stable: bool):
    def slow(ops):
        sw, sp = sort_words(ops[:num_words], ops[num_words:], stable=stable)
        return sw + sp

    ok = probes.is_sorted_words(ops[:num_words])
    return lax.cond(ok, lambda o: o, slow, ops)


def sort_words_presort_guard(
    words: Sequence[jax.Array],
    payloads: Sequence[jax.Array] = (),
    stable: bool = True,
):
    """sort_words with the reference's presorted early-exit (`radix_sort.hpp:60-62`).

    The probe is one cheap bandwidth-bound pass; `lax.cond` skips the sorter
    entirely when the input is already ordered. The guard is one cached
    ``jit``: an eager ``lax.cond`` built from fresh closures would re-trace
    and re-compile its branches on every call.
    """
    words = tuple(words)
    payloads = tuple(payloads)
    out = _presort_guarded(words + payloads, num_words=len(words),
                           stable=stable)
    return tuple(out[: len(words)]), tuple(out[len(words):])


@functools.partial(jax.jit, static_argnames=("guard",))
def sort_words2_range_probe(hi: jax.Array, lo: jax.Array,
                            guard: bool = False):
    """Keys-only sort of a two-word (64-bit) derived key with in-graph dispatch.

    The reference's always-on probe (`radix_sort.hpp:64-70`) applied to the
    multipass decomposition (`radix_sort_u64_multipass.c:117-118`): one fused
    min/max reduce over the HIGH plane decides — on device, no host sync —
    whether the hi word is constant across the array. If so the order is
    determined by the low plane alone, and the program sorts ONE u32
    operand, which XLA hands to the library radix sort; otherwise the
    two-key sort runs (XLA's own comparison sort on a GPU). A 64-bit key
    population inside one 2^32 span — clustered timestamps, offset-based
    ids — takes the one-operand branch. The cost on full-entropy data is
    one extra bandwidth-bound reduce of the hi plane.

    ``guard``: use the presorted-guarded sorter (composes with
    ``detect_presorted``). Returns the sorted ``(hi, lo)`` planes.
    """
    def sort(words):
        if guard:
            return sort_words_presort_guard(words, stable=False)[0]
        return sort_words(words, stable=False)[0]

    def hi_const():
        # a constant plane is its own sorted self; order rides on lo alone
        return (hi, sort((lo,))[0])

    return lax.cond(jnp.min(hi) == jnp.max(hi), hi_const,
                    lambda: sort((hi, lo)))
