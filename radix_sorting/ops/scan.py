"""Exclusive prefix sums over histograms — the second phase of a radix pass.

Reference: an in-register exclusive scan over 256 counters per pass
(`counting_sort_8s.c:16-21`, fused four-wide in `radix_sort_u32.c:39-57`,
live-columns-only in `radix_sort.hpp:72-80`).

These scans are tiny (bins or chunks x bins elements) and run as single
fused `cumsum` ops; the interesting structure is the **two-level scatter
offset** computation: with the input cut into chunks (tiles), a stable scatter
needs, for chunk ``c`` and bucket ``b``::

    base[c, b] = global_bucket_start[b] + (# keys with digit b in chunks < c)

i.e. an exclusive scan over buckets of the total histogram, plus an exclusive
scan over chunks *within* each bucket of the chunked histogram. That is the
distributed-memory generalization of the scalar ``cnt[k]++`` rewrite
(`counting_sort_8s.c:23-34`) and is shared verbatim by the single-device LSD
engine (chunks = tiles) and the distributed shuffle (chunks = devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["exclusive_scan", "scatter_bases"]


def exclusive_scan(counts: jax.Array, axis: int = -1) -> jax.Array:
    """Exclusive prefix sum along ``axis`` (same dtype as input)."""
    inc = jnp.cumsum(counts, axis=axis, dtype=counts.dtype)
    return inc - counts


def scatter_bases(chunk_hist: jax.Array) -> jax.Array:
    """Per-(chunk, bucket) stable scatter base offsets.

    Args:
      chunk_hist: (num_chunks, bins) int32 — per-chunk digit counts.

    Returns:
      (num_chunks, bins) int32 — ``base[c, b]`` as defined above. Within chunk
      ``c``, the j-th key carrying digit ``b`` (in input order) lands at
      ``base[c, b] + j``, which is exactly stable.
    """
    total = jnp.sum(chunk_hist, axis=0)                     # (bins,)
    global_start = exclusive_scan(total, axis=0)            # (bins,)
    within_bucket = exclusive_scan(chunk_hist, axis=0)      # (chunks, bins), scan over chunks
    return global_start[None, :] + within_bucket
