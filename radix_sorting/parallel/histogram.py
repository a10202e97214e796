"""Distributed histogram reduction: local counts + psum over the mesh.

The distributed form of the reference's fused histogram pass
(`radix_sort.hpp:47-58`): every device histograms its shard, one `psum`
collective produces the exact global per-digit distribution on every device,
placed by XLA (NCCL on GPUs). Feeds the shuffle's
splitter computation and the distributed column-skip probe.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.histogram import digit_histogram, extract_digit
from ..ops.probes import live_bit_mask

__all__ = ["global_digit_histogram", "global_live_bit_mask",
           "distributed_bincount"]


@partial(jax.jit, static_argnames=("mesh", "axis_name", "radix_bits", "pass_index"))
def global_digit_histogram(x: jax.Array, mesh: Mesh, pass_index: int = 0,
                           radix_bits: int = 8, axis_name: str = "shards") -> jax.Array:
    """Exact global histogram of one digit of a mesh-sharded u32 array."""
    num_passes = -(-32 // radix_bits)
    if not 0 <= pass_index < num_passes:
        # extract_digit's word indexing would silently wrap a negative list
        # index back to pass 0 — a wrong global distribution, not an error
        raise ValueError(
            f"pass_index {pass_index} out of range for {radix_bits}-bit "
            f"digits of a u32 plane (valid: 0..{num_passes - 1})")
    bins = 1 << radix_bits

    def body(shard):
        d = extract_digit((shard,), pass_index, radix_bits)
        return lax.psum(digit_histogram(d, bins), axis_name)

    return jax.shard_map(
        body, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_vma=False
    )(x)


@partial(jax.jit, static_argnames=("mesh", "axis_name"))
def global_live_bit_mask(x: jax.Array, mesh: Mesh, axis_name: str = "shards") -> jax.Array:
    """Global live-bit mask (OR ^ AND) of a mesh-sharded u32 array.

    The distributed column-skip probe: one element per device, ONE tiny
    collective (the per-device OR and AND scalars gather as a stacked pair).
    """

    def body(shard):
        # OR/AND reductions across the mesh via one all_gather of the
        # per-device (or, and) pair (a (D, 2) gather), then a local fold —
        # one latency-bound collective instead of two.
        local = jnp.stack([jnp.bitwise_or.reduce(shard),
                           jnp.bitwise_and.reduce(shard)])
        g = lax.all_gather(local, axis_name)              # (D, 2)
        return (jnp.bitwise_or.reduce(g[:, 0])
                ^ jnp.bitwise_and.reduce(g[:, 1]))[None]

    return jax.shard_map(
        body, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_vma=False
    )(x)[0]


@partial(jax.jit, static_argnames=("mesh", "length", "axis_name"))
def distributed_bincount(x: jax.Array, mesh: Mesh, length: int,
                         axis_name: str = "shards") -> jax.Array:
    """``np.bincount`` of a mesh-sharded integer array: local dense
    histograms + ONE psum.

    The public generalization of :func:`global_digit_histogram` to
    arbitrary value domains: every device bincounts its shard (one
    scatter-add, :func:`..extras.bincount`), and a single ``psum`` of the
    (length,) counts produces the exact global distribution replicated on
    every device. Values outside ``[0, length)`` are dropped (the
    :func:`..extras.bincount` contract), which also makes the
    divisibility padding free — pad slots carry the u32 sentinel, which is
    always out of range. Returns int32 counts of shape ``(length,)``.
    """
    from ..extras import bincount

    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    xa = jnp.asarray(x)
    if xa.ndim != 1:
        raise ValueError(f"bincount input must be 1-D, got shape {xa.shape}")
    w = xa.astype(jnp.uint32)
    D = mesh.shape[axis_name]
    pad = (-int(w.shape[0])) % D
    if pad:
        w = jnp.concatenate([w, jnp.full((pad,), jnp.uint32(0xFFFFFFFF))])

    def body(shard):
        return lax.psum(bincount(shard, length=length), axis_name)

    return jax.shard_map(
        body, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_vma=False
    )(w)
