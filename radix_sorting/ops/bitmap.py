"""Bitmap ("esoteric") unique-sort: 1 bit of presence per possible value.

Reference `bitmap_sort_16.c:6-28`: mark a presence bit per value, then emit
sorted unique values by scanning the bitmap with ``bits & -bits`` + ``ctz``.
O(domain) memory, output is the sorted *set* (duplicates collapse).

Here the presence "bitmap" is a boolean presence vector over the value domain
(the bit-packing is a CPU cache trick; on a vector machine a vector of flags is
the natural layout, and the scan is a dense prefix-sum instead of a serial ctz
loop). Emission uses the fixed-shape contract JAX requires:
``(values, count)`` with ``values`` padded to a static size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bitmap_unique_sort"]


@partial(jax.jit, static_argnames=("domain_bits", "size", "fill_value"))
def _bitmap_unique(x: jax.Array, domain_bits: int, size: int, fill_value: int):
    domain = 1 << domain_bits
    present = jnp.zeros((domain,), jnp.bool_).at[x.astype(jnp.int32)].set(True)
    values, = jnp.nonzero(present, size=size, fill_value=fill_value)
    count = jnp.sum(present.astype(jnp.int32))
    return values.astype(x.dtype), count


def bitmap_unique_sort(x: jax.Array, size: int | None = None, fill_value: int | None = None):
    """Sorted unique values of an unsigned array of <= 16-bit domain.

    Args:
      x: 1-D uint8/uint16 array.
      size: static length of the returned value vector (default: full domain).
      fill_value: padding value for slots past ``count`` (default: domain max).

    Returns:
      (values, count): ``values[:count]`` are the sorted uniques, the tail is
      ``fill_value``. Mirrors `bitmap_sort_16.c` with a fixed-shape device
      contract instead of a variable-length print loop.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError("bitmap_unique_sort supports uint8/uint16 keys")
    domain_bits = x.dtype.itemsize * 8
    if size is None:
        size = 1 << domain_bits
    if fill_value is None:
        fill_value = (1 << domain_bits) - 1
    return _bitmap_unique(x, domain_bits, int(size), int(fill_value))
