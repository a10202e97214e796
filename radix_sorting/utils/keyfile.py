"""Benchmark dataset handling: the 40M-key file and synthetic generators.

Reference: ``make genkeys`` creates ``40M_32bit_keys.dat`` — 40,000,000 random
u32 (160 MB) from /dev/urandom (`Makefile:79-82`); the CLI reads it with
optional mmap / hugepage placement (`radix_experiment.cpp:53-104`). Host-side
allocator tricks do not transfer to an accelerator (the array lives in device
memory); what remains
is deterministic dataset generation, raw-file IO, and the CLI's value-mask
fault-injection knob (`radix_experiment.cpp:188-198`).

A native (C++) fast path for file IO lives in :mod:`..runtime.native`; this
module is the portable layer.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = [
    "DEFAULT_COUNT",
    "default_keyfile",
    "generate_keys",
    "write_keyfile",
    "read_keyfile",
    "load_or_create",
]

DEFAULT_COUNT = 40_000_000  # `Makefile:79-82`


def default_keyfile(root: str | os.PathLike | None = None) -> Path:
    root = Path(root) if root is not None else Path(__file__).resolve().parents[2] / "data"
    return root / "40M_32bit_keys.dat"


def generate_keys(count: int = DEFAULT_COUNT, seed: int = 0x5EED) -> np.ndarray:
    """Deterministic uniform-random u32 keys (PCG64), reference-shaped dataset.

    The reference uses /dev/urandom; we default to a seeded PRNG so benchmark
    runs and bit-exactness checks are reproducible across machines.
    """
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 1 << 32, size=count, dtype=np.uint32)


def write_keyfile(path: str | os.PathLike, keys: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    keys.astype("<u4").tofile(path)


def read_keyfile(path: str | os.PathLike, count: int | None = None, dtype=np.uint32) -> np.ndarray:
    """Read up to ``count`` keys from a raw little-endian key file.

    The CLI semantics of `radix_experiment.cpp:78-104` (read the first
    ``count * sizeof(T)`` bytes); mmap when possible to avoid a copy.
    """
    path = Path(path)
    dt = np.dtype(dtype).newbyteorder("<")
    n_avail = path.stat().st_size // dt.itemsize
    n = n_avail if count is None else min(count, n_avail)
    try:
        arr = np.memmap(path, dtype=dt, mode="r", shape=(n,))
        return np.asarray(arr)
    except (OSError, ValueError):
        return np.fromfile(path, dtype=dt, count=n)


def load_or_create(count: int = DEFAULT_COUNT, path: str | os.PathLike | None = None,
                   seed: int = 0x5EED) -> np.ndarray:
    """Return the benchmark keys, creating and caching the key file if needed.

    The file is grown to cover ``count`` words when a larger request arrives
    (e.g. the CLI reading 40M u64 = 80M u32 words, or 160M-class wide-tier
    runs). PCG64 integer draws are prefix-stable — ``generate_keys(2n)[:n]
    == generate_keys(n)`` — so growth keeps the first 40M words (and every
    artifact derived from them: parity cases, bench numbers) bit-identical.
    """
    p = Path(path) if path is not None else default_keyfile()
    want = max(int(count), DEFAULT_COUNT)
    have = p.stat().st_size // 4 if p.exists() else 0
    if have < want:
        write_keyfile(p, generate_keys(want, seed))
    return read_keyfile(p, count)
