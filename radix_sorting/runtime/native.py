"""ctypes bindings to the native host runtime (radix_sorting/native/radix_rt.cpp).

Builds the shared library on demand with g++ (cached by source mtime) — the
framework's native components are real compiled code, matching the
reference's C/C++ host machinery, while degrading gracefully to numpy
fallbacks when no toolchain is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "load",
    "available",
    "read_keyfile",
    "generate_keyfile",
    "is_sorted",
    "oracle_sort",
    "oracle_rank",
]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "radix_rt.cpp"
_BUILD = _PKG / "native" / "build"
_LIB = _BUILD / "libradixrt.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _kind_of(dtype) -> int:
    d = np.dtype(dtype)
    kinds = {"u": 0, "i": 1, "f": 2}
    if d.kind not in kinds:
        raise ValueError(f"unsupported dtype for the native oracle: {d}")
    return kinds[d.kind]


def _build() -> bool:
    try:
        # may fail on a read-only install (site-packages without write
        # permission) — degrade to the numpy fallbacks, per the module contract
        _BUILD.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        str(_SRC), "-o", str(_LIB),
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        import sys
        print(f"radix_rt build failed:\n{r.stderr}", file=sys.stderr)
        return False
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not _SRC.exists():
        return None
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.rrt_read_keyfile.restype = ctypes.c_int64
    lib.rrt_read_keyfile.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int]
    lib.rrt_generate_keyfile.restype = ctypes.c_int
    lib.rrt_generate_keyfile.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_uint64]
    lib.rrt_is_sorted.restype = ctypes.c_int
    lib.rrt_is_sorted.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rrt_oracle_sort.restype = ctypes.c_int
    lib.rrt_oracle_sort.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int]
    lib.rrt_oracle_rank.restype = ctypes.c_int
    lib.rrt_oracle_rank.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def read_keyfile(path, count: int, dtype=np.uint32) -> np.ndarray:
    """mmap-backed key file read; numpy fallback when native is unavailable."""
    d = np.dtype(dtype)
    lib = load()
    if lib is None:
        from ..utils.keyfile import read_keyfile as np_read
        return np_read(path, count, d)
    out = np.empty(count, dtype=d)
    got = lib.rrt_read_keyfile(str(path).encode(), out.ctypes.data, count, d.itemsize)
    if got < 0:
        raise OSError(f"native read of {path} failed")
    return out[:got]


def generate_keyfile(path, count: int, seed: int = 0x5EED) -> None:
    """Write the CANONICAL benchmark key stream (PCG64) to ``path``.

    Always the numpy/PCG64 stream — the native `rrt_generate_keyfile`
    (splitmix64) produces a DIFFERENT byte stream for the same (count,
    seed), so routing through it would make the dataset depend on whether a
    C++ toolchain is present (round-3 review finding). The native generator
    remains in the library for standalone C consumers, documented as a
    non-canonical stream.
    """
    from ..utils import keyfile as kf
    kf.write_keyfile(path, kf.generate_keys(count, seed))


def is_sorted(arr: np.ndarray, descending: bool = False) -> bool:
    lib = load()
    a = np.ascontiguousarray(arr)
    if lib is None:
        from ..utils.verify import is_sorted as jax_is_sorted
        return jax_is_sorted(a, descending)
    r = lib.rrt_is_sorted(a.ctypes.data, a.size, a.dtype.itemsize,
                          _kind_of(a.dtype), int(descending))
    if r < 0:
        raise ValueError(f"unsupported dtype {a.dtype}")
    return bool(r)


def oracle_sort(arr: np.ndarray) -> np.ndarray:
    """Independent native stable LSD sort (KDF order); returns a new array."""
    lib = load()
    a = np.ascontiguousarray(arr).copy()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    r = lib.rrt_oracle_sort(a.ctypes.data, a.size, a.dtype.itemsize,
                            _kind_of(a.dtype))
    if r == -2:
        raise MemoryError("native oracle allocation failed")
    if r != 0:
        raise ValueError(f"unsupported dtype {a.dtype}")
    return a


def oracle_rank(arr: np.ndarray) -> np.ndarray:
    """Independent native stable argsort; input untouched."""
    lib = load()
    a = np.ascontiguousarray(arr)
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    idx = np.empty(a.size, dtype=np.uint32)
    r = lib.rrt_oracle_rank(a.ctypes.data, idx.ctypes.data, a.size,
                            a.dtype.itemsize, _kind_of(a.dtype))
    if r == -2:
        raise MemoryError("native oracle allocation failed")
    if r != 0:
        raise ValueError(f"unsupported dtype {a.dtype}")
    return idx
