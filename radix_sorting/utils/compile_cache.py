"""Persistent compilation cache — the PGO analog.

The reference ships a profile-generate/profile-use build cycle
(`Makefile:69-77`, `:22-30`): pay a profiling run once, reuse the optimized
binary after. The JAX counterpart is the persistent compilation cache: the
first process pays trace+compile for each (program, shape) and serializes
the executable; later processes deserialize instead of recompiling.

Enabled by the process entry points (CLI, bench, chip_smoke) — never by
library import, so embedding applications keep control of their own cache
policy. Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no directory;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``). The path is part of the cache key, so it must
  not move between runs.

CPU-only processes (``JAX_PLATFORMS=cpu``, as the tests and the gloo
workers run) get no default cache: XLA:CPU AOT artifacts are
machine-feature brittle on reload ("+prefer-no-scatter not supported on the
host machine ... could lead to SIGILL" when one CPU process reloads
another's cache).
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache. Returns the cache dir.

    Idempotent. Thresholds are zeroed so even small sort programs cache —
    the workload is a handful of executables, not a training sweep. Checked
    via the environment, not ``jax.default_backend()``, so calling this
    never initializes the runtime (workers call it before
    ``jax.distributed.initialize``).
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir and os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return None
    import jax

    if not env_dir:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return env_dir or DEFAULT_CACHE_DIR
