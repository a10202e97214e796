"""Configuration for the sort-execution engine.

The reference configures its engine with compile-time template parameters and
make vars (`radix_sort.hpp:98-115` counter-width dispatch, `Makefile:14-40`);
here a single dataclass covers the same knobs plus this engine's own
(execution strategy, pass width, probes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SortConfig", "Strategy", "DEFAULT_CONFIG"]


class Strategy:
    """Execution strategies for the single-device engine.

    AUTO      pick per-call: probes (presorted / live-digit) choose the cheapest
              applicable path, mirroring the reference's runtime early-exit and
              column-skip behavior (`radix_sort.hpp:47-70`).
    HW_SORT   derived-key sort with ``lax.sort`` (on a GPU, XLA hands a
              one-key sort to CUB's radix sort) — the general workhorse.
    COUNTING  the `counting_sort_8.c` contract: keys-only, over a live domain
              of <= counting_max_bits bits that the dtype or a value_mask
              promises statically (raises otherwise). It runs the HW_SORT
              route: on an H100 at 40M keys the library radix sort beat
              every histogram + regeneration formulation at every domain
              from 2^4 to 2^17 bins (PERF.md), and masked 64-bit keys sort
              as one compacted operand.
    LSD       the faithful chunked LSD radix engine (per-digit histogram →
              exclusive scan → stable scatter with ping-pong), structured like
              `radix_sort.hpp:31-93`; the blueprint for the distributed
              shuffle.
    """

    AUTO = "auto"
    HW_SORT = "hw_sort"
    COUNTING = "counting"
    LSD = "lsd"

    ALL = (AUTO, HW_SORT, COUNTING, LSD)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Knobs for the sort engine.

    Attributes:
      strategy: execution strategy, see :class:`Strategy`.
      radix_bits: digit width for the LSD engine and distributed shuffle.
        The reference's tuned default is 8 (`README.md:316-335`), with 11-bit
        digits studied (`README.md:781-811`); both are supported.
      descending: sort order. Implemented via derived-key complement
        (`README.md:566-574`), preserving stability.
      counting_max_bits: ceiling on the live-domain width that an explicit
        ``Strategy.COUNTING`` request accepts (default 17). AUTO does not
        read it.
      lsd_chunk: elements per chunk in the LSD engine's tile decomposition
        (the distributed-memory generalization of `cnt[k]++`,
        `counting_sort_8s.c:23-34`).
      detect_presorted: early-exit on already-sorted input
        (`radix_sort.hpp:48-62`, `README.md:652-669`).
      skip_trivial_digits: elide passes whose digit is constant across all keys
        (column skipping, `radix_sort.hpp:64-70`, diagram `data/colskip.dot`).
      dynamic_probe: in AUTO strategy, measure the live-bit mask of two-word
        (64-bit) keys (one OR-reduce + one AND-reduce + a host sync) and,
        when <= 32 bits vary, sort the planes as ONE compacted operand —
        the runtime form of the reference's probe-based column skipping,
        valid with NO value_mask promise (dead bits are constant by
        measurement). One-word keys are unaffected. Off by default: the
        host sync breaks async dispatch pipelines.
      device_probe: in AUTO strategy (keys-only), two-word (64-bit) keys
        dispatch IN-GRAPH on their hi plane: one fused min/max reduce feeds
        a `lax.cond` that, when every key shares one 2^32 span (clustered
        timestamps, offset ids), sorts the lo plane as ONE operand instead
        of two — NO host sync, so async dispatch pipelines stay intact (the
        fix for what keeps ``dynamic_probe`` off by default). One-word keys
        are unaffected. Valid with no promise: the range is measured,
        in-graph.
    """

    strategy: str = Strategy.AUTO
    radix_bits: int = 8
    descending: bool = False
    counting_max_bits: int = 17
    lsd_chunk: int = 8192
    detect_presorted: bool = True
    skip_trivial_digits: bool = True
    dynamic_probe: bool = False
    device_probe: bool = False

    def __post_init__(self):
        if self.strategy not in Strategy.ALL:
            raise ValueError(f"unknown strategy {self.strategy!r}; one of {Strategy.ALL}")
        if not (1 <= self.radix_bits <= 16):
            raise ValueError("radix_bits must be in [1, 16]")
        if self.lsd_chunk <= 0:
            raise ValueError("lsd_chunk must be positive")

    def replace(self, **kw) -> "SortConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SortConfig()
