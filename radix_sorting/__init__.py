"""radix_sorting — a vectorized sort-execution framework for accelerators.

A from-scratch JAX/XLA re-design of the capability set of
eloj/radix-sorting (see SURVEY.md at the repo root): stable value/record/rank
sorting for all fixed-width key types via key-derivation transforms, counting
and bitmap fast paths, multipass 64-bit composition, column-skip and
presorted-input elision — on one device and across a device mesh.

Public API:
  sort, argsort/rank_sort, sort_pairs, counting_sort, sort_u64_multipass,
  bitmap_unique_sort, SortConfig/Strategy, and the models.* sorter zoo.
Distributed:
  parallel.distributed_sort over a jax.sharding.Mesh.
"""

from .api import (
    argsort,
    argsort_batched,
    counting_sort,
    rank_sort,
    sort,
    sort_batched,
    sort_pairs,
    sort_pairs_batched,
    sort_u64_multipass,
)
from .config import DEFAULT_CONFIG, SortConfig, Strategy
from .extras import (
    bincount,
    group_reduce,
    lexsort,
    merge_sorted,
    searchsorted,
    nth_element,
    stable_partition,
    value_counts,
    segmented_argsort,
    segmented_sort,
    sort_complex,
    top_k,
    top_k_batched,
    unique_sorted,
)
from .ops.bitmap import bitmap_unique_sort
from .stats import (
    argpartition,
    digitize,
    histogram,
    histogram_bin_edges,
    median,
    mode,
    partition,
    percentile,
    quantile,
    rankdata,
)
from .sets import (
    UniqueResult,
    in1d,
    intersect1d,
    isin,
    setdiff1d,
    setxor1d,
    union1d,
    unique,
    unique_all,
    unique_counts,
    unique_inverse,
    unique_values,
)

__version__ = "0.4.1"

__all__ = [
    "sort",
    "argsort",
    "rank_sort",
    "sort_pairs",
    "counting_sort",
    "sort_u64_multipass",
    "sort_batched",
    "argsort_batched",
    "sort_pairs_batched",
    "bitmap_unique_sort",
    "lexsort",
    "merge_sorted",
    "searchsorted",
    "bincount",
    "nth_element",
    "stable_partition",
    "value_counts",
    "group_reduce",
    "unique_sorted",
    "sort_complex",
    "unique",
    "unique_values",
    "unique_counts",
    "unique_inverse",
    "unique_all",
    "UniqueResult",
    "isin",
    "in1d",
    "union1d",
    "intersect1d",
    "setdiff1d",
    "setxor1d",
    "segmented_sort",
    "segmented_argsort",
    "top_k",
    "top_k_batched",
    "rankdata",
    "quantile",
    "percentile",
    "median",
    "mode",
    "digitize",
    "histogram",
    "histogram_bin_edges",
    "partition",
    "argpartition",
    "SortConfig",
    "Strategy",
    "DEFAULT_CONFIG",
    "__version__",
]
