"""Multi-device / multi-host scale-out: mesh shuffle and distributed reductions."""

from .balanced import (  # noqa: F401
    distributed_argsort_balanced,
    distributed_argsort_balanced_u32,
    distributed_group_reduce,
    distributed_median,
    distributed_quantile,
    distributed_select,
    distributed_sort_balanced,
    distributed_sort_balanced_u32,
    distributed_sort_pairs_balanced,
    distributed_sort_pairs_balanced_u32,
    distributed_top_k,
    distributed_unique_sorted,
)
from .histogram import (  # noqa: F401
    distributed_bincount,
    global_digit_histogram,
    global_live_bit_mask,
)
from .shuffle import (  # noqa: F401
    distributed_argsort,
    distributed_argsort_u32,
    distributed_sort,
    distributed_sort_pairs,
    distributed_sort_pairs_u32,
    distributed_sort_u32,
    gather_sorted,
    make_sort_mesh,
)
