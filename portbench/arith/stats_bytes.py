"""Bytes, operations and the least time of one call of the port's
segmented-stats kernel 1 (``segmented_stats_words``).

Each keyed row (a row whose group key is below the group count) is read
once: its key and its two payload words, 12 bytes. Each group's output
is written once: ``n_weights`` sums, the z-min and two medians of each
of ``n_values`` value channels, 4 bytes each. Kernel 1 sums 4 weights
and takes 3 medians. A row costs one operation per weight, the z-min and
one per value.
"""
from __future__ import annotations

from portbench.arith import peaks

WORDS_ROW_BYTES = 12
WORDS_WEIGHTS = 4
WORDS_VALUES = 3


def stats_bound(keyed_rows, row_bytes, groups, n_weights, n_values):
    """{'bytes', 'ops', 'bound_s', 'bound_by'} of one stats call."""
    nbytes = keyed_rows * row_bytes + groups * 4 * (n_weights + 1
                                                    + 2 * n_values)
    ops = keyed_rows * (n_weights + 1 + n_values)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = ops / peaks.FP32_FLOPS
    return dict(bytes=nbytes, ops=ops, bound_s=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def words_bound(keyed_rows, groups):
    """The bound of one kernel-1 call."""
    return stats_bound(keyed_rows, WORDS_ROW_BYTES, groups, WORDS_WEIGHTS,
                       WORDS_VALUES)
