"""Kernel 1's share of its byte bound: the least time of every call in
the traced stretch (arith/stats_bytes over the keyed rows and groups the
harness recorded, at 3.35 TB/s) over the profiler's device time of the
kernel in that stretch."""


def read(rec):
    tr = rec.get('trace')
    if not tr or not rec.get('stats_calls'):
        return None
    kernel_s = tr['kernel_s'].get('segmented_stats', 0.0)
    if kernel_s <= 0:
        return None
    return 100.0 * rec['stats_bound_s'] / kernel_s
