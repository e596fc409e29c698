"""Tracker per frame: host ms of the program's 'track' spans (the
tracker's update and the instance tables, accum/tracking.py, on the
dispatching thread) in the span registry that the traced stretch filled
(utils/profiling.py), mean over its spans. None where the program has no
such registry or span."""


def _spans():
    try:
        from pc_accumulation_lib_tpu_torch.utils import profiling
        return profiling.snapshot()['spans']
    except (ImportError, AttributeError):
        return {}


def read(rec):
    s = _spans().get('track')
    return s['total_ms'] / s['n'] if s and s['n'] else None
