"""Paint and insert per frame: device ms (CUDA events on the stream) of
the program's 'paint' span (the multi-camera paint) and 'insert' span
(compact_rows, the ring insert, the dyn-table update) in the span
registry that the traced stretch filled (utils/profiling.py), summed and
divided by its frames (one 'paint' a frame). None where the program has
no such registry or spans."""


def _spans():
    try:
        from pc_accumulation_lib_tpu_torch.utils import profiling
        return profiling.snapshot()['spans']
    except (ImportError, AttributeError):
        return {}


def read(rec):
    spans = _spans()
    paint, insert = spans.get('paint'), spans.get('insert')
    if (not paint or not insert or not paint['n']
            or paint['device_ms'] is None or insert['device_ms'] is None):
        return None
    return (paint['device_ms'] + insert['device_ms']) / paint['n']
