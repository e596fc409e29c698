"""Harvest per sample: host ms of the program's 'harvest' spans (a
sample's finalize on the drain thread) less their 'sync.*' children
(the waits for the copies and the painted counts): the host assembly of
the sample, from the span registry that the traced stretch filled
(utils/profiling.py), mean over its samples. None where the program has
no such registry or span."""


def _spans():
    try:
        from pc_accumulation_lib_tpu_torch.utils import profiling
        return profiling.snapshot()['spans']
    except (ImportError, AttributeError):
        return {}


def read(rec):
    spans = _spans()
    h = spans.get('harvest')
    if not h or not h['n']:
        return None
    waits = sum(s['under'].get('harvest', 0.0) for name, s in spans.items()
                if name.startswith('sync.'))
    return (h['total_ms'] - waits) / h['n']
