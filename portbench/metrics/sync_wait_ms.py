"""Host waits per frame: host ms of the program's 'sync.*' spans opened
inside its 'integrate' spans (the painted-count check's wait for the
previous frame's event) in the span registry that the traced stretch
filled (utils/profiling.py), summed and divided by the 'integrate'
spans. None where the program has no such registry or span."""


def _spans():
    try:
        from pc_accumulation_lib_tpu_torch.utils import profiling
        return profiling.snapshot()['spans']
    except (ImportError, AttributeError):
        return {}


def read(rec):
    spans = _spans()
    integ = spans.get('integrate')
    if not integ or not integ['n']:
        return None
    waits = sum(s['under'].get('integrate', 0.0)
                for name, s in spans.items() if name.startswith('sync.'))
    return waits / integ['n']
