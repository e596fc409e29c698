"""Semseg per frame (all cameras): CUDA-event span from the model's
forward pre-hook to its forward hook, summed over the window and divided
by its frames."""


def read(rec):
    ms = rec['spans'].get('semseg')
    return sum(ms) / rec['frames'] if ms and rec['frames'] else None
