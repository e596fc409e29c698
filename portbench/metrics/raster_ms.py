"""Raster per sample: CUDA-event span around each raster call, summed
over the window and divided by its samples."""


def read(rec):
    ms = rec['spans'].get('raster')
    return sum(ms) / rec['samples'] if ms and rec['samples'] else None
