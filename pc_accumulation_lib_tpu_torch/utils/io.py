"""Compressed-pickle dataset IO (sem_pc_accum.py:280-308 parity)."""
from __future__ import annotations

import gzip
import os
import pickle


def write_compressed_pickle(obj, filename: str, write_dir: str):
    """Write ``<write_dir>/<filename>.gz`` (gzip pickle). Mirrors
    write_compressed_pickle (sem_pc_accum.py:280-294) including the .gz
    suffix convention."""
    path = os.path.join(write_dir, f'{filename}.gz')
    pkl_obj = pickle.dumps(obj)
    try:
        # mtime=0 keeps the gzip stream a pure function of the payload, so
        # identical samples produce byte-identical files — a crash-resumed
        # job's outputs can be byte-compared against an uninterrupted run
        # (tests/test_job_multichip.py).
        with open(path, 'wb') as raw:
            with gzip.GzipFile(fileobj=raw, mode='wb', mtime=0) as f:
                f.write(pkl_obj)
    except IOError as error:
        print(error)


def read_compressed_pickle(path: str):
    """Read a gzip pickle (sem_pc_accum.py:296-308)."""
    try:
        with gzip.open(path, 'rb') as f:
            return pickle.loads(f.read())
    except IOError as error:
        print(error)
        return None
