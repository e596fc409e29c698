"""Asynchronous compressed-pickle dataset writer.

The port's copy of the JAX package's utils/async_writer.py. Python
pickles the sample (cheap); gzip compression + disk IO run on the native
C++ thread pool (native/fastio.cpp, built on demand with g++ into
``build/host/`` under the repository root), keeping the accumulation
pipeline off the serialization critical path. This is host IO, not the
device: where no C++ toolchain is available it falls back to a Python
ThreadPoolExecutor + gzip, as the JAX package's writer does.
"""
from __future__ import annotations

import ctypes
import gzip
import os
import pickle
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parents[2]
_NATIVE_SRC = _REPO / 'native' / 'fastio.cpp'
_NATIVE_LIB = _REPO / 'build' / 'host' / 'libfastio.so'


def _build_native() -> Optional[str]:
    src, lib = _NATIVE_SRC, _NATIVE_LIB
    if not src.exists():
        return None
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return str(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run(
            ['g++', '-O2', '-shared', '-fPIC', '-o', tmp, str(src), '-lz',
             '-lpthread'], check=True, capture_output=True)
        os.replace(tmp, lib)   # atomic: a concurrent build never sees half
        return str(lib)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f'fastio build failed ({e}); falling back to Python gzip')
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class AsyncPickleWriter:
    """write(obj, filename, dir) -> queued gzip pickle; wait() to drain."""

    def __init__(self, n_threads: int = 4, compresslevel: int = 6,
                 force_python: bool = False):
        self.compresslevel = compresslevel
        self._lib = None
        self._pool = None
        if not force_python:
            lib_path = _build_native()
            if lib_path:
                lib = ctypes.CDLL(lib_path)
                lib.fastio_init.argtypes = [ctypes.c_int]
                lib.fastio_submit.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
                    ctypes.c_int
                ]
                lib.fastio_pending.restype = ctypes.c_long
                lib.fastio_errors.restype = ctypes.c_long
                lib.fastio_init(n_threads)
                self._lib = lib
                import atexit
                atexit.register(lib.fastio_shutdown)
        if self._lib is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=n_threads)
            self._futures = []

    @property
    def native(self) -> bool:
        return self._lib is not None

    def write(self, obj, filename: str, write_dir: str):
        """Queue ``<write_dir>/<filename>.gz`` (same naming as
        utils.io.write_compressed_pickle)."""
        path = os.path.join(write_dir, f'{filename}.gz')
        payload = pickle.dumps(obj)
        if self._lib is not None:
            self._lib.fastio_submit(path.encode(), payload, len(payload),
                                    self.compresslevel)
        else:
            def task(p=path, d=payload):
                # mtime=0 like utils/io.py (and like the native zlib
                # path): byte-deterministic outputs for resume compares.
                with open(p, 'wb') as raw:
                    with gzip.GzipFile(
                            fileobj=raw, mode='wb', mtime=0,
                            compresslevel=self.compresslevel) as f:
                        f.write(d)
            self._futures.append(self._pool.submit(task))

    def pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.fastio_pending())
        self._futures = [f for f in self._futures if not f.done()]
        return len(self._futures)

    def wait(self):
        if self._lib is not None:
            self._lib.fastio_wait_all()
            if int(self._lib.fastio_errors()):
                raise IOError('fastio reported write errors')
        else:
            for f in self._futures:
                f.result()
            self._futures = []
