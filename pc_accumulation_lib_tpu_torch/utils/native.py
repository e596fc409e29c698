"""Builds the host C++ libraries of ``native/`` with g++, and the port's
CUDA kernels of ``csrc/`` with nvcc, for ctypes.

Each host library is compiled at first use into ``build/host/`` under the
repository root, never into ``native/``, and only when the source is newer
than the build; each kernel library into ``build/torch_kernels/``, under a
name that carries a hash of its source and flags. The compiler writes a temporary file beside the target,
which is renamed into place, so a process or thread that loads the library
while another builds it never sees half a file. A failed build raises with
the compiler's output: the port has no silent switch to numpy.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE_DIR = REPO / 'native'
BUILD_DIR = REPO / 'build' / 'host'
CUDA_BUILD_DIR = REPO / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def build_shared_library(source: Path, library: Path) -> Path:
    """Compile ``source`` into ``library`` with ``g++ -O3 -shared -fPIC``
    unless the library is newer than the source. Raises RuntimeError with
    g++'s stderr if it fails."""
    if library.exists() and (library.stat().st_mtime
                             >= source.stat().st_mtime):
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=library.parent)
    os.close(fd)
    try:
        proc = subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', tmp,
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed to build {source} '
                               f'({proc.returncode}):\n{proc.stderr}')
        os.replace(tmp, library)    # atomic: a concurrent build never
    finally:                        # sees half a library
        if os.path.exists(tmp):
            os.unlink(tmp)
    return library


def build_cuda_library(source: Path) -> Path:
    """Compile the kernel source ``source`` (csrc/<name>.cu) with nvcc
    for sm_90a unless this source's build exists (the file name carries a
    hash of the source and the flags, so an edit rebuilds). The compiler's
    report (registers, shared memory, spills) is kept beside it as
    ``.log``. Raises if nvcc is missing or fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    out = CUDA_BUILD_DIR / f'{source.stem}_{h.hexdigest()[:16]}.so'
    if out.exists():
        return out
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f'nvcc not found: set CUDA_HOME to the CUDA '
                           f'toolkit to build {source.name}')
    nvcc = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    CUDA_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=CUDA_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, str(source)],
                              capture_output=True, text=True)
        out.with_suffix('.log').write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
