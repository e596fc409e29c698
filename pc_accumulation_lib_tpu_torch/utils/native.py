"""Builds the host C++ libraries of ``native/`` with g++ for ctypes.

Each library is compiled at first use into ``build/host/`` under the
repository root, never into ``native/``, and only when the source is newer
than the build. The compiler writes a temporary file beside the target,
which is renamed into place, so a process or thread that loads the library
while another builds it never sees half a file. A failed build raises with
the compiler's output: the port has no silent switch to numpy.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE_DIR = REPO / 'native'
BUILD_DIR = REPO / 'build' / 'host'


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
