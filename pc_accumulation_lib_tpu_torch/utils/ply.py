"""Minimal PLY point-cloud export (host numpy).

The port's copy of utils/ply.py: accumulated clouds are written as binary
little-endian PLY for external viewers.
"""
from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb=None):
    """Write (N,3) points, with optional (N,3) colours in [0, 255]."""
    n = xyz.shape[0]
    header = ['ply', 'format binary_little_endian 1.0',
              f'element vertex {n}',
              'property float x', 'property float y', 'property float z']
    dtype = [('x', '<f4'), ('y', '<f4'), ('z', '<f4')]
    if rgb is not None:
        header += ['property uchar red', 'property uchar green',
                   'property uchar blue']
        dtype += [('r', 'u1'), ('g', 'u1'), ('b', 'u1')]
    header.append('end_header')
    rec = np.zeros(n, dtype=dtype)
    xyz = np.asarray(xyz, '<f4')
    rec['x'], rec['y'], rec['z'] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if rgb is not None:
        rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
        rec['r'], rec['g'], rec['b'] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, 'wb') as f:
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        f.write(rec.tobytes())


def read_ply(path: str):
    """Read a file of write_ply: (N,3) float32 points and (N,3) uint8
    colours (None when the file has none)."""
    with open(path, 'rb') as f:
        data = f.read()
    end = data.index(b'end_header\n') + len(b'end_header\n')
    info = read_ply_header(path)
    rgb = 'red' in info['props']
    dtype = [('x', '<f4'), ('y', '<f4'), ('z', '<f4')]
    if rgb:
        dtype += [('r', 'u1'), ('g', 'u1'), ('b', 'u1')]
    rec = np.frombuffer(data, dtype=dtype, count=info['n'], offset=end)
    xyz = np.stack([rec['x'], rec['y'], rec['z']], 1)
    return xyz, (np.stack([rec['r'], rec['g'], rec['b']], 1) if rgb
                 else None)


def read_ply_header(path: str) -> dict:
    """Parse a PLY header: {'n': vertex count, 'props': property names}."""
    info = {'n': 0, 'props': []}
    with open(path, 'rb') as f:
        while True:
            line = f.readline().decode('ascii').strip()
            if line.startswith('element vertex'):
                info['n'] = int(line.split()[-1])
            elif line.startswith('property'):
                info['props'].append(line.split()[-1])
            elif line == 'end_header' or not line:
                break
    return info
