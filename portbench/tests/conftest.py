"""Test helpers of the benchmark: a tiny copy of the benchmark tree whose
cells run on the CPU, and the ``chip`` marker for tests that need the
card (decided inside a fixture, never at import).

Run them from the checkout's root:

    python3 -m pytest portbench/tests -q
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes at which a cell runs on the CPU in seconds: every width of the
# configuration file is overridden here, nothing else.
TINY = {
    'nuscenes_oracle': dict(
        camera={'img_hw': [32, 64]}, scene_keyframes=6,
        stream={'lidar_range': 25.0, 'points_per_frame': 2000},
        semseg={'stage_sizes': [1, 1, 1, 1], 'compute_dtype': 'float32'},
        accum=dict(max_points_per_frame=4096, max_frames=8,
                   max_painted_points_per_frame=4096),
        bev={'pixel_size': 32}),
}
TINY_TRAFFIC = {
    'oracle_6cam': dict(trace_frames=3, check=dict(drawn=1, drawn_within=2,
                                                   semseg_frames=3)),
}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs a CUDA card (skipped without one)')


@pytest.fixture
def chip():
    """Skips the test unless a CUDA card is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: run on the chip')
    return torch.device('cuda', 0)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def copy_bench(dst: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under ``dst``."""
    shutil.copy(ROOT / 'BENCHMARK.json', dst / 'BENCHMARK.json')
    shutil.copytree(ROOT / 'portbench', dst / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose configurations and traffic mixes are
    cut to the TINY sizes."""
    root = copy_bench(tmp_path)
    for d, table in (('configs', TINY), ('traffic', TINY_TRAFFIC)):
        for name, over in table.items():
            p = root / 'portbench' / d / f'{name}.json'
            p.write_text(json.dumps(_merge(json.loads(p.read_text()),
                                           over)))
    return root


def tiny_ctx(root, workload, seed=2147483659, seconds=2.0, trace=0):
    import time

    import torch
    from portbench.harness import runner
    from portbench.harness.manifest import Manifest
    return runner.make_ctx(Manifest(root), workload, seed, seconds, trace,
                           time.perf_counter(), torch.device('cpu'))
