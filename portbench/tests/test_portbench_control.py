"""The control: the reference put in the program's place one precision
step below the configuration (TF32 matmul operands, fp8 convolutions) has to come
out not correct under the cell's limits. At a tiny size on the CPU here;
at the cell's own size on the chip with the ``chip`` marker."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, tiny_ctx
from portbench import readings
from portbench.harness.manifest import Manifest
from portbench.reference.compare import judge

CELLS = ['nuscenes_oracle_6cam']


def _judged(manifest, workload, seed, seconds, device):
    rows = readings.readings(manifest, workload, seed, seconds, device,
                             control=True)
    limits = manifest.limits(manifest.cell(workload))
    out = {}
    for r in rows:
        if r.get('crashed'):
            out[r['run']] = False        # a control that stops has failed
        else:
            out[r['run']] = judge(r['values'], limits)[1]
    return out


@pytest.mark.parametrize('workload', CELLS)
def test_control_is_not_correct_at_a_tiny_size(tiny_root, workload):
    # The semseg at full depth and on larger images: the fp8 control's
    # error grows with both.
    p = tiny_root / 'portbench' / 'configs' / 'nuscenes_oracle.json'
    c = json.loads(p.read_text())
    c['semseg']['stage_sizes'] = [3, 4, 6, 3]
    c['camera']['img_hw'] = [64, 128]
    p.write_text(json.dumps(c))
    ctx = tiny_ctx(tiny_root, workload)
    got = _judged(ctx.manifest, workload, 2147483659, 2.0, ctx.device)
    assert got == {'program': True, 'control': False}


@pytest.mark.chip
@pytest.mark.parametrize('workload', CELLS)
def test_control_is_not_correct_at_the_cells_size(chip, workload):
    manifest = Manifest(ROOT)
    for seed in (2147483701, 2147483702, 2147483703):
        got = _judged(manifest, workload, seed, 14.0, chip)
        assert got == {'program': True, 'control': False}, seed
