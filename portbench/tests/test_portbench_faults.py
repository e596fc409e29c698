"""A whole run of each cell on the CPU at a tiny size, sound and with
the timed path broken underneath: the sound run comes out correct, and
each fault the cell can have makes ``correct`` false. (One chip: no
exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

from conftest import tiny_ctx
from portbench.harness import runner

PORT = 'pc_accumulation_lib_tpu_torch'


def _run(root, workload):
    torch.manual_seed(0)
    return runner.run_cell(tiny_ctx(root, workload))


def _state_unchanged(monkeypatch):
    """Frames are no longer written into the point window."""
    from pc_accumulation_lib_tpu_torch.accum import buffer
    monkeypatch.setattr(buffer, 'insert_frame', lambda *a, **k: None)


def _half_the_cameras(monkeypatch):
    """The semseg runs on the first half of the cameras and repeats
    their classes for the rest."""
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    orig = SemSegTorch.predict

    def predict(self, images):
        n = images.shape[0]
        if n < 2:
            return orig(self, images)
        out = orig(self, images[:n // 2])
        return torch.cat([out, out[:n - n // 2]])

    monkeypatch.setattr(SemSegTorch, 'predict', predict)


def _labels_altered(monkeypatch):
    """The semseg's answer is altered where it is produced: a block of
    pixels gets the next class."""
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    orig = SemSegTorch.predict

    def predict(self, images):
        out = orig(self, images).clone()
        h, w = out.shape[1] // 2, out.shape[2] // 2
        out[:, :h, :w] = (out[:, :h, :w] + 1) % 19
        return out

    monkeypatch.setattr(SemSegTorch, 'predict', predict)


def _dyn_flags_dropped(monkeypatch):
    """The tracker's dynamic flags never reach the device table."""
    from pc_accumulation_lib_tpu_torch.accum import buffer
    monkeypatch.setattr(buffer, 'set_instance_dyn', lambda *a, **k: None)


WORKLOAD = 'nuscenes_oracle_6cam'


def test_sound_run_is_correct(tiny_root):
    out = _run(tiny_root, WORKLOAD)
    assert out['correct'], out['rows']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert {'setup_s', 'samples_per_s'} <= set(out['metrics'])


def _paint_off_by_a_pixel(monkeypatch):
    """Each point is painted from the pixel to the right of its own."""
    from pc_accumulation_lib_tpu_torch.accum import buffer
    orig = buffer.paint_frame_multicam

    def paint(pc, *a, **k):
        pc = pc.clone()
        pc[:, 4] += 1.0
        return orig(pc, *a, **k)

    monkeypatch.setattr(buffer, 'paint_frame_multicam', paint)


FAULTS = [_state_unchanged, _half_the_cameras, _labels_altered,
          _dyn_flags_dropped, _paint_off_by_a_pixel]


@pytest.mark.parametrize('fault', FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_root, WORKLOAD)
    assert not out['correct'], out['rows']
