"""The plain reference on inputs whose answer is known by hand: one
sample's cells and maps, the trajectories' crop, the tracker, TF32
rounding."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.reference import bev, oracle

BEV = dict(view_size=80, pixel_size=256, int_scaler=1.0,
           int_sep_scaler=30.0, int_mid_threshold=0.12)


def _sample(xyz, frame, sem, inten, rgb, dynamic=None, present=1):
    n = len(xyz)
    return bev.sample_maps(
        torch.tensor(xyz, dtype=torch.float64),
        torch.tensor(frame), torch.tensor(sem),
        torch.tensor(inten, dtype=torch.float64),
        torch.tensor(rgb, dtype=torch.float64),
        torch.zeros(n, dtype=torch.bool) if dynamic is None
        else torch.tensor(dynamic), torch.zeros(3, dtype=torch.float64),
        0.0, present, BEV)


def test_points_land_in_their_cells_with_the_stated_maps():
    # Two road points and a car point in the cell right of and above the
    # origin (column 128, row 127), one in the present and two in the
    # future split; a point on the view's edge is out.
    out = _sample([[0.1, 0.1, -1.0], [0.2, 0.2, -1.5], [0.1, 0.2, 0.5],
                   [40.0, 0.0, 0.0]],
                  frame=[0, 1, 1, 0], sem=[0, 0, 13, 0],
                  inten=[0.5, 0.1, 0.9, 0.5],
                  rgb=[[10, 20, 30], [30, 40, 50], [51, 0, 0], [9, 9, 9]])
    full = {k: v[..., 127, 128].astype(np.float64)
            for k, v in out.items() if k.endswith('full')}
    assert full['road_full'] == pytest.approx(3 / 5, abs=1e-3)
    raw = (0.5 + 0.1) / 3
    assert full['intensity_full'] == pytest.approx(
        1 / (1 + math.exp(-30 * (raw - 0.12))), abs=1e-3)
    assert list(full['rgb_full']) == pytest.approx([30 / 255, 20 / 255,
                                                    30 / 255], abs=1e-3)
    assert full['dynamic_full'] == pytest.approx(2 / 5, abs=1e-3)
    assert full['elevation_full'] == pytest.approx(-1.5, abs=1e-3)
    assert out['road_present'][127, 128] == pytest.approx(2 / 3, abs=1e-3)
    assert out['elevation_future'][127, 128] == pytest.approx(-1.5,
                                                              abs=1e-3)
    # Empty cells: priors and zeros; nothing on the edge column.
    assert out['road_full'][0, 0] == pytest.approx(0.5)
    assert out['elevation_full'][0, 0] == 0
    assert (out['rgb_full'][:, :, 255] == 0).all()
    assert np.count_nonzero(out['elevation_full']) == 1


def test_dynamic_points_are_left_out():
    out = _sample([[0.1, 0.1, -1.0], [0.1, 0.1, -2.0]], frame=[0, 0],
                  sem=[0, 13], inten=[0.5, 0.5], rgb=[[0, 0, 0]] * 2,
                  dynamic=[False, True])
    assert out['elevation_full'][127, 128] == pytest.approx(-1.0)
    assert out['dynamic_full'][127, 128] == pytest.approx(1 / 3, abs=1e-3)


def test_a_trajectory_is_cropped_at_the_box_and_pixelised():
    traj = np.array([[-50.0, 0.0, 1.0], [-30.0, 0.0, 2.0], [0.0, 0.0, 3.0],
                     [30.0, 0.0, 4.0], [50.0, 0.0, 5.0]])
    px = bev.traj_pixels(traj, 0.0, 80.0, 256)
    # The crossing into the box (z of the edge's start), the inside
    # starts, the crossing out; the last pose is not given by itself.
    assert px[:, 0].tolist() == [0, 32, 128, 224, 255]
    assert px[:, 1].tolist() == [128] * 5
    assert px[:, 2].tolist() == [1.0, 2.0, 3.0, 4.0, 4.0]
    assert bev.traj_pixels(traj[:1], 0.0, 80.0, 256).shape == (0, 3)
    assert bev.heading_angle(traj[:2]) == pytest.approx(math.pi / 2)


def test_the_tracker_flags_an_object_that_moved_over_a_metre():
    tr = oracle.Tracker()
    for ts in range(4):
        ids = tr.update(ts, ['parked', 'moving', 'walker'], [0, 0, 7],
                        [[5.0, 0, 0], [0.6 * ts, 0, 0], [0, 0, 0]])
    assert ids == {'parked': 1, 'moving': 2}
    assert tr.dynamic == {2}
    assert [t.shape for t in tr.trajs()] == [(4, 3)]
    assert [t.shape for t in tr.trajs(end=1)] == [(2, 3)]
    assert tr.trajs(start=3) == []


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                      -3.0 - 2 ** -10])
    assert bev.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0,
                                    1.0 + 2 ** -10, -3.0 - 2 ** -9]
