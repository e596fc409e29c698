"""The traffic generators: the same seed gives the same inputs, other
seeds other ones, and no frame's inputs repeat within a window."""
from __future__ import annotations

import numpy as np

from portbench.gen.nuscenes import NuScenesScene, make_scene
from portbench.harness.weights import fcn_weights

BIG = 2 ** 31 + 12345


CONFIG = dict(scene_keyframes=40, camera=dict(img_hw=[16, 32], n_cams=6),
              stream=dict(step=2.0, lidar_range=50.0, points_per_frame=34_000))


def _scene(seed, sc=0):
    return make_scene(CONFIG, seed, sc)


def test_nuscenes_scene_is_deterministic_and_frames_do_not_repeat():
    a, b = _scene(BIG), _scene(BIG)
    fa, fb = a.frame(5, 5), b.frame(5, 5)
    assert np.array_equal(fa['pc'], fb['pc'])
    assert np.array_equal(fa['images'], fb['images'])
    assert not np.array_equal(_scene(BIG + 1).frame(5, 5)['pc'], fa['pc'])
    assert not np.array_equal(_scene(BIG, 1).frame(5, 45)['pc'], fa['pc'])
    # 800 global frames of a window: every frame's six images differ
    # from every other frame's.
    seen = set()
    for g in range(800):
        imgs = _scene(BIG, g // 40).render_images(g)
        key = imgs.tobytes()
        assert key not in seen, g
        seen.add(key)
    assert 32_000 < a.frame(0, 0)['pc'].shape[0] < 37_000


def test_a_scene_holds_its_stated_points_on_every_keyframe():
    s = _scene(BIG)
    assert isinstance(s, NuScenesScene) and s.n_frames == 40
    counts = [s.frame(i, i)['pc'].shape[0] for i in range(0, 40, 3)]
    assert 32_000 < min(counts) and max(counts) < 37_000


def test_weights_are_deterministic_in_the_seed():
    a = fcn_weights(BIG, 'cpu', (1, 1, 1, 1))
    b = fcn_weights(BIG, 'cpu', (1, 1, 1, 1))
    c = fcn_weights(BIG + 1, 'cpu', (1, 1, 1, 1))
    k = 'backbone.layer1.0.conv2.weight'
    assert all(np.array_equal(a[n].numpy(), b[n].numpy()) for n in a)
    assert not np.array_equal(a[k].numpy(), c[k].numpy())
