"""The seeded synthetic world the traffic generators drive through (host
numpy).

The benchmark's own copy of the port's dataloaders/synthetic.py
``_world_points``, kept here so that the traffic does not move with the
program. The same seed gives byte-identical points.

World: a straight road along +x with lane markings, sidewalks, building
walls, poles, parked cars and vegetation.
"""
from __future__ import annotations

import numpy as np

RAW_ROAD, RAW_SIDEWALK, RAW_BUILDING, RAW_VEGETATION, RAW_CAR = 7, 8, 11, 21, 26
RAW_POLE = 17
EGO_Z = 1.73  # lidar height above the road


def world_points(rng: np.random.Generator, n_road=6000, n_side=1500,
                 n_bld=2500, n_veg=800, n_car=600, length=400.0):
    """Static world point set: (N,3) xyz, (N,) intensity, (N,) raw
    semantic id. The draw order fixes the world for a seed."""
    pts, inten, sem = [], [], []
    x = rng.uniform(0, length, n_road)
    y = rng.uniform(-4, 4, n_road)
    marking = (np.abs(y) < 0.15) | (np.abs(np.abs(y) - 3.8) < 0.1)
    i_road = np.where(marking & (np.floor(x / 2) % 2 == 0), 0.9, 0.1)
    pts.append(np.stack([x, y, np.zeros(n_road)], 1))
    inten.append(i_road)
    sem.append(np.full(n_road, RAW_ROAD))
    x = rng.uniform(0, length, n_side)
    y = rng.choice([-1, 1], n_side) * rng.uniform(4.0, 6.0, n_side)
    pts.append(np.stack([x, y, np.full(n_side, 0.12)], 1))
    inten.append(rng.uniform(0.2, 0.4, n_side))
    sem.append(np.full(n_side, RAW_SIDEWALK))
    x = rng.uniform(0, length, n_bld)
    y = rng.choice([-1, 1], n_bld) * rng.uniform(7.5, 8.5, n_bld)
    z = rng.uniform(0, 8.0, n_bld)
    pts.append(np.stack([x, y, z], 1))
    inten.append(rng.uniform(0.3, 0.6, n_bld))
    sem.append(np.full(n_bld, RAW_BUILDING))
    x = rng.uniform(0, length, n_veg)
    y = rng.choice([-1, 1], n_veg) * rng.uniform(6.0, 7.0, n_veg)
    z = rng.uniform(0.5, 3.0, n_veg)
    pts.append(np.stack([x, y, z], 1))
    inten.append(rng.uniform(0.4, 0.8, n_veg))
    sem.append(np.full(n_veg, RAW_VEGETATION))
    # Poles every ~8 m: longitudinal structure, so ICP observes x-motion.
    for px in np.arange(4.0, length, 8.0):
        n_p = 40
        x = px + rng.normal(0, 0.02, n_p)
        y = rng.choice([-1, 1]) * 5.0 + rng.normal(0, 0.02, n_p)
        z = rng.uniform(0, 4.0, n_p)
        pts.append(np.stack([x, np.full(n_p, 0.) + y, z], 1))
        inten.append(rng.uniform(0.4, 0.7, n_p))
        sem.append(np.full(n_p, RAW_POLE))
    centers = np.arange(15, length, 30.0)
    per = max(n_car // max(len(centers), 1), 1)
    for cx in centers:
        x = cx + rng.uniform(-2, 2, per)
        y = -3.0 + rng.uniform(-0.8, 0.8, per)
        z = rng.uniform(0.2, 1.5, per)
        pts.append(np.stack([x, y, z], 1))
        inten.append(rng.uniform(0.5, 0.9, per))
        sem.append(np.full(per, RAW_CAR))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(inten).astype(np.float32),
            np.concatenate(sem).astype(np.int16))


BASE_WORLD_POINTS = 6000 + 1500 + 2500 + 800 + 600   # world_points' default


def world_scale(points_per_frame, lidar_range, length):
    """The factor on world_points' default counts that puts about
    ``points_per_frame`` points within ``lidar_range`` of a pose on a
    world ``length`` metres long (the default counts are spread over the
    whole length; a pose sees a band 2 * lidar_range long)."""
    return points_per_frame * length / (BASE_WORLD_POINTS * 2 * lidar_range)
