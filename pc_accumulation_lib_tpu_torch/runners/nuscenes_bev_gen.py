"""NuScenes BEV dataset generation entry point.

Counterpart of runners/nuscenes_bev_gen.py: a per-scene attribute skip
filter; per scene, phase 1 integrates the whole scene and phase 2 samples
BEVs by path distance over all its poses; oracle or ICP poses; optional GT
lanes; per-sample metadata (scene_idx, map, ego_global_x/y); a resumable
manifest and strided shards.

Library use: run(...) with a devkit object or a test double as ``nusc``;
CLI: python -m pc_accumulation_lib_tpu_torch.runners.nuscenes_bev_gen
<dataroot> [<semseg_model>] [--use_oracle_pose] [--device cuda].

With ``bev_params['mesh']`` every rank of the mesh calls run() with the
same arguments; rank 0 of the points axis runs the job and the others
serve its point-sharded rasters (parallel/sharded.serve_mesh_rasters).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from time import ctime
from typing import List, Optional

import torch

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.parallel import sharded
from pc_accumulation_lib_tpu_torch.parallel.manifest import (
    CompletionManifest, shard_units)
from pc_accumulation_lib_tpu_torch.utils.io import write_compressed_pickle

# NuScenes semseg filters (no 255 ignore label).
NUSCENES_FILTERS = (10, 11, 12, 16, 18)

# run()'s BEV parameters: 80 m / 256 px, no augmentation and no warp.
DEFAULT_BEV_PARAMS = {
    'type': 'sem', 'view_size': 80, 'pixel_size': 256,
    'max_trans_radius': 0., 'zoom_thresh': 0., 'do_warp': False,
    'int_scaler': 1., 'int_sep_scaler': 30., 'int_mid_threshold': 0.12,
    'height_filter': None,
}


def scene_attributes(nusc, scene_id: int):
    """The scene description's comma-separated attributes plus its
    location, and the location."""
    scene = nusc.scene[scene_id]
    attrs = scene['description'].lower().replace(', ', ',').split(',')
    loc = nusc.get('log', scene['log_token'])['location']
    attrs.append(loc)
    return attrs, loc


def should_skip_scene(attrs: List[str], skip_attributes: List[str]):
    """(skip, hits): the skip attributes found as a substring of some
    scene attribute."""
    hits = [s for s in skip_attributes if any(s in a for a in attrs)]
    return len(hits) > 0, hits


def sample_scene_bevs(sem_pc_accum, sampling: cfg.SamplingConfig,
                      gen_future: bool = True):
    """Phase 2 over all accumulated poses: a pose is sampled when at least
    ``bev_horizon_dist`` of path lies behind and ahead of it and it is
    ``bev_dist_between_samples`` from the previous sample. Yields
    (present_idx, bevs)."""
    incr_path_dists = sem_pc_accum.get_incremental_path_dists()
    previous_idx = 0
    for present_idx in range(len(sem_pc_accum.poses) - 1):
        back = incr_path_dists[min(present_idx, len(incr_path_dists) - 1)]
        if back < sampling.bev_horizon_dist:
            continue
        fut_dist = incr_path_dists[-1] - back
        if fut_dist < sampling.bev_horizon_dist:
            continue
        pose_0 = sem_pc_accum.get_pose(previous_idx)
        pose_1 = sem_pc_accum.get_pose(present_idx)
        if sem_pc_accum.dist(pose_0, pose_1) < \
                sampling.bev_dist_between_samples:
            continue
        previous_idx = present_idx
        print(f'\t{ctime()} | back {back:.1f} | front {fut_dist:.1f}')
        bevs = sem_pc_accum.generate_bev(present_idx,
                                         sampling.bevs_per_sample,
                                         gen_future=gen_future)
        yield present_idx, bevs


def write_scene_samples(sem_pc_accum, scene_id: int,
                        sampling: cfg.SamplingConfig,
                        output: cfg.OutputConfig, start_count: int = 0,
                        writer=None) -> int:
    """Phase 2 of one integrated scene: sample, add the per-sample
    metadata, write subdirNNN/bev_NNN.pkl.gz (through ``writer``, an
    AsyncPickleWriter, when given) numbered on from ``start_count``, and
    with ``output.viz_to_disk`` a PNG beside each. Returns the number
    written."""
    n = 0
    for present_idx, bevs in sample_scene_bevs(sem_pc_accum, sampling):
        rgbs = sem_pc_accum.get_rgb(present_idx)
        semsegs = sem_pc_accum.get_semseg(present_idx)
        if rgbs and isinstance(rgbs[0], list):
            rgbs, semsegs = rgbs[0], semsegs[0]
        if output.viz_to_disk and torch.is_tensor(semsegs):
            semsegs = semsegs.cpu().numpy()
        for bev in bevs:
            count = start_count + n
            bev_idx = count % output.subdir_size
            filename = f'bev_{bev_idx:03d}.pkl'
            out_path = os.path.join(
                output.output_dir,
                f'subdir{count // output.subdir_size:03d}')
            os.makedirs(out_path, exist_ok=True)
            bev['scene_idx'] = scene_id
            bev['map'] = sem_pc_accum.map
            bev['ego_global_x'] = sem_pc_accum.ego_global_xs[present_idx]
            bev['ego_global_y'] = sem_pc_accum.ego_global_ys[present_idx]
            if writer is not None:
                writer.write(bev, filename, out_path)
            else:
                write_compressed_pickle(bev, filename, out_path)
            if output.viz_to_disk:
                sem_pc_accum.viz_bev(
                    bev, os.path.join(out_path, f'viz_{bev_idx:03d}.png'),
                    rgbs, semsegs)
            n += 1
    return n


def run(nuscenes_path: str, semseg_model=None,
        version: str = 'v1.0-trainval', use_oracle_pose: bool = True,
        get_gt_lanes: bool = False, start_scene_idx: int = 0,
        end_scene_idx: int = 850, do_scene_idxs: Optional[List[int]] = None,
        skip_attr: Optional[List[str]] = None, num_sweeps: int = 1,
        accum_horizon_dist: float = 200.0, icp_threshold: float = 1e3,
        bev_params: Optional[dict] = None,
        sampling: Optional[cfg.SamplingConfig] = None,
        output: Optional[cfg.OutputConfig] = None,
        accum_cfg: Optional[cfg.AccumConfig] = None,
        icp_cfg: Optional[cfg.ICPConfig] = None,
        manifest_path: Optional[str] = None, shard_idx: int = 0,
        num_shards: int = 1, seed: Optional[int] = None,
        nusc=None, img_transfer: str = 'rgb8',
        pc_transfer: str = 'float32', *, device='cuda') -> dict:
    """Generate the BEV dataset of NuScenes scenes [start_scene_idx,
    end_scene_idx) on ``device`` (the card unless the caller passes
    'cpu'); ``semseg_model`` is a models.semseg.SemSegTorch on the same
    device. ``nusc`` injects a devkit object or a test double; without it
    the nuscenes-devkit loads ``nuscenes_path``. Returns {bevs, units,
    resumed_at}."""
    from pc_accumulation_lib_tpu_torch.accum.nuscenes import (
        NuScenesSemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.dataloaders.nuscenes import (
        NuScenesDataloader)

    sampling = sampling or cfg.SamplingConfig(bev_horizon_dist=80.0)
    output = output or cfg.OutputConfig()
    skip_attr = skip_attr or []
    bev_params = bev_params or dict(DEFAULT_BEV_PARAMS)
    mesh = bev_params.get('mesh')
    if mesh is not None and not sharded.is_controller(mesh):
        sharded.serve_mesh_rasters(mesh)
        return {'bevs': 0, 'units': [], 'resumed_at': 0}
    try:
        if nusc is None:
            from nuscenes.nuscenes import NuScenes
            nusc = NuScenes(dataroot=nuscenes_path, version=version)
        manifest = CompletionManifest(manifest_path) if manifest_path else None
        if num_shards > 1:
            # Shards share the manifest file, never an output file.
            output = dataclasses.replace(
                output, output_dir=os.path.join(output.output_dir,
                                                f'shard{shard_idx:02d}'))
        writer = None
        if output.async_io:
            from pc_accumulation_lib_tpu_torch.utils.async_writer import (
                AsyncPickleWriter)
            writer = AsyncPickleWriter()
        scene_ids = list(range(start_scene_idx,
                               min(end_scene_idx, len(nusc.scene))))
        all_units = [str(s) for s in scene_ids]
        scene_units = shard_units(all_units, shard_idx, num_shards, manifest)
        # Resume the numbering after the samples this shard already wrote.
        bev_count = 0
        if manifest is not None:
            for i, u in enumerate(all_units):
                rec = manifest.get(u)
                if i % num_shards == shard_idx and rec is not None:
                    bev_count += int(rec.get('bevs', 0))
        resumed_at = bev_count
        for scene_str in scene_units:
            scene_id = int(scene_str)
            attrs, loc = scene_attributes(nusc, scene_id)
            print(f'Processing scene id {scene_id} | {loc}')
            if do_scene_idxs and scene_id not in do_scene_idxs:
                print(f'\tSkip scene id {scene_id} (not in idx list)')
                if manifest is not None:
                    manifest.mark_skipped(scene_str, 'idx_list')
                continue
            skip, hits = should_skip_scene(attrs, skip_attr)
            if skip:
                print(f'\tSkip scene id {scene_id} ({" ".join(hits)})')
                if manifest is not None:
                    manifest.mark_skipped(scene_str, ' '.join(hits))
                continue

            if use_oracle_pose:
                sem_pc_accum = NuScenesOracleSemanticPointCloudAccumulator(
                    semseg_model, NUSCENES_FILTERS, cfg.DEFAULT_SEM_IDXS,
                    False, bev_params, loc, get_gt_lanes, nuscenes_path,
                    accum_cfg=accum_cfg, seed=seed, img_transfer=img_transfer,
                    transfer_dtype=pc_transfer, device=device)
            else:
                sem_pc_accum = NuScenesSemanticPointCloudAccumulator(
                    accum_horizon_dist, icp_threshold, semseg_model,
                    NUSCENES_FILTERS, cfg.DEFAULT_SEM_IDXS, False, bev_params,
                    loc, accum_cfg=accum_cfg, icp_cfg=icp_cfg, seed=seed,
                    img_transfer=img_transfer, transfer_dtype=pc_transfer,
                    device=device)

            try:
                # Phase 1: integrate the whole scene.
                for observations in NuScenesDataloader(nusc, [scene_id], 1,
                                                       num_sweeps):
                    sem_pc_accum.integrate(observations)
                if use_oracle_pose:
                    sem_pc_accum.check_painted()
                # Phase 2: sample and write.
                scene_bevs = write_scene_samples(sem_pc_accum, scene_id,
                                                 sampling, output, bev_count,
                                                 writer)
            finally:
                # Before mark_done: a TileRouteOverflow from the tile raster's
                # last deferred checks leaves the scene pending.
                sem_pc_accum.sem_bev_generator.close()
            bev_count += scene_bevs
            if manifest is not None:
                manifest.mark_done(scene_str, bevs=scene_bevs)
        if writer is not None:
            writer.wait()
        return {'bevs': bev_count - resumed_at, 'units': list(scene_units),
                'resumed_at': resumed_at}
    finally:
        if mesh is not None:
            sharded.shutdown_mesh_workers(mesh)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('nuscenes_path', type=str)
    parser.add_argument('semseg_model_path', type=str, nargs='?', default='')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--nuscenes_version', type=str,
                        default='v1.0-trainval')
    parser.add_argument('--use_oracle_pose', action='store_true')
    parser.add_argument('--get_gt_lanes', action='store_true')
    parser.add_argument('--start_scene_idx', type=int, default=0)
    parser.add_argument('--end_scene_idx', type=int, default=850)
    parser.add_argument('--do_scene_idxs', type=int, nargs='+', default=[])
    parser.add_argument('--skip_attr', type=str, nargs='+', default=[],
                        help='e.g. night rain singapore')
    parser.add_argument('--num_sweeps', type=int, default=1)
    parser.add_argument('--accum_batch_size', type=int, default=1)
    parser.add_argument('--accum_horizon_dist', type=float, default=200)
    parser.add_argument('--use_gt_sem', action='store_true')
    parser.add_argument('--bev_output_dir', type=str, default='bevs')
    parser.add_argument('--bevs_per_sample', type=int, default=1)
    parser.add_argument('--bev_horizon_dist', type=float, default=80)
    parser.add_argument('--bev_dist_between_samples', type=float, default=1.)
    parser.add_argument('--bev_type', type=str, default='sem',
                        choices=('sem', 'rgb'))
    parser.add_argument('--bev_view_size', type=float, default=80)
    parser.add_argument('--bev_pixel_size', type=int, default=256)
    parser.add_argument('--bev_max_trans_radius', type=float, default=0)
    parser.add_argument('--bev_zoom_thresh', type=float, default=0)
    parser.add_argument('--bev_do_warp', action='store_true')
    parser.add_argument('--int_scaler', type=float, default=1)
    parser.add_argument('--int_sep_scaler', type=float, default=30)
    parser.add_argument('--int_mid_threshold', type=float, default=0.12)
    parser.add_argument('--height_filter', type=float, default=None)
    parser.add_argument('--icp_threshold', type=float, default=1e3)
    parser.add_argument('--manifest', type=str, default=None)
    parser.add_argument('--shard_idx', type=int, default=0)
    parser.add_argument('--num_shards', type=int, default=1)
    # Camera and point wires (ops/imgcodec.py, accum/pointpack.py).
    parser.add_argument('--img_transfer', type=str, default='rgb8',
                        choices=('rgb8', 'yuv420', 'yuv420h'))
    parser.add_argument('--pc_transfer', type=str, default='float32',
                        choices=('float32', 'quantized'))
    args = parser.parse_args(argv)

    from pc_accumulation_lib_tpu_torch.models.semseg import load_semseg_model
    semseg_model = load_semseg_model(args.semseg_model_path,
                                     device=args.device)
    bev_params = {
        'type': args.bev_type, 'view_size': args.bev_view_size,
        'pixel_size': args.bev_pixel_size,
        'max_trans_radius': args.bev_max_trans_radius,
        'zoom_thresh': args.bev_zoom_thresh, 'do_warp': args.bev_do_warp,
        'int_scaler': args.int_scaler,
        'int_sep_scaler': args.int_sep_scaler,
        'int_mid_threshold': args.int_mid_threshold,
        'height_filter': args.height_filter,
    }
    stats = run(
        args.nuscenes_path, semseg_model, args.nuscenes_version,
        args.use_oracle_pose, args.get_gt_lanes, args.start_scene_idx,
        args.end_scene_idx, args.do_scene_idxs or None, args.skip_attr,
        args.num_sweeps, args.accum_horizon_dist, args.icp_threshold,
        bev_params,
        cfg.SamplingConfig(args.bev_horizon_dist,
                           args.bev_dist_between_samples,
                           args.bevs_per_sample),
        cfg.OutputConfig(args.bev_output_dir),
        manifest_path=args.manifest, shard_idx=args.shard_idx,
        num_shards=args.num_shards, img_transfer=args.img_transfer,
        pc_transfer=args.pc_transfer, device=args.device)
    print(stats)


if __name__ == '__main__':
    main()
