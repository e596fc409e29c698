"""KITTI-360 BEV dataset generation entry point.

Counterpart of runners/kitti360_bev_gen.py: streams observations,
integrates them into the accumulator, applies the three-condition BEV
sampling policy, and writes gzip-pickled BEV dicts (and, with
``viz_to_disk``, PNGs) in subdirNNN/bev_NNN.pkl shards.

Library use: run(...) on a KITTI-360 tree, run_sharded(...) for the
scene-sharded job that resumes from a completion manifest, or
sampling_loop(...) on any iterable of observation batches; CLI: python -m
pc_accumulation_lib_tpu_torch.runners.kitti360_bev_gen <root>
[<semseg_model>] [--device cuda] [--manifest PATH --shard_idx I
--num_shards N] [--coordinator_address host:port --num_processes N
--process_id I]. The KITTI-360 dataloader reads images with PIL, imported
only when a frame is read.

With ``bev_params['mesh']`` (parallel/mesh.make_mesh) every rank of the
mesh calls run() or run_sharded() with the same arguments: rank 0 of the
points axis integrates, samples and writes, and the other ranks serve
its point-sharded rasters (parallel/sharded.serve_mesh_rasters) until it
ends the job, however it ends.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
    Kitti360SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu_torch.parallel import sharded
from pc_accumulation_lib_tpu_torch.utils.io import write_compressed_pickle
from pc_accumulation_lib_tpu_torch.utils.profiling import PhaseTimer

# run()'s BEV parameters: 80 m / 256 px, no augmentation and no warp.
DEFAULT_BEV_PARAMS = {
    'type': 'sem', 'view_size': 80, 'pixel_size': 256,
    'max_trans_radius': 0., 'zoom_thresh': 0., 'do_warp': False,
    'int_scaler': 20., 'int_sep_scaler': 20., 'int_mid_threshold': 0.5,
    'height_filter': None,
}


def build_calib_params(kitti360_path: str) -> dict:
    """Projection matrices from the KITTI-360 calibration files."""
    from pc_accumulation_lib_tpu_torch.dataloaders.kitti360 import (
        get_camera_intrinsics, get_transf_matrices)
    h_cam_velo, h_velo_cam = get_transf_matrices(kitti360_path)
    p_cam_frame = get_camera_intrinsics(kitti360_path)
    p_velo_frame = np.matmul(p_cam_frame, h_velo_cam)
    return {
        'h_velo_cam': h_velo_cam,
        'p_cam_frame': p_cam_frame,
        'p_velo_frame': p_velo_frame,
        'c_x': p_cam_frame[0, 2], 'c_y': p_cam_frame[1, 2],
        'f_x': p_cam_frame[0, 0], 'f_y': p_cam_frame[1, 1],
    }


def sampling_loop(sem_pc_accum, dataloader, sampling: cfg.SamplingConfig,
                  output: cfg.OutputConfig, gen_future: bool = True,
                  batch_size: int = 1, on_bev=None, start_count: int = 0,
                  timer: Optional[PhaseTimer] = None) -> dict:
    """Integrate + sample + write loop.

    A sample is taken at the first pose ``bev_horizon_dist`` of path
    behind the newest one, when as much path lies ahead of it and it is
    ``bev_dist_between_samples`` from the previous sample. Returns the
    counters {frames, bevs} (bevs = new samples this call). ``on_bev(bev,
    path)`` is an optional hook; ``start_count`` seats the sequential
    subdirNNN/bev_NNN numbering after earlier samples; ``timer`` collects
    the per-phase wall-clock times (integrate, generate_bev, write, viz,
    write_drain)."""
    timer = PhaseTimer() if timer is None else timer
    bev_idx = start_count % output.subdir_size
    subdir_idx = start_count // output.subdir_size
    bev_count = 0
    previous_idx = 0
    frames = 0
    writer = None
    if output.async_io:
        from pc_accumulation_lib_tpu_torch.utils.async_writer import (
            AsyncPickleWriter)
        writer = AsyncPickleWriter()
    for sample_idx, observations in enumerate(dataloader):
        with timer.phase('integrate'):
            num_obs_removed = sem_pc_accum.integrate(observations)
        frames += len(observations)
        previous_idx = max(previous_idx - num_obs_removed, 0)

        if len(sem_pc_accum.poses) < 2:
            continue
        incr_path_dists = sem_pc_accum.get_incremental_path_dists()
        # Condition (1): enough path behind the newest pose.
        if incr_path_dists[-1] < sampling.bev_horizon_dist:
            continue
        dists = incr_path_dists - sampling.bev_horizon_dist
        present_idx = int((dists > 0).argmax())
        # Condition (2): enough path from the present to the newest pose.
        fut_dist = incr_path_dists[-1] - incr_path_dists[present_idx]
        if fut_dist < sampling.bev_horizon_dist:
            continue
        # Condition (3): far enough from the previous sample.
        pose_0 = sem_pc_accum.get_pose(previous_idx)
        pose_1 = sem_pc_accum.get_pose(present_idx)
        if sem_pc_accum.dist(pose_0, pose_1) < \
                sampling.bev_dist_between_samples:
            continue
        previous_idx = present_idx

        print(f'{sample_idx * batch_size} | {bev_count} |',
              f' back {incr_path_dists[present_idx]:.1f} |',
              f'front {fut_dist:.1f}')

        with timer.phase('generate_bev'):
            bevs = sem_pc_accum.generate_bev(present_idx,
                                             sampling.bevs_per_sample,
                                             gen_future=gen_future)
        rgbs = sem_pc_accum.get_rgb(present_idx)
        semsegs = sem_pc_accum.get_semseg(present_idx)

        for bev in bevs:
            if bev_idx >= output.subdir_size:
                bev_idx = 0
                subdir_idx += 1
            filename = f'bev_{bev_idx:03d}.pkl'
            output_path = os.path.join(output.output_dir,
                                       f'subdir{subdir_idx:03d}')
            os.makedirs(output_path, exist_ok=True)
            with timer.phase('write'):
                if writer is not None:
                    writer.write(bev, filename, output_path)
                else:
                    write_compressed_pickle(bev, filename, output_path)
            if output.viz_to_disk:
                viz_file = os.path.join(output_path, f'viz_{bev_idx:03d}.png')
                with timer.phase('viz'):
                    sem_pc_accum.viz_bev(bev, viz_file, rgbs, semsegs)
            if on_bev is not None:
                on_bev(bev, os.path.join(output_path, filename))
            bev_idx += 1
            bev_count += 1
    if writer is not None:
        with timer.phase('write_drain'):
            writer.wait()
    if bev_count:
        print('--- phase timing ---')
        print(timer.report())
    return {'frames': frames, 'bevs': bev_count}


def run(kitti360_path: str, semseg_model=None, use_gt_sem: bool = False,
        sequences=None, start_idxs=None, end_idxs=None,
        accum_horizon_dist: float = 200.0, icp_threshold: float = 1e3,
        bev_params: Optional[dict] = None,
        sampling: Optional[cfg.SamplingConfig] = None,
        output: Optional[cfg.OutputConfig] = None,
        accum_cfg: Optional[cfg.AccumConfig] = None,
        icp_cfg: Optional[cfg.ICPConfig] = None,
        seed: Optional[int] = None,
        img_transfer: Optional[str] = None,
        pc_transfer: str = 'float32', *, device='cuda') -> dict:
    """Generate the BEV dataset of the given KITTI-360 sequences on
    ``device`` (the card unless the caller passes 'cpu');
    ``semseg_model`` is a models.semseg.SemSegTorch on the same device
    (or None with ``use_gt_sem``). Returns {frames, bevs}."""
    from pc_accumulation_lib_tpu_torch.dataloaders.kitti360 import (
        Kitti360Dataloader)
    sequences = list(sequences or cfg.KITTI360_SEQUENCES)
    start_idxs = list(start_idxs or cfg.KITTI360_START_IDXS)
    end_idxs = list(end_idxs or cfg.KITTI360_END_IDXS)
    sampling = sampling or cfg.SamplingConfig()
    output = output or cfg.OutputConfig()
    bev_params = bev_params or dict(DEFAULT_BEV_PARAMS)

    mesh = bev_params.get('mesh')
    if mesh is not None and not sharded.is_controller(mesh):
        sharded.serve_mesh_rasters(mesh)
        return {'frames': 0, 'bevs': 0}
    try:
        calib_params = build_calib_params(kitti360_path)
        sem_pc_accum = Kitti360SemanticPointCloudAccumulator(
            accum_horizon_dist, calib_params, icp_threshold, semseg_model,
            cfg.DEFAULT_SEMSEG_FILTERS, cfg.DEFAULT_SEM_IDXS, use_gt_sem,
            bev_params, accum_cfg=accum_cfg, icp_cfg=icp_cfg, seed=seed,
            img_transfer=img_transfer, transfer_dtype=pc_transfer,
            device=device)
        dataloader = Kitti360Dataloader(kitti360_path, 1, sequences,
                                        start_idxs, end_idxs)
        try:
            return sampling_loop(sem_pc_accum, dataloader, sampling, output)
        finally:
            # Surfaces the tile raster's last deferred overflow checks.
            sem_pc_accum.sem_bev_generator.close()
    finally:
        if mesh is not None:
            sharded.shutdown_mesh_workers(mesh)


def run_sharded(kitti360_path: str, semseg_model=None,
                use_gt_sem: bool = False, sequences=None, start_idxs=None,
                end_idxs=None, accum_horizon_dist: float = 200.0,
                icp_threshold: float = 1e3,
                bev_params: Optional[dict] = None,
                sampling: Optional[cfg.SamplingConfig] = None,
                output: Optional[cfg.OutputConfig] = None,
                accum_cfg: Optional[cfg.AccumConfig] = None,
                icp_cfg: Optional[cfg.ICPConfig] = None,
                seed: Optional[int] = None,
                manifest_path: Optional[str] = None, shard_idx: int = 0,
                num_shards: int = 1, on_bev=None,
                img_transfer: Optional[str] = None,
                pc_transfer: str = 'float32', *, device='cuda') -> dict:
    """Scene-sharded dataset job that resumes from a manifest.

    Each sequence is a unit of work with a fresh accumulator. Units are
    strided over ``num_shards`` (parallel/manifest.shard_units), finished
    units are recorded in the JSON-lines manifest, and a restarted job
    runs only the pending ones. The subdirNNN/bev_NNN numbering goes on
    from the manifest's per-unit counts, so a unit that crashed part way
    is written again over the same file names, byte for byte (the seed is
    per unit). With ``num_shards > 1`` shard i writes under
    ``output_dir/shardII/``. A unit is recorded only after its
    generator's close(), so a TileRouteOverflow leaves it pending.
    Returns {frames, bevs, units, resumed_at}."""
    from pc_accumulation_lib_tpu_torch.dataloaders.kitti360 import (
        Kitti360Dataloader)
    from pc_accumulation_lib_tpu_torch.parallel.manifest import (
        CompletionManifest, shard_units)
    sequences = list(sequences or cfg.KITTI360_SEQUENCES)
    start_idxs = list(start_idxs or cfg.KITTI360_START_IDXS)
    end_idxs = list(end_idxs or cfg.KITTI360_END_IDXS)
    sampling = sampling or cfg.SamplingConfig()
    output = output or cfg.OutputConfig()
    mesh = (bev_params or {}).get('mesh')
    if mesh is not None and not sharded.is_controller(mesh):
        sharded.serve_mesh_rasters(mesh)
        return {'frames': 0, 'bevs': 0, 'units': [], 'resumed_at': 0}
    try:
        if num_shards > 1:
            output = dataclasses.replace(
                output, output_dir=os.path.join(output.output_dir,
                                                f'shard{shard_idx:02d}'))
        manifest = (CompletionManifest(manifest_path) if manifest_path
                    else None)
        spans = {seq: (s, e)
                 for seq, s, e in zip(sequences, start_idxs, end_idxs)}
        pending = shard_units(sequences, shard_idx, num_shards, manifest)
        # Seat the numbering after every sample of this shard's finished
        # units (a unit that crashed part way runs again over its names).
        done_count = 0
        if manifest is not None:
            for i, u in enumerate(sequences):
                rec = manifest.get(u)
                if i % num_shards == shard_idx and rec is not None:
                    done_count += int(rec.get('bevs', 0))
        calib_params = build_calib_params(kitti360_path)
        total_frames, total_new = 0, 0
        for unit in pending:
            s, e = spans[unit]
            sem_pc_accum = Kitti360SemanticPointCloudAccumulator(
                accum_horizon_dist, calib_params, icp_threshold,
                semseg_model, cfg.DEFAULT_SEMSEG_FILTERS,
                cfg.DEFAULT_SEM_IDXS, use_gt_sem, bev_params,
                accum_cfg=accum_cfg, icp_cfg=icp_cfg, seed=seed,
                img_transfer=img_transfer, transfer_dtype=pc_transfer,
                device=device)
            dataloader = Kitti360Dataloader(kitti360_path, 1, [unit], [s],
                                            [e])
            try:
                stats = sampling_loop(sem_pc_accum, dataloader, sampling,
                                      output, on_bev=on_bev,
                                      start_count=done_count + total_new)
            finally:
                sem_pc_accum.sem_bev_generator.close()
            total_frames += stats['frames']
            total_new += stats['bevs']
            if manifest is not None:
                manifest.mark_done(unit, bevs=stats['bevs'])
        return {'frames': total_frames, 'bevs': total_new,
                'units': list(pending), 'resumed_at': done_count}
    finally:
        if mesh is not None:
            sharded.shutdown_mesh_workers(mesh)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('kitti360_path', type=str)
    parser.add_argument('semseg_model_path', type=str, nargs='?', default='')
    parser.add_argument('--device', type=str, default='cuda')
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
    parser.add_argument('--int_scaler', type=float, default=20)
    parser.add_argument('--int_sep_scaler', type=float, default=20)
    parser.add_argument('--int_mid_threshold', type=float, default=0.5)
    parser.add_argument('--height_filter', type=float, default=None)
    parser.add_argument('--icp_threshold', type=float, default=1e3)
    parser.add_argument('--no_viz', action='store_true')
    # Camera and point wires (ops/imgcodec.py, accum/pointpack.py).
    parser.add_argument('--img_transfer', type=str, default='rgb8',
                        choices=('rgb8', 'yuv420', 'yuv420h'))
    parser.add_argument('--pc_transfer', type=str, default='float32',
                        choices=('float32', 'quantized'))
    # Scene-sharded job (run_sharded): per-sequence units, a JSON-lines
    # completion manifest, the strided shard of the units.
    parser.add_argument('--manifest', type=str, default=None)
    parser.add_argument('--shard_idx', type=int, default=0)
    parser.add_argument('--num_shards', type=int, default=1)
    # Multi-host bring-up (parallel/mesh.initialize_multihost): each
    # process runs its own scene shard; the manifest keeps restarts from
    # repeating finished units.
    parser.add_argument('--coordinator_address', type=str, default=None)
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    args = parser.parse_args(argv)

    from pc_accumulation_lib_tpu_torch.parallel.mesh import (
        initialize_multihost)
    initialize_multihost(args.coordinator_address, args.num_processes,
                         args.process_id)

    semseg_model = None
    if not args.use_gt_sem:
        from pc_accumulation_lib_tpu_torch.models.semseg import (
            load_semseg_model)
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
    entry = run_sharded if (args.manifest or args.num_shards > 1) else run
    extra = ({'manifest_path': args.manifest, 'shard_idx': args.shard_idx,
              'num_shards': args.num_shards}
             if entry is run_sharded else {})
    stats = entry(
        args.kitti360_path, semseg_model, args.use_gt_sem,
        accum_horizon_dist=args.accum_horizon_dist,
        icp_threshold=args.icp_threshold, bev_params=bev_params,
        sampling=cfg.SamplingConfig(args.bev_horizon_dist,
                                    args.bev_dist_between_samples,
                                    args.bevs_per_sample),
        output=cfg.OutputConfig(args.bev_output_dir,
                                viz_to_disk=not args.no_viz),
        img_transfer=args.img_transfer, pc_transfer=args.pc_transfer,
        device=args.device, **extra)
    print(stats)


if __name__ == '__main__':
    main()
