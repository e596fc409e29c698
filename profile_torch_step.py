#!/usr/bin/env python3
"""Where the time of the PyTorch port's step() goes, at chip_smoke.py's
bench configuration on one NVIDIA GPU.

    python3 profile_torch_step.py

Runs integrate on frame 0 and 20 step(bev_num=16) calls, which fill the
40 m window, then times each piece of a step on its own, with
torch.cuda.synchronize() around it (median of 10 runs), and runs two
more steps under torch.profiler for the device-busy share and the ops
that take the most device time. Prints one JSON line per part, then the
profiler's table and the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

STEPS, REPS = 20, 10


def _median_s(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def run_steps(accum, frames):
    step_s = []
    for f in frames:
        t = time.perf_counter()
        accum.step([f], bev_num=cs.BEV_NUM, gen_future=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    return step_s


def time_pieces(accum, frames, reps):
    """Seconds of each piece of one step, run alone on the current state;
    ``frames`` are the last two integrated frames."""
    from pc_accumulation_lib_tpu_torch.accum import buffer
    gen = accum.sem_bev_generator
    prev, obs = (accum.upload_obs(f) for f in frames)
    clouds = [accum._icp_pre(accum._dequant(o.pc_pad)[:, :3], o.valid)
              for o in (prev, obs)]
    pc = accum._dequant(obs.pc_pad)
    rgb = obs.aux.to(torch.float32)[None]
    window = buffer.compact_window(accum.state, accum._ws_dev,
                                   accum.accum_cfg.compact_cap)
    flat_pts, pt_fids, flat_valid, _ = window
    prepped = gen.prep_points(flat_pts, accum.state.inst_dyn,
                              accum._pose_vec_dev)
    rot, dx, dy, zoom = gen._draw_geom_aug()
    w = gen._draw_warp()
    hf = np.inf if gen.height_filter is None else gen.height_filter
    aug = torch.tensor([rot, dx, dy, zoom, w['a1'], w['a2'], w['b1'],
                        w['b2'], hf], dtype=torch.float32, device=accum.device)

    def raster():
        return gen._raster_prepped(prepped[0], flat_valid, pt_fids,
                                   prepped[1], prepped[2],
                                   (accum._pose_vec_dev, aug), True)

    pieces = {
        'upload': lambda: accum.upload_obs(frames[1]),
        'icp_preprocess': lambda: accum._icp_pre(pc[:, :3], obs.valid),
        'icp_register': lambda: accum._icp_reg(
            clouds[0], clouds[1], accum._T_new_prev_dev,
            accum.icp_cfg.max_corr_dist),
        'semseg': lambda: accum.semseg_model.predict(rgb),
        'compact_window': lambda: buffer.compact_window(
            accum.state, accum._ws_dev, accum.accum_cfg.compact_cap),
        'prep': lambda: gen.prep_points(flat_pts, accum.state.inst_dyn,
                                        accum._pose_vec_dev),
        'raster': raster,
        'raster_and_fetch': lambda: raster().to('cpu'),
    }
    return {k: _median_s(fn, reps) for k, fn in pieces.items()}


def profile_steps(accum, frames):
    """Two steps under torch.profiler: wall span, device time, kernel
    launches, and the top ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_steps(accum, frames)
        span = time.perf_counter() - t
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in ka if e.key in (
        'cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel'))
    res = dict(steps=len(frames), span_s=span, device_s=device_us * 1e-6,
               device_busy_share=device_us * 1e-6 / span,
               kernel_launches=launches)
    table = ka.table(sort_by='self_device_time_total', row_limit=20,
                     max_name_column_width=60)
    return res, table


def main():
    if not torch.cuda.is_available():
        print('profile_torch_step: no CUDA device', file=sys.stderr)
        return 1
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    dev = torch.device('cuda', 0)
    n = STEPS + 3
    stream = SyntheticKitti360Stream(n_frames=n, **cs.STREAM)
    frames = [stream.frame(i) for i in range(n)]
    accum = cs._make_accum(dev, SemSegTorch(dev, seed=0), cs.STREAM,
                           cs.ACCUM, cs.ICP, cs.HORIZON, cs.BEV,
                           use_gt_sem=False)
    accum.integrate([frames[0]])
    step_s = run_steps(accum, frames[1:STEPS + 1])
    print(json.dumps(dict(
        part='steps', step_s=step_s, median_step_s=statistics.median(
            step_s[1:]), median_last10_step_s=statistics.median(
            step_s[-10:]), window_frames=len(accum.poses),
        max_live_rows=accum.max_live_rows)), flush=True)
    pieces = time_pieces(accum, frames[STEPS - 1:STEPS + 1], REPS)
    print(json.dumps(dict(part='pieces', reps=REPS, seconds=pieces)),
          flush=True)
    prof, table = profile_steps(accum, frames[STEPS + 1:])
    print(json.dumps(dict(part='profile', **prof)), flush=True)
    print(table, flush=True)
    print(cs.run(['nvidia-smi', '--query-gpu=name,power.limit',
                  '--format=csv,noheader']).splitlines()[0], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
