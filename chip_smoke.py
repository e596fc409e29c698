#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pc_accumulation_lib_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernel from this checkout, checks it against
its plain PyTorch version on made-up and adversarial rows, drives the
KITTI-360 step() path at the bench configuration, checks the kernel again
on the sorted rows one of that run's rasters gave it, and checks the GPU
run against a CPU run at test size.

    python3 chip_smoke.py

Prints one JSON line per phase, then the card's name and power limit, a
JSON line with each kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = 'pc_accumulation_lib_tpu_torch/csrc/segmented_stats.cu'
KERNEL_REPLACES = 'pc_accumulation_lib_tpu/ops/pallas_stats.py:353'

# Bench configuration (the JAX package's bench.py workload, without its
# remote-link machinery): 376x1408 camera, ~121k points per frame,
# full-depth ResNet-50 semseg, 16 augmented 256x256 samples per frame.
# compact_cap is the bench's 993,280. Only the painted cap is raised from
# the bench's 40,960: the painted count depends on the random semseg
# weights, and the seed-0 PyTorch model paints up to ~47.7k points per
# frame where the JAX bench's model painted ~37.7k; 53,248 is that peak
# plus ~10%, the bench's sizing rule.
STREAM = dict(step=2.0, lidar_range=60.0, seed=0, points_per_frame=45_000,
              img_hw=(376, 1408))
ACCUM = dict(max_points_per_frame=131072, max_frames=26,
             max_painted_points_per_frame=53248, compact_cap=993_280)
ICP = dict(max_downsampled=4096, num_iters=16)
HORIZON = 40.0
BEV = dict(type='sem', view_size=80, pixel_size=256, max_trans_radius=3.0,
           zoom_thresh=0.05, do_warp=True, int_scaler=20.,
           int_sep_scaler=20., int_mid_threshold=0.5, fetch_dtype='float16')
BEV_NUM = 16
N_STEPS = 9

# Kernel-vs-plain tolerance: everything exact except the intensity sums.
INTENSITY_RTOL = 1e-5
# GPU-vs-CPU step() tolerances (as the CPU parity tests hold the port to
# the JAX package): poses 1e-4 m; BEV maps: fraction of cells differing by
# more than 2e-2 below 0.02.
POSE_ATOL = 1e-4
MAP_ATOL, MAP_MISMATCH = 2e-2, 0.02


def check(ok, what):
    """Raise unless ``ok`` (unlike an assert statement, also under
    python -O)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {what}')


def emit(phase, t0, **numbers):
    print(json.dumps(dict(phase=phase, seconds=time.perf_counter() - t0,
                          **numbers)), flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_env():
    t0 = time.perf_counter()
    from torch.utils.cpp_extension import CUDA_HOME
    # The parity-critical float32 products (poses, ICP, geometry) rely on
    # PyTorch's default of no TF32 in matmuls; the port does not set it.
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 matmul is on')
    check(torch.get_float32_matmul_precision() == 'highest',
          torch.get_float32_matmul_precision())
    card = run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]
    nvcc = run([os.path.join(CUDA_HOME, 'bin', 'nvcc'), '--version'])
    emit('env', t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.splitlines()[-1],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=card,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build():
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    path = ss.build_library()
    ss.load_library()
    ptxas = [ln.strip() for ln in
             path.with_suffix('.log').read_text().splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit('build', t0, library=os.path.relpath(path, HERE), ptxas=ptxas)


def _words(gen, n, dev):
    """Random payload words in pack_payload_words layout: flags + rgb in
    w1, float16 z bits + u16 intensity in w2."""
    w1 = torch.randint(0, 1 << 26, (n,), generator=gen, dtype=torch.int32)
    z = (torch.randn(n, generator=gen) * 3.0).to(torch.float16)
    z16 = z.view(torch.int16).to(torch.int32) & 0xFFFF
    w2 = (z16 << 16) | torch.randint(0, 1 << 16, (n,), generator=gen,
                                     dtype=torch.int32)
    return w1.to(dev), w2.to(dev)


def _kernel_cases(dev):
    gen = torch.Generator().manual_seed(0)
    cases = {}
    # Bench raster shape: 860,160 sorted rows over ~7.7k occupied of
    # 65,536 cells, 131,072 groups (cell * 2 + is_future), a quarter of
    # the rows masked to the sentinel key.
    n, cells, G = 860_160, 65_536, 131_072
    occ = torch.randperm(cells, generator=gen)[:7_700]
    c2 = (occ[torch.randint(0, occ.numel(), (n,), generator=gen)] * 2
          + (torch.rand(n, generator=gen) < 0.35))
    c2 = torch.where(torch.rand(n, generator=gen) < 0.25, G, c2)
    cases['bench'] = (torch.sort(c2.to(torch.int32)).values.to(dev),
                      *_words(gen, n, dev), G)
    # Adversarial small case: sentinels, empty groups, single-row groups,
    # float16 subnormal and extreme heights.
    n, G = 6000, 1024
    c2 = torch.randint(G // 4, 3 * G // 4, (n,), generator=gen)
    c2 = torch.where(torch.rand(n, generator=gen) < 0.1, G, c2)
    c2[:8] = torch.arange(8) * 4 + 1
    w1, w2 = _words(gen, n, 'cpu')
    tricky = torch.tensor([0.0, -0.0, 5.9604645e-08, -5.9604645e-08,
                           6.0975552e-05, 65504.0, -65504.0, 1e-4])
    zbits = tricky.to(torch.float16).view(torch.int16).to(torch.int32)
    w2[:8] = ((zbits & 0xFFFF) << 16) | (w2[:8] & 0xFFFF)
    order = torch.sort(c2.to(torch.int32)).indices
    cases['adversarial'] = (c2.to(torch.int32)[order].to(dev),
                            w1[order].to(dev), w2[order].to(dev), G)
    # One group of more than 65,535 rows.
    n, G = 70_000, 8
    c2 = torch.full((n,), 3, dtype=torch.int32)
    c2[-100:] = 5
    cases['large_group'] = (c2.to(dev), *_words(gen, n, dev), G)
    return cases


def _max_err(got, ref):
    """Max abs difference over all outputs; +inf z-mins must match
    exactly. Also checks the exact-equality contract."""
    sums, zmin, meds = got
    rsums, rzmin, rmeds = ref
    check(torch.equal(sums[:, :3], rsums[:, :3]), 'counts/road/dyn differ')
    check(torch.equal(zmin, rzmin), 'z-min differs')
    check(torch.equal(meds, rmeds), 'medians differ')
    check(torch.allclose(sums[:, 3], rsums[:, 3], rtol=INTENSITY_RTOL,
                          atol=1e-6), 'intensity differs')
    fin = torch.isfinite(rzmin)
    return max(float((sums - rsums).abs().max()),
               float((zmin[fin] - rzmin[fin]).abs().max()) if fin.any()
               else 0.0,
               float((meds - rmeds).abs().max()))


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(ss, c2, w1, w2, G):
    """Kernel against the plain version on one input; returns the max abs
    error after the exactness checks."""
    got = ss.segmented_stats_words(c2, w1, w2, G, med_nsplit=2)
    ref = ss.segmented_stats_words_reference(c2, w1, w2, G, med_nsplit=2)
    torch.cuda.synchronize()
    return _max_err(got, ref)


def _time_pair(ss, c2, w1, w2, G):
    """Median ms of kernel and plain version on one input, timed in turns
    on this card: plain, kernel, kernel, plain."""
    def plain():
        return _median_ms(lambda: ss.segmented_stats_words_reference(
            c2, w1, w2, G, med_nsplit=2))

    def kern():
        return _median_ms(lambda: ss.segmented_stats_words(
            c2, w1, w2, G, med_nsplit=2))
    p, k = [plain()], [kern(), kern()]
    p.append(plain())
    return dict(ms=statistics.median(k), plain_ms=statistics.median(p),
                ms_runs=k, plain_ms_runs=p)


def _shape(c2, G):
    """Rows, rows with a group key (not the sentinel), groups, and
    occupied groups of one kernel input."""
    keyed = c2[c2 < G]
    return dict(rows=int(c2.numel()), keyed_rows=int(keyed.numel()),
                groups=G, occupied_groups=int(torch.unique(keyed).numel()))


def phase_kernel(dev):
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    cases = _kernel_cases(dev)
    errs = {name: _compare(ss, *case) for name, case in cases.items()}
    res = dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
               **_time_pair(ss, *cases['bench']), **_shape(
                   cases['bench'][0], cases['bench'][3]))
    emit('kernel_vs_plain', t0, **res)
    return res


def phase_kernel_on_main_path(raster_in):
    """The kernel against the plain version on one raster's sorted rows as
    the main path gave them to the kernel (compact_cap rows)."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    c2, w1, w2, G = raster_in
    check(c2.numel() == ACCUM['compact_cap'], c2.numel())
    res = dict(max_abs_err=_compare(ss, c2, w1, w2, G),
               **_time_pair(ss, c2, w1, w2, G), **_shape(c2, G))
    emit('kernel_on_main_path', t0, **res)
    return res


def _make_accum(dev, semseg, stream_cfg, accum_cfg, icp_cfg,
                horizon, bev, use_gt_sem, seed=0):
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        make_calib)
    _, H_velo_cam, P_cam_frame = make_calib(stream_cfg['img_hw'])
    calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                 p_velo_frame=P_cam_frame @ H_velo_cam)
    return Kitti360SemanticPointCloudAccumulator(
        horizon, calib, 1e3, semseg, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, use_gt_sem, bev,
        accum_cfg=cfg.AccumConfig(**accum_cfg),
        icp_cfg=cfg.ICPConfig(**icp_cfg), seed=seed,
        transfer_dtype='quantized', img_transfer='rgb8', device=dev)


def _check_bevs(bevs, P):
    """16 dicts of 15 float16 maps, finite; returns the occupied-cell
    fraction of the 'full' split."""
    check(len(bevs) == BEV_NUM, len(bevs))
    occ = []
    for b in bevs:
        maps = {k: v for k, v in b.items() if not k.startswith('trajs')}
        check(len(maps) == 15, sorted(maps))
        for k, v in maps.items():
            check(v.dtype == np.float16 and v.shape[-2:] == (P, P),
                  (k, v.dtype, v.shape))
            check(np.isfinite(v).all(), k)
        # Empty cells hold road = dynamic = 0.5 and elevation 0.
        occ.append(float(np.mean((b['road_full'] != 0.5)
                                 | (b['dynamic_full'] != 0.5)
                                 | (b['elevation_full'] != 0))))
    return float(np.mean(occ))


def phase_main_path(dev):
    """9 bench-configuration steps. Also returns the sorted rows the kernel
    got in the last step's first raster."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    t0 = time.perf_counter()
    raster_in = []

    def capture(c2, w1, w2, num_groups, med_nsplit):
        # Keeps the first call's inputs, then launches as the path does.
        check(med_nsplit == 2, med_nsplit)
        if not raster_in:
            raster_in.extend((c2, w1, w2, num_groups))
        return ss.segmented_stats_words(c2, w1, w2, num_groups,
                                        med_nsplit=med_nsplit)

    stream = SyntheticKitti360Stream(n_frames=N_STEPS + 1, **STREAM)
    frames = [stream.frame(i) for i in range(N_STEPS + 1)]
    semseg = SemSegTorch(dev, seed=0)
    accum = _make_accum(dev, semseg, STREAM, ACCUM, ICP, HORIZON,
                        BEV, use_gt_sem=False)
    torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    accum.integrate([frames[0]])
    torch.cuda.synchronize()
    step_s, occ = [], []
    for i, f in enumerate(frames[1:]):
        before = ss.segmented_stats_words.launches
        if i == N_STEPS - 1:   # the last step, with the most live rows
            sort_raster.segmented_stats = types.SimpleNamespace(
                segmented_stats_words=capture)
        ts = time.perf_counter()
        try:
            bevs = accum.step([f], bev_num=BEV_NUM, gen_future=True)
            torch.cuda.synchronize()
        finally:
            sort_raster.segmented_stats = ss
        step_s.append(time.perf_counter() - ts)
        rose = ss.segmented_stats_words.launches - before
        check(rose == BEV_NUM, f'step {i}: {rose} kernel launches')
        occ.append(_check_bevs(bevs, BEV['pixel_size']))
    launches = ss.segmented_stats_words.launches
    check(launches == BEV_NUM * N_STEPS, launches)
    check(min(occ) > 0, occ)
    steady = statistics.median(step_s[1:])
    res = dict(steps=N_STEPS, bev_num=BEV_NUM, launches=launches,
               step_s=step_s, median_step_s=steady,
               samples_per_s=BEV_NUM / steady,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               max_live_rows=accum.max_live_rows,
               window_frames=len(accum.poses),
               occupied_cell_fraction=occ)
    emit('main_path', t0, **res)
    return res, raster_in


def phase_gpu_vs_cpu(dev):
    """The same small step() run on the GPU and on the CPU."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    stream_cfg = dict(step=2.0, lidar_range=25.0, seed=3,
                      points_per_frame=3000, img_hw=(188, 704))
    accum_cfg = dict(max_points_per_frame=8192, max_frames=10,
                     max_painted_points_per_frame=8192, compact_cap=49152)
    bev = dict(BEV, view_size=40, pixel_size=64, max_trans_radius=2.0)
    stream = SyntheticKitti360Stream(n_frames=6, **stream_cfg)
    frames = [stream.frame(i) for i in range(6)]
    runs = {}
    for d in (dev, torch.device('cpu')):
        a = _make_accum(d, None, stream_cfg, accum_cfg,
                        dict(max_downsampled=512, num_iters=8), 12.0, bev,
                        use_gt_sem=True, seed=7)
        before = ss.segmented_stats_words.launches
        a.integrate([frames[0]])
        out = [(a.step([f], bev_num=2, gen_future=True),
                np.array(a.poses), a.window_start) for f in frames[1:]]
        runs[d.type] = (out, ss.segmented_stats_words.launches - before)
    (gpu, gpu_launches), (cpu, cpu_launches) = runs['cuda'], runs['cpu']
    check(gpu_launches == 2 * 5 and cpu_launches == 0,
          (gpu_launches, cpu_launches))
    pose_err, mism = 0.0, 0.0
    for (bg, pg, wg), (bc, pc, wc) in zip(gpu, cpu):
        check(wg == wc, (wg, wc))
        pose_err = max(pose_err, float(np.abs(pg - pc).max()))
        for sg, sc in zip(bg, bc):
            for k in sg:
                if k.startswith('trajs'):
                    continue
                d = np.abs(sg[k].astype(np.float32) - sc[k].astype(np.float32))
                mism = max(mism, float(np.mean(d > MAP_ATOL)))
    emit('gpu_vs_cpu', t0, max_pose_err_m=pose_err, pose_atol=POSE_ATOL,
         max_cell_mismatch_fraction=mism, mismatch_limit=MAP_MISMATCH,
         gpu_kernel_launches=gpu_launches)
    check(pose_err <= POSE_ATOL, pose_err)
    check(mism < MAP_MISMATCH, mism)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import pc_accumulation_lib_tpu_torch  # noqa: F401  (needs the checkout)
    dev = torch.device('cuda', 0)
    card = phase_env()
    phase_build()
    kern = phase_kernel(dev)
    main_res, raster_in = phase_main_path(dev)
    on_path = phase_kernel_on_main_path(raster_in)
    phase_gpu_vs_cpu(dev)
    print(card, flush=True)
    print(json.dumps({'kernels': [{
        'name': 'segmented_stats_words', 'route': 'cuda',
        'source': KERNEL_SOURCE, 'replaces': KERNEL_REPLACES,
        'launches': main_res['launches'],
        'max_abs_err': max(kern['max_abs_err'], on_path['max_abs_err']),
        'ms': on_path['ms'], 'plain_ms': on_path['plain_ms']}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
