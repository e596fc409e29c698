#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pc_accumulation_lib_tpu_torch) on one
NVIDIA GPU. It builds the CUDA kernels from this checkout and checks both
(kernel 1 on the packed payload words, kernel 2 on unpacked float rows)
against their plain PyTorch versions on made-up and adversarial rows. It
drives the KITTI-360 step() path at the bench configuration and checks
kernel 1 on the sorted rows one of its rasters gave it. It drives the
KITTI-360 dataset runner's sampling_loop (integrate + generate_bev, the
classic raster) at the runner's default configuration, writes and reads
back its samples, holds the words route against the unpacked route
(kernel 2) and both kernels against their plain versions on one of its
rasters' rows, and the raster with the kernels against the raster
without them on one of its samples. It drives the runner a second time
with every raster's stats stage on the unpacked route (kernel 2) and
holds its samples against the first run's. It drives the NuScenes
oracle-pose accumulator at the JAX bench's oracle configuration (6
cameras, tracking, the dynamic table) and holds both kernels against
their plain versions on one of its rasters' rows, then the NuScenes
runner's two phases at run()'s defaults with oracle poses and its ICP
branch. It checks a GPU run against a CPU run at test size, for step(),
the KITTI-360 runner and the oracle accumulator. It writes the
full-width semseg model as an .onnx and a weight file and loads each
back, trains it at 376x1408 through the training runner (step time,
FLOP/s, peak memory, a checkpoint restored bit-equal), drives the two
point-cloud export runners, and checks train steps on the GPU against
the CPU at test size. It drives step() and the oracle accumulator again
on the JAX bench's yuv420h / quantized upload wires, the KITTI-360 runner
with the RGB BEV type, the legacy BEV pipeline on the runner's last
window (card against CPU), and the mesh paths in spawned processes (two
ranks, and step() on four) over gloo on the one card. The JAX bench's
download path: sparse_step_path (step() at the bench's sparse fetch
configuration: prewarm_rungs, step(async_fetch=True) drained on a worker
thread, samples held to the dense raster, the overflow fallback),
kernels_on_sparse_path (both kernels on its rank-compacted keys),
sparse_oracle_path (the oracle on the sparse fetch) and mesh_sparse (the
sparse step() through the tile engine's group on two ranks, byte-equal
to sparse_step_path's buffers). Tensor parallelism: train_tp_path (the
training runner at its default (1, 2) layout on the two ranks, full
depth and width, a float64 run held to one card's, float32 timed, the
model-axis collectives' bytes), train_tp4_path ((2, 2) on four ranks,
float64, held) and dryrun_multichip on 2 and 4 ranks. The host side of
the upload wires: wire_path and oracle_wire_path time the native camera
encoder against its numpy spec (held equal), and oracle_wire_path drives
its frames again with each upload on a worker thread (samples held to
the serial drive's). reference_api_path: obs2sem_vec_space against
integrate on main_path's first frames, and the semseg wrapper's
pred_batch / pred against predict at 376x1408.

    python3 chip_smoke.py

Prints one JSON line per phase, then the card's name and power limit, a
JSON line with each kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a machine without a CUDA device.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = 'pc_accumulation_lib_tpu_torch/csrc/segmented_stats.cu'
KERNEL_REPLACES = 'pc_accumulation_lib_tpu/ops/pallas_stats.py:353'
KERNEL2_REPLACES = 'pc_accumulation_lib_tpu/ops/pallas_stats.py:90'

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

# The dataset runner at its run() defaults (runners/kitti360_bev_gen.py):
# AccumConfig() (256 frames x 131,072 rows, so each sample's raster sweeps
# 33,554,432 rows), ICPConfig(max_corr_dist=1e3), SamplingConfig() (80 m
# behind and ahead, 1 m apart, 1 sample), the 80 m / 256 px BEV without
# augmentation or warp, horizon 200 m, on 120 frames of the bench stream
# (2 m apart). A sample's present pose is the first one 80 m along the
# path from the window's oldest pose, so it moves, and samples follow one
# per frame, only once the 200 m horizon evicts frames (~frame 101); 100
# frames give one sample.
RUNNER_FRAMES = 120
RUNNER_MIN_SAMPLES = 10

# The JAX bench's NuScenes oracle workload (bench.py:134-206) without its
# remote link: 20 synthetic frames 2 m apart, 6 cameras of 448x800,
# full-depth ResNet-50, the bench's caps (32 frames x 49,152 painted rows
# per raster; the port's seed-0 model paints under 9k points per frame
# here, so the cap stands), the 80 m / 256 px BEV with the NuScenes road
# marking parameters, the dense float16 fetch in place of the bench's
# sparse one. 4 warm-up frames, then one upload + integrate +
# generate_bev per frame, each frame's samples harvested one frame later.
# A straight lane centerline along the drive is injected (gt_lanes).
NUSCENES_FILTERS = (10, 11, 12, 16, 18)
ORACLE_STREAM = dict(step=2.0, lidar_range=50.0, seed=0, img_hw=(448, 800))
ORACLE_FRAMES, ORACLE_WARMUP = 20, 4
ORACLE_ACCUM = dict(max_points_per_frame=65536, max_frames=32,
                    max_painted_points_per_frame=49152)
ORACLE_BEV = dict(type='sem', view_size=80, pixel_size=256, int_scaler=1.,
                  int_sep_scaler=30., int_mid_threshold=0.12,
                  fetch_dtype='float16')
# The NuScenes runner at run()'s defaults (runners/nuscenes_bev_gen.py):
# AccumConfig() (256 x 131,072 rows per raster), SamplingConfig(80 m), the
# runner's BEV, oracle pose, on 100 frames of the same stream: a real
# scene has ~40 keyframes, but at 2 m per frame that leaves no pose with
# 80 m of path on both sides. Then the ICP branch (horizon 200 m,
# ICPConfig(max_corr_dist=1e3)) on the stream's first 12 frames, whose
# steps must come out at the stream's 2 m within 0.4 m.
NUSC_RUNNER_FRAMES, NUSC_ICP_FRAMES = 100, 12
STEP_ATOL = 0.4
# reference_api_path: main_path's first frames through obs2sem_vec_space
# and through integrate.
REFERENCE_API_FRAMES = 6
# Camera wire bytes per pixel (ops/imgcodec.py); the JAX bench's own runs
# upload 'yuv420h' images and 'quantized' points (wire_path,
# oracle_wire_path).
WIRE_BYTES_PER_PIXEL = {'rgb8': 3, 'yuv420': 1.5, 'yuv420h': 0.75}

# Semseg training at full width (runners/train_semseg.run): the
# full-depth ResNet-50 dilated FCN on a shard of 16 rendered 376x1408
# frames, run()'s batch of 8, 12 steps, a checkpoint every 6. Then 5 steps
# on one fixed batch must lower the loss (as the JAX package's model test
# holds its trainer).
TRAIN_FRAMES, TRAIN_STEPS, TRAIN_BATCH, TRAIN_CKPT_EVERY = 16, 12, 8, 6
FIXED_BATCH_STEPS = 5
BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA's data sheet
# The GPU-vs-CPU train check at test size, with the CPU parity test's
# tolerances against the JAX trainer: step-1 loss rtol 1e-5, gradients
# rtol 1e-4 with atol GRAD_FLOOR * max|g| per tensor, batch-norm running
# statistics rtol 1e-5 with atol 1e-5 * max|stat|; three steps' losses
# rtol 1e-4, parameters within 2 * lr * steps (Adam moves a weight by about
# lr per step whatever its gradient's size). phase_gpu_vs_cpu_train says
# where float32 is held to a float64 run instead.
SMALL_TRAIN = dict(stage_sizes=(1, 1, 1, 1), hw=(64, 128), batch=2,
                   steps=3, lr=1e-3)
GRAD_FLOOR = 5e-5
# The point-cloud export runners (runners/*_pc_accum.py) at their run()
# defaults: the KITTI-360 one on main's 20 frames of the bench stream, the
# NuScenes one with oracle poses on the oracle stream's 20 frames.
PC_ACCUM_FRAMES = 20

# Kernel-vs-plain tolerance: everything exact except the float sums.
INTENSITY_RTOL = 1e-5
# The raster with the kernels against the raster without them (bench.py's
# --selftest gate): float16 stacks within 2e-3 max abs.
SELFTEST_ATOL = 2e-3
# GPU-vs-CPU step() tolerances (as the CPU parity tests hold the port to
# the JAX package): poses 1e-4 m; BEV maps: fraction of cells differing by
# more than 2e-2 below 0.02.
POSE_ATOL = 1e-4
MAP_ATOL, MAP_MISMATCH = 2e-2, 0.02

# Kernel timing. The kernels are bound by bytes: the least time is the
# bytes they must move (the key and payload of each keyed row read once,
# each output written once) over the H100 SXM's HBM3 rate at its 700 W
# limit (NVIDIA's data sheet); their operations (a few adds, a min and a
# compare per row and value) over the card's 67 TFLOP/s float32 rate take
# far less. Outputs per group: sums 4 B per weight, z-min 4 B, medians
# 2 x 4 B per value row.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TIMING_REPS = 50
PROFILER_REPS = 20


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
                      *_words(gen, n, dev), G, {})
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
                            w1[order].to(dev), w2[order].to(dev), G, {})
    # One group of more than 65,535 rows.
    n, G = 70_000, 8
    c2 = torch.full((n,), 3, dtype=torch.int32)
    c2[-100:] = 5
    cases['large_group'] = (c2.to(dev), *_words(gen, n, dev), G, {})
    # Group sizes around the register/histogram thresholds, with and
    # without medians, one and two groups per cell.
    keys, G = _edge_keys()
    w1, w2 = _words(gen, keys.numel(), dev)
    for name, kw in (('register_edges', {}),
                     ('register_edges_nsplit_1', dict(med_nsplit=1)),
                     ('register_edges_no_medians',
                      dict(hist_medians=False))):
        cases[name] = (keys.to(dev), w1, w2, G, kw)
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    cases['no_rows'] = (none, none, none, 64, {})
    cases['all_sentinel'] = (torch.full((5000,), 64, dtype=torch.int32,
                                        device=dev), *_words(gen, 5000, dev),
                             64, {})
    keys = _sorted_keys(gen, 3000, 77, 0, 77, 0.1)
    cases['odd_groups_nsplit_1'] = (keys.to(dev), *_words(gen, 3000, dev),
                                    77, dict(med_nsplit=1))
    return cases


def _edge_keys():
    """Sorted keys whose groups hold 1, 31-33, 63-65, 127-129 and 200 rows
    (around the register/histogram thresholds) in cells whose other split
    is empty or as full; pairs whose sum crosses a threshold; negative
    keys before and sentinels after. Returns (keys, num_groups)."""
    sizes = []
    for a in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 200):
        sizes += [a, 0, 0, a, a, 0]
    for pair in ((16, 16), (16, 17), (32, 32), (32, 33), (60, 5), (64, 64),
                 (64, 65), (100, 28), (100, 29), (1, 127), (0, 0), (3, 0)):
        sizes += list(pair)
    G = len(sizes)
    keys = torch.repeat_interleave(torch.arange(G, dtype=torch.int32),
                                   torch.tensor(sizes))
    return torch.cat([torch.full((7,), -3, dtype=torch.int32), keys,
                      torch.full((50,), G, dtype=torch.int32)]), G


def _max_abs(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def _max_err(got, ref):
    """Max abs difference over all outputs; +inf z-mins must match
    exactly. Also checks the exact-equality contract."""
    check(len(got) == len(ref), (len(got), len(ref)))
    sums, zmin = got[:2]
    rsums, rzmin = ref[:2]
    check(torch.equal(sums[:, :3], rsums[:, :3]), 'counts/road/dyn differ')
    check(torch.equal(zmin, rzmin), 'z-min differs')
    check(torch.allclose(sums[:, 3], rsums[:, 3], rtol=INTENSITY_RTOL,
                          atol=1e-6), 'intensity differs')
    fin = torch.isfinite(rzmin)
    errs = [_max_abs(sums, rsums), _max_abs(zmin[fin], rzmin[fin])]
    if len(got) == 3:
        check(torch.equal(got[2], ref[2]), 'medians differ')
        errs.append(_max_abs(got[2], ref[2]))
    return max(errs)


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


def _median_ms_host(fn, reps=10):
    """Median host-clock ms of ``fn`` (host work)."""
    fn()
    times = []
    for _ in range(reps):
        ts = time.perf_counter()
        fn()
        times.append((time.perf_counter() - ts) * 1e3)
    return statistics.median(times)


def _bound(keyed_rows, row_bytes, groups, n_weights, n_values):
    """Bytes, operations and the least time of one stats call."""
    nbytes = keyed_rows * row_bytes + groups * 4 * (n_weights + 1
                                                    + 2 * n_values)
    ops = keyed_rows * (n_weights + 1 + n_values)
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    return dict(bytes=nbytes, ops=ops, bound_us=bound_s * 1e6,
                bound_by='bytes' if nbytes / HBM_BYTES_PER_S
                >= ops / FP32_OPS_PER_S else 'operations')


def _profiler_us(raw, reps=PROFILER_REPS):
    """The stats kernel's own mean device time under torch.profiler over
    ``reps`` launches; None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    raw()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            raw()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if 'segmented_stats' in ev.key and ev.count:
            total = (getattr(ev, 'self_device_time_total', 0)
                     or getattr(ev, 'self_cuda_time_total', 0))
            if total:
                return total / ev.count
    return None


def _events_us(raw, reps=TIMING_REPS):
    """Mean device time of ``reps`` back-to-back calls of ``raw``: CUDA
    events around the run."""
    raw()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        raw()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def _timing(raw, wrapper, keyed_rows, row_bytes, groups, n_weights,
            n_values, reps=TIMING_REPS):
    """(i) the kernel's device time: CUDA events around ``reps``
    back-to-back launches of ``raw`` (the kernel alone, on prepared
    inputs and outputs), and its mean under torch.profiler; (ii) the
    wrapper's time per call: host clock around ``reps`` calls of
    ``wrapper``, ending in a synchronize; (iii) the bound and the share of
    it the device time reaches. Inputs stay warm in L2 between launches,
    as the sort that precedes the stats stage leaves them. Also checks
    that one wrapper call runs one device operation (the kernel)."""
    device_us = _events_us(raw, reps)
    wrapper()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        wrapper()
    torch.cuda.synchronize()
    wrapper_us = (time.perf_counter() - t) * 1e6 / reps
    bound = _bound(keyed_rows, row_bytes, groups, n_weights, n_values)
    # The wrapper runs the kernel and no other device operation: the one
    # node of a CUDA graph that captures a call, and the one operation
    # torch.profiler sees, where its sessions see the card at all. (The
    # profiler sometimes drops a launch's record, so fewer than one per
    # call can show; never another operation.)
    graph_ops = _graph_ops(wrapper)
    check(len(graph_ops) == 1 and 'segmented_stats_kernel' in graph_ops[0],
          f'one device operation per call in a CUDA graph, got {graph_ops}')
    per_call, ops = _device_ops(wrapper)
    check(per_call is None or (len(ops) == 1
                               and 'segmented_stats_kernel' in ops[0]
                               and 0 < per_call <= 1),
          f'one device operation per call, got {per_call}: {ops}')
    return dict(device_us=device_us, device_us_profiler=_profiler_us(raw),
                wrapper_us=wrapper_us, **bound,
                bound_share=bound['bound_us'] / device_us,
                device_ops_per_call=ops, profiled_ops_per_call=per_call,
                graph_ops_per_call=graph_ops)


def _raw_words(ss, c2, w1, w2, G, nsplit=2):
    """Kernel 1 alone: its output buffer made once, then only the
    launch."""
    buf, _ = ss._outputs(c2, G, 4, 3)
    return lambda: ss._launch_words(c2, w1, w2, G, nsplit, 3, buf)


def _raw_rows(ss, case):
    """Kernel 2 alone: its output buffer made once, then only the
    launch."""
    keys, G = case['sorted_keys'], case['num_groups']
    wr, vr = case['weight_rows'], case['value_rows']
    nsplit = 2 if vr and case['med_nsplit'] == 2 else 1
    buf, _ = ss._outputs(keys, G, len(wr), len(vr))
    return lambda: ss._launch_rows(keys, wr, case['z_sorted'], vr, G,
                                   nsplit, buf)


def _device_ops(fn, calls=5, tries=10):
    """The device operations (kernels, copies, sets) one call of ``fn``
    runs, from torch.profiler over ``calls`` calls, tried again when a
    session records no device activity: (operations per call, their
    names). (None, None) when none of ``tries`` sessions records any:
    while another process profiles a card of the same host, every session
    of this one can come back empty for the rest of the run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return len(names) / calls, sorted(set(names))
    return None, None


# CUgraphNodeType (libcuda's cuda.h): the node types a stream
# capture records.
_GRAPH_NODE_TYPES = {0: 'kernel', 1: 'memcpy', 2: 'memset', 3: 'host',
                     4: 'graph', 5: 'empty', 6: 'wait_event',
                     7: 'event_record', 10: 'mem_alloc', 11: 'mem_free',
                     12: 'batch_mem_op', 13: 'conditional'}


def _graph_ops(fn):
    """The device operations of one call of ``fn`` (warmed up), read from
    a CUDA graph that captures the call: one name per graph node, a kernel
    by its function's (mangled) name, through libcuda. A capture
    records every operation the call puts on the stream, with no
    profiler."""
    import ctypes
    cu = ctypes.CDLL('libcuda.so.1')

    def ok(rc, what):
        check(rc == 0, f'{what} returned CUresult {rc}')

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode='thread_local'):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), 'cuGraphGetNodes')
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), 'cuGraphGetNodes')
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           'cuGraphNodeGetType')
        name = _GRAPH_NODE_TYPES.get(kind.value, f'node type {kind.value}')
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2 as pointer-sized words: func at
            # 0, kern (a CUkernel) at 7.
            params = (ctypes.c_void_p * 9)()
            ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                params),
               'cuGraphKernelNodeGetParams')
            text = ctypes.c_char_p()
            if params[0]:
                ok(cu.cuFuncGetName(ctypes.byref(text),
                                    ctypes.c_void_p(params[0])),
                   'cuFuncGetName')
            elif params[7]:
                ok(cu.cuKernelGetName(ctypes.byref(text),
                                      ctypes.c_void_p(params[7])),
                   'cuKernelGetName')
            name = text.value.decode() if text.value else name
        names.append(name)
    del g
    return names


def _time_words(ss, c2, w1, w2, G):
    """Kernel 1's timing numbers on one input (med_nsplit 2, medians)."""
    keyed = int((c2 < G).sum())
    return _timing(_raw_words(ss, c2, w1, w2, G),
                   lambda: ss.segmented_stats_words(c2, w1, w2, G,
                                                    med_nsplit=2),
                   keyed, 12, G, 4, 3)


def _time_rows(ss, case):
    """Kernel 2's timing numbers on one input."""
    keys, G = case['sorted_keys'], case['num_groups']
    nw, nv = len(case['weight_rows']), len(case['value_rows'])
    keyed = int(((keys >= 0) & (keys < G)).sum())
    return _timing(_raw_rows(ss, case),
                   lambda: ss.segmented_stats(**case),
                   keyed, 4 * (1 + nw + 1 + nv), G, nw, nv)


def _rows_case(c2, w1, w2, G):
    """Kernel 2's inputs on sorted words rows, as the stats stage's
    unpacked route makes them (sort_raster, words_kernel=False)."""
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    z, inten, road, dyn = sort_raster._unpack_words(w1, w2)
    return dict(sorted_keys=c2, weight_rows=[torch.ones_like(road), road,
                                             dyn, inten],
                z_sorted=z, num_groups=G,
                value_rows=[((w1 >> s) & 255).to(torch.float32)
                            for s in (16, 8, 0)], med_nsplit=2)


def _compare(ss, c2, w1, w2, G, kw=None):
    """Kernel against the plain version on one input (med_nsplit 2 and
    medians unless ``kw`` says otherwise); returns the max abs error after
    the exactness checks."""
    kw = dict(dict(med_nsplit=2), **(kw or {}))
    got = ss.segmented_stats_words(c2, w1, w2, G, **kw)
    ref = ss.segmented_stats_words_reference(c2, w1, w2, G, **kw)
    torch.cuda.synchronize()
    return _max_err(got, ref)


def _time_pair(ss, c2, w1, w2, G):
    """Median ms of kernel and plain version on one input, timed in turns
    on this card: plain, kernel, kernel, plain."""
    return _time_turns(
        lambda: ss.segmented_stats_words(c2, w1, w2, G, med_nsplit=2),
        lambda: ss.segmented_stats_words_reference(c2, w1, w2, G,
                                                   med_nsplit=2))


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
    bench = cases['bench'][:4]
    res = dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
               **_time_pair(ss, *bench), **_shape(bench[0], bench[3]),
               timing=_time_words(ss, *bench))
    emit('kernel_vs_plain', t0, **res)
    return res


def _sorted_keys(gen, n, G, keyed_lo, keyed_hi, sentinel_share):
    keys = torch.randint(keyed_lo, keyed_hi, (n,), generator=gen)
    keys = torch.where(torch.rand(n, generator=gen) < sentinel_share, G, keys)
    return torch.sort(keys.to(torch.int32)).values


def _kernel2_case(gen, keys, G, n_weights, n_values, med_nsplit, z=None):
    """Kernel 2's inputs on ``keys``: the raster's weight rows (ones, road
    and dyn flags, u16 intensity / 65535), f32 z, u8-valued rows."""
    n = keys.numel()
    flags = [(torch.rand(n, generator=gen) < p).to(torch.float32)
             for p in (0.5, 0.2)]
    inten = (torch.randint(0, 1 << 16, (n,), generator=gen).to(torch.float32)
             * (1.0 / 65535.0))
    weights = [torch.ones(n), *flags, inten][:n_weights]
    z = torch.randn(n, generator=gen) * 3.0 if z is None else z
    values = [torch.randint(0, 256, (n,), generator=gen).to(torch.float32)
              for _ in range(n_values)]
    return dict(sorted_keys=keys, weight_rows=weights, z_sorted=z,
                num_groups=G, value_rows=values, med_nsplit=med_nsplit)


def _kernel2_cases(dev):
    gen = torch.Generator().manual_seed(1)
    cases = {}
    # Bench raster shape, as kernel 1's: 860,160 rows over ~7.7k occupied
    # of 65,536 cells, 131,072 groups, a quarter of the rows sentinel.
    n, cells, G = 860_160, 65_536, 131_072
    occ = torch.randperm(cells, generator=gen)[:7_700]
    c2 = (occ[torch.randint(0, occ.numel(), (n,), generator=gen)] * 2
          + (torch.rand(n, generator=gen) < 0.35))
    c2 = torch.where(torch.rand(n, generator=gen) < 0.25, G, c2)
    cases['bench'] = _kernel2_case(gen, torch.sort(c2.to(torch.int32)).values,
                                   G, 4, 3, 2)
    # One group of more than 65,535 rows.
    keys = torch.full((70_000,), 3, dtype=torch.int32)
    keys[-100:] = 5
    cases['large_group'] = _kernel2_case(gen, keys, 8, 4, 3, 2)
    # Empty and single-row groups, negative, signed-zero and subnormal z.
    keys = _sorted_keys(gen, 6000, 1024, 256, 768, 0.1)
    keys[:8] = torch.arange(8, dtype=torch.int32) * 4 + 1
    keys = torch.sort(keys).values
    z = torch.randn(6000, generator=gen) * 3.0
    tricky = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
                           -7.5, 1.17549435e-38, -3.0e38, 3.0e38])
    z[::9] = tricky.repeat(z[::9].numel() // tricky.numel() + 1)[
        :z[::9].numel()]
    cases['empty_groups_tricky_z'] = _kernel2_case(gen, keys, 1024, 4, 3, 2,
                                                   z=z)
    cases['all_sentinel'] = _kernel2_case(
        gen, torch.full((5000,), 64, dtype=torch.int32), 64, 4, 3, 2)
    keys = _sorted_keys(gen, 6000, 1024, 0, 1024, 0.1)
    cases['one_weight_no_values'] = _kernel2_case(gen, keys, 1024, 1, 0, 1)
    for ms in (0, 1):
        cases[f'med_nsplit_{ms}'] = _kernel2_case(gen, keys, 1024, 4, 3, ms)
    # Group sizes around the register/histogram thresholds (kernel 1's).
    keys, G = _edge_keys()
    for ms in (2, 1):
        cases[f'register_edges_med_nsplit_{ms}'] = _kernel2_case(
            gen, keys, G, 4, 3, ms)
    cases['no_rows'] = _kernel2_case(gen, torch.zeros((0,), dtype=torch.int32),
                                     64, 4, 3, 2)
    cases['odd_groups_nsplit_1'] = _kernel2_case(
        gen, _sorted_keys(gen, 3000, 77, 0, 77, 0.1), 77, 4, 3, 1)
    # Values in (-1, 256) that are not integers: truncated toward zero.
    n = keys.numel()
    cases['truncated_values'] = dict(
        _kernel2_case(gen, keys, G, 4, 3, 2),
        value_rows=[torch.rand(n, generator=gen) * 256.99 - 0.99
                    for _ in range(3)])
    # Values outside [0, 256): left out of the medians (IN_RANGE_ONLY).
    cases['values_out_of_range'] = dict(
        _kernel2_case(gen, keys, G, 4, 3, 2),
        value_rows=[torch.rand(n, generator=gen) * 340.0 - 40.0
                    for _ in range(3)])
    return {name: {k: ([t.to(dev) for t in v] if isinstance(v, list)
                       else v.to(dev) if torch.is_tensor(v) else v)
                   for k, v in case.items()}
            for name, case in cases.items()}


def _max_err2(got, ref, n_exact):
    """Max abs difference over kernel 2's outputs after its contract:
    counts and flags (the first ``n_exact`` weight rows), z-min and
    medians exact, float sums within rtol 1e-5."""
    check(len(got) == len(ref), (len(got), len(ref)))
    sums, rsums = got[0], ref[0]
    check(torch.equal(sums[:, :n_exact], rsums[:, :n_exact]),
          'counts/flags differ')
    check(torch.allclose(sums, rsums, rtol=INTENSITY_RTOL, atol=1e-6),
          'float sums differ')
    check(torch.equal(got[1], ref[1]), 'z-min differs')
    fin = torch.isfinite(ref[1])
    errs = [float((sums - rsums).abs().max()) if sums.numel() else 0.0,
            float((got[1][fin] - ref[1][fin]).abs().max()) if fin.any()
            else 0.0]
    if len(got) == 3:
        check(torch.equal(got[2], ref[2]), 'medians differ')
        errs.append(float((got[2] - ref[2]).abs().max()))
    return max(errs)


# Kernel 2's cases whose value rows leave [0, 256): the plain version's
# medians are not defined there, so their reference is the plain version
# on each channel's in-range rows.
IN_RANGE_ONLY = ('values_out_of_range',)


def _in_range_medians(ss, case):
    """(n_values, 2, G) medians of the plain version over each channel's
    rows whose truncated value lies in [0, 256)."""
    keys, G = case['sorted_keys'], case['num_groups']
    meds = []
    for v in case['value_rows']:
        t = v.to(torch.int64)
        ok = (t >= 0) & (t < 256)
        meds.append(ss.segmented_stats_reference(
            torch.where(ok, keys, G), [torch.ones_like(v)], case['z_sorted'],
            G, [torch.where(ok, v, 0.0)], case['med_nsplit'])[2][0])
    return torch.stack(meds)


def _compare2(ss, case, in_range_only=False):
    got = ss.segmented_stats(**case)
    ref = ss.segmented_stats_reference(**case)
    if in_range_only:
        ref = (*ref[:2], _in_range_medians(ss, case))
    torch.cuda.synchronize()
    return _max_err2(got, ref, min(3, len(case['weight_rows'])))


def _check_rows_layout_raises(ss, case):
    """The wrapper refuses rows it cannot read in place: a strided weight
    or z row, a value row that is not float32. Nothing is launched."""
    w0 = case['weight_rows'][0]
    wide = torch.stack([w0, w0], dim=1)
    before = ss.segmented_stats.launches
    for bad in (dict(weight_rows=[wide[:, 0], *case['weight_rows'][1:]]),
                dict(z_sorted=wide[:, 1]),
                dict(value_rows=[v.to(torch.float64)
                                 for v in case['value_rows']])):
        try:
            ss.segmented_stats(**{**case, **bad})
        except ValueError:
            continue
        raise RuntimeError(f'chip_smoke check failed: {sorted(bad)} was '
                           'accepted')
    check(ss.segmented_stats.launches == before, 'a refused call launched')


def _time_turns(kernel, plain):
    """Median ms of a kernel and its plain version, timed in turns on this
    card: plain, kernel, kernel, plain."""
    p, k = [_median_ms(plain)], [_median_ms(kernel), _median_ms(kernel)]
    p.append(_median_ms(plain))
    return dict(ms=statistics.median(k), plain_ms=statistics.median(p),
                ms_runs=k, plain_ms_runs=p)


def phase_kernel2(dev):
    """Kernel 2 (segmented_stats on unpacked rows) against its plain
    version at the bench raster shape and on adversarial inputs."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    cases = _kernel2_cases(dev)
    errs = {name: _compare2(ss, case, name in IN_RANGE_ONLY)
            for name, case in cases.items()}
    _check_rows_layout_raises(ss, cases['register_edges_med_nsplit_2'])
    bench = cases['bench']
    res = dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
               **_time_turns(lambda: ss.segmented_stats(**bench),
                             lambda: ss.segmented_stats_reference(**bench)),
               **_shape(bench['sorted_keys'], bench['num_groups']),
               timing=_time_rows(ss, bench))
    emit('kernel2_vs_plain', t0, **res)
    return res


def phase_kernel_on_main_path(raster_in):
    """The kernel against the plain version on one raster's sorted rows as
    the main path gave them to the kernel (compact_cap rows)."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    c2, w1, w2, G = raster_in
    check(c2.numel() == ACCUM['compact_cap'], c2.numel())
    case2 = _rows_case(c2, w1, w2, G)
    res = dict(max_abs_err=_compare(ss, c2, w1, w2, G),
               **_time_pair(ss, c2, w1, w2, G), **_shape(c2, G),
               timing=_time_words(ss, c2, w1, w2, G),
               kernel2=dict(max_abs_err=_compare2(ss, case2),
                            **_time_turns(
                                lambda: ss.segmented_stats(**case2),
                                lambda: ss.segmented_stats_reference(
                                    **case2)),
                            timing=_time_rows(ss, case2)))
    emit('kernel_on_main_path', t0, **res)
    return res


def _make_accum(dev, semseg, stream_cfg, accum_cfg, icp_cfg,
                horizon, bev, use_gt_sem, seed=0, img_transfer='rgb8'):
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
        transfer_dtype='quantized', img_transfer=img_transfer, device=dev)


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


def phase_main_path(dev, img_transfer='rgb8', name='main_path'):
    """9 bench-configuration steps, the camera image on ``img_transfer``'s
    wire (the points at 7 B/point). Also returns the sorted rows the
    kernel got in the last step's first raster, each step's samples'
    maps, and the frames and the accumulator."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    t0 = time.perf_counter()
    raster_in = []

    def capture(c2, w1, w2, num_groups, med_nsplit, hist_medians=True):
        # Keeps the first call's inputs, then launches as the path does.
        check(med_nsplit == 2 and hist_medians, (med_nsplit, hist_medians))
        if not raster_in:
            raster_in.extend((c2, w1, w2, num_groups))
        return ss.segmented_stats_words(c2, w1, w2, num_groups,
                                        med_nsplit=med_nsplit)

    stream = SyntheticKitti360Stream(n_frames=N_STEPS + 1, **STREAM)
    frames = [stream.frame(i) for i in range(N_STEPS + 1)]
    semseg = SemSegTorch(dev, seed=0)
    accum = _make_accum(dev, semseg, STREAM, ACCUM, ICP, HORIZON,
                        BEV, use_gt_sem=False, img_transfer=img_transfer)
    torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    accum.integrate([frames[0]])
    torch.cuda.synchronize()
    step_s, occ, kept = [], [], []
    for i, f in enumerate(frames[1:]):
        before = ss.segmented_stats_words.launches
        if i == N_STEPS - 1:   # the last step, with the most live rows
            sort_raster.segmented_stats = types.SimpleNamespace(
                **{**vars(ss), 'segmented_stats_words': capture})
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
        kept.append([{k: v for k, v in b.items() if not k.startswith('trajs')}
                     for b in bevs])
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
    if name is not None:
        emit(name, t0, **res)
    return res, raster_in, kept, frames, accum


def _part_bytes(parts):
    """{name: bytes} of one uploaded observation's device tensors."""
    return {k: v.numel() * v.element_size() for k, v in parts.items()}


def _upload_ms(accum, frames):
    """Median host ms of upload_obs (the wire encode, the pinned staging
    copy and the host -> device copy) through a synchronize, per frame."""
    times = []
    for f in frames:
        ts = time.perf_counter()
        accum.upload_obs(f)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
    return statistics.median(times)


def _fidelity(got, ref, prefixes=('rgb', 'intensity')):
    """Max and mean abs difference of the maps whose key starts with one
    of ``prefixes``, over two step runs' samples."""
    out = {}
    for p in prefixes:
        d = [np.abs(a[k].astype(np.float32) - b[k].astype(np.float32))
             for step_a, step_b in zip(got, ref)
             for a, b in zip(step_a, step_b) for k in a if k.startswith(p)]
        out[p] = dict(max_abs=float(max(x.max() for x in d)),
                      mean_abs=float(np.mean([x.mean() for x in d])))
    return out


# --- the sparse fetch (the JAX bench's download path) --------------------
#
# The step() cell at the JAX bench's fetch configuration (bench.py:400-450,
# 486, 560-580): main_path's accumulator with the sparse fetch, the bench's
# per-split caps, its compact-rung ladder, fetch groups of 4, 'exact'
# sizing and rank-compacted stats groups; prewarm_rungs after one warm-up
# step, then N_STEPS step(async_fetch=True) calls, each drained one step
# behind on a worker thread. The first fetch group of SPARSE_HELD_STEPS
# (timed steps; the first sweeps a rung below compact_cap) is held to the
# dense float16 raster on the same inputs: the u8 code of every channel
# equal, elevation bit-exact. OVERFLOW_CAP forces the dense-words fallback
# on one of them. One more step's dispatch runs under torch's sync debug
# mode and must make no synchronizing CUDA call. The mesh phase's sparse
# step() (MESH_SPARSE_STEPS steps) is held to the first steps' buffers.
SPARSE_BEV = dict(BEV, fetch_dtype='sparse',
                  sparse_cap=(20480, 10240, 10240), fetch_group=4)
SPARSE_ACCUM = dict(ACCUM, compact_rungs=(393216, 655360, 860160))
SPARSE_HELD_STEPS = (1, N_STEPS)
OVERFLOW_CAP = 128
MESH_SPARSE_STEPS = 3
# The oracle cell on the sparse fetch (the JAX bench's oracle,
# bench.py:144-149, 189: the default cap), its samples drained on a worker
# thread; ORACLE_HELD timed samples held to the dense raster.
ORACLE_SPARSE_BEV = dict(ORACLE_BEV, fetch_dtype='sparse')
ORACLE_HELD = (0, ORACLE_FRAMES - ORACLE_WARMUP - 1)


def _codes(stack):
    """The u8 code of each [0,1] channel (round(x*255) of the clipped
    value, the fetch's quantization) and the elevation channels' float16
    bits of an (S*7, P, P) stack."""
    x = np.asarray(stack, np.float16).reshape(-1, 7, *stack.shape[-2:])
    u8 = np.round(np.clip(x[:, :6].astype(np.float32), 0, 1) * 255)
    return u8.astype(np.uint8), x[:, 6].view(np.uint16)


def _codes_equal(got, want, what):
    """A decoded sparse stack against a float16 stack: every u8 code
    equal, elevation bit-exact (the decode's empty-cell constants are the
    codes' own values, so codes, not float16 values, are compared)."""
    (gu, ge), (wu, we) = _codes(got), _codes(want)
    bad = int((gu != wu).sum()) + int((ge != we).sum())
    check(bad == 0, f'{what}: {bad} codes differ')


def _bev_stack(b, gen_future=True):
    """A BEV dict's maps back in the raster's (S*7, P, P) order."""
    out = []
    for s in ('present', 'future', 'full')[:3 if gen_future else 1]:
        out += [b[f'road_{s}'], b[f'intensity_{s}'], *b[f'rgb_{s}'],
                b[f'dynamic_{s}'], b[f'elevation_{s}']]
    return np.stack(out)


def _used_rows(sp, P):
    """Each row of a (G, bytes) sparse group of P x P rasters on the host,
    cut to its used bytes (what the fetch ships and the decode reads)."""
    from pc_accumulation_lib_tpu_torch.bev import core
    rows = sp.cpu().numpy()
    return [r[:core.sparse_used_bytes(r, P, True)].copy() for r in rows]


def _warp_of(aug9):
    a = [float(v) for v in aug9.cpu()]
    return dict(a1=a[4], a2=a[5], b1=a[6], b2=a[7], active=True)


def phase_sparse_step_path(dev, main_res):
    """The step() cell at the JAX bench's fetch configuration (the
    constants above). Returns the result and the used bytes of each
    sample of the first MESH_SPARSE_STEPS steps (warm-up included)."""
    from pc_accumulation_lib_tpu_torch.bev import core, native_decode
    from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    P = SPARSE_BEV['pixel_size']
    stream = SyntheticKitti360Stream(n_frames=N_STEPS + 2, **STREAM)
    frames = [stream.frame(i) for i in range(N_STEPS + 2)]
    accum = _make_accum(dev, SemSegTorch(dev, seed=0), STREAM, SPARSE_ACCUM,
                        ICP, HORIZON, SPARSE_BEV, use_gt_sem=False)
    gen = accum.sem_bev_generator
    check(gen.fetch_sizing == 'exact' and gen._compact_groups,
          (gen.fetch_sizing, gen._compact_groups))
    # The fetch groups the grouped raster returns (step 0 is the warm-up;
    # kept for the mesh phase's steps and the last), and the inputs of
    # the held steps' first group.
    cur, groups, held = [0], {}, {}
    make_raster = gen.prepped_raster

    def prepped_raster(grouped=False):
        fn = make_raster(grouped)
        if not grouped:
            return fn

        def run(*args):
            out = fn(*args)
            if cur[0] < MESH_SPARSE_STEPS or cur[0] == N_STEPS:
                groups.setdefault(cur[0], []).append(out)
            if cur[0] in SPARSE_HELD_STEPS and cur[0] not in held:
                held[cur[0]] = args
            return out
        return run

    gen.prepped_raster = prepped_raster
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        accum.integrate([frames[0]])
        warm = accum.step([frames[1]], bev_num=BEV_NUM, gen_future=True)
    t_pre = time.perf_counter()
    cur[0] = -1                  # prewarm's rasters are nobody's samples
    accum.prewarm_rungs(gen_future=True)
    prewarm_s = time.perf_counter() - t_pre
    stats_in = []
    split_stats = sort_raster.split_stats_from_words_flat

    def capture_stats(*args, **kwargs):
        if not stats_in:
            stats_in[:] = [args, kwargs]
        return split_stats(*args, **kwargs)

    def drain(handle):
        bevs = handle()
        return bevs, dict(gen.last_harvest)

    shorts0 = gen.sparse_short_fetches
    overflows0 = gen.sparse_overflows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    native_decode.decode_sparse_warp.decoded = 0
    steps, iter_s = [], []
    ts = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=1) as ex, \
                contextlib.redirect_stdout(log):
            fut = None
            for i, f in enumerate(frames[2:]):
                ti = time.perf_counter()
                cur[0] = i + 1
                if cur[0] == N_STEPS:   # the last step, the largest window
                    sort_raster.split_stats_from_words_flat = capture_stats
                try:
                    handle = accum.step([f], bev_num=BEV_NUM,
                                        gen_future=True, async_fetch=True)
                finally:
                    sort_raster.split_stats_from_words_flat = split_stats
                nxt = ex.submit(drain, handle)
                if fut is not None:
                    steps.append(fut.result())
                fut = nxt
                iter_s.append(time.perf_counter() - ti)
            steps.append(fut.result())
        torch.cuda.synchronize()
    finally:
        gen.prepped_raster = make_raster
    loop_s = time.perf_counter() - ts
    launches = ss.segmented_stats_words.launches
    decoded = native_decode.decode_sparse_warp.decoded
    peak = torch.cuda.max_memory_allocated()
    n = BEV_NUM * N_STEPS
    check(launches == n, f'{launches} kernel-1 launches in {N_STEPS} steps')
    check(decoded == n, f'the native decoder decoded {decoded} of {n}')
    check(gen.sparse_overflows == overflows0, 'a sample overflowed its cap')
    occ = [_check_bevs(bevs, P) for bevs, _ in steps]
    check(min(occ) > 0, occ)
    # The held samples against the dense float16 raster on the same
    # inputs (no compaction, no sparse pack).
    dense_fn = core.make_prepped_raster_fn(
        SPARSE_BEV['view_size'], P, SPARSE_BEV['int_scaler'],
        SPARSE_BEV['int_sep_scaler'], SPARSE_BEV['int_mid_threshold'])
    held_rungs = {}
    for i, (ref, valid, fids, pk, pk2, pose_vec, aug9s, gf) in held.items():
        held_rungs[i] = int(ref.shape[0])
        for r in range(aug9s.shape[0]):
            dense = dense_fn(ref, valid, fids, pk, pk2, (pose_vec, aug9s[r]),
                             gf).cpu().numpy()
            _codes_equal(_bev_stack(steps[i - 1][0][r]), dense,
                         f'step {i} sample {r}')
    check(len(held) == len(SPARSE_HELD_STEPS)
          and min(held_rungs.values()) < ACCUM['compact_cap'], held_rungs)
    # One raster past a 128-cell cap: the dense-words fallback, the same
    # codes as the dense raster and the step's own sample.
    ref, valid, fids, pk, pk2, pose_vec, aug9s, gf = held[N_STEPS]
    over = core.make_prepped_raster_fn(
        SPARSE_BEV['view_size'], P, SPARSE_BEV['int_scaler'],
        SPARSE_BEV['int_sep_scaler'], SPARSE_BEV['int_mid_threshold'],
        pack='sparse', sparse_cap=OVERFLOW_CAP, compact_groups=True)(
        ref, valid, fids, pk, pk2, (pose_vec, aug9s[0]), gf)
    gen128 = SemBEVGenerator(
        gen.sem_idxs, gen.view_size, P, int_scaler=gen.int_scaler,
        int_sep_scaler=gen.int_sep_scaler,
        int_mid_threshold=gen.int_mid_threshold, fetch_dtype='sparse',
        sparse_cap=OVERFLOW_CAP, device=dev)
    fell_back = gen128._fetch_stack(over, True, _warp_of(aug9s[0]))
    check(gen128.sparse_overflows == 1, gen128.sparse_overflows)
    _codes_equal(fell_back, _bev_stack(steps[N_STEPS - 1][0][0]),
                 'overflow fallback')
    # Host decode + warp of one sample alone (the native decoder).
    raw = _used_rows(groups[N_STEPS][0][0], P)[0]
    w0 = _warp_of(aug9s[0])
    decode_ms = _median_ms_host(lambda: native_decode.decode_sparse_warp(
        raw, True, P, gen.sparse_cap, gen._sparse_empty, w0))
    harvests = [h for _, h in steps]
    wire = sum(h['wire_bytes'] for h in harvests)
    fallback_bytes = core.sparse_buffer_bytes(P, True, gen.sparse_cap,
                                              True)[1]
    steady = statistics.median(iter_s[1:])
    res = dict(
        steps=N_STEPS, bev_num=BEV_NUM, launches=launches,
        native_decoded=decoded, iteration_s=iter_s,
        median_iteration_s=steady, main_path_median_step_s=main_res[
            'median_step_s'],
        samples_per_s=n / loop_s, main_path_samples_per_s=main_res[
            'samples_per_s'], prewarm_s=prewarm_s,
        rungs_used={str(k): v for k, v in sorted(accum.rungs_used.items())},
        held_rungs=held_rungs, held_samples=sum(
            a[6].shape[0] for a in held.values()),
        max_live_rows=accum.max_live_rows,
        max_occupied_split=gen.max_occupied_split,
        mean_occupied_split=[s / max(gen.n_occupied_obs, 1)
                             for s in gen.sum_occupied_split],
        sparse_cap=list(gen.sparse_cap),
        sparse_short_fetches=gen.sparse_short_fetches - shorts0,
        sparse_overflows=gen.sparse_overflows - overflows0,
        wire_bytes_per_sample=wire / n,
        fallback_bytes_per_sample=fallback_bytes,
        float16_bytes_per_sample=21 * P * P * 2,
        resolved_by=[h['resolved_by'] for h in harvests],
        harvest_work_ms_per_sample=1e3 * sum(h['work_s'] for h in harvests)
        / n, native_decode_warp_ms_per_sample=decode_ms,
        max_memory_allocated_bytes=peak, occupied_cell_fraction=occ,
        overflow_fallback=dict(cap=OVERFLOW_CAP,
                               sparse_overflows=gen128.sparse_overflows))
    # One more step's dispatch under the sync debug mode: a synchronizing
    # call there would stall the host until the device queue drains.
    cur[0] = -1
    with warnings.catch_warnings(record=True) as syncs, \
            contextlib.redirect_stdout(log):
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            handle = accum.step([frames[-1]], bev_num=BEV_NUM,
                                gen_future=True, async_fetch=True)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        handle()
    # (Setting the mode also warns once that it is a prototype.)
    syncs = [w for w in syncs
             if 'synchronizing CUDA operation' in str(w.message)]
    sites = sorted({f'{w.filename}:{w.lineno}' for w in syncs})
    check(not syncs, f'synchronizing calls in a sparse dispatch: {sites}')
    res['dispatch_sync_calls'] = len(syncs)
    gen.close()
    gen128.close()
    first = {i: [r for out in groups[i] for r in _used_rows(out[0], P)]
             for i in range(MESH_SPARSE_STEPS)}
    check(len(warm) == BEV_NUM, len(warm))
    emit('sparse_step_path', t0, **res)
    return res, stats_in, first


def phase_kernel_on_sparse_path(stats_in):
    """Both kernels on the rank-compacted keys of one raster of
    sparse_step_path's last step (its stats-stage inputs as the path gave
    them): each against its plain version and timed; kernel 1 timed on
    the same rows with the dense cell keys too; the stats stage's
    unpacked route (kernel 2) replayed on the inputs and held to the
    words route (maps equal, intensity rtol 1e-5)."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    t0 = time.perf_counter()
    args, kwargs = stats_in
    c2, packed, packed2, n_cells, gen_future = args[:5]
    check(kwargs.get('compact_groups') and gen_future, kwargs)
    sent = n_cells * 2
    s_c2, order = torch.sort(c2)
    g = sort_raster._rank_keys(s_c2, 2, sent)
    w1, w2 = packed[order], packed2[order]
    case2 = _rows_case(g, w1, w2, sent)
    kw = dict(kwargs, compact_groups=True)
    words = sort_raster.split_stats_from_words_flat(
        c2, packed, packed2, n_cells, True, **dict(kw, words_kernel=True))
    torch.cuda.synchronize()
    ss.segmented_stats.launches = 0
    unpacked = sort_raster.split_stats_from_words_flat(
        c2, packed, packed2, n_cells, True, **dict(kw, words_kernel=False))
    torch.cuda.synchronize()
    k2_launches = ss.segmented_stats.launches
    check(k2_launches == 1, k2_launches)
    route_err = 0.0
    for k, v in words.items():
        u = unpacked[k]
        if k.startswith('intensity'):
            check(torch.allclose(u, v, rtol=INTENSITY_RTOL, atol=1e-6), k)
        else:
            check(torch.equal(u, v), k)
        route_err = max(route_err, _max_abs(u.float(), v.float()))
    res = dict(max_abs_err=_compare(ss, g, w1, w2, sent),
               **_time_pair(ss, g, w1, w2, sent), **_shape(g, sent),
               timing=_time_words(ss, g, w1, w2, sent),
               dense_keys=dict(**_shape(s_c2, sent),
                               timing=_time_words(ss, s_c2, w1, w2, sent)),
               kernel2=dict(max_abs_err=_compare2(ss, case2),
                            **_time_turns(
                                lambda: ss.segmented_stats(**case2),
                                lambda: ss.segmented_stats_reference(
                                    **case2)),
                            timing=_time_rows(ss, case2)),
               compact_unpacked_kernel2_launches=k2_launches,
               words_vs_unpacked_max_abs=route_err)
    emit('kernels_on_sparse_path', t0, **res)
    return res


def phase_wire_path(dev, main_bevs, frames, rgb8_accum):
    """main_path's drive with the camera image on the JAX bench's wire
    ('yuv420h', the points at 7 B/point as before): encoded on the host,
    decoded on the card at the head of each frame step. Holds the card's
    decode against the CPU decode of the same parts on one frame (the CPU
    tests hold that decode exactly to the JAX package's); reports the
    bytes of each wire part per frame on both wires, the host encode and
    the upload ms, and how far the rgb and intensity maps move from
    main_path's rgb8 samples at the same seed. The host encode is timed
    native and as the numpy spec, held equal on that frame."""
    from pc_accumulation_lib_tpu_torch.ops import imgcodec
    t0 = time.perf_counter()
    res, _, bevs, _, accum = phase_main_path(dev, img_transfer='yuv420h',
                                             name=None)
    img = np.asarray(frames[1][0])[..., :3].astype(np.uint8)
    enc_ms, enc_np_ms = _encode_ms(img, 'yuv420h')
    parts = {}
    for name, acc in (('rgb8', rgb8_accum), ('yuv420h', accum)):
        dob = acc.upload_obs(frames[1])
        aux = dob.aux if isinstance(dob.aux, tuple) else (dob.aux,)
        parts[name] = _part_bytes(dict(
            points=dob.pc_pad, valid=dob.valid,
            **{f'image{i}': a for i, a in enumerate(aux)}))
    h, w = STREAM['img_hw']
    for wire, p in parts.items():
        check(sum(v for k, v in p.items() if k.startswith('image'))
              == h * w * WIRE_BYTES_PER_PIXEL[wire], (wire, p))
    gpu = imgcodec.decode_wire(dob.aux)
    cpu = imgcodec.decode_wire(tuple(a.cpu() for a in dob.aux))
    decode_err = float((gpu.cpu() - cpu).abs().max())
    check(decode_err <= 1e-4, decode_err)
    res.update(wire=('yuv420h', 'quantized'), bytes_per_frame=parts,
               encode_ms_per_frame=enc_ms,
               encode_np_ms_per_frame=enc_np_ms,
               upload_ms_per_frame={
                   'rgb8': _upload_ms(rgb8_accum, frames[1:]),
                   'yuv420h': _upload_ms(accum, frames[1:])},
               decode_vs_cpu_max_abs=decode_err,
               vs_rgb8_main_path=_fidelity(bevs, main_bevs))
    emit('wire_path', t0, **res)
    return res


def phase_reference_api_path(dev, frames):
    """The reference API on main_path's configuration: its first frames
    through obs2sem_vec_space on one accumulator and through integrate on
    another (poses, T_new_prev, the window and the device buffer equal),
    then the semseg wrapper's pred_batch and pred at 376x1408 against
    predict on the card (class maps equal)."""
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    t0 = time.perf_counter()
    semseg = SemSegTorch(dev, seed=0)
    by_obs, by_integrate = (
        _make_accum(dev, semseg, STREAM, ACCUM, ICP, HORIZON, BEV,
                    use_gt_sem=False) for _ in range(2))
    ss.segmented_stats_words.launches = 0
    obs_s, integrate_s = [], []
    with contextlib.redirect_stdout(io.StringIO()):
        for f in frames:
            ts = time.perf_counter()
            out = by_obs.obs2sem_vec_space(*f)
            obs_s.append(time.perf_counter() - ts)
            ts = time.perf_counter()
            by_integrate.integrate([f])
            integrate_s.append(time.perf_counter() - ts)
            check(len(out) == 4 and out[0] is None and out[2] is None,
                  'obs2sem_vec_space tuple')
            check(out[1] == by_obs.poses[-1] == by_integrate.poses[-1],
                  (out[1], by_integrate.poses[-1]))
            check(np.array_equal(out[3], by_integrate._T_new_prev_last),
                  'T_new_prev')
    launches = ss.segmented_stats_words.launches
    check(by_obs.poses == by_integrate.poses, 'poses')
    check(by_obs.window_start == by_integrate.window_start
          and by_obs.frame_count == by_integrate.frame_count == len(frames),
          (by_obs.window_start, by_integrate.window_start))
    for k in ('points', 'valid', 'frame_ids'):
        check(torch.equal(getattr(by_obs.state, k),
                          getattr(by_integrate.state, k)), k)
    # Each against predict on the same batch: cuDNN may pick another
    # convolution algorithm for another batch size, and the bf16 logits
    # then round differently.
    imgs = np.stack([np.asarray(f[0])[..., :3] for f in frames[:2]])
    want = semseg.predict(torch.from_numpy(imgs).to(dev)).cpu().numpy()
    want1 = semseg.predict(torch.from_numpy(imgs[1:]).to(dev)).cpu().numpy()
    batch, one = semseg.pred_batch(imgs), semseg.pred(imgs[1])
    check(batch.dtype == one.dtype == np.int32, (batch.dtype, one.dtype))
    h, w = STREAM['img_hw']
    check(batch.shape == (2, h, w) and one.shape == (1, 1, h, w),
          (batch.shape, one.shape))
    check(np.array_equal(batch, want), 'pred_batch != predict')
    check(np.array_equal(one[0], want1) and np.array_equal(semseg(imgs[1]),
                                                           want1[0]),
          'pred != predict')
    emit('reference_api_path', t0, frames=len(frames),
         window_start=by_obs.window_start, window_frames=len(by_obs.poses),
         poses_equal=True, stats_kernel_launches=launches,
         obs2sem_vec_space_s=obs_s, integrate_s=integrate_s,
         pred_batch_shape=list(batch.shape), pred_shape=list(one.shape),
         class_maps_equal=True,
         batch2_vs_batch1_agreement=float(np.mean(want[1] == want1[0])))


def _runner_accum(dev, semseg, stream_cfg, bev, use_gt_sem, **kw):
    """The accumulator as the runner's run() builds it, on the synthetic
    stream's calibration; ``kw`` overrides run()'s defaults."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        make_calib)
    _, H_velo_cam, P_cam_frame = make_calib(stream_cfg['img_hw'])
    calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                 p_velo_frame=P_cam_frame @ H_velo_cam)
    return Kitti360SemanticPointCloudAccumulator(
        kw.pop('accum_horizon_dist', 200.0), calib, 1e3, semseg,
        cfg.DEFAULT_SEMSEG_FILTERS, cfg.DEFAULT_SEM_IDXS, use_gt_sem, bev,
        device=dev, **kw)


def _read_samples(out_dir):
    """{relative path: BEV dict} of the pkl.gz files a run wrote."""
    from pc_accumulation_lib_tpu_torch.utils.io import (
        read_compressed_pickle)
    out = {}
    for d, _, names in os.walk(out_dir):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, out_dir)] = read_compressed_pickle(path)
    return out


def _check_sample(b, P):
    """15 float16 (P,P) / (3,P,P) maps, finite, and the trajectories."""
    maps = {k: v for k, v in b.items() if not k.startswith('trajs')}
    check(len(maps) == 15, sorted(maps))
    for k, v in maps.items():
        check(v.dtype == np.float16 and v.shape[-2:] == (P, P),
              (k, v.dtype, v.shape))
        check(np.isfinite(v).all(), k)
    for s in ('present', 'future', 'full'):
        trajs = b[f'trajs_{s}']
        check(len(trajs) >= 1 and all(t.shape[-1] == 3 for t in trajs),
              (s, [t.shape for t in trajs]))


def phase_runner_path(dev, words_kernel=True, reference=None,
                      bev_type='sem'):
    """The dataset runner's sampling_loop at run()'s defaults on 120 frames
    of the bench stream: full-depth ResNet-50, every sample's classic
    raster over the whole 256 x 131,072-row buffer. The stats stage takes
    the words route (kernel 1), as run() does; with ``words_kernel`` False
    every raster of the loop takes the unpacked route (kernel 2) instead.
    ``bev_type`` 'rgb' builds the RGB generator (runner --bev_type rgb).
    ``reference``: samples of an earlier run, which these must match
    (same files and keys, maps under the GPU-vs-CPU rule; for 'rgb' the
    rgb maps exactly). Returns the result, the samples read back, the
    (c2, packed, packed2, ...) one raster gave the stats stage, one
    raster's inputs and the last window's points (_legacy_window)."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    from pc_accumulation_lib_tpu_torch.utils.async_writer import (
        AsyncPickleWriter)
    from pc_accumulation_lib_tpu_torch.utils.profiling import PhaseTimer
    t0 = time.perf_counter()
    stream = SyntheticKitti360Stream(n_frames=RUNNER_FRAMES, **STREAM)
    accum = _runner_accum(dev, SemSegTorch(dev, seed=0), STREAM,
                          dict(kr.DEFAULT_BEV_PARAMS, type=bev_type),
                          use_gt_sem=False)
    gen = accum.sem_bev_generator
    # frames: (start of its integrate, frames it evicted) per frame;
    # sampled: the frame index of each stats-stage call (one per sample).
    stats_in, raster_in, frames, sampled = [], [], [], []
    split_stats = sort_raster.split_stats_from_words_flat
    classic_raster = gen._raster
    integrate = accum.integrate

    def timed_integrate(observations):
        t = time.perf_counter()
        removed = integrate(observations)
        frames.append((t, removed))
        return removed

    def capture_stats(*args, **kwargs):
        # Keeps the latest call's inputs, then runs on the chosen route.
        sampled.append(len(frames) - 1)
        stats_in[:] = [args, kwargs]
        return split_stats(*args, **{**kwargs, 'words_kernel': words_kernel})

    def capture_raster(*args):
        raster_in[:] = args
        return classic_raster(*args)

    timer = PhaseTimer()
    P = kr.DEFAULT_BEV_PARAMS['pixel_size']
    with tempfile.TemporaryDirectory() as out_dir:
        output = cfg.OutputConfig(out_dir, viz_to_disk=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sort_raster.split_stats_from_words_flat = capture_stats
        gen._raster = capture_raster
        accum.integrate = timed_integrate
        ss.segmented_stats_words.launches = 0
        ss.segmented_stats.launches = 0
        log = io.StringIO()
        ts = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                stats = kr.sampling_loop(accum, stream, cfg.SamplingConfig(),
                                         output, timer=timer)
            torch.cuda.synchronize()
        finally:
            sort_raster.split_stats_from_words_flat = split_stats
            gen._raster = classic_raster
            del accum.integrate
        t_end = time.perf_counter()
        launches = ss.segmented_stats_words.launches
        launches2 = ss.segmented_stats.launches
        peak = torch.cuda.max_memory_allocated()
        samples = _read_samples(out_dir)
        png = _png_roundtrip(samples, out_dir) if bev_type == 'rgb' else None
    n = stats['bevs']
    check(stats['frames'] == RUNNER_FRAMES, stats)
    check(n >= RUNNER_MIN_SAMPLES,
          (stats, log.getvalue().splitlines()[-10:]))
    check(len(samples) == n, (len(samples), n))
    # One stats-kernel launch per sample, on the route this run takes.
    expect = (n, 0) if words_kernel else (0, n)
    check((launches, launches2) == expect, (launches, launches2, n))
    for b in samples.values():
        (_check_rgb_sample if bev_type == 'rgb' else _check_sample)(b, P)
    phases = {k: dict(total_s=timer.totals[k], n=timer.counts[k])
              for k in timer.totals}
    # Steady state: from the first frame whose integrate evicts (the
    # window at its 200 m horizon, as for the rest of a long drive) to the
    # end of the loop. Also from the first sampled frame on, and the whole
    # loop with its warm-up.
    full = next(i for i, (_, removed) in enumerate(frames) if removed)
    steady_n = sum(f >= full for f in sampled)
    steady_s = t_end - frames[full][0]
    from_first_s = t_end - frames[sampled[0]][0]
    loop_s = t_end - ts
    res = dict(route='words' if words_kernel else 'unpacked',
               frames=stats['frames'], samples=n, launches=launches,
               kernel2_launches=launches2, first_sample_frame=sampled[0],
               first_evicting_frame=full, steady_samples=steady_n,
               steady_s=steady_s, samples_per_s_steady=steady_n / steady_s,
               samples_per_s_from_first_sample=n / from_first_s,
               loop_s=loop_s, samples_per_s_with_warmup=n / loop_s,
               samples_per_s_generate_bev=n / timer.totals['generate_bev'],
               phases=phases, rows_per_raster=accum.state.valid.numel(),
               window_frames=len(accum.poses),
               window_path_m=float(accum.get_incremental_path_dists()[-1]),
               max_memory_allocated_bytes=peak,
               async_writer_native=AsyncPickleWriter().native,
               files=sorted(samples)[:3])
    if bev_type == 'rgb':
        res.update(png_bytes=png, rgb_vs_runner_path_max_abs=_rgb_equal(
            samples, reference))
    elif reference is not None:
        mism, err = _map_mismatch(samples, reference)
        res.update(vs_words_route_max_cell_mismatch_fraction=mism,
                   vs_words_route_max_abs=err)
        check(mism < MAP_MISMATCH, mism)
    emit('rgb_runner_path' if bev_type == 'rgb' else
         'runner_path' if words_kernel else 'runner_path_unpacked', t0,
         **res)
    window = (_legacy_window(accum) if words_kernel and bev_type == 'sem'
              else None)
    return res, samples, stats_in, raster_in, window


def _check_rgb_sample(b, P):
    """An RGB sample: the present and future (3,P,P) float16 rgb maps,
    finite and in [0, 1], and the (N,3) pixel-space poses."""
    check(set(b) == {'rgb_present', 'rgb_future', 'poses_present',
                     'poses_future'}, sorted(b))
    for k in ('rgb_present', 'rgb_future'):
        v = b[k].astype(np.float32)
        check(b[k].dtype == np.float16 and v.shape == (3, P, P),
              (k, b[k].dtype, v.shape))
        check(np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1,
              (k, v.min(), v.max()))
    for k in ('poses_present', 'poses_future'):
        check(b[k].ndim == 2 and b[k].shape[1] == 3, (k, b[k].shape))


def _rgb_equal(samples, reference):
    """The RGB samples' rgb maps against the semantic run's samples of
    the same files: exactly equal; returns the max abs difference."""
    check(sorted(samples) == sorted(reference),
          (sorted(samples)[:3], sorted(reference)[:3]))
    err = 0.0
    for f, b in samples.items():
        for k in ('rgb_present', 'rgb_future'):
            check(np.array_equal(b[k], reference[f][k]), (f, k))
            err = max(err, float(np.abs(b[k].astype(np.float32)
                                        - reference[f][k].astype(
                                            np.float32)).max()))
    return err


def _png_roundtrip(samples, out_dir):
    """Each RGB sample's present and future rgb maps written beside its
    pkl.gz as one PNG (PIL; the generator's viz_bev draws with
    matplotlib, which this machine may lack) and read back equal to the
    maps x 255, rounded. Returns the PNG bytes written."""
    from PIL import Image
    total = 0
    for f, b in samples.items():
        img = np.concatenate([b['rgb_present'], b['rgb_future']], axis=2)
        img = np.rint(img.astype(np.float32).transpose(1, 2, 0) * 255)
        img = img.astype(np.uint8)
        path = os.path.join(out_dir, f.replace('.pkl.gz', '.png'))
        Image.fromarray(img).save(path)
        total += os.path.getsize(path)
        check(np.array_equal(np.asarray(Image.open(path)), img), path)
    return total


# The legacy pipeline on the runner's last window: every in-window point
# within LEGACY_RADIUS m of the middle frame's pose (the farthest an
# augmented 80 m view reaches: its corner at 1.05 zoom, 59.4 m, plus the
# 3 m translation), in that pose's frame, split there into past and
# future; gen_view at the runner's 80 m / 256 px and gen_aug_view at the
# step() bench's augmentation limits.
LEGACY_RADIUS = 64.0
LEGACY_AUG = dict(max_translation_radius=3.0, zoom_threshold=0.05,
                  view_size=80.0, pixel_size=256)
# The probmaps (from counts) and the rgb medians are exact on both
# devices. The mean maps divide float32 sums that the card adds in
# another order (atomics), and a last-bit difference can move the float16
# rounding by one step: each cell is held to one float16 step at its own
# magnitude.
LEGACY_SUMMED = ('elevmap', 'intensitymap')


def phase_legacy_path(dev, window):
    """legacy.gen_view and gen_aug_view on the runner's last window, on
    the card and on the CPU from the same numpy generator seed: the maps
    as LEGACY_SUMMED says, the poses equal. Reports the card's ms per
    call (the second of two calls) and the CPU's (one call)."""
    from pc_accumulation_lib_tpu_torch.bev import legacy
    t0 = time.perf_counter()
    past, future, poses_p, poses_f = window
    inputs = dict(LEGACY_AUG, pc_present=past, pc_future=future,
                  poses_present=poses_p, poses_future=poses_f)
    calls = {
        'gen_view': lambda rng, d: legacy.gen_view(
            past, future, poses_p, poses_f, 0.3, 1.0, -1.0, 1.0,
            LEGACY_AUG['view_size'], LEGACY_AUG['pixel_size'], rng=rng,
            device=d),
        'gen_aug_view': lambda rng, d: legacy.gen_aug_view(
            inputs, rng=rng, device=d)}
    res = dict(rows_past=len(past), rows_future=len(future),
               pixel_size=LEGACY_AUG['pixel_size'])
    for name, call in calls.items():
        out, ms = {}, {}
        for tag, d, calls_n in (('card', dev, 2),
                                ('cpu', torch.device('cpu'), 1)):
            for _ in range(calls_n):
                ts = time.perf_counter()
                out[tag] = call(np.random.default_rng(0), d)
                _sync(d)
                ms[tag] = (time.perf_counter() - ts) * 1e3
        err, differ = 0.0, 0
        for k in legacy._KEYS:
            a, b = (out[t][k].astype(np.float32) for t in ('card', 'cpu'))
            check(np.isfinite(a).all(), (name, k))
            d = np.abs(a - b)
            if k.startswith(LEGACY_SUMMED):
                step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
                    np.float16)).astype(np.float32)
                check((d <= step).all(), (name, k, float(d.max())))
            else:
                check(not d.any(), (name, k, float(d.max())))
            err, differ = max(err, float(d.max())), differ + int((d > 0).sum())
        for k in ('poses_past', 'poses_future'):
            check(np.array_equal(out['card'][k], out['cpu'][k]), (name, k))
        check((out['card']['gridmap_past_road'] != 0.5).mean() > 0.01, name)
        res[name] = dict(max_abs_vs_cpu=err, cells_differing=differ,
                         card_ms=ms['card'], cpu_ms=ms['cpu'])
    emit('legacy_path', t0, **res)
    return res


def _legacy_window(accum):
    """(past rows, future rows, past poses, future poses) of the
    accumulator's window, numpy, for the legacy pipeline."""
    pts = accum.state.points.cpu().numpy().reshape(-1, 10)
    valid = accum.state.valid.cpu().numpy().reshape(-1)
    fids = np.repeat(accum.state.frame_ids.cpu().numpy(),
                     accum.state.points.shape[1])
    mid = len(accum.poses) // 2
    T = np.linalg.inv(accum.T_world_velo[mid])
    keep = valid & (fids >= accum.window_start)
    rows, fids = pts[keep].astype(np.float64), fids[keep]
    rows[:, :3] = rows[:, :3] @ T[:3, :3].T + T[:3, 3]
    near = np.hypot(rows[:, 0], rows[:, 1]) < LEGACY_RADIUS
    rows, fids = rows[near], fids[near]
    past = fids < accum.window_start + mid
    poses = accum._poses_ref(T)
    return rows[past], rows[~past], poses[:mid], poses[mid:]


def _map_mismatch(a, b):
    """Largest fraction, over the maps of two sample sets with the same
    files and keys, of cells differing by more than MAP_ATOL, and the
    largest abs difference."""
    check(sorted(a) == sorted(b), (sorted(a), sorted(b)))
    mism, err = 0.0, 0.0
    for f, sa in a.items():
        sb = b[f]
        check(set(sa) == set(sb), f)
        for k in sa:
            if k.startswith('trajs') or k == 'gt_lanes':
                check(len(sa[k]) == len(sb[k]), (f, k))
                continue
            d = np.abs(sa[k].astype(np.float32) - sb[k].astype(np.float32))
            mism = max(mism, float(np.mean(d > MAP_ATOL)))
            err = max(err, float(d.max()))
    return mism, err


def phase_kernel2_on_runner_path(stats_in, rows,
                                 phase='kernel2_on_runner_path'):
    """The stats stage of one runner raster, on the rows it got: the words
    route (kernel 1) against the unpacked route (kernel 2), then each
    kernel against its plain version on the sorted rows it gets there.
    Also counts the keyed rows whose dyn flag (word1 bit 24) is set."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    t0 = time.perf_counter()
    args, kwargs = stats_in
    c2, n_cells, gen_future = args[0], args[3], args[4]
    check(c2.numel() == rows, (c2.numel(), rows))
    words = sort_raster.split_stats_from_words_flat(*args, **kwargs)
    kernel2_in = []

    def capture(**case):
        kernel2_in.append(case)
        return ss.segmented_stats(**case)

    def route(sorted_keys, weight_rows, z_sorted, num_groups, value_rows,
              med_nsplit):
        return capture(sorted_keys=sorted_keys, weight_rows=weight_rows,
                       z_sorted=z_sorted, num_groups=num_groups,
                       value_rows=value_rows, med_nsplit=med_nsplit)

    sort_raster.segmented_stats = types.SimpleNamespace(
        **{**vars(ss), 'segmented_stats': route})
    ss.segmented_stats.launches = 0
    try:
        unpacked = sort_raster.split_stats_from_words_flat(
            *args, **{**kwargs, 'words_kernel': False})
        torch.cuda.synchronize()
    finally:
        sort_raster.segmented_stats = ss
    launches2 = ss.segmented_stats.launches
    check(launches2 == 1, launches2)   # this replay's own launch
    check(set(words) == set(unpacked), (sorted(words), sorted(unpacked)))
    route_err = 0.0
    for k, v in words.items():
        if k.startswith('intensity'):
            check(torch.allclose(unpacked[k], v, rtol=INTENSITY_RTOL,
                                 atol=1e-7), k)
        else:
            check(torch.equal(unpacked[k], v), k)
        route_err = max(route_err, float((unpacked[k] - v).abs().max()))
    case = kernel2_in[0]
    err2 = _compare2(ss, case)
    mem = _kernel2_memory(ss, case)
    t2 = _time_turns(lambda: ss.segmented_stats(**case),
                     lambda: ss.segmented_stats_reference(**case))
    keys = case['sorted_keys']
    order = torch.sort(c2).indices
    w1, w2 = args[1][order], args[2][order]
    nsplit = 2 if gen_future else 1
    err1 = _compare(ss, keys, w1, w2, n_cells * nsplit)
    t1 = _time_pair(ss, keys, w1, w2, n_cells * nsplit)
    keyed = keys < n_cells * nsplit
    res = dict(replay_kernel2_launches=launches2,
               words_vs_unpacked_max_abs=route_err,
               keyed_dyn_rows=int((((w1 >> 24) & 1).bool() & keyed).sum()),
               kernel2=dict(max_abs_err=err2, **t2, **mem,
                            timing=_time_rows(ss, case)),
               kernel1=dict(max_abs_err=err1, **t1,
                            timing=_time_words(ss, keys, w1, w2,
                                               n_cells * nsplit)),
               **_shape(keys, case['num_groups']))
    emit(phase, t0, **res)
    return res


def _kernel2_memory(ss, case):
    """Kernel 2's peak-memory increment over its inputs: its outputs (one
    allocation) and at most 1 MiB more, since it reads the rows where
    they lie."""
    G = case['num_groups']
    out_bytes = 4 * G * (len(case['weight_rows']) + 1
                         + 2 * len(case['value_rows']))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ss.segmented_stats(**case)
    torch.cuda.synchronize()
    inc = torch.cuda.max_memory_allocated() - base
    del out
    check(inc <= out_bytes + 2 ** 20, (inc, out_bytes))
    return dict(peak_increment_bytes=inc, output_bytes=out_bytes)


def phase_selftest(raster_in):
    """One runner sample's inputs through make_raster_fn with the kernels
    and without them (use_kernel False: the 2-key sort route): the float16
    stacks agree within 2e-3 max abs."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    t0 = time.perf_counter()
    b = kr.DEFAULT_BEV_PARAMS
    stacks = [core.make_raster_fn(
        b['view_size'], b['pixel_size'], cfg.DEFAULT_SEM_IDXS,
        b['int_scaler'], b['int_sep_scaler'], b['int_mid_threshold'],
        use_kernel=uk)(*raster_in) for uk in (True, False)]
    torch.cuda.synchronize()
    err = float((stacks[0].float() - stacks[1].float()).abs().max())
    emit('selftest', t0, max_abs_err=err, atol=SELFTEST_ATOL,
         shape=list(stacks[0].shape), rows=int(raster_in[0].shape[0]))
    check(err <= SELFTEST_ATOL, err)


def _small_runner(d, out_dir):
    """A test-size sampling_loop on device ``d``; returns its counters and
    samples."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    stream_cfg = dict(step=2.0, lidar_range=25.0, seed=3,
                      points_per_frame=3000, img_hw=(188, 704))
    accum = _runner_accum(
        d, None, stream_cfg, dict(kr.DEFAULT_BEV_PARAMS), use_gt_sem=True,
        accum_horizon_dist=30.0, seed=0,
        accum_cfg=cfg.AccumConfig(max_points_per_frame=8192, max_frames=24),
        icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8))
    with contextlib.redirect_stdout(io.StringIO()):
        stats = kr.sampling_loop(
            accum, SyntheticKitti360Stream(n_frames=16, **stream_cfg),
            cfg.SamplingConfig(8.0, 1.0, 2),
            cfg.OutputConfig(out_dir, viz_to_disk=False))
    return stats, _read_samples(out_dir)


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
    check(pose_err <= POSE_ATOL, pose_err)
    check(mism < MAP_MISMATCH, mism)
    # The dataset runner's sampling_loop at test size on both devices.
    runner = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in (dev, torch.device('cpu')):
            before = ss.segmented_stats_words.launches
            runner[d.type] = (*_small_runner(d, os.path.join(tmp, d.type)),
                              ss.segmented_stats_words.launches - before)
    (gst, gs, gl), (cst, cs, cl) = runner['cuda'], runner['cpu']
    check(gst == cst and gst['bevs'] >= 4, (gst, cst))
    check(sorted(gs) == sorted(cs), (sorted(gs), sorted(cs)))
    check(gl == gst['bevs'] and cl == 0, (gl, cl))
    runner_mism, _ = _map_mismatch(gs, cs)
    emit('gpu_vs_cpu', t0, max_pose_err_m=pose_err, pose_atol=POSE_ATOL,
         max_cell_mismatch_fraction=mism, mismatch_limit=MAP_MISMATCH,
         gpu_kernel_launches=gpu_launches, runner_samples=gst['bevs'],
         runner_max_cell_mismatch_fraction=runner_mism,
         runner_gpu_kernel_launches=gl)
    check(runner_mism < MAP_MISMATCH, runner_mism)
    t0 = time.perf_counter()
    emit('gpu_vs_cpu_oracle', t0, **_oracle_gpu_vs_cpu(dev))


def _oracle_lane(stream, n_frames):
    """A straight lane centerline along the drive, in global coordinates."""
    x = np.linspace(0.0, stream.ego_pose(n_frames - 1)[0]
                    + stream.lidar_range, 200)
    return [np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)]


def _check_nuscenes_sample(b, P, lanes=True):
    """The keys the JAX package's oracle test checks
    (tests/test_nuscenes.py:111-131): the 15 maps, the three trajectory
    sets with the moving car's among the full ones, and gt_lanes."""
    _check_sample({k: v for k, v in b.items()
                   if k != 'gt_lanes' and not isinstance(v, (str, int, float))},
                  P)
    check(len(b['trajs_full']) >= 2, len(b['trajs_full']))
    if lanes:
        check(len(b['gt_lanes']) >= 1, 'gt_lanes')
    check(float(b['road_full'].astype(np.float32).min()) < 0.4, 'road_full')
    check((b['rgb_full'].astype(np.float32) > 0).any(), 'rgb_full')
    check((b['elevation_full'] != 0).any(), 'elevation_full')
    check((b['dynamic_full'] != 0.5).any(), 'dynamic_full')


def _check_tracking(accum):
    """The moving car is flagged dynamic in the device table, the parked
    car is not."""
    tr = accum.tracker
    inst_dyn = accum.state.inst_dyn.cpu()
    moving = float(inst_dyn[tr.token2global['car_moving']])
    parked = float(inst_dyn[tr.token2global['car_parked']])
    check(tr.dyn_instances == ['car_moving'], tr.dyn_instances)
    check(moving == 1.0 and parked == 0.0, (moving, parked))
    return dict(moving_car_dyn=moving, parked_car_dyn=parked)


def _encode_ms(imgs, kind):
    """Host encode of ``imgs`` on wire ``kind``: native and numpy spec
    ms (median of 10), the two held equal byte for byte."""
    from pc_accumulation_lib_tpu_torch.ops import imgcodec
    spec = {'yuv420': imgcodec.encode_yuv420_np,
            'yuv420h': imgcodec.encode_yuv420h_np}[kind]
    got, want = imgcodec.encode_wire(imgs, kind), spec(imgs)
    check(len(got) == len(want) and all(
        g.shape == w.shape and g.tobytes() == w.tobytes()
        for g, w in zip(got, want)), f'native {kind} encode != spec')
    return (_median_ms_host(lambda: imgcodec.encode_wire(imgs, kind)),
            _median_ms_host(lambda: spec(imgs)))


def _oracle_samples_held(a, b):
    """Two oracle drives' samples, in order: road, dynamic, rgb and
    elevation maps equal, every map within SELFTEST_ATOL
    (_exact_and_close), trajectories and lanes by count; returns the
    largest difference."""
    check(len(a) == len(b), (len(a), len(b)))

    def maps(s):
        return {k: v for k, v in s.items()
                if isinstance(v, np.ndarray) or k.startswith('trajs')}

    for sa, sb in zip(a, b):
        check(len(sa.get('gt_lanes', ())) == len(sb.get('gt_lanes', ())),
              'gt_lanes')
    return _exact_and_close({i: maps(s) for i, s in enumerate(a)},
                            {i: maps(s) for i, s in enumerate(b)})


def phase_oracle_path(dev, img_transfer='rgb8', transfer_dtype='float32',
                      name='oracle_path', bev=ORACLE_BEV, reference=None):
    """The NuScenes oracle-pose accumulator at the JAX bench's oracle
    configuration, on the given camera and point wires: per frame the
    next frame's upload, integrate (wire decode, 6-camera semseg, paint,
    insert, tracking, the dyn-table update) and generate_bev of the
    previous pose, whose samples are harvested one frame later. Returns
    the result and the stats-stage inputs of the last raster.

    With the sparse fetch (``bev``) each frame's samples are drained on a
    worker thread, the native decoder must decode every one, and the
    ORACLE_HELD samples are held to the dense float16 raster on their
    captured inputs (u8 codes equal, elevation bit-exact); ``reference``
    is oracle_path's result, whose rate is printed beside.

    On an encoded camera wire the phase also times the 6-camera encode,
    native and numpy (held equal), and drives the same frames again on a
    fresh accumulator with each frame's upload on one worker thread,
    started before the previous frame's integrate, as the JAX bench
    overlaps it (bench.py:166-195); its samples are held to the serial
    drive's and both rates are reported."""
    from concurrent.futures import ThreadPoolExecutor

    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.bev import core, native_decode
    from pc_accumulation_lib_tpu_torch.accum import pointpack
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator, encode_multicam_obs)
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticNuScenesStream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    t0 = time.perf_counter()
    stream = SyntheticNuScenesStream(n_frames=ORACLE_FRAMES, **ORACLE_STREAM)
    frames = [stream.frame(i) for i in range(ORACLE_FRAMES)]
    semseg = SemSegTorch(dev, seed=0)
    log = io.StringIO()

    def warm_accum():
        accum = NuScenesOracleSemanticPointCloudAccumulator(
            semseg_model=semseg, semseg_filters=NUSCENES_FILTERS,
            bev_params=dict(bev), loc='synth', get_gt_lanes=True,
            gt_lane_poses=_oracle_lane(stream, ORACLE_FRAMES),
            accum_cfg=cfg.AccumConfig(**ORACLE_ACCUM), seed=0,
            img_transfer=img_transfer, transfer_dtype=transfer_dtype,
            device=dev)
        with contextlib.redirect_stdout(log):
            for f in frames[:ORACLE_WARMUP]:
                accum.integrate([f])
            accum.generate_bev(present_idx=ORACLE_WARMUP - 2, bev_num=1,
                               gen_future=True)
        torch.cuda.synchronize()
        return accum

    accum = warm_accum()
    stats_in = []
    split_stats = sort_raster.split_stats_from_words_flat
    sparse = bev['fetch_dtype'] == 'sparse'
    gen = accum.sem_bev_generator
    raster, calls, held = gen._raster, [0], {}

    def capture_stats(*args, **kwargs):
        stats_in[:] = [args, kwargs]
        return split_stats(*args, **kwargs)

    def capture_raster(*args):
        # The held samples' inputs; the buffer is written in place by
        # later frames, so they are copied.
        if calls[0] in ORACLE_HELD:
            held[calls[0]] = [a.clone() for a in args[:5]] + [args[5]]
        calls[0] += 1
        return raster(*args)

    if sparse:
        gen._raster = capture_raster
        native_decode.decode_sparse_warp.decoded = 0
    ex = ThreadPoolExecutor(max_workers=1) if sparse else None
    wire = []

    def drained(handle):
        out = handle()      # in the worker: its finalizes run one by one
        wire.append(gen.last_harvest['wire_bytes'])
        return out

    def timed_loop(accum, overlap=False):
        """The timed frames on ``accum``; with ``overlap`` each frame's
        upload runs on a worker thread from the start of the previous
        frame. Returns the samples, each frame's seconds, its CUDA events
        (integrate, the generate_bev dispatch), its host ms (integrate,
        the dispatch, the previous frame's harvest; with ``overlap`` also
        the wait for its upload) and the loop's seconds."""
        samples, frame_s, spans, host_ms = [], [], [], []
        upx = ThreadPoolExecutor(max_workers=1) if overlap else None
        ts = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                nxt = (upx.submit(accum.upload_obs, frames[ORACLE_WARMUP])
                       if overlap else accum.upload_obs(
                           frames[ORACLE_WARMUP]))
                pending = None
                for i in range(ORACLE_WARMUP, ORACLE_FRAMES):
                    tf = time.perf_counter()
                    if overlap:
                        nxt = nxt.result()
                        tw = time.perf_counter()
                        up = (upx.submit(accum.upload_obs, frames[i + 1])
                              if i + 1 < ORACLE_FRAMES else None)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(3)]
                    ev[0].record()
                    accum.integrate([nxt])
                    ev[1].record()
                    th = time.perf_counter()
                    handle = accum.generate_bev(
                        present_idx=len(accum.poses) - 2, bev_num=1,
                        gen_future=True, async_fetch=True)
                    if ex is not None:     # drained on the worker thread
                        handle = ex.submit(drained, handle).result
                    ev[2].record()
                    tu = time.perf_counter()
                    if overlap:
                        nxt = up
                    elif i + 1 < ORACLE_FRAMES:
                        nxt = accum.upload_obs(frames[i + 1])
                    tp = time.perf_counter()
                    if pending is not None:
                        samples += pending()
                    pending = handle
                    spans.append(ev)
                    host_ms.append([(th - tf) * 1e3, (tu - th) * 1e3,
                                    (time.perf_counter() - tp) * 1e3]
                                   + ([(tw - tf) * 1e3] if overlap else []))
                    frame_s.append(time.perf_counter() - tf)
                tf = time.perf_counter()
                samples += pending()
                torch.cuda.synchronize()
                frame_s[-1] += time.perf_counter() - tf
        finally:
            if upx is not None:
                upx.shutdown()
        return samples, frame_s, spans, host_ms, time.perf_counter() - ts

    up_bytes, up_frames = accum.upload_bytes_total, accum.upload_frames
    torch.cuda.reset_peak_memory_stats()
    sort_raster.split_stats_from_words_flat = capture_stats
    ss.segmented_stats_words.launches = 0
    try:
        samples, frame_s, spans, host_ms, loop_s = timed_loop(accum)
    finally:
        sort_raster.split_stats_from_words_flat = split_stats
        gen._raster = raster
        if ex is not None:
            ex.shutdown()
    launches = ss.segmented_stats_words.launches
    peak = torch.cuda.max_memory_allocated()
    n_timed = ORACLE_FRAMES - ORACLE_WARMUP
    check(len(samples) == n_timed, len(samples))
    check(launches == len(samples), (launches, len(samples)))
    for b in samples:
        _check_nuscenes_sample(b, ORACLE_BEV['pixel_size'])
    tracking = _check_tracking(accum)
    check(accum.max_painted <= accum.accum_cfg.painted_cap,
          accum.max_painted)
    if sparse:
        decoded = native_decode.decode_sparse_warp.decoded
        check(decoded == len(samples) and gen.sparse_overflows == 0,
              (decoded, gen.sparse_overflows))
        P = bev['pixel_size']
        dense_fn = core.make_raster_fn(
            bev['view_size'], P, accum.sem_idxs, bev['int_scaler'],
            bev['int_sep_scaler'], bev['int_mid_threshold'])
        check(sorted(held) == list(ORACLE_HELD), sorted(held))
        for i, args in held.items():
            _codes_equal(_bev_stack(samples[i]), dense_fn(*args).cpu()
                         .numpy(), f'oracle sample {i}')
        tracking.update(
            native_decoded=decoded, held_samples=sorted(held),
            sparse_cap=gen.sparse_cap,
            max_occupied_split=gen.max_occupied_split,
            sparse_short_fetches=gen.sparse_short_fetches,
            sparse_overflows=gen.sparse_overflows,
            wire_bytes_per_sample=sum(wire) / len(wire),
            float16_bytes_per_sample=21 * P * P * 2)
        if reference is not None:
            tracking['oracle_path_samples_per_s_median'] = reference[
                'samples_per_s_median']
    integrate_ms = [a.elapsed_time(b) for a, b, _ in spans]
    generate_ms = [b.elapsed_time(c) for _, b, c in spans]
    # The 6-camera semseg forward alone (uint8 -> float on the device and
    # the batched ResNet-50), CUDA events, median of 10.
    imgs = torch.from_numpy(np.stack(frames[-1]['images'])).to(dev)
    semseg_ms = _median_ms(lambda: semseg.predict(imgs.to(torch.float32)),
                           reps=10)
    steady = frame_s[1:]
    res = dict(frames=ORACLE_FRAMES, warmup_frames=ORACLE_WARMUP,
               samples=len(samples), launches=launches,
               launches_per_sample=launches / len(samples),
               samples_per_s_median=1.0 / statistics.median(steady),
               samples_per_s_overall=len(samples) / loop_s,
               frame_ms=[s * 1e3 for s in frame_s],
               integrate_ms_median=statistics.median(integrate_ms),
               generate_bev_ms_median=statistics.median(generate_ms),
               integrate_ms=integrate_ms, generate_bev_ms=generate_ms,
               host_ms_median=dict(zip(
                   ('integrate', 'generate_bev_dispatch', 'harvest'),
                   np.median(np.array(host_ms), axis=0).tolist())),
               semseg_6cam_ms=semseg_ms,
               upload_mb_per_frame=(accum.upload_bytes_total - up_bytes)
               / max(accum.upload_frames - up_frames, 1) / 1e6,
               max_painted_per_frame=accum.max_painted,
               painted_cap=accum.accum_cfg.painted_cap,
               points_per_frame=[int(f['pc'].shape[0])
                                 for f in frames[ORACLE_WARMUP::4]],
               rows_per_raster=accum.state.valid.numel(),
               max_memory_allocated_bytes=peak, **tracking)
    dob = accum.upload_obs(frames[-1])
    res.update(wire=(img_transfer, transfer_dtype),
               bytes_per_frame=_part_bytes(dict(
                   points=dob.pc_pad, valid=dob.valid, cam_idx=dob.cam_idx,
                   **{f'image{i}': p for i, p in enumerate(dob.imgs)})),
               upload_ms_per_frame=_upload_ms(accum, frames[-4:]))
    wire_bytes = res['bytes_per_frame']
    h, w = ORACLE_STREAM['img_hw']
    check(sum(v for k, v in wire_bytes.items() if k.startswith('image'))
          == 6 * h * w * WIRE_BYTES_PER_PIXEL[img_transfer], wire_bytes)
    check(wire_bytes['points'] == ORACLE_ACCUM['max_points_per_frame']
          * (13 if transfer_dtype == 'quantized' else 28), wire_bytes)
    if img_transfer != 'rgb8':
        cams = np.stack([np.asarray(im)[..., :3].astype(np.uint8)
                         for im in frames[-1]['images']])
        enc_ms, enc_np_ms = _encode_ms(cams, img_transfer)
        # The whole host side of an upload (point padding or pack, the
        # camera stack and its encode), and the point pack alone.
        n_pad = ORACLE_ACCUM['max_points_per_frame']
        obs_ms = _median_ms_host(lambda: encode_multicam_obs(
            frames[-1], n_pad, img_transfer, transfer_dtype))
        pc = np.asarray(frames[-1]['pc'], np.float32)
        pack_ms = (_median_ms_host(lambda: pointpack.pack_points7_np(
            pc, n_pad)) if transfer_dtype == 'quantized' else None)
        o_accum = warm_accum()
        ss.segmented_stats_words.launches = 0
        o_samples, o_frame_s, _, o_host_ms, o_loop_s = timed_loop(
            o_accum, overlap=True)
        o_launches = ss.segmented_stats_words.launches
        check(o_launches == len(o_samples), (o_launches, len(o_samples)))
        res.update(
            encode_6cam_ms=enc_ms, encode_6cam_np_ms=enc_np_ms,
            host_encode_obs_ms=obs_ms, pack_points_ms=pack_ms,
            overlapped_upload=dict(
                samples=len(o_samples), launches=o_launches,
                samples_per_s_median=1.0 / statistics.median(o_frame_s[1:]),
                samples_per_s_overall=len(o_samples) / o_loop_s,
                frame_ms=[s * 1e3 for s in o_frame_s],
                host_ms_median=dict(zip(
                    ('integrate', 'generate_bev_dispatch', 'harvest',
                     'upload_wait'),
                    np.median(np.array(o_host_ms), axis=0).tolist())),
                vs_serial_max_abs=_oracle_samples_held(o_samples, samples)),
            icp_frame=_icp_frame_on_wire(dev, semseg, stream, img_transfer,
                                         transfer_dtype))
    emit(name, t0, **res)
    return res, stats_in


def _icp_frame_on_wire(dev, semseg, stream, img_transfer, transfer_dtype):
    """The NuScenes runner's ICP accumulator on the given wires: two
    frames (the second registers against the first) and one sample; the
    step must come out at the stream's 2 m within STEP_ATOL."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as nr
    icp = _nuscenes_runner_accum(dev, semseg, oracle=False,
                                 img_transfer=img_transfer,
                                 transfer_dtype=transfer_dtype)
    ss.segmented_stats_words.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(2):
            icp.integrate([stream.frame(i)])
        bev = icp.generate_bev(present_idx=1, bev_num=1, gen_future=True)[0]
    step = float(np.linalg.norm(np.diff(icp.get_pose(), axis=0)))
    check(abs(step - stream.step) <= STEP_ATOL, step)
    launches = ss.segmented_stats_words.launches
    check(launches == 1, launches)
    _check_sample(bev, nr.DEFAULT_BEV_PARAMS['pixel_size'])
    return dict(step_m=step, launches=launches)


def _nuscenes_runner_accum(dev, semseg, oracle, **wires):
    """The accumulator as the NuScenes runner's run() builds it, at its
    defaults (``wires``: img_transfer and transfer_dtype)."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.nuscenes import (
        NuScenesSemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as nr
    bev = dict(nr.DEFAULT_BEV_PARAMS)
    if oracle:
        return NuScenesOracleSemanticPointCloudAccumulator(
            semseg, nr.NUSCENES_FILTERS, cfg.DEFAULT_SEM_IDXS, False, bev,
            'synth', False, None, accum_cfg=None, device=dev, **wires)
    return NuScenesSemanticPointCloudAccumulator(
        200.0, 1e3, semseg, nr.NUSCENES_FILTERS, cfg.DEFAULT_SEM_IDXS, False,
        bev, 'synth', accum_cfg=None, icp_cfg=None, device=dev, **wires)


def phase_nuscenes_runner_path(dev):
    """The NuScenes runner's two phases at run()'s defaults with oracle
    poses: phase 1 integrates the whole 100-frame stream, phase 2
    (sample_scene_bevs through write_scene_samples) rasters each sampled
    pose once (kernel 1) and writes the samples with their metadata
    through the async writer; they are read back. Then the ICP branch on
    the stream's first 12 frames."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticNuScenesStream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as nr
    from pc_accumulation_lib_tpu_torch.utils.async_writer import (
        AsyncPickleWriter)
    t0 = time.perf_counter()
    stream = SyntheticNuScenesStream(n_frames=NUSC_RUNNER_FRAMES,
                                     **ORACLE_STREAM)
    semseg = SemSegTorch(dev, seed=0)
    accum = _nuscenes_runner_accum(dev, semseg, oracle=True)
    P = nr.DEFAULT_BEV_PARAMS['pixel_size']
    log = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    with tempfile.TemporaryDirectory() as out_dir, \
            contextlib.redirect_stdout(log):
        ts = time.perf_counter()
        for observations in stream:
            accum.integrate(observations)
        accum.check_painted()
        torch.cuda.synchronize()
        integrate_s = time.perf_counter() - ts
        integrate_launches = ss.segmented_stats_words.launches
        writer = AsyncPickleWriter()
        ts = time.perf_counter()
        n = nr.write_scene_samples(
            accum, 0, cfg.SamplingConfig(bev_horizon_dist=80.0),
            cfg.OutputConfig(out_dir, viz_to_disk=False), 0, writer)
        writer.wait()
        sample_s = time.perf_counter() - ts
        launches = ss.segmented_stats_words.launches
        peak = torch.cuda.max_memory_allocated()
        samples = _read_samples(out_dir)
    check(integrate_launches == 0, integrate_launches)
    check(n >= RUNNER_MIN_SAMPLES and len(samples) == n, (n, len(samples)))
    check(launches == n, (launches, n))
    for name, b in samples.items():
        _check_nuscenes_sample(b, P, lanes=False)
        check(b['scene_idx'] == 0 and b['map'] == 'synth', name)
        check(isinstance(b['ego_global_x'], float)
              and isinstance(b['ego_global_y'], float), name)
    xs = sorted(b['ego_global_x'] for b in samples.values())
    tracking = _check_tracking(accum)
    res = dict(frames=NUSC_RUNNER_FRAMES, samples=n, launches=launches,
               integrate_s=integrate_s,
               integrate_ms_per_frame=integrate_s * 1e3 / NUSC_RUNNER_FRAMES,
               sample_write_s=sample_s, samples_per_s_phase2=n / sample_s,
               samples_per_s_both_phases=n / (integrate_s + sample_s),
               rows_per_raster=accum.state.valid.numel(),
               sampled_ego_x=[xs[0], xs[-1]],
               max_painted_per_frame=accum.max_painted,
               async_writer_native=writer.native,
               max_memory_allocated_bytes=peak, **tracking)
    del accum, samples
    # The ICP branch of run() on the stream's first frames.
    icp = _nuscenes_runner_accum(dev, semseg, oracle=False)
    ss.segmented_stats_words.launches = 0
    ts = time.perf_counter()
    with contextlib.redirect_stdout(log):
        for i in range(NUSC_ICP_FRAMES):
            icp.integrate([stream.frame(i)])
        bev = icp.generate_bev(present_idx=len(icp.poses) - 2, bev_num=1,
                               gen_future=True)[0]
    torch.cuda.synchronize()
    icp_s = time.perf_counter() - ts
    icp_launches = ss.segmented_stats_words.launches
    steps = np.linalg.norm(np.diff(icp.get_pose(), axis=0), axis=1)
    step_err = float(np.abs(steps - stream.step).max())
    check(step_err <= STEP_ATOL, steps.tolist())
    check(icp_launches == 1, icp_launches)
    _check_sample(bev, P)
    res.update(icp_frames=NUSC_ICP_FRAMES, icp_max_step_err_m=step_err,
               icp_steps_m=steps.tolist(), icp_launches=icp_launches,
               icp_ms_per_frame=icp_s * 1e3 / NUSC_ICP_FRAMES)
    emit('nuscenes_runner_path', t0, **res)
    return res


def _oracle_small(d, frames, lanes):
    """The JAX package's oracle test fixture (tests/test_nuscenes.py:18-22,
    76-88) on device ``d``, with a float32 reduced-depth model: poses,
    the dyn table and the sample at present_idx 5."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    semseg = SemSegTorch(d, seed=0, stage_sizes=(1, 1, 1, 1),
                         compute_dtype=torch.float32)
    a = NuScenesOracleSemanticPointCloudAccumulator(
        semseg_model=semseg,
        bev_params=dict(type='sem', view_size=40, pixel_size=64,
                        int_scaler=1., int_sep_scaler=30.,
                        int_mid_threshold=0.12),
        loc='synth-map', get_gt_lanes=True, gt_lane_poses=lanes,
        accum_cfg=cfg.AccumConfig(max_points_per_frame=16384, max_frames=32,
                                  max_painted_points_per_frame=16384,
                                  max_instances=64), seed=0, device=d)
    with contextlib.redirect_stdout(io.StringIO()):
        for f in frames:
            a.integrate([f])
    bev = a.generate_bev(present_idx=5, bev_num=1, gen_future=True)[0]
    return np.array(a.poses), a.state.inst_dyn.cpu().numpy(), bev


def _oracle_gpu_vs_cpu(dev):
    """The oracle fixture's frames on both devices: poses within 1e-4 m,
    the dyn tables equal, maps under the step() rule. The GPU model runs
    in float32 with TF32 off in cuDNN, as on the CPU."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticNuScenesStream)
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    stream = SyntheticNuScenesStream(n_frames=10, step=2.0, lidar_range=20.0,
                                     seed=2)
    frames = [stream.frame(i) for i in range(10)]
    lanes = [np.stack([np.linspace(0, 100, 101), np.zeros(101),
                       np.zeros(101)], 1)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = ss.segmented_stats_words.launches
        gpu = _oracle_small(dev, frames, lanes)
        launches = ss.segmented_stats_words.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = _oracle_small(torch.device('cpu'), frames, lanes)
    check(launches == 1, launches)
    pose_err = float(np.abs(gpu[0] - cpu[0]).max())
    check(pose_err <= POSE_ATOL, pose_err)
    check(np.array_equal(gpu[1], cpu[1]) and gpu[1].max() == 1.0,
          'inst_dyn differs')
    mism, err = _map_mismatch({'s': gpu[2]}, {'s': cpu[2]})
    check(mism < MAP_MISMATCH, mism)
    for k in ('trajs_full', 'gt_lanes'):
        check(len(gpu[2][k]) == len(cpu[2][k]), k)
    return dict(oracle_max_pose_err_m=pose_err,
                oracle_inst_dyn_equal=True,
                oracle_max_cell_mismatch_fraction=mism,
                oracle_max_abs=err, oracle_gpu_kernel_launches=launches)


def phase_semseg_weights(dev, tmp):
    """The seed-0 full-width model written as an .onnx initializers file
    (names prefixed, so the suffix rule loads it) and as a weight file,
    each loaded with load_semseg_model on the card: logits and class maps
    on one 376x1408 frame equal to the source model's."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models import onnx_pb
    from pc_accumulation_lib_tpu_torch.models.checkpoint import (
        save_semseg_weights)
    from pc_accumulation_lib_tpu_torch.models.semseg import (
        SemSegTorch, load_semseg_model)
    t0 = time.perf_counter()
    src = SemSegTorch(dev, seed=0)
    paths = {'onnx': os.path.join(tmp, 'semseg.onnx'),
             'pt': os.path.join(tmp, 'semseg.pt')}
    ts = time.perf_counter()
    onnx_pb.write_initializers(paths['onnx'], {
        'model.' + k: v.cpu().numpy()
        for k, v in src.model.state_dict().items()
        if not k.endswith('num_batches_tracked')})
    write_s = {'onnx': time.perf_counter() - ts}
    ts = time.perf_counter()
    save_semseg_weights(src, paths['pt'])
    write_s['pt'] = time.perf_counter() - ts
    img = torch.from_numpy(SyntheticKitti360Stream(
        n_frames=1, **STREAM).render_image(0))[None].to(dev)
    res = dict(frame_hw=list(STREAM['img_hw']),
               parameters=sum(p.numel() for p in src.model.parameters()))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            want = src.model(img.to(torch.float32))
        for kind, path in paths.items():
            ts = time.perf_counter()
            model = load_semseg_model(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - ts
            with torch.no_grad():
                got = model.model(img.to(torch.float32))
            err = float((got - want).abs().max())
            check(err == 0.0, (kind, err))
            same = bool(torch.equal(model.predict(img), src.predict(img)))
            check(same, f'{kind}: class maps differ')
            res[kind] = dict(file_bytes=os.path.getsize(path),
                             write_s=write_s[kind], load_s=load_s,
                             logits_max_abs=err, class_maps_equal=same)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit('semseg_weights', t0, **res)


def _forward_flops(model, hw):
    """Forward FLOPs of one image: 2 per multiply-add of every conv, from
    the layer shapes one forward at ``hw`` gives."""
    flops = []

    def count(mod, _, out):
        k = mod.weight[0].numel()   # in_ch / groups * kh * kw
        flops.append(2 * k * out[0].numel()
                     + (out[0].numel() if mod.bias is not None else 0))

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    dev = next(model.parameters()).device
    training = model.training
    model.eval()                # keeps the running statistics as they are
    try:
        with torch.no_grad():
            model(torch.zeros((1, *hw, 3), device=dev))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return sum(flops), len(flops)


def _train_shard(path, hw):
    """TRAIN_FRAMES rendered frames and labels in 0-18 (row bands shifted
    per frame), 5% of pixels 255 and frame 3 wholly 255."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    stream = SyntheticKitti360Stream(n_frames=TRAIN_FRAMES, **STREAM)
    rng = np.random.default_rng(0)
    h, w = hw
    rows = np.arange(h)[:, None] * 19 // h
    labels = np.stack([np.broadcast_to((rows + i) % 19, (h, w))
                       for i in range(TRAIN_FRAMES)]).astype(np.uint8)
    labels[rng.random(labels.shape) < 0.05] = 255
    labels[3] = 255
    np.savez(path, images=np.stack([stream.render_image(i)
                                    for i in range(TRAIN_FRAMES)]),
             labels=labels)
    return labels


def _equal_train_states(a, b):
    """Parameters, buffers and Adam's moments and steps bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    check(set(sa) == set(sb), 'state keys differ')
    for k in sa:
        check(torch.equal(sa[k], sb[k]), f'restored {k} differs')
    oa = a.optimizer.state_dict()['state']
    ob = b.optimizer.state_dict()['state']
    check(set(oa) == set(ob) and oa, 'optimizer state differs')
    for i in oa:
        for k in ('exp_avg', 'exp_avg_sq', 'step'):
            check(torch.equal(oa[i][k].cpu(), ob[i][k].cpu()),
                  f'restored optimizer {i}.{k} differs')
    return len(sa), len(oa)


def phase_train_path(dev, tmp):
    """runners/train_semseg.run at full width: the full-depth ResNet-50
    dilated FCN at 376x1408, batch 8, 12 steps, checkpoints at 6 and 12.
    Each step is timed from one step's start to the next one's (the
    batch's load and host-to-device copy, the step, the loss read) and
    alone (the step up to its synchronize). Then 5 steps on a fixed batch
    lower the loss, and the last checkpoint restores bit-equal."""
    from pc_accumulation_lib_tpu_torch.models import checkpoint as ckpt
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.runners import train_semseg
    t0 = time.perf_counter()
    hw = STREAM['img_hw']
    shard = os.path.join(tmp, 'shard0.npz')
    labels = _train_shard(shard, hw)
    ckpt_dir = os.path.join(tmp, 'ckpt')
    make_setup = train_mod.make_train_setup
    starts, step_s = [], []

    def timed_setup(*args, **kwargs):
        state, train_step = make_setup(*args, **kwargs)

        def timed_step(state, images, labels):
            ts = time.perf_counter()
            starts.append(ts)
            out = train_step(state, images, labels)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            return out
        return state, timed_step

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_mod.make_train_setup = timed_setup
    ts = time.perf_counter()
    try:
        state, losses = train_semseg.run(
            os.path.join(tmp, 'shard*.npz'), steps=TRAIN_STEPS,
            batch_size=TRAIN_BATCH, ckpt_dir=ckpt_dir,
            ckpt_every=TRAIN_CKPT_EVERY, device=dev)
    finally:
        train_mod.make_train_setup = make_setup
    run_s = time.perf_counter() - ts
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          (len(losses), state.step))
    check(all(np.isfinite(losses)), losses)
    check(sorted(os.listdir(ckpt_dir), key=int)
          == [str(s) for s in range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                                    TRAIN_CKPT_EVERY)],
          os.listdir(ckpt_dir))
    iter_s = [b - a for a, b in zip(starts, starts[1:])]
    median_iter = statistics.median(iter_s[1:])
    median_step = statistics.median(step_s[1:])
    flops, convs = _forward_flops(state.model, hw)
    train_flops = 3 * flops * TRAIN_BATCH
    # The last checkpoint into a fresh setup.
    fresh, _ = make_setup(img_hw=hw, device=dev)
    ts = time.perf_counter()
    restored = ckpt.restore_train_state(ckpt_dir, fresh)
    restore_s = time.perf_counter() - ts
    check(restored.step == TRAIN_STEPS, restored.step)
    n_tensors, n_moments = _equal_train_states(restored, state)
    del state, fresh, restored
    # 5 steps on one fixed batch: the shard's first 8 frames.
    with np.load(shard) as d:
        images = torch.from_numpy(d['images'][:TRAIN_BATCH]).to(dev)
    fixed_labels = torch.from_numpy(labels[:TRAIN_BATCH]).to(dev)
    state, train_step = make_setup(img_hw=hw, device=dev)
    fixed = []
    for _ in range(FIXED_BATCH_STEPS):
        state, loss = train_step(state, images.to(torch.float32),
                                 fixed_labels)
        fixed.append(float(loss))
    check(all(np.isfinite(fixed)) and fixed[-1] < fixed[0], fixed)
    del state
    emit('train_path', t0, frames=TRAIN_FRAMES, hw=list(hw),
         batch=TRAIN_BATCH, steps=TRAIN_STEPS, losses=losses,
         step_s=step_s, iteration_s=iter_s,
         median_step_s_2_to_12=median_step,
         median_iteration_s_2_to_11=median_iter,
         images_per_s=TRAIN_BATCH / median_iter,
         images_per_s_step_alone=TRAIN_BATCH / median_step,
         forward_flops_per_image=flops, conv_layers=convs,
         train_flops_per_step=train_flops,
         train_flop_per_s=train_flops / median_iter,
         train_flop_per_s_step_alone=train_flops / median_step,
         bf16_peak_share=train_flops / median_iter / BF16_OPS_PER_S,
         max_memory_allocated_bytes=peak, run_s=run_s,
         restore_s=restore_s, restored_tensors=n_tensors,
         restored_moments=n_moments, fixed_batch_losses=fixed)


def _small_train(d, batches, dtype):
    """SMALL_TRAIN on device ``d``, every conv, batch norm, parameter and
    Adam moment in ``dtype``: (initial state, step-1 gradients, running
    statistics after step 1, losses, final parameters), on the host in
    float64."""
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.models.resnet_semseg import _Conv
    cfg = SMALL_TRAIN
    state, train_step = train_mod.make_train_setup(
        lr=cfg['lr'], img_hw=cfg['hw'], seed=0,
        stage_sizes=cfg['stage_sizes'], compute_dtype=dtype, device=d)
    state.model.to(dtype)
    for m in state.model.modules():
        if isinstance(m, _Conv):     # the classifier's float32 included
            m.compute_dtype = dtype
    # The optimizer again, on the parameters in their new dtype.
    state = state._replace(optimizer=type(state.optimizer)(
        state.model.parameters(), **state.optimizer.defaults))

    def host(tensors):
        # A copy: on the CPU in float64 .double().numpy() shares memory
        # with the live tensor, which the next steps change.
        return {k: v.detach().cpu().double().numpy().copy()
                for k, v in tensors}

    init = host(state.model.state_dict().items())
    losses, grads, stats = [], None, None
    for images, labels in batches:
        state, loss = train_step(state, torch.from_numpy(images).to(d),
                                 torch.from_numpy(labels).to(d))
        losses.append(float(loss))
        if grads is None:
            grads = host((k, p.grad) for k, p in
                         state.model.named_parameters())
            stats = host((k, v) for k, v in state.model.state_dict().items()
                         if 'running' in k)
    return (init, grads, stats, np.array(losses),
            host(state.model.named_parameters()))


def _rel_err(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): <= 1 passes."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _held(gpu, cpu):
    """The card's run against the CPU's under the CPU tests' tolerances
    (SMALL_TRAIN's comment): each error <= 1 passes."""
    (gi, gg, gs, gl, gp), (ci, cg, cs, cl, cp) = gpu, cpu
    check(all(np.array_equal(gi[k], ci[k]) for k in ci),
          'initial weights differ')
    check(np.isfinite(gl).all() and np.isfinite(cl).all(), (gl, cl))
    return dict(
        step1_loss=_rel_err(gl[0], cl[0], 1e-5, 0.0),
        losses=_rel_err(gl, cl, 1e-4, 0.0),
        gradients=max(_rel_err(gg[k], g, 1e-4, GRAD_FLOOR * np.abs(g).max())
                      for k, g in cg.items()),
        running_stats=max(_rel_err(gs[k], v, 1e-5, 1e-5 * np.abs(v).max())
                          for k, v in cs.items()),
        parameters=max(float(np.abs(gp[k] - v).max()) for k, v in cp.items())
        / (2 * SMALL_TRAIN['lr'] * SMALL_TRAIN['steps']))


def _grad_distance(run, ref):
    """Per step-1 gradient tensor, max |g - g_ref| / max |g_ref|."""
    return {k: float(np.abs(run[1][k] - g).max() / np.abs(g).max())
            for k, g in ref[1].items()}


def phase_gpu_vs_cpu_train(dev):
    """Three train steps of the reduced-depth model at 64x128, batch 2,
    TF32 off, on the card and on the CPU from the same weights and
    batches. In float64 the two are held to each other under the CPU
    tests' tolerances: the same function computed twice. In float32 (the
    trainer's dtype on the CPU) the step-1 loss, the batch-norm statistics
    and the parameters are held to the CPU's the same way, and the
    gradients to the CPU's float64 run: the card's largest distance from
    it, over tensors, no more than twice the CPU's plus GRAD_FLOOR. At
    this size float32 itself is the limit: a batch norm whose channel
    mean dwarfs its spread amplifies the rounding of its input, and the
    CPU's float32 layer-4 gradients lie up to ~8% of their tensor's
    largest from its float64 ones. Adam's first step, about +-lr per
    weight whatever its gradient's size, then takes a different sign on
    each device for gradients at that floor, so the float32 losses of
    steps 2 and 3 are reported with their distance from the float64 run,
    not held: the float64 pair holds the losses."""
    t0 = time.perf_counter()
    cfg = SMALL_TRAIN
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(cfg['steps']):
        images = rng.integers(0, 256, (cfg['batch'], *cfg['hw'], 3))
        labels = rng.integers(0, 19, (cfg['batch'], *cfg['hw']))
        labels[0, :5] = 255
        batches.append((images.astype(np.float32), labels.astype(np.int64)))
    cpu_dev = torch.device('cpu')
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {dt: (_small_train(dev, batches, dt),
                     _small_train(cpu_dev, batches, dt))
                for dt in (torch.float64, torch.float32)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (g64, c64), (g32, c32) = runs[torch.float64], runs[torch.float32]
    held64 = _held(g64, c64)
    held32 = _held(g32, c32)
    gpu_grads, cpu_grads = _grad_distance(g32, c64), _grad_distance(c32, c64)
    grads32 = (max(gpu_grads.values())
               / (2 * max(cpu_grads.values()) + GRAD_FLOOR))
    worst = sorted(cpu_grads, key=lambda k: max(gpu_grads[k],
                                                cpu_grads[k]))[-3:]
    res = dict(float64=held64,
               float32=dict(step1_loss=held32['step1_loss'],
                            running_stats=held32['running_stats'],
                            parameters=held32['parameters'],
                            gradients_vs_float64=grads32),
               losses=dict(gpu64=g64[3].tolist(), cpu64=c64[3].tolist(),
                           gpu32=g32[3].tolist(), cpu32=c32[3].tolist()),
               float32_loss_rel_distance_to_float64=dict(
                   gpu=(np.abs(g32[3] - c64[3]) / c64[3]).tolist(),
                   cpu=(np.abs(c32[3] - c64[3]) / c64[3]).tolist()),
               float32_grad_distance_to_float64={
                   k: dict(gpu=gpu_grads[k], cpu=cpu_grads[k])
                   for k in worst},
               grad_floor=GRAD_FLOOR,
               note='errors are ratios to their limit: <= 1 passes')
    emit('gpu_vs_cpu_train', t0, **res)
    for name, err in [*(('float64 ' + k, v) for k, v in held64.items()),
                      *(('float32 ' + k, v) for k, v in
                        res['float32'].items())]:
        check(err <= 1.0, (name, err))


def phase_pc_accum(dev, tmp):
    """Each point-cloud export runner's accumulator as its run() builds it
    (run()'s defaults, the full-depth model), fed the synthetic stream;
    export_vector_space writes the in-window cloud, read back: the point
    count equals the in-window valid rows, the points and colours equal
    the buffer's. These paths launch neither stats kernel."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream, SyntheticNuScenesStream, make_calib)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.runners import kitti360_pc_accum
    from pc_accumulation_lib_tpu_torch.runners import nuscenes_pc_accum
    from pc_accumulation_lib_tpu_torch.utils.ply import read_ply
    semseg = SemSegTorch(dev, seed=0)
    _, H_velo_cam, P_cam_frame = make_calib(STREAM['img_hw'])
    calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                 p_velo_frame=P_cam_frame @ H_velo_cam)
    runners = (
        ('kitti360_pc_accum', lambda: kitti360_pc_accum.build_accumulator(
            calib, semseg, device=dev),
         lambda: SyntheticKitti360Stream(n_frames=PC_ACCUM_FRAMES, **STREAM)),
        ('nuscenes_pc_accum', lambda: nuscenes_pc_accum.build_accumulator(
            semseg, 'synth', device=dev),
         lambda: SyntheticNuScenesStream(n_frames=PC_ACCUM_FRAMES,
                                         **ORACLE_STREAM)))
    for phase, build, make_stream in runners:
        t0 = time.perf_counter()
        accum, stream = build(), make_stream()
        out = os.path.join(tmp, f'{phase}.ply')
        ss.segmented_stats_words.launches = 0
        ss.segmented_stats.launches = 0
        log = io.StringIO()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with contextlib.redirect_stdout(log):
            for observations in stream:
                accum.integrate(observations)
        torch.cuda.synchronize()
        integrate_s = time.perf_counter() - ts
        ts = time.perf_counter()
        n = kitti360_pc_accum.export_vector_space(accum, out)
        export_s = time.perf_counter() - ts
        launches = (ss.segmented_stats_words.launches,
                    ss.segmented_stats.launches)
        st = accum.state
        in_window = int((st.valid & (st.frame_ids[:, None]
                                     >= accum.window_start)).sum())
        xyz, rgb = read_ply(out)
        pts = accum.get_vector_space()
        check(n == in_window == xyz.shape[0] and n > 0, (n, in_window,
                                                         xyz.shape))
        check(np.array_equal(xyz, pts[:, :3].astype(np.float32)),
              'PLY points differ from the buffer')
        rgb_buf = pts[:, cfg.PT_R:cfg.PT_B + 1]
        check(np.array_equal(rgb, np.clip(rgb_buf, 0, 255).astype(np.uint8)),
              'PLY colours differ')
        poses = np.loadtxt(out + '.poses.txt')
        check(poses.shape == (len(accum.poses), 3), poses.shape)
        check(launches == (0, 0), launches)
        emit(phase, t0, frames=PC_ACCUM_FRAMES, points=n,
             in_window_valid_rows=in_window, ply_bytes=os.path.getsize(out),
             integrate_s=integrate_s,
             integrate_ms_per_frame=integrate_s * 1e3 / PC_ACCUM_FRAMES,
             export_s=export_s, window_frames=len(accum.poses),
             rows=st.valid.numel(), kernel_launches=list(launches))
        del accum


# --- the mesh (parallel/) ------------------------------------------------
#
# One card: NCCL refuses two ranks on one device, so the 2-rank worlds run
# over gloo with CUDA tensors, both ranks on cuda:0 (every gloo collective
# on a CUDA tensor goes through host memory: parallel/mesh.py), and a
# 1-rank world runs over NCCL. Two ranks share one card: their times are
# not scale-out figures.
MESH_RANKS = 2
MESH4_RANKS = 4
MESH_TIMEOUT_S = 600
# GPipe on the pp = 2 mesh at tests/test_pipeline.py's shapes.
PIPE = dict(d=16, mb=8, micro=(2, 4, 5), grad_d=8, grad_mb=4, grad_micro=8)
PIPE_ATOL = 1e-5
# Data-parallel training: run()'s global batch of 8 (4 per rank) on
# train_path's shard and seed, TF32 off, against a one-card run of the
# same. In float64, over SMALL_TRAIN's 3 steps, the two are held to each
# other under the CPU tests' tolerances (SMALL_TRAIN's comment): the same
# function computed twice, the later losses included. In float32, over 6
# timed steps, the step-1 loss and the batch-norm statistics are held the
# same way and the gradients and later losses reported: at 376x1408
# float32 is the floor (gpu_vs_cpu_train's docstring), and Adam's first
# step, about +-lr per weight, turns gradients at that floor into
# different weights on the two runs. The float64 runs keep their input
# and logits in float64 too (_forward_in).
TRAIN_MESH_STEPS = 6
TRAIN_MESH_STEPS_FLOAT64 = 3
# DP+TP training (train_tp_path): train_semseg.run at the runner's
# default layout, (1, 2) on the 2 ranks, at full depth and width on
# train_path's shard, a global batch of 2 (cut from run()'s 8: gloo stages
# every model-axis collective through host memory, ~0.8 GB of channel
# gathers per float32 image in the forward pass and about as much in
# psums in the backward pass); 3 float64 steps held to a one-card float64
# run of the same by _train_held, 6 float32 steps timed. The same float64
# hold on (2, 2) in mesh_step4's 4-rank world. A (1, 2) rank holds
# TP_PARAMS_PER_RANK of the 32,975,219 parameters.
TRAIN_TP_BATCH = 2
TP_PARAMS_PER_RANK = 16_991_603


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def _mesh_plan(dev):
    """What the mesh worlds drive: the configurations of main_path,
    runner_path and train_path (a rehearsal on the CPU passes smaller
    ones)."""
    return dict(dev=str(dev), stream=STREAM, accum=ACCUM, icp=ICP,
                horizon=HORIZON, bev=BEV, bev_num=BEV_NUM, steps=N_STEPS,
                sparse_bev=SPARSE_BEV, sparse_accum=SPARSE_ACCUM,
                sparse_steps=MESH_SPARSE_STEPS,
                runner_frames=RUNNER_FRAMES, runner_accum={},
                sampling=None, semseg={},
                train_steps={str(torch.float64): TRAIN_MESH_STEPS_FLOAT64,
                             str(torch.float32): TRAIN_MESH_STEPS},
                train_batch=TRAIN_BATCH, train_tp_batch=TRAIN_TP_BATCH,
                train_tp_dtypes={
                    str(MESH_RANKS): [str(torch.float64),
                                      str(torch.float32)],
                    str(MESH4_RANKS): [str(torch.float64)]},
                train_stage_sizes=None)


def _save(tmp, name, obj):
    import pickle
    with open(os.path.join(tmp, name + '.pkl'), 'wb') as f:
        pickle.dump(obj, f)


def _load(tmp, name):
    import pickle
    with open(os.path.join(tmp, name + '.pkl'), 'rb') as f:
        return pickle.load(f)


class _WorldWatch:
    """While entered, on one rank: every mesh that parallel/mesh.make_mesh
    builds, and the collectives parallel/mesh.py stages through host
    memory (those its _staged finds on a gloo group)."""

    def __enter__(self):
        from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
        self.pmesh, self.meshes, self.staged = pmesh, [], 0
        self.saved = pmesh.make_mesh, pmesh._staged
        make, staged = self.saved

        def watched_make(*args, **kwargs):
            mesh = make(*args, **kwargs)
            self.meshes.append(mesh)
            return mesh

        def watched_staged(group, x):
            s = staged(group, x)
            self.staged += s
            return s

        pmesh.make_mesh, pmesh._staged = watched_make, watched_staged
        return self

    def __exit__(self, *exc):
        self.pmesh.make_mesh, self.pmesh._staged = self.saved

    def report(self, dev):
        """This rank's card, the backends of every axis group of the
        meshes built, and the staged collectives' count."""
        import torch.distributed as dist
        backends = {}
        for mesh in self.meshes:
            for axis in mesh.mesh_dim_names:
                backends.setdefault(axis, set()).add(
                    dist.get_backend(mesh.get_group(axis)))
        return dict(device=(torch.cuda.current_device()
                            if dev.type == 'cuda' else None),
                    backends={k: sorted(v) for k, v in backends.items()},
                    staged_collectives=self.staged)


def _mesh_world(rank, n, tmp, backend, plan, parts):
    """One rank of a mesh world: each of ``parts`` in turn, its results
    saved as ``{backend}_r{rank}`` with the rank's _WorldWatch report
    under 'world' and the bytes it had allocated on its card before each
    part under 'allocated_before'. Over gloo every rank sits on card 0; over NCCL rank r
    on card r. A rank's exception ends the spawn with it, and chip_smoke
    with a non-zero code: the group is destroyed only after success,
    because destroying it while peers wait in a collective can block
    (NCCL), and the spawn ends the other ranks only once this one has
    exited."""
    import datetime

    import torch.distributed as dist
    dev = torch.device(plan['dev'])
    if dev.type == 'cuda':
        card = rank if backend == 'nccl' else 0
        torch.cuda.set_device(card)
        dev = torch.device('cuda', card)
    dist.init_process_group(
        backend, init_method='file://' + os.path.join(tmp, 'init_'
                                                      + backend),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out, held = {}, {}
    with _WorldWatch() as watch:
        for p in parts:
            # What this rank still holds on its card from earlier parts.
            held[p] = (torch.cuda.memory_allocated() if dev.type == 'cuda'
                       else None)
            out[p] = globals()['_mesh_' + p](rank, n, tmp, plan, dev)
    out['world'] = watch.report(dev)
    out['allocated_before'] = held
    _save(tmp, f'{backend}_r{rank}', out)
    dist.destroy_process_group()


def _spawn_world(n, backend, tmp, plan, parts):
    import torch.multiprocessing as mp
    mp.spawn(_mesh_world, args=(n, tmp, backend, plan, parts), nprocs=n,
             join=True)
    return [_load(tmp, f'{backend}_r{r}') for r in range(n)]


class _Spans:
    """Wall time of each phase of the tile rasters of rank 0 (the engine's
    ``mark`` hook), with a synchronize at each boundary, so device work
    and the host's gloo staging both count."""

    def __init__(self, dev):
        self.dev, self.t, self.calls = dev, None, 0
        self.total, self.each = {}, []

    def mark(self, name):
        _sync(self.dev)
        now = time.perf_counter()
        if name == 'start':
            self.calls += 1
            self.each.append({})
        else:
            self.total[name] = self.total.get(name, 0.0) + now - self.t
            self.each[-1][name] = now - self.t
        self.t = now

    def ms_per_raster(self):
        return {k: v * 1e3 / max(self.calls, 1)
                for k, v in self.total.items()}

    def median_ms_per_raster(self):
        """The median raster's ms by phase (the mean carries each new
        group's first collective, which sets up its communicator)."""
        return {k: statistics.median(e[k] for e in self.each if k in e) * 1e3
                for k in self.total}


def _capture_stripe(store):
    """sort_raster's segmented_stats namespace with segmented_stats_words
    keeping its first call's inputs (one stripe's sorted rows)."""
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss

    def capture(c2, w1, w2, num_groups, med_nsplit, hist_medians=True):
        if not store:
            store.extend((c2, w1, w2, num_groups))
        return ss.segmented_stats_words(c2, w1, w2, num_groups,
                                        med_nsplit=med_nsplit,
                                        hist_medians=hist_medians)
    return types.SimpleNamespace(**{**vars(ss),
                                    'segmented_stats_words': capture})


class _KeepFirstParams:
    """An engine that keeps its first call's parameters in ``store`` and
    calls ``on_call`` (if given) before each call; everything else is the
    engine's."""

    def __init__(self, engine, store, on_call=None):
        self.engine, self.store, self.on_call = engine, store, on_call

    def __call__(self, points, valid, fids, inst_dyn, params, gen_future):
        if self.on_call is not None:
            self.on_call()
        if not self.store:
            self.store.append(params)
        return self.engine(points, valid, fids, inst_dyn, params,
                           gen_future)

    def __getattr__(self, name):
        return getattr(self.engine, name)


def _time_shard(client, dev, first=None, live=None):
    """Time each ``client.shard`` (the scatter of the flat rows from rank
    0, synchronized) into the returned list; ``first`` keeps a copy of
    the first call's rows; ``live`` gets each call's live rows per rank
    (shard_points_to_mesh deals row r to rank r % n)."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    shard, times = client.shard, []
    n = pmesh.axis_size(client.mesh, client.axis)

    def timed(points, valid, fids, inst_dyn):
        if first is not None and not first:
            first.extend(t.clone() for t in (points, valid, fids, inst_dyn))
        if live is not None:
            live.append(valid.reshape(-1, n).sum(0).tolist())
        _sync(dev)
        ts = time.perf_counter()
        shard(points, valid, fids, inst_dyn)
        _sync(dev)
        times.append(time.perf_counter() - ts)

    client.shard = timed
    return times


def _tile_numbers(engine):
    return dict(route_peak_rows=engine.route_peak_rows,
                route_cap=engine.route_cap,
                dest_cap_factor=engine.dest_cap_factor)


def _mesh_runner(rank, n, tmp, plan, dev):
    """The KITTI-360 runner's sampling_loop at run()'s defaults on a
    (1, n) mesh: rank 0 integrates, samples and writes to tmp/mesh_runner,
    the other ranks serve its tile rasters. Then every rank runs the psum
    engine on rank 0's first raster input, which rank 0 holds to the
    one-device raster."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.ops import sort_raster
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    from pc_accumulation_lib_tpu_torch.utils.profiling import PhaseTimer
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh((1, n), device_type=dev.type)
    bev = dict(kr.DEFAULT_BEV_PARAMS)
    out, first, first_params, stripe = {}, [], [], []
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    sort_raster.segmented_stats = _capture_stripe(stripe)
    try:
        if sharded.is_controller(mesh):
            stream = SyntheticKitti360Stream(n_frames=plan['runner_frames'],
                                             **plan['stream'])
            accum = _runner_accum(dev, SemSegTorch(dev, seed=0,
                                                   **plan['semseg']),
                                  plan['stream'], dict(bev, mesh=mesh),
                                  use_gt_sem=False, **plan['runner_accum'])
            client = accum.sem_bev_generator.mesh_raster
            engine = client.raster
            spans = _Spans(dev)
            engine.mark = spans.mark
            # frames: (start of its integrate, frames it evicted) per
            # frame; sampled: the frame of each raster (one per sample).
            frames, sampled = [], []
            integrate = accum.integrate

            def timed_integrate(observations):
                t = time.perf_counter()
                removed = integrate(observations)
                frames.append((t, removed))
                return removed

            accum.integrate = timed_integrate
            client.raster = _KeepFirstParams(
                engine, first_params,
                on_call=lambda: sampled.append(len(frames) - 1))
            scatter_s = _time_shard(client, dev, first)
            timer = PhaseTimer()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    stats = kr.sampling_loop(
                        accum, stream,
                        plan['sampling'] or cfg.SamplingConfig(),
                        cfg.OutputConfig(os.path.join(tmp, 'mesh_runner'),
                                         viz_to_disk=False), timer=timer)
                _sync(dev)
            finally:
                accum.sem_bev_generator.close()
                sharded.shutdown_mesh_workers(mesh)
                del accum.integrate
            t_end = time.perf_counter()
            # Steady state as runner_path takes it: from the first frame
            # whose integrate evicts to the end of the loop.
            full = next((i for i, (_, removed) in enumerate(frames)
                         if removed), None)
            if full is not None:
                steady_n = sum(f >= full for f in sampled)
                steady_s = t_end - frames[full][0]
                out.update(first_evicting_frame=full,
                           steady_samples=steady_n, steady_s=steady_s,
                           samples_per_s_steady=steady_n / steady_s)
            out.update(stats, raster_ms=spans.ms_per_raster(),
                       raster_median_ms=spans.median_ms_per_raster(),
                       rows_per_raster=accum.state.valid.numel(),
                       scatter_ms_per_sample=(
                           sum(scatter_s) * 1e3 / max(stats['bevs'], 1)),
                       generate_bev_ms_per_sample=(
                           timer.totals['generate_bev'] * 1e3
                           / max(stats['bevs'], 1)),
                       integrate_ms_per_frame=(
                           timer.totals['integrate'] * 1e3
                           / stats['frames']), **_tile_numbers(engine))
            del accum
        else:
            sharded.serve_mesh_rasters(mesh)
    finally:
        sort_raster.segmented_stats = ss
    _sync(dev)
    out['launches'] = ss.segmented_stats_words.launches
    if dev.type == 'cuda':
        out['max_memory_allocated_bytes'] = torch.cuda.max_memory_allocated()
    out['loop_s'] = time.perf_counter() - t0
    if dev.type == 'cuda':
        c2, w1, w2, G = stripe
        out['stripe_kernel'] = dict(max_abs_err=_compare(ss, c2, w1, w2, G),
                                    **_shape(c2, G))
    # Kernel 1's device time and bound, and its plain version's time, on
    # rank 0's stripe, once every rank's compare has left the card.
    torch.distributed.barrier()
    if dev.type == 'cuda' and rank == 0:
        out['stripe_kernel'].update(
            timing=_time_words(ss, c2, w1, w2, G),
            plain_ms=_median_ms(lambda: ss.segmented_stats_words_reference(
                c2, w1, w2, G, med_nsplit=2), reps=3))
    del stripe
    # The psum engine on rank 0's first raster input: the full rows
    # (points, valid, frame ids, inst_dyn) and the parameters.
    is0 = pmesh.axis_rank(mesh, 'points') == 0
    sp = sharded.shard_points_to_mesh(mesh, *(first[:3] if is0
                                              else (None,) * 3))
    inst, vec = pmesh.broadcast_object(
        (first[3].cpu().numpy(), first_params[0].cpu().numpy()) if is0
        else None,
        mesh, 'points')
    inst = torch.as_tensor(inst, device=dev)
    vec = torch.as_tensor(vec, device=dev)
    psum = sharded.make_sharded_raster_fn(
        mesh, bev['view_size'], bev['pixel_size'], cfg.DEFAULT_SEM_IDXS,
        bev['int_scaler'], bev['int_sep_scaler'], bev['int_mid_threshold'])
    got = psum(*sp, inst, vec, True)
    if is0:
        one = core.make_raster_fn(
            bev['view_size'], bev['pixel_size'], cfg.DEFAULT_SEM_IDXS,
            bev['int_scaler'], bev['int_sep_scaler'],
            bev['int_mid_threshold'])
        want = one(first[0], first[1], first[2], inst, vec, True)
        out['psum_vs_one_device_max_abs'] = float(
            (got.float() - want.float()).abs().max())
        check(out['psum_vs_one_device_max_abs'] <= SELFTEST_ATOL,
              out['psum_vs_one_device_max_abs'])
    out['seconds'] = time.perf_counter() - t0
    return out


def _mesh_step(rank, n, tmp, plan, dev):
    """main_path's drive on a (1, n) mesh: step(bev_num=16) for 9 steps at
    the bench configuration, rank 0 integrating and rastering through the
    tile engine (the flat rows scattered once per step), the others
    serving. Rank 0 saves the samples' maps as mesh_step_bevs."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh((1, n), device_type=dev.type)
    out = {}
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ss.segmented_stats_words.launches = 0
    if sharded.is_controller(mesh):
        try:
            stream = SyntheticKitti360Stream(n_frames=plan['steps'] + 1,
                                             **plan['stream'])
            frames = [stream.frame(i) for i in range(plan['steps'] + 1)]
            accum = _make_accum(dev, SemSegTorch(dev, seed=0,
                                                 **plan['semseg']),
                                plan['stream'], plan['accum'], plan['icp'],
                                plan['horizon'],
                                dict(plan['bev'], mesh=mesh),
                                use_gt_sem=False)
            engine = accum.sem_bev_generator.mesh_raster.raster
            spans = _Spans(dev)
            engine.mark = spans.mark
            live = []
            scatter_s = _time_shard(accum.sem_bev_generator.mesh_raster, dev,
                                    live=live)
            accum.integrate([frames[0]])
            step_s, bevs = [], []
            try:
                for f in frames[1:]:
                    ts = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        got = accum.step([f], bev_num=plan['bev_num'],
                                         gen_future=True)
                    _sync(dev)
                    step_s.append(time.perf_counter() - ts)
                    bevs.append([{k: v for k, v in b.items()
                                  if not k.startswith('trajs')}
                                 for b in got])
            finally:
                accum.sem_bev_generator.close()
            _save(tmp, 'mesh_step_bevs', bevs)
            steady = statistics.median(step_s[1:])
            out.update(step_s=step_s, median_step_s=steady,
                       samples_per_s=plan['bev_num'] / steady,
                       raster_ms=spans.ms_per_raster(),
                       raster_median_ms=spans.median_ms_per_raster(),
                       scatter_ms_per_step=statistics.median(scatter_s) * 1e3,
                       max_live_rows=accum.max_live_rows,
                       live_rows_per_rank_by_step=live,
                       **_tile_numbers(engine))
        finally:
            sharded.shutdown_mesh_workers(mesh)
    else:
        sharded.serve_mesh_rasters(mesh)
    _sync(dev)
    out['launches'] = ss.segmented_stats_words.launches
    if dev.type == 'cuda':
        out['max_memory_allocated_bytes'] = torch.cuda.max_memory_allocated()
    out['seconds'] = time.perf_counter() - t0
    return out


def _mesh_sparse(rank, n, tmp, plan, dev):
    """sparse_step_path's accumulator on a (1, n) mesh: the sparse fetch
    through the tile engine's group (one request to the workers per fetch
    group of 4), MESH_SPARSE_STEPS step(bev_num=16) calls, rank 0
    integrating. Rank 0 times each group request (synchronized) and saves
    each sample's used bytes, step by step, as mesh_sparse_rows."""
    from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
        SyntheticKitti360Stream)
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh((1, n), device_type=dev.type)
    out = {}
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    ss.segmented_stats_words.launches = 0
    if sharded.is_controller(mesh):
        try:
            # sparse_step_path's stream (its length shapes the world),
            # its first frames.
            k = plan['sparse_steps']
            stream = SyntheticKitti360Stream(n_frames=plan['steps'] + 2,
                                             **plan['stream'])
            frames = [stream.frame(i) for i in range(k + 1)]
            accum = _make_accum(dev, SemSegTorch(dev, seed=0,
                                                 **plan['semseg']),
                                plan['stream'], plan['sparse_accum'],
                                plan['icp'], plan['horizon'],
                                dict(plan['sparse_bev'], mesh=mesh),
                                use_gt_sem=False)
            client = accum.sem_bev_generator.mesh_raster
            group, rows, group_ms = client.group, [], []

            def timed_group(pose_vec, aug9s, gen_future):
                _sync(dev)
                ts = time.perf_counter()
                sp, dn = group(pose_vec, aug9s, gen_future)
                _sync(dev)
                group_ms.append((time.perf_counter() - ts) * 1e3)
                rows[-1] += _used_rows(sp, plan['sparse_bev']['pixel_size'])
                return sp, dn

            client.group = timed_group
            accum.integrate([frames[0]])
            try:
                for f in frames[1:]:
                    rows.append([])
                    with contextlib.redirect_stdout(io.StringIO()):
                        accum.step([f], bev_num=plan['bev_num'],
                                   gen_future=True)
            finally:
                accum.sem_bev_generator.close()
            _save(tmp, 'mesh_sparse_rows', rows)
            out.update(group_ms=group_ms,
                       median_group_ms=statistics.median(group_ms),
                       rungs_used={str(r): c for r, c in
                                   accum.rungs_used.items()})
        finally:
            sharded.shutdown_mesh_workers(mesh)
    else:
        sharded.serve_mesh_rasters(mesh)
    _sync(dev)
    out['launches'] = ss.segmented_stats_words.launches
    out['seconds'] = time.perf_counter() - t0
    return out


class _AxisBytes:
    """While entered: the bytes of the results of parallel/mesh.py's
    psum, all_gather and broadcast over one mesh axis on this rank (a
    psum's or a broadcast's tensor, an all_gather's n slices), by
    collective, and their calls; with ``timed``, also CUDA events on the
    current stream around each call (take_ms)."""

    NAMES = ('psum', 'all_gather', 'broadcast')

    def __init__(self, axis, timed=False):
        from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
        self.pmesh, self.axis, self.timed = pmesh, axis, timed
        self.bytes = dict.fromkeys(self.NAMES, 0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.events = {name: [] for name in self.NAMES}
        self.saved = {}

    def __enter__(self):
        for name in self.NAMES:
            self.saved[name] = getattr(self.pmesh, name)
            setattr(self.pmesh, name, self._counted(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.pmesh, name, fn)

    def _counted(self, name, fn):
        def counted(x, mesh, axis, *args, **kwargs):
            timed = self.timed and axis == self.axis
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out = fn(x, mesh, axis, *args, **kwargs)
            if axis == self.axis:
                self.bytes[name] += out.numel() * out.element_size()
                self.calls[name] += 1
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events[name].append((start, end))
            return out
        return counted

    def snapshot(self):
        return dict(self.bytes), dict(self.calls)

    def take_ms(self):
        """Milliseconds by collective since the last take (synchronizes)."""
        torch.cuda.synchronize()
        ms = {name: sum(a.elapsed_time(b) for a, b in pairs)
              for name, pairs in self.events.items()}
        for pairs in self.events.values():
            pairs.clear()
        return ms


def _forward_in(dtype):
    """ResNet50DilatedFCN.forward with its input and logits in ``dtype``
    where the model casts them to float32, as the JAX model does: a
    float64 run then differs from another by float64 rounding only (with
    float32 logits its losses drift apart through Adam, and at step 3
    reached 1.08 of their limit on an NVIDIA H100 80GB HBM3 at 700 W)."""
    def forward(model, images):
        x = (images.to(dtype) / 255.0 - model.mean) / model.std
        ax = model.model_axis
        logits = model.decode_head(model.backbone(x.permute(0, 3, 1, 2), ax),
                                   ax).to(dtype)
        logits = torch.nn.functional.interpolate(
            logits, size=images.shape[1:3], mode='bilinear',
            align_corners=False)
        return logits.permute(0, 2, 3, 1)
    return forward


def _training_probe(make_setup, rec, dev, dtype, axis_bytes=None):
    """A make_train_setup whose model, convolutions, logits and optimizer
    are in ``dtype`` and whose steps record their time and, after step 1, the
    gradients and the batch-norm running statistics on the host (full
    tensors: a model cut over 'model' gathers them), the parameters on
    this rank and their bytes with their gradients and Adam moments; with
    ``axis_bytes`` (an entered _AxisBytes) also each step's collective
    bytes and calls on its axis."""
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.models.resnet_semseg import _Conv
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh

    def setup(*args, **kwargs):
        kwargs['compute_dtype'] = dtype
        mesh = kwargs.get('mesh')
        rec['layout'] = None if mesh is None else (
            pmesh.axis_size(mesh, 'data'), pmesh.axis_size(mesh, 'model'))
        state, train_step = make_setup(*args, **kwargs)
        state.model.to(dtype)
        for m in state.model.modules():
            if isinstance(m, _Conv):   # the classifier's float32 included
                m.compute_dtype = dtype
        if dtype != torch.float32:
            state.model.forward = types.MethodType(_forward_in(dtype),
                                                   state.model)
        state = state._replace(optimizer=type(state.optimizer)(
            state.model.parameters(), **state.optimizer.defaults))

        def step(state, images, labels):
            before = axis_bytes and axis_bytes.snapshot()
            ts = time.perf_counter()
            state, loss = train_step(state, images, labels)
            _sync(dev)
            rec.setdefault('step_s', []).append(time.perf_counter() - ts)
            if axis_bytes:
                after = axis_bytes.snapshot()
                rec.setdefault('axis_bytes', []).append(
                    {k: after[0][k] - before[0][k] for k in after[0]})
                rec.setdefault('axis_calls', []).append(
                    {k: after[1][k] - before[1][k] for k in after[1]})
                if axis_bytes.timed:
                    rec.setdefault('axis_ms', []).append(
                        axis_bytes.take_ms())
            if 'grads' not in rec:
                model = state.model
                params = list(model.parameters())
                adam = [t for p in params
                        for t in state.optimizer.state[p].values()
                        if t.dim()]
                rec['params'] = sum(p.numel() for p in params)
                rec['param_grad_adam_bytes'] = sum(
                    t.numel() * t.element_size()
                    for t in params + [p.grad for p in params] + adam)
                rec['grads'] = _host(train_mod.gather_named(model, {
                    k: p.grad for k, p in model.named_parameters()}))
                rec['stats'] = _host(train_mod.gather_named(model, {
                    k: v for k, v in model.state_dict().items()
                    if 'running' in k}))
            return state, loss
        return state, step
    return setup


def _host(named):
    return {k: v.detach().cpu().numpy().copy() for k, v in named.items()}


def train_run(shard_glob, plan, dev, ckpt_dir, dtype, dp=None,
              batch=None, axis_bytes=None):
    """train_semseg.run over this process's world (one card without a
    process group) in ``dtype`` with TF32 off, for the plan's float64 or
    float32 step count, at ``dp`` (None: the runner's default layout) and
    the global ``batch`` (the plan's by default); returns the probe's
    record with the losses."""
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.runners import train_semseg
    rec = {}
    make_setup = train_mod.make_train_setup
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    train_mod.make_train_setup = _training_probe(make_setup, rec, dev,
                                                 dtype, axis_bytes)
    try:
        _, losses = train_semseg.run(
            shard_glob, steps=plan['train_steps'][str(dtype)],
            batch_size=batch or plan['train_batch'], ckpt_dir=ckpt_dir,
            ckpt_every=0, dp=dp, stage_sizes=plan['train_stage_sizes'],
            log_every=TRAIN_MESH_STEPS, device=dev)
    finally:
        train_mod.make_train_setup = make_setup
        torch.backends.cudnn.allow_tf32 = tf32
    rec['losses'] = losses
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    return rec


def _peak_train_run(shard_glob, plan, dev, ckpt_dir, dtype, **kwargs):
    """train_run with the card's peak memory over the run in its record
    (None on the CPU)."""
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rec = train_run(shard_glob, plan, dev, ckpt_dir, dtype, **kwargs)
    rec['max_memory_allocated_bytes'] = (
        torch.cuda.max_memory_allocated() if dev.type == 'cuda' else None)
    return rec


def _mesh_train(rank, n, tmp, plan, dev):
    """train_semseg.run data-parallel over the world (batch 8, 4 per
    rank), in float64 then float32; rank 0 saves the records as
    mesh_train."""
    t0 = time.perf_counter()
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    recs = {str(dt): train_run(os.path.join(tmp, 'train', 'shard*.npz'),
                               plan, dev, os.path.join(tmp, 'ckpt_mesh'),
                               dt, dp=n)
            for dt in (torch.float64, torch.float32)}
    if rank == 0:
        _save(tmp, 'mesh_train', recs)
    rec = recs[str(torch.float32)]
    out = dict(losses=rec['losses'], step_s=rec['step_s'])
    if dev.type == 'cuda':
        out['max_memory_allocated_bytes'] = torch.cuda.max_memory_allocated()
    out['seconds'] = time.perf_counter() - t0
    return out


def _mesh_train_tp(rank, n, tmp, plan, dev):
    """train_semseg.run at the runner's default layout over the world
    ((1, 2) on 2 ranks, (2, 2) on 4), global batch TRAIN_TP_BATCH, in the
    plan's dtypes for this world (float64 held, float32 timed); each
    step's model-axis collective bytes counted. Rank 0 saves the records
    as mesh_train_tp{n}; every rank returns its layout, its parameters,
    their bytes with gradients and Adam moments, its peak per dtype and
    times."""
    t0 = time.perf_counter()
    recs = {}
    timed = plan.get('axis_ms', False) and dev.type == 'cuda'
    with _AxisBytes('model', timed) as axis_bytes:
        for name in plan['train_tp_dtypes'][str(n)]:
            recs[name] = _peak_train_run(
                os.path.join(tmp, 'train', 'shard*.npz'), plan, dev,
                os.path.join(tmp, f'ckpt_tp{n}'),
                getattr(torch, name.split('.')[-1]),
                batch=plan['train_tp_batch'], axis_bytes=axis_bytes)
    if rank == 0:
        _save(tmp, f'mesh_train_tp{n}', recs)
    return {name: dict(layout=rec['layout'], params=rec['params'],
                       param_grad_adam_bytes=rec['param_grad_adam_bytes'],
                       step_s=rec['step_s'], losses=rec['losses'],
                       axis_bytes=rec['axis_bytes'],
                       axis_calls=rec['axis_calls'],
                       axis_ms=rec.get('axis_ms'),
                       max_memory_allocated_bytes=rec[
                           'max_memory_allocated_bytes'])
            for name, rec in recs.items()} | {
                'seconds': time.perf_counter() - t0}


def _dense_stage(params, x):
    return torch.tanh(x @ params['w'] + params['b'])


def _pipe_params(S, d, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [{'w': (torch.randn(d, d, generator=g) * 0.5).to(dev),
             'b': torch.zeros(d).to(dev)} for _ in range(S)]


def _mesh_gpipe(rank, n, tmp, plan, dev):
    """GPipe on a pp = n mesh at tests/test_pipeline.py's shapes: the
    forward for M = 2, 4, 5 microbatches and the stage gradients against
    the sequential stack on this card."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import pipeline as pp
    mesh = pp.make_pipeline_mesh(n, dev.type)
    g = torch.Generator().manual_seed(1)
    fwd = []
    per_stage = _pipe_params(n, PIPE['d'], dev, 0)
    mine = pp.place_stage_params(pp.stack_stage_params(per_stage), mesh)
    run = pp.gpipe_apply(_dense_stage, mesh)
    for M in PIPE['micro']:
        xs = torch.randn(M, PIPE['mb'], PIPE['d'], generator=g).to(dev)
        want = xs
        for p in per_stage:
            want = _dense_stage(p, want)
        fwd.append(float((run(mine, xs) - want).abs().max()))
    per_stage = _pipe_params(n, PIPE['grad_d'], dev, 2)
    mine = {k: v.requires_grad_() for k, v in pp.place_stage_params(
        pp.stack_stage_params(per_stage), mesh).items()}
    shape = (PIPE['grad_micro'], PIPE['grad_mb'], PIPE['grad_d'])
    xs = torch.randn(*shape, generator=g).to(dev)
    tgt = torch.randn(*shape, generator=g).to(dev)
    torch.mean((run(mine, xs) - tgt) ** 2).backward()
    seq = [{k: v.clone().requires_grad_() for k, v in p.items()}
           for p in per_stage]
    y = xs
    for p in seq:
        y = _dense_stage(p, y)
    torch.mean((y - tgt) ** 2).backward()
    s = pmesh.axis_rank(mesh, 'pp')
    grad = max(float((mine[k].grad - seq[s][k].grad).abs().max())
               for k in mine)
    check(max(fwd) <= PIPE_ATOL and grad <= PIPE_ATOL, (fwd, grad))
    return dict(forward_max_abs=fwd, grad_max_abs=grad)


def _mesh_nccl_raster(rank, n, tmp, plan, dev):
    """One tile raster at the runner's width on a 1-rank NCCL mesh: the
    runner's 256 x 131,072 made-up rows over its 80 m / 256 px BEV,
    against the one-device raster."""
    from pc_accumulation_lib_tpu_torch import config as cfg
    from pc_accumulation_lib_tpu_torch.bev import core
    from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import sharded
    from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as kr
    t0 = time.perf_counter()
    bev = kr.DEFAULT_BEV_PARAMS
    a = plan['runner_accum'].get('accum_cfg') or cfg.AccumConfig()
    m = a.max_frames * a.painted_cap
    g = torch.Generator(device=dev).manual_seed(0)
    pts = torch.zeros((m, cfg.PT_DIM), device=dev)
    pts[:, :2] = (torch.rand((m, 2), generator=g, device=dev) - 0.5) * 80
    pts[:, 2] = torch.rand(m, generator=g, device=dev) * 4 - 2
    pts[:, 3] = torch.rand(m, generator=g, device=dev)
    pts[:, 4:7] = torch.randint(0, 256, (m, 3), generator=g, device=dev)
    pts[:, 7] = torch.randint(0, 19, (m,), generator=g, device=dev)
    valid = torch.rand(m, generator=g, device=dev) > 0.1
    fids = torch.randint(0, 10, (m,), generator=g, device=dev,
                         dtype=torch.int32)
    inst = torch.zeros(4, device=dev)
    params = core.identity_params(window=(0, 9), present_frame=5)
    mesh = pmesh.make_mesh((1, n), device_type=dev.type)
    tile = sharded.make_tile_sharded_raster_fn(
        mesh, bev['view_size'], bev['pixel_size'], cfg.DEFAULT_SEM_IDXS,
        bev['int_scaler'], bev['int_sep_scaler'], bev['int_mid_threshold'])
    ss.segmented_stats_words.launches = 0
    got = tile(pts, valid, fids, inst, params, True)
    tile.drain()
    _sync(dev)
    launches = ss.segmented_stats_words.launches
    one = core.make_raster_fn(
        bev['view_size'], bev['pixel_size'], cfg.DEFAULT_SEM_IDXS,
        bev['int_scaler'], bev['int_sep_scaler'], bev['int_mid_threshold'])
    want = one(pts, valid, fids, inst, torch.as_tensor(params.pack(),
                                                       device=dev), True)
    err = float((got.float() - want.float()).abs().max())
    check(launches == (dev.type == 'cuda') and err <= SELFTEST_ATOL,
          (launches, err))
    return dict(rows=m, launches=launches, max_abs_vs_one_device=err,
                seconds=time.perf_counter() - t0, **_tile_numbers(tile))


def _mesh_nccl_train(rank, n, tmp, plan, dev):
    """One data-parallel train step of SMALL_TRAIN's model on a (1, 1)
    NCCL mesh against the one-device step from the same seed and batch;
    the mesh step's collectives over 'data' are counted, and must hold
    each batch norm's statistics and the gradients."""
    import torch.distributed as dist

    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.models.resnet_semseg import _BN
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    c = SMALL_TRAIN
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 256, (c['batch'], *c['hw'], 3)),
                             dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, 19, (c['batch'], *c['hw'])),
                             device=dev)
    losses = []
    mesh = pmesh.make_mesh((n, 1), ('data', 'model'), dev.type)
    backend = dist.get_backend(mesh.get_group('data'))
    check(backend == ('nccl' if dev.type == 'cuda' else 'gloo'), backend)
    for m in (mesh, None):
        state, step = train_mod.make_train_setup(
            lr=c['lr'], seed=0, stage_sizes=c['stage_sizes'],
            compute_dtype=torch.float32, device=dev, mesh=m)
        with _AxisBytes('data') as axis_bytes:
            losses.append(float(step(state, images, labels)[1]))
        if m is mesh:
            psum_bytes, calls = (d['psum'] for d in axis_bytes.snapshot())
            n_bn = sum(isinstance(x, _BN) for x in state.model.modules())
            grad_bytes = sum(p.numel() * p.element_size()
                             for p in state.model.parameters())
    # Per batch norm two psums forward and two backward; the valid
    # count's; the gradients' and the loss's in one.
    check(calls == 4 * n_bn + 2 and psum_bytes > grad_bytes,
          (calls, n_bn, psum_bytes, grad_bytes))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    check(rel <= 1e-5, losses)
    return dict(loss_mesh=losses[0], loss_one_device=losses[1],
                rel_err=rel, backend=backend, data_psums=calls,
                data_psum_bytes=psum_bytes)


def _exact_and_close(a, b):
    """Two sample sets with the same files and keys: road, dynamic, rgb
    and elevation maps equal, every map within SELFTEST_ATOL; returns the
    largest difference."""
    check(sorted(a) == sorted(b), (sorted(a), sorted(b)))
    err = 0.0
    for f, sa in a.items():
        sb = b[f]
        check(set(sa) == set(sb), f)
        for k in sa:
            if k.startswith('trajs'):
                check(len(sa[k]) == len(sb[k]), (f, k))
                continue
            if not k.startswith('intensity'):
                check(np.array_equal(sa[k], sb[k]), (f, k, 'not exact'))
            err = max(err, float(np.abs(sa[k].astype(np.float32)
                                        - sb[k].astype(np.float32)).max()))
    check(err <= SELFTEST_ATOL, err)
    return err


def _step_mismatch(a, b):
    """Largest cell-mismatch fraction at MAP_ATOL over two step runs'
    samples (the step() rule), and the largest difference."""
    check(len(a) == len(b), (len(a), len(b)))
    mism, err = 0.0, 0.0
    for sa, sb in zip((s for step in a for s in step),
                      (s for step in b for s in step)):
        check(set(sa) == set(sb), sorted(sa))
        for k in sa:
            d = np.abs(sa[k].astype(np.float32) - sb[k].astype(np.float32))
            mism = max(mism, float(np.mean(d > MAP_ATOL)))
            err = max(err, float(d.max()))
    check(mism < MAP_MISMATCH, mism)
    return mism, err


def _train_held(dp, one):
    """The data-parallel run against the one-card run under the CPU
    tests' tolerances (SMALL_TRAIN's comment), each error as a ratio to
    its limit (<= 1 passes), and the three tensors farthest off."""
    dl, ol = np.array(dp['losses']), np.array(one['losses'])
    check(np.isfinite(dl).all() and np.isfinite(ol).all(), (dl, ol))
    check(set(dp['grads']) == set(one['grads']), 'gradient names differ')
    grads = {k: _rel_err(dp['grads'][k], g, 1e-4,
                         GRAD_FLOOR * np.abs(g).max())
             for k, g in one['grads'].items()}
    return dict(
        step1_loss=_rel_err(dl[0], ol[0], 1e-5, 0.0),
        losses=_rel_err(dl, ol, 1e-4, 0.0),
        gradients=max(grads.values()),
        running_stats=max(_rel_err(dp['stats'][k], v, 1e-5,
                                   1e-5 * np.abs(v).max())
                          for k, v in one['stats'].items()),
        worst_gradients=sorted(grads, key=grads.get)[-3:])


def phase_mesh(dev, main_bevs, runner_samples, sparse_rows, plan=None):
    """The mesh paths on a world of MESH_RANKS ranks on this card (gloo):
    the KITTI-360 runner at run()'s defaults on runner_path's 120 frames,
    its samples held to runner_path's, file for file (road, dynamic, rgb
    and elevation exact, every map within 2e-3), and the psum engine on one of its
    raster inputs held to the one-device raster; step(bev_num=16) at the
    bench configuration for 9 steps, held to main_path's samples by the
    step() rule; train_semseg.run data-parallel at full width against a
    one-card run, in float64 (held) and float32 (timed; TRAIN_MESH_STEPS'
    comment); train_semseg.run at its default (1, 2) DP+TP layout against
    one-card runs of the same batch (train_tp_path, TRAIN_TP_BATCH's
    comment); GPipe on a pp = 2 mesh against the sequential stack; the
    sparse step() through the tile engine's group (mesh_sparse), its
    samples' used bytes equal to sparse_step_path's first steps'
    (``sparse_rows``) byte for byte. Returns the runner's, step()'s and
    the sparse step()'s kernel-1 launches per rank, the one-card
    TRAIN_TP_BATCH runs (float64, float32) that phase_mesh_step4 holds
    the (2, 2) layout to, and the one-card runs at the plan's batch
    (float64, float32) that phase_cards4 holds its layouts to."""
    plan = plan or _mesh_plan(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, 'train'))
        _train_shard(os.path.join(tmp, 'train', 'shard0.npz'),
                     plan['stream']['img_hw'])
        _sync(dev)
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        one = {str(dt): _peak_train_run(
            os.path.join(tmp, 'train', 'shard*.npz'), plan, dev,
            os.path.join(tmp, 'ckpt_one'), dt)
            for dt in (torch.float64, torch.float32)}
        one_tp = {str(dt): _peak_train_run(
            os.path.join(tmp, 'train', 'shard*.npz'), plan, dev,
            os.path.join(tmp, 'ckpt_one_tp'), dt,
            batch=plan['train_tp_batch'])
            for dt in (torch.float64, torch.float32)}
        ranks = _spawn_world(MESH_RANKS, 'gloo', tmp, plan,
                             ('runner', 'step', 'train', 'train_tp', 'gpipe',
                              'sparse'))
        mesh_samples = _read_samples(os.path.join(tmp, 'mesh_runner'))
        step_bevs = _load(tmp, 'mesh_step_bevs')
        mesh_rows = _load(tmp, 'mesh_sparse_rows')
        dp = _load(tmp, 'mesh_train')
        tp = _load(tmp, f'mesh_train_tp{MESH_RANKS}')
    runner = ranks[0]['runner']
    n = runner['bevs']
    check(n == len(runner_samples) and n > 0, (n, len(runner_samples)))
    launches = [r['runner']['launches'] for r in ranks]
    check(all(x == n for x in launches), ('runner launches', launches, n))
    runner_err = _exact_and_close(mesh_samples, runner_samples)
    step = ranks[0]['step']
    step_launches = [r['step']['launches'] for r in ranks]
    expect = plan['bev_num'] * plan['steps']
    check(all(x == expect for x in step_launches),
          ('step launches', step_launches))
    mism, step_err = _step_mismatch(step_bevs, main_bevs)
    emit('mesh_path', t0, ranks=MESH_RANKS, backend='gloo (CUDA tensors '
         'through host memory; both ranks share one card)',
         runner=dict(samples=n, launches_per_rank=launches,
                     vs_runner_path_max_abs=runner_err,
                     stripe_kernel=runner.get('stripe_kernel'),
                     psum_vs_one_device_max_abs=runner[
                         'psum_vs_one_device_max_abs'],
                     peak_bytes_per_rank=[
                         r['runner'].get('max_memory_allocated_bytes')
                         for r in ranks],
                     **{k: runner[k] for k in (
                         'raster_ms', 'scatter_ms_per_sample',
                         'generate_bev_ms_per_sample',
                         'integrate_ms_per_frame', 'rows_per_raster',
                         'route_peak_rows', 'route_cap', 'dest_cap_factor',
                         'loop_s')}),
         step=dict(launches_per_rank=step_launches,
                   vs_main_path_max_cell_mismatch_fraction=mism,
                   vs_main_path_max_abs=step_err,
                   peak_bytes_per_rank=[
                       r['step'].get('max_memory_allocated_bytes')
                       for r in ranks],
                   **{k: step[k] for k in (
                       'step_s', 'median_step_s', 'samples_per_s',
                       'raster_ms', 'scatter_ms_per_step', 'max_live_rows',
                       'route_peak_rows',
                       'route_cap', 'dest_cap_factor')}))
    _emit_train_dp('train_mesh_path', t0, MESH_RANKS, plan, dp, one, ranks,
                   'errors are ratios to their limit: <= 1 passes; held: '
                   'every float64 error, the float32 step-1 loss and running '
                   'statistics; TF32 off; two ranks share one card, so '
                   'images/s is not a scale-out figure')
    _emit_train_tp(t0, MESH_RANKS, plan, tp, one_tp, ranks)
    emit('gpipe', t0, stages=MESH_RANKS, atol=PIPE_ATOL,
         **{f'rank{r}': ranks[r]['gpipe'] for r in range(MESH_RANKS)})
    sparse_launches = _emit_mesh_sparse(
        'mesh_sparse', t0, MESH_RANKS, 'gloo (both ranks share one card)',
        plan, ranks, mesh_rows, sparse_rows)
    return launches, step_launches, sparse_launches, one_tp, one


def _emit_train_dp(phase, t0, n, plan, dp, one, ranks, note, **extra):
    """train_semseg.run data-parallel over n ranks against the one-card
    run of the same batch: every float64 error, the float32 step-1 loss
    and running statistics held by _train_held; times, images/s, peaks."""
    f64, f32 = str(torch.float64), str(torch.float32)
    held64 = _train_held(dp[f64], one[f64])
    held32 = _train_held(dp[f32], one[f32])
    median = statistics.median(dp[f32]['step_s'][1:])
    emit(phase, t0, ranks=n, hw=list(
        plan['stream']['img_hw']), global_batch=plan['train_batch'],
        steps=plan['train_steps'], float64=held64, float32=held32,
        losses={k: dict(mesh=dp[k]['losses'], one_card=one[k]['losses'])
                for k in (f64, f32)},
        note=note,
        step_s=dp[f32]['step_s'], one_card_step_s=one[f32]['step_s'],
        float64_step_s=dp[f64]['step_s'],
        one_card_float64_step_s=one[f64]['step_s'],
        images_per_s=plan['train_batch'] / median,
        one_card_images_per_s=(plan['train_batch']
                               / statistics.median(one[f32]['step_s'][1:])),
        peak_bytes_per_rank=[r['train'].get('max_memory_allocated_bytes')
                             for r in ranks], **extra)
    for name in ('step1_loss', 'losses', 'gradients', 'running_stats'):
        check(held64[name] <= 1.0, ('float64', name, held64[name]))
    for name in ('step1_loss', 'running_stats'):
        check(held32[name] <= 1.0, ('float32', name, held32[name]))


def _emit_mesh_sparse(phase, t0, n, backend, plan, ranks, mesh_rows,
                      sparse_rows, **extra):
    """The sparse step() through the tile engine's group on n ranks: the
    plan's kernel-1 launches on every rank, each sample's used bytes equal
    to sparse_step_path's first steps' (``sparse_rows``) byte for byte.
    Returns the launches per rank."""
    sparse = ranks[0]['sparse']
    sparse_launches = [r['sparse']['launches'] for r in ranks]
    expect = plan['bev_num'] * plan['sparse_steps']
    check(all(x == expect * (plan['dev'] != 'cpu')
              for x in sparse_launches),
          ('sparse launches', sparse_launches))
    check(len(mesh_rows) == plan['sparse_steps'], len(mesh_rows))
    for i, step_rows in enumerate(mesh_rows):
        check(len(step_rows) == len(sparse_rows[i]) == plan['bev_num'],
              (i, len(step_rows), len(sparse_rows[i])))
        for j, (a, b) in enumerate(zip(step_rows, sparse_rows[i])):
            check(a.tobytes() == b.tobytes(),
                  f'mesh sparse step {i} sample {j}: bytes differ')
    emit(phase, t0, ranks=n, backend=backend, steps=plan['sparse_steps'],
         launches_per_rank=sparse_launches,
         samples_byte_equal=expect,
         used_bytes_per_sample=float(np.mean(
             [r.size for step in mesh_rows for r in step])),
         world_seconds=sparse['seconds'],
         **{k: sparse[k] for k in ('group_ms', 'median_group_ms',
                                   'rungs_used')}, **extra)
    return sparse_launches


def _emit_train_tp(t0, n, plan, tp, one, ranks, phase=None, note=None,
                   **extra):
    """train_tp_path (n ranks, (1, 2) for 2) or train_tp4_path ((2, 2)),
    or ``phase`` with ``note``: the runner's default layout on every
    rank, TP_PARAMS_PER_RANK parameters on a (., 2) rank, the float64
    run held to the one-card float64 run by _train_held (and the float32
    step-1 loss and running statistics, where it ran); bytes, times and
    peaks per rank; where the model-axis collectives were timed, their
    ms per step on each rank and rank 0's bytes over them."""
    got = [r['train_tp'] for r in ranks]
    layout = (n // 2, 2)
    out = {}
    for name, rec in tp.items():
        per_rank = [g[name] for g in got]
        for g in per_rank:
            check(tuple(g['layout']) == layout, (name, g['layout'], layout))
            check(g['params'] == TP_PARAMS_PER_RANK, (name, g['params']))
        held = _train_held(rec, one[name])
        axis = per_rank[0]['axis_bytes']
        timed = {}
        if per_rank[0]['axis_ms'] is not None:
            ms = [[sum(step.values()) for step in g['axis_ms']]
                  for g in per_rank]
            timed = dict(
                model_axis_ms_per_step=ms,
                model_axis_gb_per_s_rank0=[
                    sum(b.values()) / t / 1e6 for b, t in zip(axis, ms[0])],
                images_per_s=[plan['train_tp_batch']
                              / statistics.median(g['step_s'][1:])
                              for g in per_rank],
                one_card_images_per_s=(
                    plan['train_tp_batch']
                    / statistics.median(one[name]['step_s'][1:])))
        out[name.split('.')[-1]] = dict(
            held=held, losses=dict(tp=rec['losses'], one_card=one[name][
                'losses']),
            step_s=[g['step_s'] for g in per_rank],
            one_card_step_s=one[name]['step_s'],
            params_per_rank=[g['params'] for g in per_rank],
            one_card_params=one[name]['params'],
            param_grad_adam_bytes_per_rank=[
                g['param_grad_adam_bytes'] for g in per_rank],
            one_card_param_grad_adam_bytes=one[name]['param_grad_adam_bytes'],
            peak_bytes_per_rank=[g['max_memory_allocated_bytes']
                                 for g in per_rank],
            one_card_peak_bytes=one[name]['max_memory_allocated_bytes'],
            model_axis_bytes_per_step=axis,
            model_axis_calls_per_step=per_rank[0]['axis_calls'], **timed)
        for key in (('step1_loss', 'losses', 'gradients', 'running_stats')
                    if name == str(torch.float64)
                    else ('step1_loss', 'running_stats')):
            check(held[key] <= 1.0, (name, key, held[key]))
    emit(phase or ('train_tp_path' if n == MESH_RANKS else 'train_tp4_path'),
         t0, ranks=n, layout=list(layout),
         hw=list(plan['stream']['img_hw']),
         global_batch=plan['train_tp_batch'], steps=plan['train_steps'],
         note=note or (
             'errors are ratios to their limit: <= 1 passes; held: every '
             'float64 error, the float32 step-1 loss and running '
             'statistics; TF32 off; the ranks share one card over gloo, '
             'every model-axis collective staged through host memory; '
             'model_axis_bytes: the results of each step\'s psums, '
             "all_gathers and broadcasts over 'model' on rank 0"), **out,
         **extra)


def phase_mesh_step4(dev, main_bevs, one_tp, plan=None):
    """main_path's step() drive on a (1, 4) mesh: 4 ranks on this card
    over gloo, rank 0 integrating, the tile engine's route calibrated on
    the first step's small window and then holding the grown ones (no
    TileRouteOverflow: the rows are dealt strided). Holds 144 kernel-1
    launches per rank and the samples to main_path's (road, dynamic, rgb
    and elevation exact, intensity within SELFTEST_ATOL); reports each
    rank's live rows per step and the route numbers. Then in the same
    world train_tp4_path: train_semseg.run at the runner's default (2, 2)
    layout, 3 float64 steps of TRAIN_TP_BATCH held to ``one_tp``'s
    one-card float64 run."""
    plan = plan or _mesh_plan(dev)
    t0 = time.perf_counter()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, 'train'))
        _train_shard(os.path.join(tmp, 'train', 'shard0.npz'),
                     plan['stream']['img_hw'])
        ranks = _spawn_world(MESH4_RANKS, 'gloo', tmp, plan,
                             ('step', 'train_tp'))
        bevs = _load(tmp, 'mesh_step_bevs')
        tp = _load(tmp, f'mesh_train_tp{MESH4_RANKS}')
    step = ranks[0]['step']
    launches = [r['step']['launches'] for r in ranks]
    expect = plan['bev_num'] * plan['steps']
    check(all(x == expect for x in launches), ('step launches', launches))
    flat = [{str(i): b for i, b in enumerate(s for st in run for s in st)}
            for run in (bevs, main_bevs)]
    err = _exact_and_close(*flat)
    emit('mesh_step4', t0, ranks=MESH4_RANKS, backend='gloo (4 ranks share '
         'one card)', launches_per_rank=launches,
         vs_main_path_max_abs=err,
         peak_bytes_per_rank=[r['step'].get('max_memory_allocated_bytes')
                              for r in ranks],
         **{k: step[k] for k in (
             'step_s', 'median_step_s', 'samples_per_s', 'raster_ms',
             'scatter_ms_per_step', 'max_live_rows',
             'live_rows_per_rank_by_step', 'route_peak_rows', 'route_cap',
             'dest_cap_factor')})
    _emit_train_tp(t0, MESH4_RANKS, plan, tp, one_tp, ranks)
    return launches


def phase_mesh_nccl(dev, plan=None):
    """The same mesh code on a 1-rank world over NCCL: one tile raster at
    the runner's width against the one-device raster, and one
    data-parallel train step against the one-device step. A world of one
    has no peer to wait for, so it runs in this process, last, which
    saves a spawned process's start-up."""
    plan = plan or _mesh_plan(dev)
    t0 = time.perf_counter()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    with tempfile.TemporaryDirectory() as tmp:
        _mesh_world(0, 1, tmp, backend, plan, ('nccl_raster', 'nccl_train'))
        r = _load(tmp, f'{backend}_r0')
    emit('mesh_nccl', t0, raster=r['nccl_raster'], train=r['nccl_train'])


# --- four cards of their own (NCCL) ------------------------------------
#
# With four cards visible, the mesh paths run again on a world of four
# ranks over NCCL, rank r on card r, at the one-card phases'
# configurations, held to those phases' outputs; then the trainer's CLI
# under torchrun. With fewer cards one line says so and nothing else
# changes.
CARDS4 = 4
CARDS4_NOTE = ('errors are ratios to their limit: <= 1 passes; held: every '
               'float64 error, the float32 step-1 loss and running '
               'statistics; TF32 off; over NCCL, rank r on card r')
TORCHRUN_STEPS = 3
TORCHRUN_TIMEOUT_S = 600


def _check_world(ranks, backend):
    """Every rank's _WorldWatch report: each axis group of every mesh on
    ``backend``, rank r on card r over NCCL, no collective staged through
    host memory. Returns the reports, by rank."""
    worlds = [r['world'] for r in ranks]
    for rank, w in enumerate(worlds):
        check(w['backends'] and all(b == [backend]
                                    for b in w['backends'].values()),
              (rank, w))
        check(w['staged_collectives'] == 0, (rank, w))
        if backend == 'nccl':
            check(w['device'] == rank, (rank, w))
    return dict(devices=[w['device'] for w in worlds],
                backends=[w['backends'] for w in worlds],
                staged_collectives=[w['staged_collectives'] for w in worlds])


def phase_cards4(dev, main_res, main_bevs, runner, runner_samples,
                 sparse_rows, one, plan=None):
    """The mesh on four ranks, one card each, over NCCL (gloo on the CPU,
    for a rehearsal): in one world, the KITTI-360 runner at run()'s
    defaults (``runner_samples`` equal file for file, kernel 1 exact on
    every rank's stripe), main_path's step() (``main_bevs`` equal), the
    sparse group (``sparse_rows`` byte-equal), train_semseg.run on (4, 1)
    and on (2, 2) at run()'s global batch held to the one-card runs
    ``one`` as _train_held holds them, GPipe at PIPE_ATOL; every group on
    every rank checked by _check_world. Then the trainer's CLI under
    torchrun (phase_torchrun_train). (dryrun_multichip(4) already ran
    over NCCL on cards 0-3: phase_dryrun.) Prints one skip
    line and returns None with fewer than four cards visible; else the
    kernel-1 launches per rank of the runner, step() and the sparse
    group."""
    visible = torch.cuda.device_count() if dev.type == 'cuda' else CARDS4
    if visible < CARDS4:
        print(json.dumps({'phase': 'cards4', 'skipped': True,
                          'visible': visible}), flush=True)
        return None
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    f64, f32 = str(torch.float64), str(torch.float32)
    plan = plan or _mesh_plan(dev)
    plan = dict(plan, train_tp_batch=plan['train_batch'],
                train_tp_dtypes={str(CARDS4): [f64, f32]}, axis_ms=True)
    t0 = time.perf_counter()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, 'train'))
        _train_shard(os.path.join(tmp, 'train', 'shard0.npz'),
                     plan['stream']['img_hw'])
        ranks = _spawn_world(CARDS4, backend, tmp, plan,
                             ('runner', 'step', 'sparse', 'train', 'train_tp',
                              'gpipe'))
        mesh_samples = _read_samples(os.path.join(tmp, 'mesh_runner'))
        step_bevs = _load(tmp, 'mesh_step_bevs')
        mesh_rows = _load(tmp, 'mesh_sparse_rows')
        dp = _load(tmp, 'mesh_train')
        tp = _load(tmp, f'mesh_train_tp{CARDS4}')
    world = _check_world(ranks, backend)
    where = f'{backend}, rank r on card r'
    mesh = ranks[0]['runner']
    n = mesh['bevs']
    check(n == len(runner_samples) and n > 0, (n, len(runner_samples)))
    # One kernel-1 launch per raster on each rank (the plain version on
    # the CPU).
    on_card = dev.type == 'cuda'
    launches = [r['runner']['launches'] for r in ranks]
    check(all(x == n * on_card for x in launches),
          ('runner launches', launches, n))
    runner_err = _exact_and_close(mesh_samples, runner_samples)
    check(runner_err == 0.0, ('runner', runner_err))
    stripes = [r['runner'].get('stripe_kernel') for r in ranks]
    if dev.type == 'cuda':
        check(all(k['max_abs_err'] == 0.0 for k in stripes), stripes)
    emit('mesh_runner_cards4', t0, ranks=CARDS4, backend=where, world=world,
         samples=n, launches_per_rank=launches,
         vs_runner_path_max_abs=runner_err, stripe_kernel_per_rank=stripes,
         psum_vs_one_device_max_abs=mesh['psum_vs_one_device_max_abs'],
         samples_per_s_steady=mesh.get('samples_per_s_steady'),
         one_card_samples_per_s_steady=runner['samples_per_s_steady'],
         steady_vs_one_card=(mesh['samples_per_s_steady']
                             / runner['samples_per_s_steady']
                             if 'samples_per_s_steady' in mesh else None),
         peak_bytes_per_rank=[r['runner'].get('max_memory_allocated_bytes')
                              for r in ranks],
         one_card_peak_bytes=runner['max_memory_allocated_bytes'],
         **{k: mesh.get(k) for k in (
             'steady_samples', 'steady_s', 'first_evicting_frame',
             'raster_ms', 'raster_median_ms', 'scatter_ms_per_sample',
             'generate_bev_ms_per_sample', 'integrate_ms_per_frame',
             'rows_per_raster', 'route_peak_rows', 'route_cap',
             'dest_cap_factor', 'loop_s')})
    step = ranks[0]['step']
    step_launches = [r['step']['launches'] for r in ranks]
    expect = plan['bev_num'] * plan['steps'] * on_card
    check(all(x == expect for x in step_launches),
          ('step launches', step_launches))
    flat = [{str(i): b for i, b in enumerate(s for st in run for s in st)}
            for run in (step_bevs, main_bevs)]
    step_err = _exact_and_close(*flat)
    check(step_err == 0.0, ('step', step_err))
    emit('mesh_step_cards4', t0, ranks=CARDS4, backend=where, world=world,
         launches_per_rank=step_launches, vs_main_path_max_abs=step_err,
         one_card_samples_per_s=main_res['samples_per_s'],
         samples_per_s_vs_one_card=(step['samples_per_s']
                                    / main_res['samples_per_s']),
         peak_bytes_per_rank=[r['step'].get('max_memory_allocated_bytes')
                              for r in ranks],
         **{k: step[k] for k in (
             'step_s', 'median_step_s', 'samples_per_s', 'raster_ms',
             'raster_median_ms', 'scatter_ms_per_step', 'max_live_rows',
             'live_rows_per_rank_by_step', 'route_peak_rows', 'route_cap',
             'dest_cap_factor')})
    sparse_launches = _emit_mesh_sparse(
        'mesh_sparse_cards4', t0, CARDS4, where, plan, ranks, mesh_rows,
        sparse_rows, world=world)
    held = {p: [r['allocated_before'][p] for r in ranks]
            for p in ('train', 'train_tp')}
    _emit_train_dp('train_dp_cards4', t0, CARDS4, plan, dp, one, ranks,
                   CARDS4_NOTE, layout=[CARDS4, 1], world=world,
                   allocated_before_bytes_per_rank=held['train'])
    _emit_train_tp(t0, CARDS4, plan, tp, one, ranks, phase='train_tp_cards4',
                   note=CARDS4_NOTE + '; model_axis_bytes: the results of '
                   "each step's psums, all_gathers and broadcasts over "
                   "'model' on rank 0; model_axis_ms: CUDA events around "
                   'each of them on each rank', world=world,
                   allocated_before_bytes_per_rank=held['train_tp'])
    emit('gpipe_cards4', t0, stages=CARDS4, atol=PIPE_ATOL, world=world,
         **{f'rank{r}': ranks[r]['gpipe'] for r in range(CARDS4)})
    phase_torchrun_train(dev, one[f32]['losses'][0], plan)
    return launches, step_launches, sparse_launches


def record_train_losses(out_dir, device_type):
    """In a process that torchrun started for the train_semseg CLI (called
    from the sitecustomize.py that phase_torchrun_train puts on its
    path): the model trains in float32 with TF32 off, as train_run's
    float32 runs do (_training_probe), and every step's global loss is
    written to out_dir/losses_r{RANK}.json. Everything else is the
    CLI's."""
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    rank = os.environ['RANK']
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device('cuda', int(os.environ['LOCAL_RANK']))
           if device_type == 'cuda' else torch.device(device_type))
    make = _training_probe(train_mod.make_train_setup, {}, dev,
                           torch.float32)

    def setup(*args, **kwargs):
        state, train_step = make(*args, **kwargs)
        losses = []

        def recorded(state, images, labels):
            state, loss = train_step(state, images, labels)
            losses.append(float(loss))
            with open(os.path.join(out_dir, f'losses_r{rank}.json'),
                      'w') as f:
                json.dump(losses, f)
            return state, loss
        return state, recorded

    train_mod.make_train_setup = setup


# The sitecustomize.py of phase_torchrun_train's workers: first the
# interpreter's own sitecustomize, which this one shadows, if it has one;
# then, in a process torchrun started, record_train_losses.
_LOSS_HOOK = """import importlib.machinery
import importlib.util
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    'sitecustomize',
    [p for p in sys.path if os.path.abspath(p or '.') != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
if 'LOCAL_RANK' in os.environ:
    import chip_smoke
    chip_smoke.record_train_losses(OUT_DIR, DEVICE_TYPE)
"""


def phase_torchrun_train(dev, one_loss1, plan):
    """``python -m torch.distributed.run --standalone --nproc-per-node 4
    -m pc_accumulation_lib_tpu_torch.runners.train_semseg`` on
    train_path's shard, TORCHRUN_STEPS steps, a checkpoint at the last:
    one process per card, the JAX runner's default (2, 2) layout, run()'s
    defaults otherwise, but float32 with TF32 off (record_train_losses),
    so that its step-1 loss can be held to the one-card float32 run's
    (``one_loss1``, the same batch and weights) at _train_held's float32
    step-1 bound (bf16 convolutions on two layouts differ by about that
    bound). It must exit 0; every rank's losses agree, and its checkpoint
    restores on one card."""
    from pc_accumulation_lib_tpu_torch.models import checkpoint as ckpt
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    t0 = time.perf_counter()
    hw = plan['stream']['img_hw']
    with tempfile.TemporaryDirectory() as tmp:
        _train_shard(os.path.join(tmp, 'shard0.npz'), hw)
        hook = os.path.join(tmp, 'hook')
        os.makedirs(hook)
        with open(os.path.join(hook, 'sitecustomize.py'), 'w') as f:
            f.write(_LOSS_HOOK.replace('OUT_DIR', repr(tmp)).replace(
                'DEVICE_TYPE', repr(dev.type)))
        ckpt_dir = os.path.join(tmp, 'ckpt')
        env = {k: v for k, v in os.environ.items()
               if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK',
                            'MASTER_ADDR', 'MASTER_PORT')}
        env['PYTHONPATH'] = os.pathsep.join(
            [hook, HERE] + [p for p in [os.environ.get('PYTHONPATH')] if p])
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc-per-node', str(CARDS4), '-m',
               'pc_accumulation_lib_tpu_torch.runners.train_semseg',
               os.path.join(tmp, 'shard*.npz'), '--steps',
               str(TORCHRUN_STEPS), '--ckpt_every', str(TORCHRUN_STEPS),
               '--ckpt_dir', ckpt_dir, '--device', dev.type]
        ts = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=TORCHRUN_TIMEOUT_S)
        run_s = time.perf_counter() - ts
        check(proc.returncode == 0, (proc.returncode, proc.stderr[-3000:]))
        losses = []
        for r in range(CARDS4):
            with open(os.path.join(tmp, f'losses_r{r}.json')) as f:
                losses.append(json.load(f))
        check(all(x == losses[0] for x in losses)
              and len(losses[0]) == TORCHRUN_STEPS
              and np.isfinite(losses[0]).all(), losses)
        check(sorted(os.listdir(ckpt_dir)) == [str(TORCHRUN_STEPS)],
              os.listdir(ckpt_dir))
        fresh, _ = train_mod.make_train_setup(img_hw=hw, device=dev)
        restored = ckpt.restore_train_state(ckpt_dir, fresh)
        check(restored.step == TORCHRUN_STEPS, restored.step)
        tensors = list(restored.model.state_dict().values())
        check(all(bool(torch.isfinite(t).all()) for t in tensors
                  if t.is_floating_point()), 'restored weights not finite')
        del fresh, restored, tensors
        command = ' '.join(['python'] + cmd[1:]).replace(tmp, '<tmp>')
    step1 = _rel_err(losses[0][0], one_loss1, 1e-5, 0.0)
    emit('torchrun_train_cards4', t0, nproc_per_node=CARDS4, command=command,
         exit_code=proc.returncode, run_s=run_s, losses=losses[0],
         one_card_step1_loss=one_loss1, step1_loss_vs_one_card=step1,
         note='step1_loss_vs_one_card: a ratio to rtol 1e-5, <= 1 passes; '
         "run()'s batch of 8, float32 convolutions and TF32 off on both; "
         'layout (2, 2); the checkpoint restored on one card')
    check(step1 <= 1.0, ('torchrun step-1 loss', losses[0][0], one_loss1))


def phase_dryrun(dev, n):
    """parallel/dryrun.py on n ranks: step 1 trains DP+TP with the JAX
    dryrun's tp (the largest power of two dividing n, at most 4), which
    the summary reports. With n cards visible each rank has its own over
    NCCL (dryrun_multichip's rule), which the placement must show
    (rank r on card r); else the ranks share this card over gloo."""
    from pc_accumulation_lib_tpu_torch.parallel.dryrun import (
        dryrun_multichip)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = dryrun_multichip(n, device=dev.type)
    check(summary['tp'] == min(4, n & -n), summary)
    if n <= torch.cuda.device_count():
        want = [dict(backend='nccl', device=r) for r in range(n)]
        check(summary['placement'] == want, (summary['placement'], want))
    emit('dryrun_multichip', t0, ranks=n, **summary)


def _kernel_entry(name, replaces, launches, max_abs_err, on_runner,
                  launches_by_path):
    """One kernel's entry of the kernels line, at a runner raster's rows:
    ``ms`` is the kernel's own device time, ``plain_ms`` the plain
    version's; no single PyTorch call computes this function, so
    ``library_ms`` is null. ``launches`` is the KITTI-360 runner's count,
    ``launches_by_path`` each driven path's."""
    t = on_runner['timing']
    return {'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE,
            'replaces': replaces, 'launches': launches,
            'launches_by_path': launches_by_path,
            'max_abs_err': max_abs_err, 'ms': t['device_us'] / 1e3,
            'plain_ms': on_runner['plain_ms'],
            'bound_ms': t['bound_us'] / 1e3, 'bound_by': t['bound_by'],
            'library_ms': None, 'device_us': t['device_us'],
            'wrapper_us': t['wrapper_us'], 'bound_us': t['bound_us'],
            'bound_share': t['bound_share']}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import pc_accumulation_lib_tpu_torch  # noqa: F401  (needs the checkout)
    dev = torch.device('cuda', 0)
    card = phase_env()
    phase_build()
    kern = phase_kernel(dev)
    kern2 = phase_kernel2(dev)
    main_res, raster_in, main_bevs, frames, accum = phase_main_path(dev)
    wire = phase_wire_path(dev, main_bevs, frames, accum)
    del accum
    phase_reference_api_path(dev, frames[:REFERENCE_API_FRAMES])
    del frames
    on_path = phase_kernel_on_main_path(raster_in)
    del raster_in
    sparse, sparse_stats_in, sparse_rows = phase_sparse_step_path(dev,
                                                                  main_res)
    on_sparse = phase_kernel_on_sparse_path(sparse_stats_in)
    del sparse_stats_in
    runner, samples, stats_in, runner_raster_in, window = \
        phase_runner_path(dev)
    on_runner = phase_kernel2_on_runner_path(stats_in,
                                             runner['rows_per_raster'])
    del stats_in
    phase_selftest(runner_raster_in)
    del runner_raster_in
    runner2 = phase_runner_path(dev, words_kernel=False, reference=samples)[0]
    rgb_runner = phase_runner_path(dev, reference=samples,
                                   bev_type='rgb')[0]
    phase_legacy_path(dev, window)
    del window
    oracle, oracle_stats_in = phase_oracle_path(dev)
    oracle_wire = phase_oracle_path(dev, 'yuv420h', 'quantized',
                                    'oracle_wire_path')[0]
    oracle_sparse = phase_oracle_path(dev, name='sparse_oracle_path',
                                      bev=ORACLE_SPARSE_BEV,
                                      reference=oracle)[0]
    on_oracle = phase_kernel2_on_runner_path(
        oracle_stats_in, oracle['rows_per_raster'],
        phase='kernels_on_oracle_path')
    del oracle_stats_in
    nusc_runner = phase_nuscenes_runner_path(dev)
    phase_gpu_vs_cpu(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_semseg_weights(dev, tmp)
        phase_train_path(dev, tmp)
        phase_pc_accum(dev, tmp)
    phase_gpu_vs_cpu_train(dev)
    mesh_runner, mesh_step, mesh_sparse, one_tp, one = phase_mesh(
        dev, main_bevs, samples, sparse_rows)
    mesh_step4 = phase_mesh_step4(dev, main_bevs, one_tp)
    del one_tp
    phase_dryrun(dev, MESH_RANKS)
    phase_dryrun(dev, MESH4_RANKS)
    phase_mesh_nccl(dev)
    cards4 = phase_cards4(dev, main_res, main_bevs, runner, samples,
                          sparse_rows, one)
    del main_bevs, samples, sparse_rows, one
    # Each kernel's timing at five shapes: made-up bench raster rows, a
    # step() raster's rows (dense cell keys, and rank-compacted keys on the
    # sparse path), a KITTI-360 runner raster's rows, an oracle raster's
    # rows.
    shapes = {'segmented_stats_words': dict(
        bench=kern['timing'], step_raster=on_path['timing'],
        step_raster_compact=on_sparse['timing'],
        step_raster_compact_dense_keys=on_sparse['dense_keys']['timing'],
        runner_raster=on_runner['kernel1']['timing'],
        oracle_raster=on_oracle['kernel1']['timing']),
        'segmented_stats': dict(
        bench=kern2['timing'], step_raster=on_path['kernel2']['timing'],
        step_raster_compact=on_sparse['kernel2']['timing'],
        runner_raster=on_runner['kernel2']['timing'],
        oracle_raster=on_oracle['kernel2']['timing'])}
    emit('kernel_timing', time.perf_counter(), **shapes)
    print(card, flush=True)
    print(json.dumps({'kernels': [
        _kernel_entry('segmented_stats_words', KERNEL_REPLACES,
                      runner['launches'],
                      max(kern['max_abs_err'], on_path['max_abs_err'],
                          on_sparse['max_abs_err'],
                          on_runner['kernel1']['max_abs_err'],
                          on_oracle['kernel1']['max_abs_err']),
                      on_runner['kernel1'],
                      {'step': main_res['launches'],
                       'kitti360_runner': runner['launches'],
                       'nuscenes_oracle': oracle['launches'],
                       'nuscenes_runner': nusc_runner['launches'],
                       'nuscenes_runner_icp': nusc_runner['icp_launches'],
                       'kitti360_runner_mesh2': mesh_runner,
                       'step_mesh2': mesh_step,
                       'step_yuv420h': wire['launches'],
                       'nuscenes_oracle_wire': oracle_wire['launches'],
                       'nuscenes_oracle_wire_overlapped':
                           oracle_wire['overlapped_upload']['launches'],
                       'nuscenes_runner_icp_wire':
                           oracle_wire['icp_frame']['launches'],
                       'kitti360_runner_rgb': rgb_runner['launches'],
                       'step_mesh4': mesh_step4,
                       'step_sparse': sparse['launches'],
                       'nuscenes_oracle_sparse': oracle_sparse['launches'],
                       'step_sparse_mesh2': mesh_sparse,
                       **(dict(zip(('kitti360_runner_cards4', 'step_cards4',
                                    'step_sparse_cards4'), cards4))
                          if cards4 else {})}),
        _kernel_entry('segmented_stats', KERNEL2_REPLACES,
                      runner2['kernel2_launches'],
                      max(kern2['max_abs_err'],
                          on_path['kernel2']['max_abs_err'],
                          on_sparse['kernel2']['max_abs_err'],
                          on_runner['kernel2']['max_abs_err'],
                          on_oracle['kernel2']['max_abs_err']),
                      on_runner['kernel2'],
                      {'kitti360_runner_unpacked':
                       runner2['kernel2_launches'],
                       'step_sparse_compact_unpacked':
                       on_sparse['compact_unpacked_kernel2_launches']})]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
