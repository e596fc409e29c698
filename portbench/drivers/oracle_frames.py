"""Driver of the NuScenes oracle traffic: the oracle dataset loop, one
sample per frame, six cameras at their published size.

A scene is the configuration's ``scene_keyframes`` frames on its own
world and its own accumulator (the oracle accumulator keeps every frame of a scene), with
the one semseg model shared. Set-up: the weights, a warm-up scene of
``warm_frames`` frames and one sample (every shape the window uses), and
the frame producer's head start. Window, per frame: the next frame's
``upload_obs`` is submitted to one worker thread (its submission starts
that frame's latency), then this frame is integrated and, from a scene's
second frame on, ``generate_bev(present_idx=len(poses) - 2, bev_num=1,
gen_future=True, async_fetch=True)`` is dispatched and drained on a
second worker thread; one frame in flight. Frames run until
``--seconds`` have passed, then drain; the window ends when the last
sample is on the host.

Traffic parameters (traffic/<mix>.json): warm_frames, producer_depth,
frames_in_flight, trace_frames (the traced stretch, on a scene of its
own before the window in a ``--trace 1`` run) and what is checked
(check: drawn scenes among the window's first drawn_within, and the
window's last scene; the semseg on semseg_frames frames of those drawn
from the seed, and the window's last frame).

After the window the checked scenes are worked out again by the
reference (reference/oracle.py) and compared. The producer's lag, the
time the loop waited for a frame to be made, is reported in ``info``.
"""
from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.arith import fcn_r50_d8, peaks
from portbench.harness import bev
from portbench.harness.profile import DeviceTrace, host_range
from portbench.harness.spans import Spans
from portbench.harness.stats import percentile, seeds as draw_seeds
from portbench.harness.weights import fcn_weights, load_into
from portbench.gen.nuscenes import make_scene
from portbench.reference import compare, oracle as ref_oracle

WARM_SCENE = -1
TRACE_SCENE = -2


def run_seeds(seed: int) -> dict:
    s = draw_seeds(seed, 4)
    return dict(stream=s[0], weights=s[1], aug=s[2], check=s[3])


def checked_scenes(traffic, seed_check) -> set:
    c = traffic['check']
    rng = np.random.default_rng(seed_check)
    return set(int(k) for k in rng.choice(c['drawn_within'], c['drawn'],
                                          replace=False))


def build_semseg(config, seeds, device):
    from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
    ss = config['semseg']
    dt = {'bfloat16': torch.bfloat16,
          'float32': torch.float32}[ss['compute_dtype']]
    semseg = SemSegTorch(device=device, stage_sizes=ss['stage_sizes'],
                         compute_dtype=dt)
    weights = fcn_weights(seeds['weights'], device, ss['stage_sizes'],
                          ss['num_classes'], config['semseg_filters'])
    load_into(semseg.model, weights)
    return semseg


def accumulator_kwargs(config: dict, scene, seed: int) -> dict:
    return dict(semseg_filters=tuple(config['semseg_filters']),
                bev_params=dict(config['bev']), loc='synth',
                get_gt_lanes=True, gt_lane_poses=scene.lane(), seed=seed,
                img_transfer=config['img_transfer'],
                transfer_dtype=config['transfer_dtype'])


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def program_run(ctx):
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    from pc_accumulation_lib_tpu_torch import config as pcfg
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator)
    seeds = run_seeds(ctx.seed)
    checked = checked_scenes(traffic, seeds['check'])
    F = config['scene_keyframes']
    scenes = {}

    def scene_of(sc):
        if sc not in scenes:
            scenes[sc] = make_scene(config, seeds['stream'], sc)
        return scenes[sc]

    def make_frame(g):
        """Global frame g of the window (scene g // F)."""
        return scene_of(g // F).frame(g % F, g)

    def new_accumulator(sc, scene):
        return NuScenesOracleSemanticPointCloudAccumulator(
            semseg_model=semseg, accum_cfg=pcfg.AccumConfig(
                **config['accum']), device=device,
            **accumulator_kwargs(config, scene, seeds['aug']))

    producer = bev.Prefetch(make_frame, traffic['producer_depth'])
    producer.start(0)
    semseg = build_semseg(config, seeds, device)
    spans = Spans(ctx.trace, device)
    stats_calls = bev.StatsCalls()
    current = [-1]     # the global frame being integrated

    def keep(g):
        # The drawn scenes, and the last two (the window's last scene with
        # a sample may be the one before the last).
        return g >= 0 and (g // F in checked
                           or g // F >= current[0] // F - 1)

    stash = bev.LabelStash(semseg, lambda: current[0], keep)
    # Set-up: a warm-up scene through every shape the window uses.
    warm = make_scene(config, seeds['stream'], WARM_SCENE)
    acc = new_accumulator(WARM_SCENE, warm)
    with torch.no_grad():
        for i in range(traffic['warm_frames']):
            acc.integrate([warm.frame(i, -1 - i)])
        acc.generate_bev(present_idx=len(acc.poses) - 2, bev_num=1,
                         gen_future=True)
    sync(device)
    del acc
    if ctx.trace:
        spans.hook_module('semseg', semseg.model)
        stats_calls.install()

    lat_ms, samples, inst_dyn, accs, submitted = [], {}, {}, {}, {}
    upx = ThreadPoolExecutor(max_workers=1)
    drx = ThreadPoolExecutor(max_workers=1)
    trace = DeviceTrace() if ctx.trace else None

    def accumulator(sc):
        if sc not in accs:
            accs[sc] = new_accumulator(sc, scene_of(sc))
            if ctx.trace:
                gen = accs[sc].sem_bev_generator
                gen._raster = spans.wrap('raster', gen._raster)
        return accs[sc]

    def drain(handle, g, window):
        with host_range('drain'):
            out = handle()
        t1 = time.perf_counter()
        if window:
            lat_ms.append((t1 - submitted[g]) * 1e3)
        return g, out, t1

    def upload(g, frames):
        acc = accumulator(g // F)
        submitted[g] = time.perf_counter()
        return upx.submit(acc.upload_obs, frames(g))

    state = dict(delivered=0, frames=0, t_last=None)

    def take(fut, window):
        g, out, t1 = fut.result()
        if not window:
            return
        state['delivered'] += len(out)
        state['t_last'] = t1
        sc = g // F
        samples.setdefault(sc, []).extend(out)
        for old in [k for k in samples if k < sc and k not in checked]:
            del samples[old]

    def loop(g, frames, n_frames=None, deadline=None, window=True,
             traced=False):
        """Frames from global frame ``g`` (made by ``frames``) until
        ``n_frames`` or the deadline; returns the next frame."""
        pending = collections.deque()
        n = 0
        up = upload(g, frames)
        if traced:
            up.result()
            trace.start()
            stats_calls.on = True
        while True:
            sc, i = divmod(g, F)
            acc = accumulator(sc)
            with host_range('upload_wait'):
                dobs = up.result()
            up = upload(g + 1, frames)
            current[0] = g
            with host_range('dispatch'), torch.no_grad():
                acc.integrate([dobs])
                handle = None
                if i >= 1:
                    handle = acc.generate_bev(
                        present_idx=len(acc.poses) - 2, bev_num=1,
                        gen_future=True, async_fetch=True)
            if handle is not None:
                pending.append(drx.submit(drain, handle, g, window))
            if window:
                state['frames'] += 1
                inst_dyn[sc] = acc.state.inst_dyn
            if len(pending) > traffic['frames_in_flight']:
                with host_range('drain_wait'):
                    take(pending.popleft(), window)
            g += 1
            n += 1
            if g % F == 0 and g // F - 2 in accs:
                # A scene's accumulator goes once its samples are drained.
                del accs[g // F - 2]
            if (n_frames is not None and n >= n_frames) or (
                    deadline is not None and time.perf_counter() >= deadline):
                break
        while pending:
            with host_range('drain_wait'):
                take(pending.popleft(), window)
        if traced:
            stats_calls.on = False
            trace.stop()
        up.result()
        return g

    try:
        if trace is not None:
            # The traced stretch runs on a scene of its own before the
            # window, so that the profiler's start and stop cost the window
            # nothing.
            g0 = TRACE_SCENE * F
            tframes = bev.Prefetch(lambda j: make_frame(g0 + j),
                                   traffic['producer_depth'])
            loop(g0, lambda j: tframes.get(j - g0),
                 n_frames=traffic['trace_frames'], window=False, traced=True)
            tframes.close()
            accs.clear()
        sync(device)
        t_start = time.perf_counter()
        producer.reset_lag()
        g = loop(0, producer.get, deadline=t_start + ctx.seconds)
        sync(device)
    finally:
        upx.shutdown(wait=True)
        drx.shutdown(wait=True)
        producer.close()
    delivered, frames_done, t_last = (state['delivered'], state['frames'],
                                      state['t_last'])
    window_s = t_last - t_start
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == 'cuda' else 0)
    last_scene, n_last = divmod(g - 1, F)
    n_last += 1
    checked_now = {sc: (sc * F, F) for sc in checked if sc < last_scene}
    # The window's last scene with a sample (the one before, if the last
    # ended on its first frame) is always checked.
    if n_last >= 2:
        checked_now[last_scene] = (last_scene * F, n_last)
    elif last_scene >= 1:
        checked_now[last_scene - 1] = ((last_scene - 1) * F, F)
    img_hw = config['camera']['img_hw']
    record = dict(
        window_s=window_s, frames=frames_done, samples=delivered,
        images=frames_done * config['camera']['n_cams'],
        frame_ms=lat_ms, spans=spans.millis() if ctx.trace else {},
        flops_per_image=fcn_r50_d8.forward_flops(
            *img_hw, config['semseg']['stage_sizes'],
            config['semseg']['num_classes']),
        peak_flops=peaks.BF16_FLOPS)
    if trace is not None:
        record['trace'] = trace.summary(kernel_filters=('segmented_stats',))
        record['stats_bound_s'] = stats_calls.bound_s()
        record['stats_calls'] = len(stats_calls.calls)
        stats_calls.uninstall()
    judged = semseg_frames(traffic, seeds['check'], checked_now, g - 1)
    outputs = dict(
        scenes=checked_now, judged=judged,
        labels={f: v for f, v in stash.labels.items()
                if f // F in checked_now},
        samples={sc: samples.get(sc, []) for sc in checked_now},
        inst_dyn={sc: inst_dyn[sc].cpu().numpy() for sc in checked_now})
    attempted = frames_done - (last_scene + 1)   # a scene's first: none
    del accs, semseg, stash, inst_dyn
    return dict(outputs=outputs, record=record,
                e2e=dict(samples_per_s=delivered / window_s,
                         frame_p95_ms=percentile(lat_ms, 95),
                         setup_s=t_start - ctx.t_start),
                attempted=attempted, failed=attempted - delivered,
                memory_peak_bytes=memory_peak, seeds=seeds,
                info=dict(frames=frames_done, scenes=last_scene + 1,
                          checked_scenes=sorted(checked_now),
                          **producer.lag()))


def semseg_frames(traffic, seed_check, scenes, last) -> list:
    """The frames whose class maps the reference's semseg judges: drawn
    from the seed among the checked scenes' frames, and the window's last
    frame."""
    frames = sorted(g for g0, n in scenes.values() for g in range(g0, g0 + n))
    rng = np.random.default_rng([seed_check, 1])
    k = min(traffic['check']['semseg_frames'], len(frames))
    return sorted({int(f) for f in rng.choice(frames, k, replace=False)}
                  | ({last} & set(frames)))


def values(config, limits, prog_out, ref, gaps) -> dict:
    """The compared numbers of one run: the program's (or the control's)
    outputs ``prog_out``, the reference's replay ``ref`` painted with the
    same class maps, and the reference semseg's judgement ``gaps``
    {frame: (gap, share)} of those maps."""
    ks = sorted(prog_out['scenes'])
    ps = [s for k in ks for s in prog_out['samples'].get(k, [])]
    rs = [s for k in ks for s in ref['samples'][k]]
    mism, missing = compare.map_mismatch(ps, rs, limits['_map_tolerance'])
    return dict(
        semseg_gap=max((g for g, _ in gaps.values()), default=float('inf')),
        map_mismatch=mism,
        traj_gap_px=compare.traj_gap(ps, rs),
        inst_dyn_gap=max((ref_oracle.inst_dyn_gap(prog_out['inst_dyn'][k],
                                                  ref['dynamic'][k])
                          for k in ks), default=0.0),
        samples_missing=missing + max(0, len(rs) - len(ps)))


def check(ctx, out, seeds, control=False) -> dict:
    """{'program': compared numbers, ...}; with ``control`` also the
    control's: the reference put in the program's place one precision
    step below the configuration (fp8 convolutions, TF32 matmul
    operands), on the same frames (None if it stopped: it has failed)."""
    config, dev = ctx.config, ctx.device
    ss = config['semseg']
    weights = fcn_weights(seeds['weights'], dev, ss['stage_sizes'],
                          ss['num_classes'], config['semseg_filters'])
    label_sets = {'program': out['labels']}
    runs = {'program': out}
    if control:
        try:
            labels = ref_oracle.control_labels(config, seeds, sorted(
                out['labels']), weights, dev)
            ctl = ref_oracle.replay(config, seeds, out['scenes'], labels,
                                    dev, control=True)
            label_sets['control'] = labels
            runs['control'] = dict(
                out, samples=ctl['samples'], inst_dyn={
                    k: ref_oracle.dyn_table(v, len(out['inst_dyn'][k]))
                    for k, v in ctl['dynamic'].items()})
        except RuntimeError:
            runs['control'] = None
    gaps = ref_oracle.judge_semseg(config, seeds, out['judged'], label_sets,
                                   weights, dev)
    result = {}
    for name, run_out in runs.items():
        if run_out is None:
            result[name] = None
            continue
        ref = ref_oracle.replay(config, seeds, out['scenes'],
                                label_sets[name], dev)
        result[name] = values(config, ctx.limits, run_out, ref, gaps[name])
    result['label_share_differing'] = max(
        (s for _, s in gaps['program'].values()), default=None)
    return result


def run(ctx):
    res = program_run(ctx)
    out = res.pop('outputs')
    t0 = time.perf_counter()
    got = check(ctx, out, res['seeds'])
    res['values'] = got['program']
    res['info'].update(label_share_differing=got['label_share_differing'],
                       check_s=time.perf_counter() - t0)
    return res
