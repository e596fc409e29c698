"""The program's spans and counters (utils/profiling.py): nothing recorded
and no profiler range, CUDA event or span object made with tracing off;
profiler ranges on the registry's clock; worker threads, parents, self
times, the switch and the export; one oracle frame's spans under one
frame id; the painted-count check shared by two threads."""
from __future__ import annotations

import collections
import contextlib
import glob
import io
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as TOracle)
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
from pc_accumulation_lib_tpu_torch.utils import profiling

ACCUM = dict(max_points_per_frame=16384, max_frames=8,
             max_painted_points_per_frame=16384, max_instances=64)
BEV_PARAMS = dict(type='sem', view_size=40, pixel_size=32, int_scaler=1.,
                  int_sep_scaler=30., int_mid_threshold=0.12)
ORACLE_SPANS = {'upload', 'integrate', 'sync.painted', 'track', 'decode',
                'semseg', 'paint', 'insert', 'generate_bev', 'trajs',
                'raster', 'fetch', 'harvest', 'sync.fetch'}


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope='module')
def frames():
    stream = tsyn.SyntheticNuScenesStream(n_frames=3, step=2.0,
                                          lidar_range=20.0, seed=5)
    return [stream.frame(i) for i in range(3)]


@pytest.fixture(scope='module')
def semseg():
    return SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))


def _oracle(semseg):
    return TOracle(semseg_model=semseg, accum_cfg=tcfg.AccumConfig(**ACCUM),
                   bev_params=BEV_PARAMS, loc='synth-map', seed=0,
                   device='cpu')


def _run_oracle(acc, frames, upx=None, drx=None):
    """The benchmark's loop: uploads (on ``upx``), integrate, and from the
    second frame a sample drained (on ``drx``). Returns the samples."""
    out = []
    with contextlib.redirect_stdout(io.StringIO()):
        for i, f in enumerate(frames):
            dobs = upx.submit(acc.upload_obs, f).result() if upx else f
            acc.integrate([dobs])
            if i >= 1:
                h = acc.generate_bev(present_idx=len(acc.poses) - 2,
                                     bev_num=1, gen_future=True,
                                     async_fetch=True)
                out += drx.submit(h).result() if drx else h()
    return out


def _raise(*args, **kwargs):
    raise AssertionError('made with tracing off')


def test_off_records_nothing_and_makes_nothing(monkeypatch, semseg,
                                               frames):
    monkeypatch.setattr(profiling, 'record_function', _raise)
    monkeypatch.setattr(profiling, '_Span', _raise)
    monkeypatch.setattr(profiling, '_PinnedCount', _raise)
    monkeypatch.setattr(torch.cuda, 'Event', _raise)
    assert not profiling.on()
    assert profiling.span('x', 1, device=True) is profiling._NULL
    assert profiling.pinned_allocs() is profiling._NULL
    samples = _run_oracle(_oracle(semseg), frames)
    assert len(samples) == 2
    assert profiling.snapshot() == dict(spans={}, counters={})
    assert profiling.records() == []


def test_switch_reads_the_flag_torch_sets():
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert not profiling.profiler_recording() and not profiling.on()
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        seen.append(profiling.profiler_recording())
        t = threading.Thread(target=lambda: seen.append(profiling.on()))
        t.start()
        t.join(timeout=10)
    assert seen == [True, True]
    assert not profiling.profiler_recording()
    with profiling.enable():
        assert profiling.on()
    assert not profiling.on()


def test_profiler_ranges_on_the_registry_clock(semseg, frames):
    acc = _oracle(semseg)
    with profile(activities=[ProfilerActivity.CPU]):
        _run_oracle(acc, frames[:1])    # first-use costs out of the way
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_oracle(acc, frames[1:])
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.PREFIX)]
    recs = [r for r in profiling.records(since) if r['in_profiler']]
    assert {r['name'] for r in recs} >= {'integrate', 'track', 'semseg',
                                         'generate_bev', 'raster'}
    starts = {}
    for e in evs:
        starts.setdefault(e.name()[len(profiling.PREFIX):], []).append(
            e.start_ns())
    gaps = sorted(min(abs(s - r['start_ns']) for s in starts[r['name']])
                  for r in recs)
    # A session's first range pays the profiler's first-use cost, and a
    # loaded host delays any one: the median is the clock's agreement.
    assert gaps[len(gaps) // 2] < 50_000 and gaps[-1] < 1_000_000, gaps


def test_worker_thread_made_before_the_session_is_recorded():
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix='up') as ex:
        tid = ex.submit(threading.get_native_id).result()

        def work():
            with profiling.span('w', frame=7):
                time.sleep(0.001)

        with profile(activities=[ProfilerActivity.CPU]):
            ex.submit(work).result()
    (rec,) = profiling.records()
    assert (rec['name'], rec['frame'], rec['tid']) == ('w', 7, tid)
    assert rec['thread'].startswith('up') and not rec['in_profiler']
    assert rec['end_ns'] - rec['start_ns'] >= 1_000_000


def test_parents_frames_and_self_times():
    with profiling.enable():
        with profiling.span('outer', frame=3):
            time.sleep(0.002)
            with profiling.span('mid'):
                time.sleep(0.003)
                with profiling.span('leaf', device=True):
                    time.sleep(0.001)
            with profiling.span('mid'):
                pass
        profiling.count('c', 2)
        profiling.count('c')
    recs = {r['name']: r for r in profiling.records()}
    assert recs['leaf']['parent'] == 'mid' and recs['mid']['parent'] == 'outer'
    assert recs['outer']['parent'] is None
    assert {r['frame'] for r in recs.values()} == {3}
    snap = profiling.snapshot()
    sp = snap['spans']
    assert snap['counters'] == {'c': 3}
    assert sp['mid']['n'] == 2 and sp['outer']['n'] == 1
    assert sp['outer']['self_ms'] == pytest.approx(
        sp['outer']['total_ms'] - sp['mid']['total_ms'], abs=1e-6)
    assert sp['mid']['self_ms'] == pytest.approx(
        sp['mid']['total_ms'] - sp['leaf']['total_ms'], abs=1e-6)
    assert sp['outer']['self_ms'] >= 2.0 and sp['mid']['self_ms'] >= 3.0
    assert sp['mid']['under'] == {'outer': sp['mid']['total_ms']}
    assert sp['leaf']['device_ms'] == pytest.approx(sp['leaf']['total_ms'])
    assert sp['outer']['device_ms'] is None


def test_device_trace_writes_the_spans_beside_the_profilers(tmp_path):
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix='drain') as ex:
        ex.submit(lambda: None).result()
        with profiling.device_trace(str(tmp_path)):
            with profiling.span('main'):
                torch.ones(64).cumsum(0)
            with profiling.pinned_allocs():
                profiling.count('upload.bytes', 5)

            def work():
                with profiling.span('worker', frame=1):
                    torch.ones(8).sum()

            ex.submit(work).result()
    (path,) = glob.glob(str(tmp_path / '*.pt.trace.json'))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert {'pcacc.main', 'pcacc.worker', 'pcacc.upload.bytes'} <= names
    (worker,) = [e for e in events if e.get('name') == 'pcacc.worker']
    assert worker['cat'] == 'pcacc' and worker['args']['frame'] == 1
    (main,) = [e for e in events if e.get('name') == 'pcacc.main']
    assert main['cat'] == 'user_annotation'        # the profiler's range
    assert any(e.get('ph') == 'M' and e['tid'] == worker['tid']
               and e['args']['name'].startswith('drain') for e in events)
    counter = [e for e in events if e.get('name') == 'pcacc.upload.bytes']
    assert counter[0]['ph'] == 'C' and counter[0]['args'] == {'value': 5}


def test_one_oracle_frame_shares_one_frame_id(semseg, frames):
    acc = _oracle(semseg)
    with ThreadPoolExecutor(max_workers=1) as upx, \
            ThreadPoolExecutor(max_workers=1) as drx, profiling.enable():
        samples = _run_oracle(acc, frames[:2], upx, drx)
    assert len(samples) == 1
    recs = profiling.records()
    frame = acc.last_frame
    names = {r['name'] for r in recs if r['frame'] == frame}
    assert names == ORACLE_SPANS, names ^ ORACLE_SPANS
    by = {r['name']: r for r in recs if r['frame'] == frame}
    assert by['upload']['tid'] != by['integrate']['tid']
    assert by['harvest']['tid'] not in (by['integrate']['tid'],
                                        by['upload']['tid'])
    assert by['sync.painted']['parent'] in ('integrate', 'harvest')
    assert by['track']['parent'] == 'integrate'
    assert by['raster']['parent'] == 'generate_bev'
    assert by['sync.fetch']['parent'] == 'harvest'
    counters = profiling.snapshot()['counters']
    assert counters['upload.bytes'] == acc.upload_bytes_total
    assert counters['fetch.bytes'] > 0


class _Count:
    """A painted count whose read is recorded."""

    def __init__(self, i, reads):
        self.i, self.reads = i, reads

    def __int__(self):
        self.reads.append(self.i)
        return 0


class _Landed:
    @staticmethod
    def synchronize():
        time.sleep(0)


def test_check_painted_shared_by_two_threads_reads_each_count_once():
    acc = TOracle.__new__(TOracle)
    acc.accum_cfg = tcfg.AccumConfig(**ACCUM)
    acc._painted_pending = collections.deque()
    acc._painted_lock = threading.Lock()
    acc.max_painted = 0
    reads, errors = [], []
    for i in range(1000):
        acc._painted_pending.append((_Count(i, reads), _Landed()))

    def drain():
        try:
            acc.check_painted()
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drain) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(reads) == list(range(1000))
    assert not acc._painted_pending
