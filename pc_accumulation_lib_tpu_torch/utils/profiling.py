"""The program's spans and counters, a per-phase wall-clock timer, and a
device trace that carries both.

Tracing is on while ``enable()`` is in force or while a torch.profiler
session records (``profiler_recording``). Off, ``span`` is one check that
returns a shared no-op context and ``count`` returns at once: no profiler
range, no CUDA event, no allocation.

On, a span records its name, its thread, its host start and end in epoch
nanoseconds (``time.time_ns``: the clock of the profiler's events), its
parent (the span open on the same thread when it began) and ``frame``, the
id that every span of one frame or sample shares across threads
(``new_frame``; a span given none takes its parent's). On the thread whose
profiler session records, it also opens ``record_function('pcacc.<name>')``,
so it appears in the profiler's own trace. With ``device=True`` two CUDA
events on the current stream bound it as well, read by ``snapshot``,
``records`` and ``device_trace`` and never on the hot path; where CUDA is
not initialised the host times stand in.

Spans are kept in a ring of recent records beside running totals per name
(count, host time, self time: host time less the child spans', device
time, and host time by parent). ``snapshot()`` returns the totals and the
counters, ``reset()`` clears them. ``device_trace(log_dir)`` writes the
profiler's trace with the session's spans and counters merged in as Chrome
trace events on its timebase, every thread named.

Counterpart of utils/profiling.py: PhaseTimer, and device_trace over
torch.profiler where the JAX package's is over jax.profiler.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

PREFIX = 'pcacc.'
RING = 16384          # span records kept for records() and the export
UNREAD_MAX = 4096     # device spans held before the finished are read

_autograd_profiler = torch.autograd.profiler
_frames = itertools.count()


def profiler_recording() -> bool:
    """True while a torch.profiler session records, on every thread: the
    module flag that torch.autograd.profiler sets when a session starts
    and clears when it ends (the C flag is per thread)."""
    return _autograd_profiler._is_profiler_enabled


def new_frame() -> int:
    """A process-wide id for the spans of one frame or sample."""
    return next(_frames)


class _Null:
    """The span of tracing off: a shared context that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ('reg', 'name', 'frame', 'device', 'parent', 'tid',
                 'start_ns', 'end_ns', 'child_ns', 'events', 'range',
                 'device_ms')

    def __init__(self, reg, name, frame, device):
        self.reg, self.name, self.frame = reg, name, frame
        self.device = device
        self.child_ns = 0
        self.events = self.range = self.device_ms = None

    def __enter__(self):
        stack = self.reg._stack()
        self.parent = stack[-1] if stack else None
        if self.frame is None and self.parent is not None:
            self.frame = self.parent.frame
        stack.append(self)
        self.tid = threading.get_native_id()
        if self.reg.ranges and torch._C._autograd._profiler_enabled():
            self.range = record_function(PREFIX + self.name)
            self.range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.reg._stack().pop()
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        self.reg._record(self)
        return False


class _Total:
    __slots__ = ('n', 'host_ns', 'self_ns', 'device_ms', 'under')

    def __init__(self):
        self.n = self.host_ns = self.self_ns = 0
        self.device_ms = None
        self.under = {}       # parent name -> host ns spent under it


class Registry:
    """Spans and counters (module docstring). ``ranges``: open a profiler
    range for each span on a thread whose profiler session records."""

    def __init__(self, ranges: bool = True):
        self.ranges = ranges
        self._on = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads: Dict[int, str] = {}
        self.reset()

    def reset(self):
        """Forget every span and counter (spans open now still record)."""
        with self._lock:
            self._ring = collections.deque(maxlen=RING)
            self._totals: Dict[str, _Total] = {}
            self._counters: Dict[str, float] = collections.defaultdict(int)
            self._unread = []

    def on(self) -> bool:
        return bool(self._on) or _autograd_profiler._is_profiler_enabled

    def enable(self) -> '_Enabled':
        """Turn tracing on until the returned handle is closed (or its
        ``with`` block ends)."""
        return _Enabled(self)

    def span(self, name: str, frame: Optional[int] = None,
             device: bool = False):
        """A context that records one span (module docstring)."""
        if self._on or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name, frame, device)
        return _NULL

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to the counter ``name`` while tracing is on."""
        if self._on or _autograd_profiler._is_profiler_enabled:
            with self._lock:
                self._counters[name] += n

    def current_frame(self) -> Optional[int]:
        """The frame of the innermost span open on this thread."""
        stack = getattr(self._local, 'stack', None)
        return stack[-1].frame if stack else None

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            with self._lock:
                self._threads[threading.get_native_id()] = (
                    threading.current_thread().name)
            return self._local.stack

    def _record(self, s: _Span) -> None:
        dur = s.end_ns - s.start_ns
        with self._lock:
            self._ring.append(s)
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = _Total()
            t.n += 1
            t.host_ns += dur
            t.self_ns += dur - s.child_ns
            if s.parent is not None:
                t.under[s.parent.name] = t.under.get(s.parent.name, 0) + dur
            if s.device:
                if s.events is None:
                    s.device_ms = dur * 1e-6
                    t.device_ms = (t.device_ms or 0.0) + s.device_ms
                else:
                    self._unread.append(s)
                    if len(self._unread) > UNREAD_MAX:
                        self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Read the CUDA events of unread device spans into the totals:
        every one (waiting for the device) or, under the lock on the hot
        path, those whose end has passed."""
        keep = []
        for s in self._unread:
            if not wait and not s.events[1].query():
                keep.append(s)
                continue
            if wait:
                s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
            t = self._totals.get(s.name)
            if t is not None:
                t.device_ms = (t.device_ms or 0.0) + s.device_ms
        self._unread = keep

    def _read_all(self) -> None:
        with self._lock:
            self._fold(wait=True)

    def snapshot(self) -> dict:
        """{'spans': {name: {'n', 'total_ms', 'self_ms', 'device_ms' (None
        for a host span), 'under': {parent: ms}}}, 'counters': {name:
        value}}, device spans read first."""
        self._read_all()
        with self._lock:
            spans = {name: dict(
                n=t.n, total_ms=t.host_ns * 1e-6, self_ms=t.self_ns * 1e-6,
                device_ms=t.device_ms,
                under={p: ns * 1e-6 for p, ns in t.under.items()})
                for name, t in self._totals.items()}
            return dict(spans=spans, counters=dict(self._counters))

    def records(self, since_ns: int = 0) -> list:
        """The ring's spans that started at or after ``since_ns``, oldest
        first, as dicts (name, frame, tid, thread, parent, start_ns,
        end_ns, device_ms, in_profiler)."""
        self._read_all()
        with self._lock:
            return [dict(name=s.name, frame=s.frame, tid=s.tid,
                         thread=self._threads.get(s.tid),
                         parent=None if s.parent is None else s.parent.name,
                         start_ns=s.start_ns, end_ns=s.end_ns,
                         device_ms=s.device_ms,
                         in_profiler=s.range is not None)
                    for s in self._ring if s.start_ns >= since_ns]

    def chrome_events(self, since_ns: int, base_ns: int,
                      counters: dict) -> list:
        """Chrome trace events of the spans since ``since_ns`` that the
        profiler does not hold as ranges ('X'), their threads' names and
        ``counters``' values at the last span's end ('C'), timed in us
        from ``base_ns``."""
        pid = os.getpid()
        recs = self.records(since_ns)
        out = [dict(ph='X', cat='pcacc', name=PREFIX + r['name'], pid=pid,
                    tid=r['tid'], ts=(r['start_ns'] - base_ns) * 1e-3,
                    dur=(r['end_ns'] - r['start_ns']) * 1e-3,
                    args=dict(frame=r['frame'], parent=r['parent'],
                              device_ms=r['device_ms']))
               for r in recs if not r['in_profiler']]
        for tid in sorted({r['tid'] for r in recs}):
            out.append(dict(ph='M', name='thread_name', pid=pid, tid=tid,
                            args=dict(name=self._threads.get(tid, str(tid)))))
        end = max((r['end_ns'] for r in recs), default=since_ns)
        for name, v in sorted(counters.items()):
            out.append(dict(ph='C', name=PREFIX + name, pid=pid,
                            ts=(end - base_ns) * 1e-3, args=dict(value=v)))
        return out


class _Enabled:
    __slots__ = ('reg', 'open')

    def __init__(self, reg: Registry):
        self.reg, self.open = reg, True
        with reg._lock:
            reg._on += 1

    def close(self):
        if self.open:
            self.open = False
            with self.reg._lock:
                self.reg._on -= 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


REGISTRY = Registry()
span = REGISTRY.span
count = REGISTRY.count
enable = REGISTRY.enable
on = REGISTRY.on
snapshot = REGISTRY.snapshot
records = REGISTRY.records
reset = REGISTRY.reset
current_frame = REGISTRY.current_frame


class _PinnedCount:
    """Counts the pinned host blocks allocated inside the block
    (``pinned.new_blocks``) and their allocation ms (``pinned.alloc_ms``),
    from torch.cuda.host_memory_stats."""
    __slots__ = ('before',)

    def __enter__(self):
        self.before = _host_allocs()
        return self

    def __exit__(self, *exc):
        after = _host_allocs()
        count('pinned.new_blocks', after[0] - self.before[0])
        count('pinned.alloc_ms', after[1] - self.before[1])
        return False


def _host_allocs():
    s = torch.cuda.host_memory_stats()
    return s.get('num_host_alloc', 0), s.get('host_alloc_time.total', 0) * 1e-3


def pinned_allocs():
    """A context counting the pinned allocations inside it while tracing
    is on and CUDA is initialised; the shared no-op context otherwise."""
    if on() and torch.cuda.is_initialized():
        return _PinnedCount()
    return _NULL


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    with timer.phase('integrate'): ...
    print(timer.report())

    Its phases are spans of a registry of its own, always on; each is
    also the span 'phase.<name>' of the program's registry."""

    def __init__(self):
        self._reg = Registry(ranges=False)
        self._reg.enable()

    @contextlib.contextmanager
    def phase(self, name: str):
        with span('phase.' + name), self._reg.span(name):
            yield

    def _spans(self) -> dict:
        return self._reg.snapshot()['spans']

    @property
    def totals(self) -> Dict[str, float]:
        """{phase: seconds}."""
        return collections.defaultdict(float, {
            k: v['total_ms'] * 1e-3 for k, v in self._spans().items()})

    @property
    def counts(self) -> Dict[str, int]:
        return collections.defaultdict(int, {
            k: v['n'] for k, v in self._spans().items()})

    def report(self) -> str:
        spans = self._spans()
        lines = []
        for name in sorted(spans, key=lambda k: -spans[k]['total_ms']):
            t, n = spans[name]['total_ms'] * 1e-3, spans[name]['n']
            lines.append(f'{name:24s} total {t:8.3f}s  n {n:5d}  '
                         f'mean {t / max(n, 1) * 1e3:8.2f}ms')
        return '\n'.join(lines)

    def reset(self):
        self._reg.reset()


def _merge_spans(log_dir: str, since_ns: int, counters_before: dict):
    """Add the spans since ``since_ns`` and the counters' change since
    ``counters_before`` to the newest profiler trace in ``log_dir``."""
    traces = glob.glob(os.path.join(log_dir, '*.pt.trace.json'))
    if not traces:
        return
    path = max(traces, key=os.path.getmtime)
    with open(path) as f:
        trace = json.load(f)
    counters = {k: v - counters_before.get(k, 0)
                for k, v in snapshot()['counters'].items()}
    trace.setdefault('traceEvents', []).extend(REGISTRY.chrome_events(
        since_ns, int(trace.get('baseTimeNanoseconds', 0)), counters))
    with open(path, 'w') as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (host and, where there is a
    card, CUDA activity), written to ``log_dir`` as a Chrome trace with
    the program's spans of every thread and its counters merged in;
    nothing when log_dir is None."""
    if log_dir is None:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    since = time.time_ns()
    before = snapshot()['counters']

    def ready(prof):
        tensorboard_trace_handler(log_dir)(prof)
        _merge_spans(log_dir, since, before)

    with profile(activities=acts, on_trace_ready=ready):
        yield
