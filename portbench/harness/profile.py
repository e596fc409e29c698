"""The traced part of a run: torch.profiler over a stretch of the cell's
own traffic (run before the window, so that the profiler costs the
window nothing), reduced to the device's busy seconds, the kernels that
took most time and the longest idle gaps named by what the host was
doing.

Busy time is the union of the device's kernel, copy and set intervals.
A gap between two busy stretches is named by the benchmark's own host
range (``torch.profiler.record_function('portbench.<part>')``) that
covers its middle on any thread, and by the innermost operator running
on the dispatching thread at that moment; past the NAMED_GAPS longest,
the gaps are summed under one name.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

LABEL = 'portbench.'
NAMED_GAPS = 2000    # the longest gaps, each named; the rest summed


def host_range(part: str):
    """A host range the gaps are named by (no cost when not profiling)."""
    return record_function(LABEL + part)


class DeviceTrace:
    """Start with ``start()``, stop with ``stop()``; then ``summary()``."""

    def __init__(self):
        self._prof = None
        self.window_s = None
        self._t0 = None

    def start(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    @staticmethod
    def _labels(evs):
        return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                 e.start_thread_id()) for e in evs
                if e.name().startswith(LABEL)
                and str(e.device_type()).endswith('CPU')]

    def summary(self, kernel_filters=()):
        """{'busy_s', 'window_s', 'device_ops', 'idle_gaps', 'kernel_s':
        {filter: seconds of device ops whose name holds it}}."""
        evs = self._prof.profiler.kineto_results.events()
        dev, cpu = [], []
        for e in evs:
            if e.is_user_annotation():
                continue            # the host ranges, mirrored on the device
            kind = str(e.device_type())
            if kind.endswith('CUDA'):
                if e.duration_ns() > 0:
                    dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.name()))
            elif kind.endswith('CPU'):
                cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), e.start_thread_id()))
        by_op = defaultdict(float)
        for a, b, n in dev:
            by_op[n] += (b - a) * 1e-9
        kernel_s = {f: sum(s for n, s in by_op.items() if f in n)
                    for f in kernel_filters}
        dev.sort()
        busy, gaps = 0.0, []
        cur_a = cur_b = None
        for a, b, _ in dev:
            if cur_b is None:
                cur_a, cur_b = a, b
            elif a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        named = defaultdict(float)
        labels = [(a, b, n[len(LABEL):], t) for a, b, n, t
                  in self._labels(evs)]
        # The dispatching thread is the one that opens the 'dispatch'
        # ranges (the profiler's thread ids are its own).
        tids = [t for *_, n, t in labels if n == 'dispatch']
        tid = tids[0] if tids else None
        ops = sorted((a, b, n) for a, b, n, t in cpu if t == tid)
        starts = [o[0] for o in ops]
        ranked = sorted(gaps, key=lambda g: g[0] - g[1])
        for ga, gb in ranked[:NAMED_GAPS]:
            mid = (ga + gb) // 2
            lab = [n for a, b, n, _ in labels if a <= mid <= b]
            name = min(lab, key=len) if lab else 'outside the driver'
            # Operators nest: the covering one that started last is the
            # innermost.
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 500, -1), -1):
                if ops[j][1] >= mid:
                    name += ' > ' + ops[j][2]
                    break
            named[name] += (gb - ga) * 1e-9
        if len(ranked) > NAMED_GAPS:
            shortest = ranked[NAMED_GAPS - 1]
            named[f'{len(ranked) - NAMED_GAPS} gaps under '
                  f'{(shortest[1] - shortest[0]) * 1e-3:.1f} us'] = sum(
                (b - a) for a, b in ranked[NAMED_GAPS:]) * 1e-9
        return dict(
            busy_s=busy * 1e-9, window_s=self.window_s,
            device_ops=sorted(([n, s] for n, s in by_op.items()),
                              key=lambda x: -x[1])[:10],
            idle_gaps=sorted(([n, s] for n, s in named.items()),
                             key=lambda x: -x[1])[:10],
            kernel_s=kernel_s, n_device_ops=len(dev))
