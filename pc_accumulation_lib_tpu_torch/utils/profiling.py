"""Per-phase wall-clock aggregation and a device trace context.

Counterpart of utils/profiling.py: PhaseTimer, and device_trace over
torch.profiler where the JAX package's is over jax.profiler."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    with timer.phase('integrate'): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f'{name:24s} total {t:8.3f}s  n {n:5d}  '
                         f'mean {t / max(n, 1) * 1e3:8.2f}ms')
        return '\n'.join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (host and, where there is a
    card, CUDA activity), written to ``log_dir`` as a Chrome trace;
    nothing when log_dir is None."""
    if log_dir is None:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
