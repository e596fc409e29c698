"""Per-phase wall-clock aggregation (the JAX package's utils/profiling.py
PhaseTimer; its jax.profiler trace context has no counterpart here:
device traces come from torch.profiler)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
