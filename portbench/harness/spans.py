"""Per-layer spans taken from the benchmark's side of the calls into the
program: CUDA events recorded on the current stream before and after a
call (stream span time, not busy time), read once the window has
closed. On the CPU (tests) the host clock stands in."""
from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    """Spans by layer name. ``enabled`` False makes every wrapper the
    callable itself and records nothing."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == 'cuda'
        self._open = defaultdict(list)
        self._pairs = defaultdict(list)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def begin(self, name: str):
        if self.enabled:
            self._open[name].append(self._mark())

    def end(self, name: str):
        if self.enabled:
            self._pairs[name].append((self._open[name].pop(), self._mark()))

    def wrap(self, name: str, fn):
        if not self.enabled:
            return fn

        def wrapped(*args, **kwargs):
            self.begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.end(name)

        return wrapped

    def hook_module(self, name: str, module: torch.nn.Module):
        """A forward pre-hook and hook pair on ``module``."""
        if not self.enabled:
            return
        module.register_forward_pre_hook(lambda *_: self.begin(name))
        module.register_forward_hook(lambda *_: self.end(name))

    def millis(self) -> dict:
        """{name: [ms of each span]} (synchronizes the device)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self._pairs.items():
            if self.cuda:
                out[name] = [a.elapsed_time(b) for a, b in pairs]
            else:
                out[name] = [(b - a) * 1e3 for a, b in pairs]
        return out
