"""Pieces the BEV drivers share: the frame producer, the stash of the
program's semseg labels, and the record of each stats kernel call's rows
in the traced stretch."""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

from portbench.arith import stats_bytes


class Prefetch:
    """Items ``make(i)`` made on one worker thread, ``depth`` ahead of the
    one asked for (the traffic's producer). ``lag()``: how long ``get``
    waited for items not yet made, since ``reset_lag()``."""

    def __init__(self, make, depth: int):
        self.make = make
        self.depth = depth
        self.ex = ThreadPoolExecutor(max_workers=1)
        self.futs = {}
        self.next = 0
        self.reset_lag()

    def reset_lag(self):
        self.waits = []

    def start(self, i: int):
        while self.next < i + self.depth + 1:
            self.futs[self.next] = self.ex.submit(self.make, self.next)
            self.next += 1

    def get(self, i: int):
        if i not in self.futs:
            self.next = max(self.next, i)
            self.futs[i] = self.ex.submit(self.make, i)
            self.next = max(self.next, i + 1)
        self.start(i)
        fut = self.futs.pop(i)
        t0 = time.perf_counter()
        item = fut.result()
        self.waits.append(time.perf_counter() - t0)
        return item

    def lag(self) -> dict:
        w = self.waits
        return dict(producer_wait_s=sum(w),
                    producer_wait_max_ms=1e3 * max(w, default=0.0),
                    producer_waits_over_1ms=sum(x > 1e-3 for x in w),
                    producer_gets=len(w))

    def close(self):
        for f in self.futs.values():
            f.cancel()
        self.ex.shutdown(wait=True)
        self.futs.clear()


class LabelStash:
    """Keeps the class maps that the program's ``predict`` returns for the
    frames ``keep(frame)`` names (the frame is ``frame_of()`` at the
    call), as uint8 on the device: one small cast, so that the stash adds
    a quarter of the int32 maps to the run's memory peak."""

    def __init__(self, semseg, frame_of, keep):
        self.labels = {}
        self.keep = keep
        orig = semseg.predict

        def predict(images):
            out = orig(images)
            fid = frame_of()
            if self.keep(fid):
                self.labels[fid] = out.to(torch.uint8)
                self.prune(self.keep)
            return out

        semseg.predict = predict

    def prune(self, keep):
        for fid in [f for f in self.labels if not keep(f)]:
            del self.labels[fid]


class StatsCalls:
    """While ``on``, records each kernel-1 call's keyed rows (a 0-d device
    tensor) and group count, for the byte bound of the calls a traced
    stretch holds."""

    def __init__(self):
        self.on = False
        self.calls = []

    def install(self):
        from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
        orig = ss.segmented_stats_words

        def words(sorted_c2, sorted_w1, sorted_w2, num_groups, *a, **kw):
            if self.on:
                self.calls.append(((sorted_c2 < num_groups).sum(),
                                   int(num_groups)))
            return orig(sorted_c2, sorted_w1, sorted_w2, num_groups, *a,
                        **kw)

        words.launches = orig.launches
        ss.segmented_stats_words = words
        self._restore = (ss, orig)

    def uninstall(self):
        ss, orig = self._restore
        ss.segmented_stats_words = orig

    def bound_s(self) -> float:
        return sum(stats_bytes.words_bound(int(k), g)['bound_s']
                   for k, g in self.calls)
