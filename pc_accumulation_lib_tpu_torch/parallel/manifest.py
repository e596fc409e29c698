"""Resumable generation manifest (host JSON lines).

The port's copy of parallel/manifest.py: a JSON-lines file records the
finished work units of a dataset job, so a restarted job skips them and
resumes its output numbering after them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional


class CompletionManifest:

    def __init__(self, path: str):
        self.path = path
        self._done: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rec = json.loads(line)
                        self._done[rec['unit']] = rec

    def is_done(self, unit: str) -> bool:
        """True for units that completed work. A skip record (this run's
        filters excluded the unit) does not count: a later run with other
        filters evaluates the unit again."""
        rec = self._done.get(unit)
        return rec is not None and not rec.get('skipped')

    def get(self, unit: str) -> Optional[dict]:
        """The unit's record (None if pending); runners read its output
        count to resume their numbering."""
        return self._done.get(unit)

    def mark_done(self, unit: str, **meta) -> None:
        rec = {'unit': unit, **meta}
        self._done[unit] = rec
        os.makedirs(os.path.dirname(self.path) or '.', exist_ok=True)
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def mark_skipped(self, unit: str, reason: str) -> None:
        """Record that this run's filters excluded ``unit``; it stays
        pending. A repeat skip for the same reason is not appended."""
        prev = self._done.get(unit)
        if prev is not None and prev.get('skipped') == reason:
            return
        self.mark_done(unit, bevs=0, skipped=reason)

    def pending(self, units: Iterable[str]) -> List[str]:
        return [u for u in units if not self.is_done(u)]

    def stats(self) -> dict:
        return {'done': len(self._done)}


def shard_units(units: List[str], shard_idx: int, num_shards: int,
                manifest: Optional[CompletionManifest] = None) -> List[str]:
    """The strided shard of ``units`` for process ``shard_idx`` of
    ``num_shards``, minus the units the manifest has done."""
    mine = [u for i, u in enumerate(units) if i % num_shards == shard_idx]
    if manifest is not None:
        mine = manifest.pending(mine)
    return mine
