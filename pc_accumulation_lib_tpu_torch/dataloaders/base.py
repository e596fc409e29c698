"""Observation dataloader ABC (obs_dataloaders/obs_dataloader.py:4-54
parity): index-based access, batched iteration, final partial batch dropped."""
from __future__ import annotations

from abc import ABC, abstractmethod


class ObservationDataloader(ABC):

    def __init__(self, root_path: str, batch_size: int):
        self.root_path = root_path
        self.batch_size = batch_size

    @abstractmethod
    def read_obs(self, idx: int):
        """Return a single observation for index ``idx``."""

    @abstractmethod
    def __len__(self) -> int:
        ...

    def __iter__(self):
        self.idx = 0
        return self

    def __next__(self):
        if self.idx + self.batch_size <= len(self):
            obss = []
            for _ in range(self.batch_size):
                obss.append(self.read_obs(self.idx))
                self.idx += 1
            return obss
        raise StopIteration
