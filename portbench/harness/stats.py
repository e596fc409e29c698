"""Order statistics of the host's readings."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank (a value that was read)."""
    v = sorted(values)
    if not v:
        raise ValueError('no values')
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]


def seeds(seed: int, n: int):
    """``n`` independent 32-bit seeds drawn from the run's seed."""
    import numpy as np
    return [int(s) for s in np.random.SeedSequence(int(seed))
            .generate_state(n)]
