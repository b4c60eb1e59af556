"""Thread-safe numpy RNG for data transforms (counterpart of
`sc2bench_tpu/utils/rngtools.py`).

`np.random.Generator` is not thread-safe, and a loader may run its
transforms from several threads. `ThreadLocalRng` gives each thread its
own child generator spawned from one `SeedSequence`: the draws are valid
and independent per thread, and a single-threaded run is reproducible
from the seed (a multi-threaded one only as a set, since children go to
threads in first-touch order)."""
from __future__ import annotations

import threading

import numpy as np


class ThreadLocalRng:
    """Duck-types a `np.random.Generator`; each thread lazily gets its own
    child generator spawned from the seed sequence."""

    def __init__(self, seed=None):
        self._seq = np.random.SeedSequence(seed)
        self._local = threading.local()
        self._spawn_lock = threading.Lock()

    def _rng(self) -> np.random.Generator:
        rng = getattr(self._local, 'rng', None)
        if rng is None:
            with self._spawn_lock:
                child = self._seq.spawn(1)[0]
            rng = np.random.default_rng(child)
            self._local.rng = rng
        return rng

    def __getattr__(self, name):
        if name.startswith('_'):
            # never proxy private lookups: unpickling and deepcopy probe
            # them before __dict__ is restored, which would recurse
            raise AttributeError(name)
        return getattr(self._rng(), name)
