"""Host-side phase timers (port of PhaseAccumulator,
lzzx_nerf_tpu/utils/profiling.py)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class PhaseAccumulator:
    """Wall-time totals of named host phases (input staging, dispatch,
    fetch and sink) around the chunk loop; device work inside a phase is
    counted only where the phase waits for it."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        return " ".join(f"{k}={v:.3f}s" for k, v in self.totals.items())
