"""Straggler mitigation: per-step timing watchdog + slow-host hook.

A copy of ``repro.train.watchdog`` (pure Python).  At multi-node scale a
single slow host gates every collective.  The watchdog keeps a running
mean/variance of step wall-times, flags z-score outliers, and calls a
pluggable ``on_straggler`` hook (production: report the host for
exclusion and restart from the last checkpoint; locally: log).  The
data pipeline is stateless (step -> batch is pure), so re-issuing a
straggler's work after exclusion is deterministic.  The caller makes a
step's time the device's by synchronising before :meth:`stop`.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional


class StragglerWatchdog:
    def __init__(self, z_threshold: float = 3.0, warmup: int = 5,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.z = z_threshold
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.events: List[dict] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        if self._t0 is None:
            raise RuntimeError("start() not called")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.n += 1
        delta = dt - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (dt - self.mean)
        if self.n > self.warmup:
            std = (self.m2 / (self.n - 1)) ** 0.5
            if std > 0 and (dt - self.mean) / std > self.z:
                self.events.append({"step": step, "seconds": dt,
                                    "mean": self.mean, "std": std})
                if self.on_straggler:
                    self.on_straggler(step, dt)
        return dt
