"""Straggler detection from per-host step heartbeats (the port's copy of
``repro/ft/heartbeat.py``; plain Python).

Each host posts (host_id, step, wall_time) after every step; the detector
classifies hosts whose step time runs past ``slow_factor`` × the median
as slow, and hosts silent for ``dead_factor`` × the median as dead. The
store is in memory. ``ServingEngine`` posts one heartbeat per served
microbatch and reports ``stragglers()`` with its workload statistics.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HostRecord:
    step: int = -1
    last_seen: float = 0.0
    step_times: list[float] = field(default_factory=list)


class StragglerDetector:
    def __init__(self, *, window: int = 20, slow_factor: float = 2.0,
                 dead_factor: float = 5.0):
        self.hosts: dict[str, HostRecord] = {}
        self.window = window
        self.slow_factor = slow_factor
        self.dead_factor = dead_factor

    def heartbeat(self, host: str, step: int, now: float | None = None):
        now = time.monotonic() if now is None else now
        rec = self.hosts.setdefault(host, HostRecord())
        if rec.step >= 0 and step > rec.step:
            rec.step_times.append((now - rec.last_seen) / (step - rec.step))
            rec.step_times = rec.step_times[-self.window :]
        rec.step, rec.last_seen = step, now

    def median_step_time(self) -> float:
        times = sorted(
            t for r in self.hosts.values() for t in r.step_times[-self.window :]
        )
        return times[len(times) // 2] if times else float("inf")

    def stragglers(self, now: float | None = None) -> dict[str, str]:
        """host -> 'slow' | 'dead' classification."""
        now = time.monotonic() if now is None else now
        med = self.median_step_time()
        out = {}
        for host, rec in self.hosts.items():
            if rec.step_times and rec.step_times[-1] > self.slow_factor * med:
                out[host] = "slow"
            if now - rec.last_seen > self.dead_factor * max(med, 1e-9):
                out[host] = "dead"
        return out
