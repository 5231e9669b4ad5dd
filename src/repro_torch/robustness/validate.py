"""Per-request deadlines for the query engine.

Only :class:`Deadline` is ported in this slice; the typed ``DecodeError``
taxonomy, the stream validators and checksum-verified decode are ROADMAP
queue 1 item 9.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Deadline:
    """A per-request time budget with an injectable clock.

    ``expired()`` is checked at work-unit boundaries (per decoded chunk /
    per term / per MaxScore strip) — work in flight always completes, so a
    deadline never yields a torn result, only a *smaller* one flagged
    ``degraded``. ``clock`` is injectable so tests expire deadlines
    deterministically.
    """

    budget_s: float
    clock: callable = time.monotonic
    start: float = field(default=None)  # type: ignore[assignment]
    hit: bool = False  # set once expired() first returns True

    def __post_init__(self):
        if self.start is None:
            self.start = self.clock()

    def expired(self) -> bool:
        if not self.hit and self.clock() - self.start >= self.budget_s:
            self.hit = True
        return self.hit

    def remaining(self) -> float:
        return max(0.0, self.budget_s - (self.clock() - self.start))
