"""Frame-time statistics.

Port of rustexp_tpu/core/timing.py (pure Python, copied so the port
imports no jax through rustexp_tpu/core/__init__.py), less its getTick
and timeIt, which the port does not use (core/trace.py's spans time the
program's layers).

Re-expresses the reference's bounded ring of frame times with median
(hs-src/BoundedSequence.hs:16-46, hs-src/Median.hs:7-15) and the
median/min/max overlay statistics (hs-src/App.hs:135-150).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


def median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 == 1 else 0.5 * (xs[mid - 1] + xs[mid])


@dataclass
class FrameTimes:
    """Bounded ring of frame durations with median/min/max stats.

    Reference: BoundedSequence.hs:16-46 + App.hs:135-150 (60-deep ring,
    first frames treated as outliers by the caller).
    """

    limit: int = 60
    times: deque = field(default_factory=deque)

    def push(self, dt: float) -> None:
        self.times.appendleft(dt)
        while len(self.times) > self.limit:
            self.times.pop()

    def stats(self):
        if not self.times:
            return 0.0, 0.0, 0.0, 0.0
        med = median(self.times)
        lo, hi = min(self.times), max(self.times)
        fps = 1.0 / med if med > 0 else 0.0
        return fps, med, lo, hi

    def status_string(self) -> str:
        fps, med, lo, hi = self.stats()
        return (
            f"{fps:.1f}FPS/{med * 1000:.2f}ms (Worst: {1.0 / hi if hi else 0:.1f}, "
            f"Best: {1.0 / lo if lo else 0:.1f})"
        )
