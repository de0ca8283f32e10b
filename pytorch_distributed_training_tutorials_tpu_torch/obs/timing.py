"""Min-of-N timing with stalls kept visible (an own copy of the JAX
package's ``obs/timing.py:MinOfN`` and ``TimingResult``).

The measured callable must end with one real sync with the device
(``torch.cuda.synchronize()`` or a ``.item()`` of its last result):
PyTorch returns before the device finishes, so a host clock without a
sync measures the enqueue. A sample more than ``stall_factor`` x the
median is counted as a stall instead of silently widening the min.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class TimingResult:
    """Samples from a min-of-N run, stalls separated from steady state."""

    samples_s: list[float]
    stall_factor: float

    @property
    def best_s(self) -> float:
        return min(self.samples_s)

    @property
    def median_s(self) -> float:
        s = sorted(self.samples_s)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    @property
    def stalled_s(self) -> list[float]:
        """Samples that hit a stall (> stall_factor x median)."""
        med = self.median_s
        return [s for s in self.samples_s if s > self.stall_factor * med]

    @property
    def n_stalled(self) -> int:
        return len(self.stalled_s)

    def to_dict(self) -> dict:
        return {
            "best_s": round(self.best_s, 6),
            "median_s": round(self.median_s, 6),
            "n": len(self.samples_s),
            "n_stalled": self.n_stalled,
            "stall_factor": self.stall_factor,
            "samples_s": [round(s, 6) for s in self.samples_s],
        }


class MinOfN:
    """min-of-N timer for a callable that ENDS WITH A REAL SYNC.

    ``fn`` is run once un-timed first when ``warmup`` is set (first
    launches, allocator growth and kernel builds belong outside the timed
    region)."""

    def __init__(self, n: int = 3, stall_factor: float = 5.0, warmup: bool = True):
        if n < 1:
            raise ValueError("MinOfN needs n >= 1")
        self.n = n
        self.stall_factor = stall_factor
        self.warmup = warmup

    def measure(self, fn: Callable[[], object]) -> TimingResult:
        if self.warmup:
            fn()
        samples: list[float] = []
        for _ in range(self.n):
            t0 = time.perf_counter()
            fn()  # the contract: fn's last action is a sync with the device
            samples.append(time.perf_counter() - t0)
        return TimingResult(samples_s=samples, stall_factor=self.stall_factor)
