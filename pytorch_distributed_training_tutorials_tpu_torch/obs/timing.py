"""Honest wall-clock timing (an own copy of the JAX package's
``obs/timing.py``).

- :class:`MinOfN`: min-of-N with stalls kept visible: a sample more than
  ``stall_factor`` x the median is counted as a stall instead of silently
  widening the min;
- :class:`DriftBracket`: a ceiling leg (a raw copy or compute of the same
  bytes) run before AND after a main leg; only same-window legs compare,
  and the ratio of the two ceilings says how far the window moved;
- :func:`launch_overhead_fit`: ``wall = fixed + per_op * len`` over two
  chain lengths, which separates a launch's fixed cost from per-op time.

None of them times anything by itself: the measured callable must end
with one real sync with the device (``torch.cuda.synchronize()`` or a
``.item()`` of its last result). PyTorch returns before the device
finishes, so a host clock without a sync measures the enqueue.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence


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


@dataclass
class BracketResult:
    """A main-leg measurement bracketed by before and after ceiling legs."""

    result: object
    before_s: float
    after_s: float
    payload_bytes: int = 0

    @property
    def drift(self) -> float:
        """max / min of the two ceiling legs: how far the window moved (1.0:
        the main leg and its ceiling are comparable)."""
        lo = min(self.before_s, self.after_s)
        hi = max(self.before_s, self.after_s)
        return hi / lo if lo > 0 else float("inf")

    @property
    def ceiling_s(self) -> float:
        return min(self.before_s, self.after_s)

    def bandwidth_mbs(self) -> float | None:
        if not self.payload_bytes:
            return None
        return self.payload_bytes / self.ceiling_s / 1e6

    def to_dict(self) -> dict:
        d = {
            "ceiling_before_s": round(self.before_s, 4),
            "ceiling_after_s": round(self.after_s, 4),
            "window_drift": round(self.drift, 2),
        }
        bw = self.bandwidth_mbs()
        if bw is not None:
            d["ceiling_mb_s"] = round(bw, 2)
        return d


class DriftBracket:
    """Bracket a main measurement with a repeated ceiling leg:
    ``ceiling_fn`` (a raw reference transfer or compute, ending in a real
    sync) runs immediately before and after ``main_fn``."""

    def __init__(self, ceiling_fn: Callable[[], object], payload_bytes: int = 0):
        self.ceiling_fn = ceiling_fn
        self.payload_bytes = payload_bytes

    def _time_ceiling(self) -> float:
        t0 = time.perf_counter()
        self.ceiling_fn()  # the contract: ends with a real sync
        return time.perf_counter() - t0

    def around(self, main_fn: Callable[[], object]) -> BracketResult:
        before = self._time_ceiling()
        result = main_fn()
        after = self._time_ceiling()
        return BracketResult(result=result, before_s=before, after_s=after,
                             payload_bytes=self.payload_bytes)


@dataclass
class LaunchFit:
    """``wall = fixed + per_op * len`` over chain lengths."""

    fixed_ms: float
    per_op_us: float
    lens: tuple[int, ...]
    wall_s: tuple[float, ...] = field(default_factory=tuple)

    def naive_per_op_us(self, length: int) -> float:
        """What dividing one chain of ``length`` by its length would say."""
        return self.fixed_ms * 1e3 / length + self.per_op_us

    def to_dict(self) -> dict:
        return {
            "fixed_ms": round(self.fixed_ms, 3),
            "per_op_us": round(self.per_op_us, 3),
            "lens": list(self.lens),
            "wall_s": [round(w, 6) for w in self.wall_s],
        }


def launch_overhead_fit(time_chain: Callable[[int], float],
                        lens: Sequence[int] = (64, 1024)) -> LaunchFit:
    """Separate a chain's fixed cost from its per-op cost.

    ``time_chain(n)`` returns the wall seconds of one chain of ``n`` ops,
    ended by a real sync and already stall-filtered (min-of-N). The
    shortest and longest lengths give the slope (per op: for eager ops on
    the card, the host's launch cost where it exceeds the device's) and
    the intercept (the fixed cost of a chain and its sync)."""
    if len(lens) < 2:
        raise ValueError("need at least two chain lengths to fit")
    ls = sorted(set(int(n) for n in lens))
    walls = [time_chain(n) for n in ls]
    short_n, long_n = ls[0], ls[-1]
    short_t, long_t = walls[0], walls[-1]
    per_op_us = (long_t - short_t) / (long_n - short_n) * 1e6
    fixed_ms = (short_t - per_op_us * 1e-6 * short_n) * 1e3
    return LaunchFit(fixed_ms=fixed_ms, per_op_us=per_op_us, lens=tuple(ls), wall_s=tuple(walls))
