"""Streaming log2 histograms: bounded-error quantiles without the sample
list. The port's own copy of the JAX package's ``obs/histogram.py``
(standard library only), with the same geometry, state and receipt keys.

:class:`LogHistogram` bins samples geometrically (HDR-histogram style):
O(bins) memory forever, O(1) record, mergeable state (element-wise count
addition — shard per recorder, merge at receipt time), and quantiles
whose relative error is bounded by the bucket ratio, a constant chosen at
construction, never by the data.

Geometry: bucket 0 absorbs everything at or below ``min_value`` (zeros
included); bucket ``i >= 1`` covers the half-open ratio interval
``(min_value * r^(i-1), min_value * r^i]`` with ``r = 2^(1/bins_per_octave)``;
values past ``max_value`` clamp into the last bucket (the true max is kept
apart, so the tail quantile stays honest). A quantile estimate is the
geometric midpoint of its bucket, clamped to the observed [min, max], so
the worst-case relative error against any sample in the bucket is
``sqrt(r) - 1``; :attr:`LogHistogram.rel_error_bound` (``r - 1``, one whole
bucket) is the documented guarantee the tests hold the sort-based
percentiles to.
"""

from __future__ import annotations

import math


class LogHistogram:
    """Fixed-bucket log2 histogram with mergeable state.

    Parameters
    ----------
    min_value: lower edge of bucket 1; everything at or below lands in
        bucket 0 (the underflow bucket). Must be > 0.
    max_value: values above it clamp into the last bucket.
    bins_per_octave: buckets per factor-of-2 — the resolution/memory
        knob. 8 gives a bucket ratio of ~1.09 (relative error bound ~9%)
        at ~27 buckets per factor-of-1e8 span decade-octave.
    """

    __slots__ = (
        "min_value", "max_value", "bins_per_octave", "n_bins",
        "counts", "n", "total", "min_seen", "max_seen",
    )

    def __init__(self, min_value: float = 1e-4, max_value: float = 1e4,
                 bins_per_octave: int = 8):
        if min_value <= 0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        if max_value <= min_value:
            raise ValueError("max_value must exceed min_value")
        if bins_per_octave < 1:
            raise ValueError("bins_per_octave must be >= 1")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.bins_per_octave = int(bins_per_octave)
        octaves = math.log2(self.max_value / self.min_value)
        # +1 for the underflow bucket 0; ceil so max_value itself fits
        self.n_bins = int(math.ceil(octaves * self.bins_per_octave)) + 1
        self.counts = [0] * self.n_bins
        self.n = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = -math.inf

    # -- recording ---------------------------------------------------------

    def _bucket(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        i = int(math.log2(value / self.min_value) * self.bins_per_octave)
        # log2 of an exact bucket edge can land on the edge index; the
        # interval is (lo, hi], so push exact-edge values down a bucket
        lo = self.min_value * 2.0 ** (i / self.bins_per_octave)
        if value <= lo and i > 0:
            i -= 1
        return min(i + 1, self.n_bins - 1)

    def record(self, value: float) -> None:
        """O(1) intake of one sample; NaNs are dropped (counted nowhere —
        a non-finite latency is a bug upstream, not a tail event)."""
        v = float(value)
        if math.isnan(v):
            return
        self.counts[self._bucket(v)] += 1
        self.n += 1
        self.total += v
        self.min_seen = min(self.min_seen, v)
        self.max_seen = max(self.max_seen, v)

    # -- merge -------------------------------------------------------------

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Element-wise merge of ``other`` into self (both must share
        geometry). Recording shards independently and merging is EXACTLY
        recording everything into one histogram — bucketing is
        deterministic — which is what makes per-worker recorders safe."""
        if (other.min_value, other.max_value, other.bins_per_octave) != (
            self.min_value, self.max_value, self.bins_per_octave
        ):
            raise ValueError("cannot merge histograms of different geometry")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.min_seen = min(self.min_seen, other.min_seen)
        self.max_seen = max(self.max_seen, other.max_seen)
        return self

    # -- quantiles ---------------------------------------------------------

    @property
    def rel_error_bound(self) -> float:
        """One full bucket's relative width — the documented worst-case
        quantile error vs an exact sort (the estimate itself is the
        geometric midpoint, so typically half this)."""
        return 2.0 ** (1.0 / self.bins_per_octave) - 1.0

    def quantile(self, q: float) -> float:
        """Bounded-error quantile: walk the cumulative counts to the
        bucket holding rank ``ceil(q * n)`` and return its geometric
        midpoint clamped to the observed [min, max]. Returns 0.0 on an
        empty histogram (receipts round-trip through JSON; NaN does not)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.n == 0:
            return 0.0
        target = max(1, math.ceil(q * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if i == 0:
                    est = self.min_value
                else:
                    hi = self.min_value * 2.0 ** (i / self.bins_per_octave)
                    lo = self.min_value * 2.0 ** (
                        (i - 1) / self.bins_per_octave
                    )
                    est = math.sqrt(lo * hi)
                return min(max(est, self.min_seen), self.max_seen)
        return self.max_seen  # unreachable unless counts were mutated

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self, prefix: str = "", unit: str = "") -> dict:
        """Flat receipt-ready dict: count/mean/min/max + p50/p95/p99.
        ``unit`` suffixes the value keys (``ttft_p95_s``-style names)."""
        u = f"_{unit}" if unit else ""
        return {
            f"{prefix}count": self.n,
            f"{prefix}mean{u}": self.mean,
            f"{prefix}min{u}": self.min_seen if self.n else 0.0,
            f"{prefix}max{u}": self.max_seen if self.n else 0.0,
            f"{prefix}p50{u}": self.quantile(0.50),
            f"{prefix}p95{u}": self.quantile(0.95),
            f"{prefix}p99{u}": self.quantile(0.99),
        }

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-ready state; sparse counts keep flight-log dumps small."""
        return {
            "min_value": self.min_value,
            "max_value": self.max_value,
            "bins_per_octave": self.bins_per_octave,
            "n": self.n,
            "total": self.total,
            "min_seen": self.min_seen if self.n else None,
            "max_seen": self.max_seen if self.n else None,
            "counts": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(
            min_value=d["min_value"], max_value=d["max_value"],
            bins_per_octave=d["bins_per_octave"],
        )
        for i, c in d["counts"].items():
            h.counts[int(i)] = int(c)
        h.n = int(d["n"])
        h.total = float(d["total"])
        h.min_seen = (
            float(d["min_seen"]) if d.get("min_seen") is not None
            else math.inf
        )
        h.max_seen = (
            float(d["max_seen"]) if d.get("max_seen") is not None
            else -math.inf
        )
        return h
