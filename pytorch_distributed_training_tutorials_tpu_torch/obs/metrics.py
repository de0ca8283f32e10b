"""MetricsLogger: per-step and per-epoch telemetry without per-step host
syncs (port of the JAX package's ``obs/metrics.py``).

``log_step`` keeps a step's loss, and any ``extra`` scalars (the guarded
step's ``"skipped"`` flag), as the device scalars they are; the pending
scalars are fetched in ONE batched copy (stacked on the device, one
``.tolist()``) when an epoch is logged or at :meth:`flush`. Every fetch is
counted in ``host_fetches``. Events land in a ring buffer; console lines
print on rank 0 unless ``quiet``. With a ``flight`` recorder
(:class:`.flight.FlightRecorder`), a drained step whose ``"skipped"`` flag
is set becomes a ``step_skipped`` event: the flag rode the drain's one
fetch, so the recorder learns of the skip with no sync of its own.
"""

from __future__ import annotations

import collections

import torch

from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import log0

CAPACITY = 4096  # events kept, and pending scalars between drains


class MetricsLogger:
    """Ring buffer of step and epoch events, with one batched fetch of the
    pending step losses per drain."""

    def __init__(self, *, quiet: bool = False, flight=None):
        self.events: collections.deque[dict] = collections.deque(maxlen=CAPACITY)
        self._pending: collections.deque[tuple[int, torch.Tensor | float, dict | None]] = (
            collections.deque(maxlen=CAPACITY))
        self.quiet = quiet
        self.flight = flight
        self.host_fetches = 0

    def say(self, msg: str) -> None:
        """Console line: rank-0 gated, silenced by ``quiet``."""
        if not self.quiet:
            log0(msg)

    def log_step(self, step: int, loss, extra: dict | None = None) -> None:
        """Record a step's loss and ``extra`` scalars, un-fetched: they ride
        the next drain's one fetch."""
        self._pending.append((int(step), loss, extra))

    def log_epoch(self, metrics: dict) -> dict:
        """Record an epoch event (draining pending steps first) and print
        the epoch line unless quiet."""
        self.flush()
        event = {"kind": "epoch", **metrics}
        self.events.append(event)
        self.say(f"  epoch {metrics['epoch']}: loss {metrics['loss']:.4f} | "
                 f"{metrics['steps_per_sec']:.1f} steps/s | "
                 f"{metrics['samples_per_sec']:.0f} samples/s")
        return event

    def flush(self) -> None:
        """Drain the pending step losses: every device scalar in one
        stacked copy to the host."""
        if not self._pending:
            return
        pending = list(self._pending)
        self._pending.clear()
        values = [v for _, loss, extra in pending for v in (loss, *(extra or {}).values())]
        on_device = [v for v in values if isinstance(v, torch.Tensor)]
        fetched = iter([])
        if on_device:
            fetched = iter(torch.stack([v.detach().double().reshape(()) for v in on_device])
                           .tolist())
            self.host_fetches += 1

        def host(v) -> float:
            return next(fetched) if isinstance(v, torch.Tensor) else float(v)

        for step, loss, extra in pending:
            event = {"kind": "step", "step": step, "loss": host(loss)}
            event.update({k: host(v) for k, v in (extra or {}).items()})
            if self.flight is not None and event.get("skipped"):
                self.flight.step_skipped(step=step)
            self.events.append(event)

    def step_events(self) -> list[dict]:
        return [e for e in self.events if e.get("kind") == "step"]

    def epoch_events(self) -> list[dict]:
        return [e for e in self.events if e.get("kind") == "epoch"]
