"""MetricsLogger: per-step and per-epoch telemetry without per-step host
syncs (port of the JAX package's ``obs/metrics.py``).

Every event lands in a ring buffer and, on rank 0 only, an optional JSONL
sink; the verbose step line the Trainer prints goes through the same code
path, so the printed loss and the recorded one are the same fetched float.

The hot-path contract: ``log_step`` keeps a step's loss, and any
``extra`` scalars (the guarded step's ``"skipped"`` flag), as the device
scalars they are; the pending scalars are fetched in ONE batched copy
(stacked on the device, one ``.tolist()``) when an epoch is logged or at
:meth:`flush`. The one deliberate exception is a verbose step (the
Trainer's ``log_every`` opt-in), which fetches its loss. Every fetch is
counted in ``host_fetches``. With a ``flight`` recorder
(:class:`.flight.FlightRecorder`), a drained step whose ``"skipped"`` flag
is set becomes a ``step_skipped`` event: the flag rode the drain's one
fetch, so the recorder learns of the skip with no sync of its own.

The JAX logger's ``defer_host_fetch`` (epoch boundaries that skip the
drain, a knob of its deferred XLA epochs) is not ported: the port's
epoch ends with its one fetch.
"""

from __future__ import annotations

import collections
import json
from typing import IO

import torch

from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import process_index
from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import log0


class MetricsLogger:
    """Ring buffer + JSONL sink for step and epoch events, rank-0 gated.

    Parameters
    ----------
    jsonl_path: sink file (one JSON object a line, appended); None:
        in memory only.
    capacity: ring-buffer size for both recorded events and pending scalars.
    quiet: suppress ALL console lines (bench runs); events still record.
    flops_per_token / peak_flops / tokens_per_sample: when set, epoch
        events gain ``tokens_per_sec`` (``samples_per_sec`` x
        ``tokens_per_sample``) and ``mfu`` (``tokens_per_sec`` x
        ``flops_per_token`` / ``peak_flops``: the analytic-FLOPs
        convention of :func:`..models.utils.model_flops_per_token`).
    flight: optional :class:`.flight.FlightRecorder` (module docstring).
    """

    def __init__(self, *, jsonl_path: str | None = None, capacity: int = 4096,
                 quiet: bool = False, flops_per_token: float | None = None,
                 peak_flops: float | None = None, tokens_per_sample: int | None = None,
                 flight=None):
        self.events: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._pending: collections.deque[tuple[int, torch.Tensor | float, dict | None]] = (
            collections.deque(maxlen=capacity))
        self.jsonl_path = jsonl_path
        self.quiet = quiet
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.tokens_per_sample = tokens_per_sample
        self.flight = flight
        self.host_fetches = 0
        self._sink: IO[str] | None = None

    # -- gating ------------------------------------------------------------

    @property
    def is_process_zero(self) -> bool:
        """This process is rank 0 of ``torch.distributed`` (or no group is
        initialized)."""
        return process_index() == 0

    def say(self, msg: str) -> None:
        """Console line: rank-0 gated, silenced by ``quiet``."""
        if not self.quiet:
            log0(msg)

    # -- event intake ------------------------------------------------------

    def log_step(self, step: int, loss, verbose: bool = False,
                 extra: dict | None = None) -> None:
        """Record a step's loss and ``extra`` scalars, un-fetched: they ride
        the next drain's one fetch. ``verbose`` (the Trainer's
        ``log_every`` opt-in) fetches the loss once — counted in
        ``host_fetches`` — and prints and records the same float."""
        if verbose:
            if isinstance(loss, torch.Tensor):
                self.host_fetches += 1
            loss = float(loss)  # the single opted-in fetch
            self.say(f"  step {step}: loss {loss:.4f}")
        self._pending.append((int(step), loss, extra))

    def log_epoch(self, metrics: dict) -> dict:
        """Record an epoch event (draining pending steps first) and print
        the epoch line unless quiet."""
        self._drain_pending()
        event = {"kind": "epoch", **metrics}
        if self.tokens_per_sample and "samples_per_sec" in metrics:
            event["tokens_per_sec"] = metrics["samples_per_sec"] * self.tokens_per_sample
        if self.flops_per_token and self.peak_flops and "tokens_per_sec" in event:
            event["mfu"] = event["tokens_per_sec"] * self.flops_per_token / self.peak_flops
        self._record(event)
        self.say(f"  epoch {metrics['epoch']}: loss {metrics['loss']:.4f} | "
                 f"{metrics['steps_per_sec']:.1f} steps/s | "
                 f"{metrics['samples_per_sec']:.0f} samples/s")
        return event

    # -- draining ----------------------------------------------------------

    def _drain_pending(self) -> None:
        """Every pending device scalar in one stacked copy to the host."""
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
            self._record(event)

    def flush(self) -> None:
        """Drain the pending step scalars (one fetch) and flush the JSONL
        sink."""
        self._drain_pending()
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        self.flush()
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- storage -----------------------------------------------------------

    def _record(self, event: dict) -> None:
        self.events.append(event)
        if self.jsonl_path and self.is_process_zero:
            if self._sink is None:
                self._sink = open(self.jsonl_path, "a")
            self._sink.write(json.dumps(event) + "\n")

    # -- views -------------------------------------------------------------

    @property
    def last_epoch(self) -> dict | None:
        for ev in reversed(self.events):
            if ev.get("kind") == "epoch":
                return ev
        return None

    def step_events(self) -> list[dict]:
        return [e for e in self.events if e.get("kind") == "step"]

    def epoch_events(self) -> list[dict]:
        return [e for e in self.events if e.get("kind") == "epoch"]
