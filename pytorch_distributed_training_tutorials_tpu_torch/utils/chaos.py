"""Deterministic fault injection: the port's own copy of the JAX
package's ``utils/chaos.py``.

A :class:`ChaosConfig` names exactly where a fault lands (slot, step,
request id, chain index) and the injectors fire there and nowhere else,
so every chaos run is reproducible bit for bit. The configs are copied
whole, with the same fields and defaults; the injectors have torch
bodies:

- **device side** (:func:`poison_grads`, :func:`poison_logits`): a
  ``torch.where`` on a device step counter, never a host read, so a
  guarded step stays free of host syncs; :func:`poison_logits` given a
  host step index decides on the host instead (no upload of the index);
- **host side** (:func:`maybe_poison_batch`, :func:`maybe_fail_prefill`,
  :func:`maybe_stall`, :func:`host_spike_loss`): plain Python against host
  counters;
- **replica level** (:class:`FleetChaosConfig`, :func:`replica_killed`,
  :func:`replica_stall_pending`): host predicates the fleet router
  (:mod:`..serve.router`) reads to kill or freeze a whole replica.

The trainer consumes the training injectors (``Trainer(chaos=...)``), the
serving engine the serving ones (``ServeEngine(chaos=...)``), the router
the replica-level ones (``FleetRouter(chaos=...)``).
"""

from __future__ import annotations

import dataclasses
import time

import torch


class ChaosError(RuntimeError):
    """The injected prefill failure (:func:`maybe_fail_prefill`). A
    distinct type so tests can assert the engine survived *this* fault
    rather than swallowing an unrelated bug."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Where faults land. ``-1`` (the default) disables an injector.

    - ``nan_logit_slot`` / ``nan_logit_step``: overwrite that slot's
      logits row with NaN at that global decode-step index (the engine
      counts scan iterations across chains: chain ``c``'s iteration
      ``i`` is step ``c * tokens_per_launch + i``).
    - ``nan_grad_step``: replace every gradient leaf with NaN at that
      ``TrainState.step`` value (device-side, survives grad-accum — the
      poison lands on the averaged grads). NOTE: with the skip-step
      guard on, ``step`` freezes at the poisoned value, so this injector
      re-fires on every later attempt — state stays protected (the
      guard's whole point) but no further update ever applies. Use it
      for single-step bitwise assertions; for continue-after-fault runs
      use ``nan_batch_step``.
    - ``nan_batch_step``: poison the input batch (first leaf all-NaN) at
      that 1-based host dispatch index — host-keyed and monotonic, so it
      fires exactly ONCE even though the skipped step leaves
      ``TrainState.step`` unchanged (the guarded run continues and its
      final model equals a clean run with that one update elided).
    - ``spike_loss_step`` / ``spike_loss_len`` / ``spike_loss_factor``:
      multiply the loss the Trainer's rollback monitor SEES for
      ``spike_loss_len`` consecutive host steps starting at host step
      ``spike_loss_step`` (1-based, monotonic across rollbacks).
    - ``fail_prefill_request``: raise :class:`ChaosError` when the
      engine is about to prefill that request id.
    - ``stall_chain`` / ``stall_s``: sleep ``stall_s`` seconds before
      dispatching chain index ``stall_chain`` — a deterministic stand-in
      for a multi-second launch stall.
    - ``preempt_slot`` / ``preempt_at_chain``: force the SLO engine to
      preempt that slot (KV swap-out to host) at the chain-boundary
      check once its chain counter reaches ``preempt_at_chain`` — the
      swap path is testable without manufacturing real pool pressure.
      Fires exactly ONCE (the engine latches the firing); the victim
      resumes through the ordinary swap-in path, token-exact. Requires
      ``priority_classes > 0`` on the engine; ignored otherwise.
    - ``seed`` rides into receipts/fingerprints so chaos runs are
      self-describing; the injectors themselves are deterministic.
    """

    nan_logit_slot: int = -1
    nan_logit_step: int = -1
    nan_grad_step: int = -1
    nan_batch_step: int = -1
    spike_loss_step: int = -1
    spike_loss_len: int = 1
    spike_loss_factor: float = 100.0
    fail_prefill_request: int = -1
    stall_chain: int = -1
    stall_s: float = 0.0
    preempt_slot: int = -1
    preempt_at_chain: int = -1
    seed: int = 0

    @property
    def poisons_logits(self) -> bool:
        return self.nan_logit_slot >= 0 and self.nan_logit_step >= 0

    @property
    def poisons_grads(self) -> bool:
        return self.nan_grad_step >= 0

    @property
    def poisons_batch(self) -> bool:
        return self.nan_batch_step >= 1

    @property
    def spikes_loss(self) -> bool:
        return self.spike_loss_step >= 0

    @property
    def fails_prefill(self) -> bool:
        return self.fail_prefill_request >= 0

    @property
    def stalls(self) -> bool:
        return self.stall_chain >= 0 and self.stall_s > 0

    @property
    def preempts(self) -> bool:
        return self.preempt_slot >= 0 and self.preempt_at_chain >= 0


@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    """Replica-level fault injection for a fleet router.
    Same philosophy as :class:`ChaosConfig`: ``-1`` disables an
    injector, every firing is keyed to deterministic host counters
    (replica index, the replica's chain count, the router's own round
    counter) so a chaos fleet run is reproducible bit for bit.

    - ``kill_replica`` / ``kill_at_chain``: the router declares that
      replica dead once its chain counter reaches ``kill_at_chain`` —
      PERMANENTLY (a half-open probe against a chaos-killed replica
      fails, exercising the circuit re-open path). The engine process
      is untouched; death is simulated at the router boundary, which is
      exactly where a real death is observed.
    - ``stall_replica`` / ``stall_from_chain`` / ``stall_rounds``: once
      the replica's chain counter reaches ``stall_from_chain``, the
      router skips stepping it for ``stall_rounds`` scheduling rounds —
      a progress freeze (heartbeat ages, suspicion and hedging fire)
      with no wall-clock sleep, so chaos tests stay fast and flake-free.
    - ``seed`` rides into receipts/fingerprints; the injectors are
      deterministic.

    The poison-a-replica path needs no new injector: hand ONE replica's
    engine an engine-level :class:`ChaosConfig` with
    ``nan_logit_slot``/``nan_logit_step`` and the router observes the
    resulting fault-stat deltas.
    """

    kill_replica: int = -1
    kill_at_chain: int = -1
    stall_replica: int = -1
    stall_from_chain: int = 0
    stall_rounds: int = 0
    seed: int = 0

    @property
    def kills(self) -> bool:
        return self.kill_replica >= 0 and self.kill_at_chain >= 0

    @property
    def stalls(self) -> bool:
        return self.stall_replica >= 0 and self.stall_rounds > 0


def replica_killed(cfg: FleetChaosConfig, replica: int, n_chains: int) -> bool:
    """True once the configured victim replica has dispatched
    ``kill_at_chain`` chains, and forever after (the counter is
    monotonic, so a killed replica stays killed across probes)."""
    return cfg.kills and replica == cfg.kill_replica and n_chains >= cfg.kill_at_chain


def replica_stall_pending(cfg: FleetChaosConfig, replica: int, n_chains: int,
                          rounds_consumed: int) -> bool:
    """True while the configured replica should stay frozen: its chain
    counter reached ``stall_from_chain`` and fewer than ``stall_rounds``
    scheduling rounds were skipped so far (the router counts its skips and
    passes them back as ``rounds_consumed``)."""
    return (cfg.stalls and replica == cfg.stall_replica
            and n_chains >= cfg.stall_from_chain and rounds_consumed < cfg.stall_rounds)


# ---------------------------------------------------------------- device side


def poison_logits(logits: torch.Tensor, step_index, slot: int, step: int) -> torch.Tensor:
    """``logits`` with row ``slot`` set to NaN where ``step_index`` equals
    ``step``. ``logits`` is the per-slot row block, ``(n_slots, ...)``. A
    device ``step_index`` selects with ``torch.where`` (a clean step
    computes the same values, with no host read); a host ``int`` is
    decided on the host — the row is filled only at the matching step,
    and no scalar goes up to the device."""
    if not isinstance(step_index, torch.Tensor):
        if int(step_index) != step:
            return logits
        poisoned = logits.clone()
        poisoned[slot].fill_(float("nan"))
        return poisoned
    poisoned = logits.clone()
    poisoned[slot].fill_(float("nan"))
    return torch.where(step_index.to(logits.device) == step, poisoned, logits)


def poison_grads(grads: list[torch.Tensor], step_counter: torch.Tensor,
                 step: int) -> list[torch.Tensor]:
    """``grads`` with every leaf NaN where the device ``step_counter``
    equals ``step``, else bitwise unchanged: one multi-tensor multiply by
    a device scalar chosen with ``torch.where`` (``g * 1.0`` is ``g``
    exactly; ``g * NaN`` is NaN). Lands after the gradient average, where
    a real non-finite reduction would."""
    one = torch.ones((), dtype=grads[0].dtype, device=grads[0].device)
    scale = torch.where(step_counter == step, torch.full_like(one, float("nan")), one)
    return torch._foreach_mul(grads, scale)


# ------------------------------------------------------------------ host side


def maybe_poison_batch(cfg: ChaosConfig, host_step: int, batch):
    """``batch`` with its first leaf all-NaN when ``host_step`` (the
    trainer's 1-based, monotonic dispatch counter) matches
    ``nan_batch_step``; the batch unchanged otherwise. The NaN flows into
    the loss and the gradients as a corrupt batch would; the host key makes
    it fire exactly once."""
    if not (cfg.poisons_batch and host_step == cfg.nan_batch_step):
        return batch
    if isinstance(batch, tuple):
        return (batch[0] * float("nan"), *batch[1:])
    return batch * float("nan")


def maybe_fail_prefill(cfg: ChaosConfig, request_id: int) -> None:
    """Raise :class:`ChaosError` when ``request_id`` is the configured
    prefill victim (an engine calls it just before a request's prefill)."""
    if cfg.fails_prefill and request_id == cfg.fail_prefill_request:
        raise ChaosError(f"injected prefill failure for request {request_id}")


def maybe_stall(cfg: ChaosConfig, chain_index: int, flight=None) -> None:
    """Sleep ``stall_s`` before the configured chain index: wall time
    passes (deadlines expire) with no effect on the device. A recorder
    passed as ``flight`` gets a ``stall`` event first."""
    if cfg.stalls and chain_index == cfg.stall_chain:
        if flight is not None:
            flight.record("stall", chain=chain_index, stall_s=cfg.stall_s)
        time.sleep(cfg.stall_s)


def host_spike_loss(loss_value: float, host_step: int, cfg: ChaosConfig) -> float:
    """The loss the rollback monitor sees at ``host_step`` (1-based, never
    replayed): times ``spike_loss_factor`` inside the configured window,
    untouched outside it. The training state never sees the spike."""
    if cfg.spikes_loss and (
        cfg.spike_loss_step <= host_step < cfg.spike_loss_step + cfg.spike_loss_len
    ):
        return float(loss_value) * cfg.spike_loss_factor
    return float(loss_value)
