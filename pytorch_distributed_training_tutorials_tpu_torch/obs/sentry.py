"""Runtime contract sentry: native-load / fetch / re-upload attribution.
The port's own copy of the JAX package's ``obs/sentry.py``: the same class,
methods, flight events and ``summary()`` keys, with its three probes
restated for PyTorch.

Every engine contract the serving path depends on — "nothing is built
or loaded per request", "host syncs = chains + prefills + splices (+
handoffs in + swaps out)", "no leaf of a dispatch is copied to the device
per call" — is pinned by spies in the CPU tests, but on the card nothing
watches them at runtime. :class:`ContractSentry` is the production twin of
those spies: threaded through ``ServeEngine``, ``FleetRouter`` and
``Trainer``, it makes a violation announce itself.

Three probes, all host bookkeeping (a counter bump, a hook, an attribute
walk — never a device sync of their own, so the fetch budget they
measure is unchanged by measuring it):

- **Compile probe** (``compile_probe == "native"``): the eager port has no
  XLA compile. Its counterpart is the build or load of a native library —
  a CUDA kernel library (``ops/_build.py``) or the host gather
  (``data/native.py``) — which stalls the request loop for an ``nvcc`` or
  ``g++`` build (or a ``dlopen``) exactly as a steady-state XLA compile
  stalls the JAX engine. :meth:`install` subscribes to the one listener
  seam both loaders report through (``ops._build.add_native_listener``:
  ``(library, ms, "built" | "loaded")``). Every event is a ``compile``
  flight event; after :meth:`mark_steady` it is a steady recompile, and
  the sentry dumps a ``graft-flightlog/v1`` snapshot naming it.
- **Fetch probe**: a marker-guarded wrapper of ``torch.Tensor.cpu``
  counts each call as one fetch; on a machine with a card, PyTorch's sync
  debug mode (``"warn"``, saved and restored by install/uninstall) counts
  every other synchronizing call of a device tensor — ``.item()``,
  ``.tolist()``, ``int(t)`` — as one fetch too (a ``.cpu()`` of a device
  tensor warns inside the wrapper and is not counted twice). A wait the
  probes cannot see (a CUDA event's ``synchronize()``) is counted by its
  caller (:meth:`note_fetch`). The engine's budgeted sites also call
  :meth:`budgeted_fetch`; inside a :meth:`begin_round` / :meth:`end_round`
  window (one ``step()``), ``fetched > budgeted`` is a stray sync: a
  ``budget_violation`` event, auto-dumped. A block that installs its own
  ``warnings.catch_warnings`` hook (the harness's ``count_host_syncs``)
  hides the device syncs inside it from the sentry.
- **Re-upload probe**: :meth:`check_args` walks a dispatched tree for
  numpy leaves and for tensors on another device than ``device`` — the
  torch form of the ``device_materialize`` trap: a host leaf feeding a
  device chain is copied on every call. It reads ``.device`` and
  ``.nbytes`` only. The first hit per label records a ``reupload`` event
  (auto-dumped); counters accumulate every hit.

Host-only: this module imports torch, numpy and the standard library,
nothing else, and a sentry constructed but never installed changes
nothing. ``summary()`` has exactly the JAX sentry's keys, so
``FleetRouter.fleet_sentry_summary`` and receipts read it unchanged.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, List, Optional

import numpy as np
import torch

# the message of PyTorch's sync debug mode warning
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a tensor on ``a`` feeds work on ``b`` without a copy (an
    index-less ``cuda`` matches any card's: the current one)."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _leaves(tree: Any):
    """Every array leaf of ``tree``: mappings, sequences, dataclasses and
    modules (their state dict) are walked; any other object is skipped."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.nn.Module):
        yield from _leaves(tree.state_dict(keep_vars=True))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


class ContractSentry:
    """Runtime monitor for the three engine contracts.

    Parameters
    ----------
    flight: a :class:`.flight.FlightRecorder` to stamp ``compile`` /
        ``budget_violation`` / ``reupload`` events into (and to dump
        post-steady loads through). ``None`` keeps the sentry
        counters-only.
    label: initial phase label attributed to compile events (default
        ``"warmup"``; :meth:`set_phase` and :meth:`begin_round` move it).
    max_compile_records: how many per-event ``(label, ms)`` records to
        retain for post-mortem context (counters never truncate).
    """

    def __init__(self, flight: Any = None, label: str = "warmup",
                 max_compile_records: int = 64):
        self._flight = flight
        self.phase = label
        self.steady = False
        # compile probe
        self.n_compiles = 0
        self.n_steady_recompiles = 0
        self.compile_ms_total = 0.0
        self.compile_records: List[dict] = []
        self._max_compile_records = int(max_compile_records)
        self.compile_probe = "off"   # "native" | "off"
        self._listener = None
        # fetch probe
        self.installed = False
        self.sync_probe = "off"      # "sync_debug_mode" | "off"
        self._real_cpu = None
        self._had_cpu = False
        self._real_show = None
        self._filter = None
        self._sync_mode = None
        self._quiet = 0
        self.n_fetched = 0
        self.n_budgeted = 0
        self.n_rounds = 0
        self.n_budget_violations = 0
        self._in_round = False
        self._round_fetched = 0
        self._round_budgeted = 0
        self._round_label: Optional[str] = None
        # re-upload probe
        self.n_reuploads = 0
        self.reupload_bytes = 0
        self.n_checked = 0
        self._reupload_sites: set = set()

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "ContractSentry":
        """Activate the native-load listener, the counting
        ``torch.Tensor.cpu`` wrapper and, with a card, sync debug mode's
        count. Idempotent; pair with :meth:`uninstall` (or use the sentry
        as a context manager) so a scoped sentry never leaks its hooks.
        Install outside any round: the process's first switch to sync
        debug mode synchronizes once, and is made here uncounted."""
        if self.installed:
            return self
        from pytorch_distributed_training_tutorials_tpu_torch.ops import _build

        def _listener(library: str, ms: float, kind: str) -> None:
            self._on_compile(ms, library=library, kind=kind)

        _build.add_native_listener(_listener)
        self._listener = _listener
        self.compile_probe = "native"

        real = torch.Tensor.cpu
        sentry = self

        def _sentry_cpu(t, *args, **kwargs):
            sentry._fetched()
            sentry._quiet += 1  # its own sync warning is this fetch
            try:
                return real(t, *args, **kwargs)
            finally:
                sentry._quiet -= 1

        # marker so uninstall only restores OUR wrapper (a spy layered on
        # top is the spy's to undo)
        _sentry_cpu._contract_sentry = self  # type: ignore[attr-defined]
        self._had_cpu = "cpu" in torch.Tensor.__dict__
        self._real_cpu = real
        torch.Tensor.cpu = _sentry_cpu
        if torch.cuda.is_available():
            self._install_sync_probe()
        self.installed = True
        return self

    def _install_sync_probe(self) -> None:
        """Count sync debug mode's warnings (``"warn"``; the mode in force
        is saved for :meth:`uninstall`): an ``always`` filter for the
        message and a marker-guarded ``warnings.showwarning`` that counts
        and swallows it, forwarding every other warning."""
        self._sync_mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode(self._sync_mode)
        warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
        self._filter = warnings.filters[0]
        show = warnings.showwarning
        sentry = self

        def _sentry_show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                if not sentry._quiet:
                    sentry._fetched()
                return None
            return show(message, category, filename, lineno, file, line)

        _sentry_show._contract_sentry = self  # type: ignore[attr-defined]
        self._real_show = show
        warnings.showwarning = _sentry_show
        torch.cuda.set_sync_debug_mode("warn")
        self.sync_probe = "sync_debug_mode"

    def uninstall(self) -> None:
        if not self.installed:
            return
        from pytorch_distributed_training_tutorials_tpu_torch.ops import _build

        if getattr(torch.Tensor.__dict__.get("cpu"), "_contract_sentry", None) is self:
            if self._had_cpu:
                torch.Tensor.cpu = self._real_cpu
            else:
                del torch.Tensor.cpu
        self._real_cpu = None
        if self.sync_probe != "off":
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            if getattr(warnings.showwarning, "_contract_sentry", None) is self:
                warnings.showwarning = self._real_show
            if self._filter in warnings.filters:
                warnings.filters.remove(self._filter)
                getattr(warnings, "_filters_mutated", lambda: None)()
            self._real_show = self._filter = None
            self.sync_probe = "off"
        _build.remove_native_listener(self._listener)
        self._listener = None
        self.compile_probe = "off"
        self.installed = False

    def __enter__(self) -> "ContractSentry":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def mark_steady(self) -> None:
        """Declare the warmup boundary (the ``flight.reset()`` seam): every
        native build or load from here on is a steady-state recompile —
        the stall the serving contract forbids."""
        self.steady = True
        self.phase = "steady"

    def set_phase(self, label: str) -> None:
        """Attribute subsequent compile events to ``label``."""
        self.phase = str(label)

    # -- compile probe -----------------------------------------------------

    def _on_compile(self, ms: float, library: str = "", kind: str = "") -> None:
        self.n_compiles += 1
        self.compile_ms_total += ms
        record = {"label": self.phase, "ms": round(ms, 3), "steady": self.steady}
        if len(self.compile_records) < self._max_compile_records:
            self.compile_records.append(record)
        if self.steady:
            self.n_steady_recompiles += 1
        if self._flight is not None:
            ev = self._flight.record("compile", label=self.phase, ms=round(ms, 3),
                                     steady=self.steady, library=library, native=kind)
            if self.steady:
                # warmup loads never dump; a POST-STEADY one is the
                # contract breaking: snapshot it now, named by its phase
                self._flight.dump(reason="compile", trigger=ev)

    # -- fetch probe -------------------------------------------------------

    def _fetched(self) -> None:
        self.n_fetched += 1
        if self._in_round:
            self._round_fetched += 1

    def note_fetch(self) -> None:
        """A host wait the probes cannot see (a CUDA event's
        ``synchronize()``), counted by its caller as one fetch."""
        if self.installed:
            self._fetched()

    def begin_round(self, label: Optional[str] = None) -> None:
        """Open one scheduling-round accounting window (the engine calls
        this at the top of ``step()``). Fetches outside a round — warmup,
        reference decodes, receipt assembly — never count against the
        budget."""
        self._in_round = True
        self._round_label = label
        self._round_fetched = 0
        self._round_budgeted = 0
        if label is not None:
            self.phase = str(label)

    def budgeted_fetch(self) -> None:
        """A budgeted engine call site is about to fetch (routed through
        ``ServeEngine._fetch``) — the fetch it precedes is inside the
        declared budget."""
        self.n_budgeted += 1
        if self._in_round:
            self._round_budgeted += 1

    def end_round(self) -> None:
        """Close the round; ``fetched > budgeted`` is a violation (one
        ``budget_violation`` event, auto-dumped via the recorder's fault
        path)."""
        if not self._in_round:
            return
        self._in_round = False
        self.n_rounds += 1
        if self._round_fetched > self._round_budgeted:
            self.n_budget_violations += 1
            if self._flight is not None:
                self._flight.record(
                    "budget_violation", fetched=self._round_fetched,
                    budgeted=self._round_budgeted,
                    round=self._round_label or f"round {self.n_rounds}")

    # -- re-upload probe ---------------------------------------------------

    def check_args(self, tree: Any, label: str = "dispatch", device=None) -> int:
        """Walk ``tree`` for leaves that are copied to the device on every
        dispatch: numpy arrays, and (``device`` given) tensors on another
        device. Returns their bytes; 0 means clean. Reads ``.device`` and
        ``.nbytes`` only — never fetches."""
        self.n_checked += 1
        dev = None if device is None else torch.device(device)
        host = [leaf for leaf in _leaves(tree)
                if isinstance(leaf, np.ndarray)
                or (dev is not None and isinstance(leaf, torch.Tensor)
                    and not _same_device(leaf.device, dev))]
        if not host:
            return 0
        nbytes = sum(int(leaf.nbytes) for leaf in host)
        self.n_reuploads += 1
        self.reupload_bytes += nbytes
        if label not in self._reupload_sites:
            self._reupload_sites.add(label)
            if self._flight is not None:
                # first occurrence per site announces (and auto-dumps);
                # repeats only accumulate: n_reuploads >> sites shows them
                self._flight.record("reupload", label=label, n_leaves=len(host),
                                    bytes=nbytes)
        return nbytes

    # -- receipt surface ---------------------------------------------------

    def summary(self) -> dict:
        """Flat receipt-ready aggregate (``sentry_*`` keys, the JAX
        sentry's). ``sentry`` itself is configuration; the rest are
        outcomes."""
        return {
            "sentry": 1,
            "sentry_compiles": self.n_compiles,
            "sentry_steady_recompiles": self.n_steady_recompiles,
            "sentry_compile_ms": round(self.compile_ms_total, 3),
            "sentry_rounds": self.n_rounds,
            "sentry_fetched": self.n_fetched,
            "sentry_budgeted": self.n_budgeted,
            "sentry_budget_violations": self.n_budget_violations,
            "sentry_fetch_budget_ok": int(self.n_budget_violations == 0),
            "sentry_reuploads": self.n_reuploads,
            "sentry_reupload_bytes": self.reupload_bytes,
        }
