"""Observability of the PyTorch port: honest timing, the metrics logger
and the receipt every measurement is written through; and, exported
lazily (PEP 562, as ``adapters/``), the serving flight recorder
(:mod:`.flight`: events, spans, ``graft-flightlog/v1`` dumps, the fleet
merge), its streaming histograms (:mod:`.histogram`), the runtime
contract sentry (:mod:`.sentry`: native loads, fetches against the
budget, leaves off the device) and the trace classifier (:mod:`.trace`:
``StepReport``, where a traced step's device time went). ``python -m
...obs --selftest`` drives them all (:mod:`.__main__`)."""

import importlib

from pytorch_distributed_training_tutorials_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import (
    environment_stamp,
    load_receipt,
    make_receipt,
    validate_receipt,
    write_receipt,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.timing import (
    BracketResult,
    DriftBracket,
    LaunchFit,
    MinOfN,
    TimingResult,
    launch_overhead_fit,
)

# name -> submodule; resolved on first access via __getattr__
_LAZY_EXPORTS = {
    name: f"pytorch_distributed_training_tutorials_tpu_torch.obs.{mod}"
    for mod, names in (
        ("flight", ("EVENT_KINDS", "FLIGHT_SCHEMA", "FlightRecorder", "load_flightlog",
                    "merge_snapshots", "summarize_merged", "validate_flightlog")),
        ("histogram", ("LogHistogram",)),
        ("sentry", ("ContractSentry",)),
        ("trace", ("StepReport",)),
    )
    for name in names
}

__all__ = ["BracketResult", "DriftBracket", "LaunchFit", "MetricsLogger", "MinOfN",
           "TimingResult", "environment_stamp", "launch_overhead_fit", "load_receipt",
           "make_receipt", "validate_receipt", "write_receipt", *sorted(_LAZY_EXPORTS)]


def __getattr__(name: str):
    try:
        module_name = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY_EXPORTS))
