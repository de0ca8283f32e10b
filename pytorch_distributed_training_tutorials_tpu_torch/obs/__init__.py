"""Observability of the PyTorch port: honest timing, the metrics logger
and the receipt every measurement is written through."""

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

__all__ = ["BracketResult", "DriftBracket", "LaunchFit", "MetricsLogger", "MinOfN",
           "TimingResult", "environment_stamp", "launch_overhead_fit", "load_receipt",
           "make_receipt", "validate_receipt", "write_receipt"]
