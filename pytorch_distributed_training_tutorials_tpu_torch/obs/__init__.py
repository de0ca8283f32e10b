"""Observability of the PyTorch port: honest timing and the metrics
logger."""

from pytorch_distributed_training_tutorials_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_training_tutorials_tpu_torch.obs.timing import MinOfN, TimingResult

__all__ = ["MetricsLogger", "MinOfN", "TimingResult"]
