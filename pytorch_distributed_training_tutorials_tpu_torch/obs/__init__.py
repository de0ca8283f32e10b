"""Observability of the PyTorch port: honest timing."""

from pytorch_distributed_training_tutorials_tpu_torch.obs.timing import MinOfN, TimingResult

__all__ = ["MinOfN", "TimingResult"]
