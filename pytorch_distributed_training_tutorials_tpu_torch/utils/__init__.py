"""Utilities of the PyTorch port: rank-0 logging and the epoch line."""

from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import epoch_line, log0

__all__ = ["epoch_line", "log0"]
