"""Training of the PyTorch port: the LM train step and AdamW."""

from pytorch_distributed_training_tutorials_tpu_torch.train.optim import AdamW, adamw
from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
    TrainState,
    make_train_step,
)

__all__ = ["AdamW", "TrainState", "adamw", "make_train_step"]
