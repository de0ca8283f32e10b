"""Training of the PyTorch port: the train and eval steps, the
``Trainer``, AdamW and SGD."""

from pytorch_distributed_training_tutorials_tpu_torch.train.optim import SGD, AdamW, adamw, sgd
from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
)

__all__ = ["SGD", "AdamW", "TrainState", "Trainer", "adamw", "make_eval_step",
           "make_train_step", "sgd"]
