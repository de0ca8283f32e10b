"""The input pipeline of the PyTorch port: the exact ``DistributedSampler``
order, the datasets and their offline surrogates, the sharded host loader
and the device-resident loader."""

from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import (
    ArrayDataset,
    cifar10,
    mnist,
    random_dataset,
    synthetic_regression,
)
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.data.resident import DeviceResidentLoader
from pytorch_distributed_training_tutorials_tpu_torch.data.sampler import DistributedSampler

__all__ = [
    "ArrayDataset",
    "DeviceResidentLoader",
    "DistributedSampler",
    "ShardedLoader",
    "cifar10",
    "mnist",
    "random_dataset",
    "synthetic_regression",
]
