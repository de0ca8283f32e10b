"""The input pipeline of the PyTorch port: the exact ``DistributedSampler``
order, the datasets and their offline surrogates, the sharded host loader,
its prefetching and chunked-streaming forms, and the device-resident
loader."""

from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import (
    ArrayDataset,
    cifar10,
    mnist,
    random_dataset,
    synthetic_lm,
    synthetic_regression,
)
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.data.prefetch import (
    PrefetchLoader,
    prefetch_iterable,
)
from pytorch_distributed_training_tutorials_tpu_torch.data.resident import DeviceResidentLoader
from pytorch_distributed_training_tutorials_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_training_tutorials_tpu_torch.data.streaming import ChunkedStreamingLoader

__all__ = [
    "ArrayDataset",
    "ChunkedStreamingLoader",
    "DeviceResidentLoader",
    "DistributedSampler",
    "PrefetchLoader",
    "ShardedLoader",
    "cifar10",
    "mnist",
    "prefetch_iterable",
    "random_dataset",
    "synthetic_lm",
    "synthetic_regression",
]
