"""Datasets: an own copy of the JAX package's ``data/datasets.py``.

Whole datasets are materialized in host memory as numpy arrays, NHWC for
images (the layout changes to NCHW at the model's input, in
:mod:`..models.resnet`). ``mnist`` and ``cifar10`` read the standard files
under ``DATA_DIR`` (default ``~/.cache/tpu_ddp_data``) and otherwise
return the deterministic surrogate the JAX package returns — byte for
byte, uint8 at rest, ``.synthetic`` set — drawn with numpy ``PCG64`` from
the same fixed seeds (templates 101 / 103, noise 1 and 2 / 3 and 4).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from dataclasses import dataclass

import numpy as np

from pytorch_distributed_training_tutorials_tpu_torch.data.native import gather_rows

DATA_DIR = os.environ.get("DATA_DIR", os.path.expanduser("~/.cache/tpu_ddp_data"))


@dataclass
class ArrayDataset:
    """A fully materialized map-style dataset: parallel numpy arrays,
    gathered a batch at a time (:meth:`gather`)."""

    arrays: tuple[np.ndarray, ...]
    synthetic: bool = False  # True when this is a no-network surrogate

    def __post_init__(self):
        n = len(self.arrays[0])
        for a in self.arrays[1:]:
            if len(a) != n:
                raise ValueError("all arrays must share dim 0")

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, i: int):
        return tuple(a[i] for a in self.arrays)

    def gather(self, indices: np.ndarray) -> tuple[np.ndarray, ...]:
        return tuple(gather_rows(a, indices) for a in self.arrays)


def synthetic_regression(size: int = 2048, in_dim: int = 20, out_dim: int = 1,
                         seed: int = 0) -> ArrayDataset:
    """``size`` samples of ``(rand(in_dim), rand(out_dim))``, uniform [0, 1)
    float32: the DDP scripts' workload."""
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.random((size, in_dim), dtype=np.float32)
    y = rng.random((size, out_dim), dtype=np.float32)
    return ArrayDataset((x, y))


def random_dataset(size: int = 32, length: int = 1024, seed: int = 0) -> ArrayDataset:
    """``length`` samples of ``randn(size)``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.standard_normal((length, size)).astype(np.float32)
    return ArrayDataset((x,))


def _synthetic_images(n: int, shape: tuple[int, ...], num_classes: int, template_seed: int,
                      noise_seed: int, raw: bool = False, modes: int = 4,
                      signal: float = 0.35) -> ArrayDataset:
    """A learnable surrogate: each class a mixture of ``modes`` fixed random
    templates, a sample ``signal * template + sqrt(1 - signal^2) * noise``,
    quantized to uint8 around 128. ``raw=True`` returns the uint8 bytes,
    else float32 ``uint8 / 255`` (the same bytes either way)."""
    t_rng = np.random.Generator(np.random.PCG64(template_seed))
    templates = t_rng.standard_normal((num_classes, modes, *shape)).astype(np.float32)
    rng = np.random.Generator(np.random.PCG64(noise_seed))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    mode_ids = rng.integers(0, modes, size=n)
    noise_amp = float(np.sqrt(1.0 - signal * signal))
    images = templates[labels, mode_ids] * signal + (
        noise_amp * rng.standard_normal((n, *shape)).astype(np.float32)
    )
    u8 = np.clip(images * 64.0 + 128.0, 0, 255).astype(np.uint8)
    if raw:
        return ArrayDataset((u8, labels), synthetic=True)
    return ArrayDataset((u8.astype(np.float32) / 255.0, labels), synthetic=True)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def mnist(split: str = "train", data_dir: str | None = None, *, raw: bool = False) -> ArrayDataset:
    """MNIST as (N, 28, 28, 1) images (float32 in [0, 1], or uint8 with
    ``raw=True``) and int32 labels, from the idx(.gz) files under
    ``data_dir``, else the deterministic surrogate (``.synthetic``)."""
    data_dir = data_dir or DATA_DIR
    prefix = "train" if split == "train" else "t10k"
    for ext in ("", ".gz"):
        img_p = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
        lbl_p = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(img_p) and os.path.exists(lbl_p):
            u8 = _read_idx(img_p)[..., None]
            labels = _read_idx(lbl_p).astype(np.int32)
            images = u8 if raw else u8.astype(np.float32) / 255.0
            return ArrayDataset((images, labels))
    n = 60000 if split == "train" else 10000
    return _synthetic_images(n, (28, 28, 1), 10, template_seed=101,
                             noise_seed=1 if split == "train" else 2, raw=raw)


def cifar10(split: str = "train", data_dir: str | None = None, *, raw: bool = False) -> ArrayDataset:
    """CIFAR-10 as (N, 32, 32, 3) images and int32 labels (NHWC), from the
    python-pickle batches (or their ``.tar.gz``) under ``data_dir``, else
    the deterministic surrogate."""
    data_dir = data_dir or DATA_DIR
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    tar_path = os.path.join(data_dir, "cifar-10-python.tar.gz")
    if not os.path.isdir(batch_dir) and os.path.exists(tar_path):
        with tarfile.open(tar_path) as t:
            t.extractall(data_dir, filter="data")
    if os.path.isdir(batch_dir):
        names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
                 else ["test_batch"])
        xs, ys = [], []
        for name in names:
            with open(os.path.join(batch_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        u8 = np.ascontiguousarray(np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        images = u8 if raw else u8.astype(np.float32) / 255.0
        return ArrayDataset((images, np.asarray(ys, dtype=np.int32)))
    n = 50000 if split == "train" else 10000
    return _synthetic_images(n, (32, 32, 3), 10, template_seed=103,
                             noise_seed=3 if split == "train" else 4, raw=raw)
