"""ctypes bridge to the multithreaded host row gather.

The source is the port's own ``csrc/fastgather.cpp`` (a copy of the JAX
package's): the library is built with ``g++`` into the gitignored
``build/host/`` at the repo root, named by a hash of the source, at the
first gather (never at import). When ``g++``
or the build is missing, :func:`gather_rows` uses numpy fancy indexing,
as the JAX loader does: the native copy is a host throughput measure,
never a correctness dependency. A build or load is reported to the
native listeners (:func:`..ops._build.add_native_listener`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from pytorch_distributed_training_tutorials_tpu_torch.ops._build import notify_native

_REPO = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastgather.cpp"
BUILD_DIR = _REPO / "build" / "host"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename over the target, so a
    # concurrent builder never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             str(SOURCE), "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        target = BUILD_DIR / f"fastgather-{digest}.so"
        t0 = time.perf_counter()
        built = not target.exists()
        try:
            if built:
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.SubprocessError):
            return None
        notify_native("fastgather", (time.perf_counter() - t0) * 1e3,
                      "built" if built else "loaded")
        lib.fg_gather_rows.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.POINTER(ctypes.c_int64),  # indices
            ctypes.c_void_p,  # dst
            ctypes.c_int64,  # n_rows
            ctypes.c_int64,  # row_bytes
            ctypes.c_int32,  # n_threads
        ]
        lib.fg_gather_rows.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def gather_rows(arr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``arr[rows]``, with the multithreaded native copy for C-contiguous
    arrays and 1-d integer indices (checked in range here: the C side does
    raw memcpys); numpy indexing for everything else."""
    lib = _load()
    rows = np.asarray(rows)
    if (lib is None or arr.ndim < 1 or not arr.flags["C_CONTIGUOUS"]
            or arr.dtype.hasobject or rows.ndim != 1 or rows.dtype.kind not in "iu"):
        return arr[rows]
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n = len(arr)
    if rows.size and (rows.min() < -n or rows.max() >= n):
        raise IndexError(f"index out of range for axis 0 with size {n}")
    rows = np.where(rows < 0, rows + n, rows)
    out = np.empty((rows.shape[0], *arr.shape[1:]), arr.dtype)
    row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
    lib.fg_gather_rows(
        arr.ctypes.data_as(ctypes.c_void_p),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_void_p),
        rows.shape[0], row_bytes, 0,
    )
    return out
