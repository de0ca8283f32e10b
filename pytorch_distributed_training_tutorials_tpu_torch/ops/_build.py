"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through :mod:`ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/`` at the repo
root (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source never loads a stale library. Nothing is built
at import: the first call of a kernel's wrapper on a CUDA tensor builds
it, and :func:`build_all` builds every source at once (one ``nvcc`` each,
all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no contraction beyond the __fmaf_rn the sources spell out: results
    # must be bitwise those of the plain PyTorch versions
    "-fmad=false",
    "-Xptxas", "-v",
)

# name -> (argtypes, restype) of each library's one C entry point
_SIGNATURES = {
    "int8_matmul": (
        "int8_matmul_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when a cached library loaded),
# "log": nvcc's output (-Xptxas -v: registers, shared memory, spills)}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc "
            "on PATH to build the port's kernels"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start one nvcc build (or return None when the library exists)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> None:
    if started is None:
        build_info[name] = {"seconds": 0.0, "log": ""}
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    fn_name, argtypes, restype = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    return lib


def build_all() -> dict[str, dict]:
    """Build every kernel source under ``csrc/`` in parallel and load it;
    returns :data:`build_info`."""
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in _SIGNATURES if n not in _libs]
        started = {n: _start(n) for n in todo}
        for n in todo:
            _finish(n, started[n], t0)
            _libs[n] = _load(n)
    return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first call builds
    every kernel source (:func:`build_all`)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib
