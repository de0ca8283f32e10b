"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through :mod:`ctypes` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/`` at the repo
root (listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and its flags (each library has its own,
:data:`_LIBRARIES`), so an edited source, header or flag never loads a
stale library. A library may export several C entry
points. Nothing is built
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
    "-Xptxas", "-v",
)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_PTR_ARRAY = ctypes.POINTER(ctypes.c_void_p)


class Layout(ctypes.Structure):
    """Element strides of a (B, S, H, D) tensor's first three axes (the
    last axis is contiguous), passed by value to the flash kernels."""

    _fields_ = [("sb", ctypes.c_longlong), ("ss", ctypes.c_longlong),
                ("sh", ctypes.c_longlong)]


# name -> the library's extra nvcc flags (part of its content hash) and
# {C entry point: (argtypes, restype)}
_LIBRARIES = {
    "int8_matmul": {
        # no contraction beyond the __fmaf_rn the source spells out: the
        # kernel must be bitwise its plain PyTorch version
        "flags": ("-fmad=false",),
        "entry": {
            "int8_matmul_launch": ([_PTR] * 6 + [_INT] * 4 + [_PTR], _INT),
        },
    },
    "int8_matmul_sm90": {
        # bitwise its plain version, as int8_matmul
        "flags": ("-fmad=false",),
        "entry": {
            # x qt scale out xq sx part sx_part tickets, M N K block_k,
            # tiles per split, splits, stream
            "int8_matmul_sm90_launch": ([_PTR] * 9 + [_INT] * 6 + [_PTR], _INT),
            # qt, N K, reps, cached -> host ns per TMA map
            "int8_matmul_sm90_encode_ns": ([_PTR] + [_INT] * 4, ctypes.c_double),
        },
    },
    "fused_adamw": {
        # no contraction: the kernel must be bitwise its plain foreach version
        "flags": ("-fmad=false",),
        "entry": {
            # g m v p (arrays of leaf pointers), sizes, count, b1, 1 - b1, b2,
            # 1 - b2, eps, weight decay, -lr, the bias corrections'
            # reciprocals, stream, launches (out)
            "fused_adamw_launch": (
                [_PTR_ARRAY] * 4 + [ctypes.POINTER(ctypes.c_longlong), _INT]
                + [ctypes.c_float] * 9 + [_PTR, ctypes.POINTER(_INT)],
                _INT,
            ),
        },
    },
    "fused_loss": {
        "flags": (),
        "entry": {
            # h w y part_lse part_tgt, N D V, splits, tiles per split, dtype,
            # stream
            "fused_ce_fwd_launch": ([_PTR] * 5 + [_INT] * 6 + [_PTR], _INT),
            # h w y lse g part, N D V, splits, tiles per split, dtype, stream
            "fused_ce_dh_launch": ([_PTR] * 6 + [_INT] * 6 + [_PTR], _INT),
            # h w y lse g part out, N D V, dtype, stream
            "fused_ce_dw_launch": ([_PTR] * 7 + [_INT] * 4 + [_PTR], _INT),
        },
    },
    "fused_loss_sm90": {
        "flags": (),
        "entry": {
            # h w y part_lse part_tgt, N D V, splits, tiles per split, stream
            "fused_ce_fwd_sm90_launch": ([_PTR] * 5 + [_INT] * 5 + [_PTR], _INT),
            # h w y lse g part, N D V, splits, groups per split, stream
            "fused_ce_dh_sm90_launch": ([_PTR] * 6 + [_INT] * 5 + [_PTR], _INT),
            # h w y lse g part out, N D V, stream
            "fused_ce_dw_sm90_launch": ([_PTR] * 7 + [_INT] * 3 + [_PTR], _INT),
        },
    },
    "flash_attention": {
        "flags": (),
        "entry": {
            # q k v o lse, their layouts, B S H D, dtype code, scale, stream
            "flash_fwd_launch": (
                [_PTR] * 5 + [Layout] * 4 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
            # q k v do lse delta dq, layouts of q k v do dq, B S H D, dtype,
            # scale, stream
            "flash_dq_launch": (
                [_PTR] * 7 + [Layout] * 5 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
            # q k v do lse delta dk dv, layouts of q k v do dk dv, B S H D,
            # dtype, scale, stream
            "flash_dkv_launch": (
                [_PTR] * 8 + [Layout] * 6 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
        },
    },
    "flash_attention_sm90": {
        "flags": (),
        "entry": {
            # as flash_fwd_launch, flash_dq_launch and flash_dkv_launch
            # (dtype code 1, bf16, only)
            "flash_fwd_sm90_launch": (
                [_PTR] * 5 + [Layout] * 4 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
            "flash_dq_sm90_launch": (
                [_PTR] * 7 + [Layout] * 5 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
            "flash_dkv_sm90_launch": (
                [_PTR] * 8 + [Layout] * 6 + [_INT] * 5 + [ctypes.c_float, _PTR],
                _INT,
            ),
        },
    },
    "paged_attention": {
        "flags": (),
        "entry": {
            # q k_pool v_pool k_scale v_scale table pos out, B S H KV D
            # page_size P n_pages, q type, storage, pos is int64, scale,
            # shared bytes, stream
            "paged_attention_launch": (
                [_PTR] * 8 + [_INT] * 11 + [ctypes.c_float, _INT, _PTR], _INT,
            ),
        },
    },
    "paged_attention_sm90": {
        "flags": (),
        "entry": {
            # q k_pool v_pool k_scale v_scale table pos out rec_ml rec_acc
            # tickets, B S H KV D page_size P n_pages, q type, storage, pos
            # is int64, scale, pages per split, splits, stages, stream
            "paged_attention_sm90_launch": (
                [_PTR] * 11 + [_INT] * 11 + [ctypes.c_float] + [_INT] * 3 + [_PTR], _INT,
            ),
        },
    },
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


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + _LIBRARIES[name]["flags"]


def _target(name: str) -> Path:
    # the source, every shared header under csrc/ (an edited header must
    # not load a stale library) and the flags
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start one nvcc build (or return None when the library exists)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    for fn_name, (argtypes, restype) in _LIBRARIES[name]["entry"].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_all() -> dict[str, dict]:
    """Build every kernel source under ``csrc/`` in parallel and load it;
    returns :data:`build_info`."""
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in _LIBRARIES if n not in _libs]
        started = {n: _start(n) for n in todo}
        for n in todo:
            _finish(n, started[n], t0)
            _libs[n] = _load(n)
    return build_info


_tickets: dict = {}


def tickets(device, n: int, owner: str):
    """A zeroed int32 buffer of at least ``n`` counters on ``device`` for
    ``owner``'s kernel, kept from call to call: the split kernels' "last
    block to arrive" tickets (``int8_matmul_sm90.cu``,
    ``paged_attention_sm90.cu``). Each call leaves every counter at 0 (the
    block that takes a counter's last ticket resets it), so the buffer is
    never cleared again; calls of one owner run in stream order."""
    import torch

    key = (str(device), owner)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        with _lock:
            buf = _tickets.get(key)
            if buf is None or buf.numel() < n:
                buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
                _tickets[key] = buf
    return buf


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first call builds
    every kernel source (:func:`build_all`)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib
