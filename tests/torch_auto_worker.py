"""Worker body for ``tests/test_torch_auto_tp.py``, run on every rank of a
world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: a module-level function in a module that imports torch and the
port only, so the ranks start without JAX."""

from __future__ import annotations

import dataclasses
import os

import torch

from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
    load_quantized_lm,
    place_int8_lm_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import restore_checkpoint
from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine
from torch_tp_worker import run_stream


def load_cases(tp, workdir: str) -> dict:
    """For each float checkpoint in ``workdir`` (``unrolled``, ``stacked``;
    the config in ``spec.pt``): whether this rank's
    ``load_quantized_lm(path, tp)`` is bitwise the rank's shard of the
    whole-tree bridge (``place_int8_lm_params(from_jax_params(...))``),
    the shard's shapes, and the greedy tokens of the stream in
    ``reqs.pt`` from the TP engine over the loaded shard and from the
    replicated engine over the whole weights."""
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    reqs = torch.load(os.path.join(workdir, "reqs.pt"))
    cfg = TransformerConfig(**spec, quantized=True)
    cfg_tp = dataclasses.replace(cfg, int8_mesh=tp)
    out = {}
    for layout in ("unrolled", "stacked"):
        path = os.path.join(workdir, layout)
        got = load_quantized_lm(path, tp, device="cpu")
        whole = from_jax_params(restore_checkpoint(path), cfg, device="cpu")
        want = place_int8_lm_params(whole, cfg_tp)
        tp_engine = ServeEngine(TransformerLM(cfg_tp), got, n_slots=2, device="cpu",
                                strategy=tp)
        rep_engine = ServeEngine(TransformerLM(cfg), whole, n_slots=2, device="cpu")
        out[layout] = {
            "keys_equal": set(got) == set(want),
            "bitwise": sorted(k for k in want if torch.equal(got[k], want[k])),
            "n_keys": len(want),
            "shapes": {k: tuple(v.shape) for k, v in got.items()},
            "tp_tokens": run_stream(tp_engine, reqs),
            "replicated_tokens": run_stream(rep_engine, reqs),
        }
    return out
