"""Worker bodies for the tensor-parallel tests (``tests/test_torch_tp_*.py``),
run on every rank of a world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: module-level functions (the spawn start method pickles them by
name) in a module that imports torch, numpy and the port only, so the
ranks start without JAX. Each takes the rank's ``TensorParallel`` and a
work directory holding the whole weights the parent converted from the
JAX package, runs every case of its file and returns what the parent
compares."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch.adapters import AdapterBank
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    generate,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    Int8Param,
    int8_matmul_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig


def quant_cases(tp, workdir: str) -> dict:
    """``int8_matmul_tp`` on the operands in ``workdir/quant.pt`` (x, q
    (K, N) K-contiguous, scale): each rank's column block and its row
    result, and the launches counted (none on the CPU)."""
    torch.set_num_threads(1)
    ops = torch.load(os.path.join(workdir, "quant.pt"))
    w = Int8Param(q=ops["qt"].t(), scale=ops["scale"])
    tp.reset_collectives()
    col = int8_matmul_tp(ops["x"], w, tp, kind="column")
    row = int8_matmul_tp(ops["x"], w, tp, kind="row")
    # the same through the serving mesh over the world: {"model": tp}
    mesh = create_mesh({"model": tp.tp_size}, device="cpu")
    by_mesh = [int8_matmul_tp(ops["x"], w, mesh, kind=k) for k in ("column", "row")]
    return {"column": col, "row": row, "collectives": dict(tp.collectives),
            "launches": int8_matmul_tp.launches, "mesh": by_mesh,
            "mesh_names": tuple(mesh.mesh_dim_names)}


def run_stream(engine, reqs, adapters=None) -> list:
    """The JAX TP tests' staggered stream: two requests up front, one more
    submitted each scheduling round. Returns each request's tokens."""
    def request(i):
        p, m = reqs[i]
        return Request(prompt=p, max_new_tokens=m, seed=i,
                       adapter=0 if adapters is None else adapters[i])

    ids = [engine.submit(request(i)) for i in range(min(2, len(reqs)))]
    pending = list(range(2, len(reqs)))
    done = {}
    while not engine.idle or pending:
        if pending:
            ids.append(engine.submit(request(pending.pop(0))))
        for c in engine.step():
            done[c.request_id] = c.tokens
    return [done[r] for r in ids]


def _cfg(spec: dict) -> TransformerConfig:
    return TransformerConfig(**spec)


def serve_case(tp, workdir: str, case: dict) -> dict:
    """One engine case: ``case`` holds the config (``cfg``), the weights'
    file (``params``), engine options (``engine``), the stream
    (``reqs``) and optionally adapter rows (``bank``: n_adapters, rank
    and the rows' seed) with per-request ids. Returns the tokens, the
    engine's syncs and counters, its KV leaf shapes, ``tp_stats()`` and
    ``audit_decode()``, and teacher-forced logits of the first request."""
    cfg = _cfg(case["cfg"])
    params = torch.load(os.path.join(workdir, case["params"]))
    kw = dict(case.get("engine", {}))
    bank = None
    if "bank" in case:
        n, r, seed, scale = case["bank"]
        bank = AdapterBank(TransformerLM(cfg), n, r, device="cpu")
        rng = np.random.Generator(np.random.PCG64(seed))
        for t in range(1, n):
            rows = {k: torch.tensor(rng.standard_normal(tuple(v.shape)) * scale,
                                    dtype=torch.float32)
                    for k, v in bank.row_zeros().items()}
            bank.register(f"tenant-{t}", rows)
        kw["adapter_bank"] = bank
    engine = ServeEngine(TransformerLM(cfg), params, n_slots=2, tokens_per_launch=8,
                         device="cpu", strategy=tp, **kw)
    tp.reset_collectives()
    tokens = run_stream(engine, case["reqs"], case.get("adapters"))
    stream_collectives = dict(tp.collectives)
    cache = engine._state.cache
    out = {
        "tokens": tokens, "host_syncs": engine.n_host_syncs,
        "budget": engine.n_chains + engine.n_prefills + engine.n_splices,
        "n_chains": engine.n_chains, "n_prefills": engine.n_prefills,
        "kv_shape": tuple(cache.k.shape), "stream_collectives": stream_collectives,
        "tp_stats": engine.tp_stats(),
    }
    if tp.tp_size > 1:
        out["audit"] = engine.audit_decode()
        out["tp_stats_after_audit"] = engine.tp_stats()
    p, m = case["reqs"][0]
    ref = tokens[0]
    out["tf_logits"] = engine.teacher_forced_logits(p, ref[:m])
    if "bank" not in case:  # generate() on the engine's (sharded) model
        out["generate"] = generate(engine.model, None, [p], m, device="cpu")[0, len(p):].tolist()
    return out


def serve_cases(tp, workdir: str, cases: dict) -> dict:
    """Every case of ``cases`` (name -> :func:`serve_case`'s dict) in turn."""
    torch.set_num_threads(1)
    return {name: serve_case(tp, workdir, case) for name, case in cases.items()}


def int8_cases(tp, workdir: str) -> dict:
    """The quantized tensor-parallel model of ``workdir/int8.pt`` (whole
    weights, ``cfg`` in ``workdir/int8_cfg.pt``): its full-sequence logits
    on the tokens there, its prefill and decode logits; and whether the
    engine refuses under ``tp`` > 1 (None: it accepts) each clock-driven
    host decision: ``default_deadline_s``, a chaos stall,
    ``Request.deadline_s``."""
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(workdir, "int8_cfg.pt"))
    whole = torch.load(os.path.join(workdir, "int8.pt"))
    tokens = torch.load(os.path.join(workdir, "int8_tokens.pt"))
    cfg = TransformerConfig(**spec, quantized=True, int8_mesh=tp)
    from pytorch_distributed_training_tutorials_tpu_torch.models import KVCache, bind_params
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        shard_params,
    )

    model = TransformerLM(cfg)
    bind_params(model, shard_params(whole, tp.rank, tp.tp_size, head_dim=cfg.head_dim))
    out = {"full": model(tokens)}
    cache = KVCache.zeros(cfg, tokens.shape[0], device="cpu")
    steps = [model(tokens[:, :4], cache, prefill=True)]
    for i in range(4, tokens.shape[1]):
        steps.append(model(tokens[:, i:i + 1], cache, decode=True))
    out["cached"] = torch.cat(steps, dim=1)
    out["kv_shape"] = tuple(cache.k.shape)
    whole_cfg = dataclasses.replace(cfg, int8_mesh=None)
    refused = {}
    for name, kw in (("default_deadline_s", dict(default_deadline_s=1.0)),
                     ("chaos_stall", dict(chaos=ChaosConfig(stall_chain=1, stall_s=1.0)))):
        try:
            ServeEngine(TransformerLM(whole_cfg), whole, device="cpu", strategy=tp, **kw)
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    engine = ServeEngine(TransformerLM(whole_cfg), whole, device="cpu", strategy=tp)
    try:
        engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=2, deadline_s=5.0))
        refused["request_deadline_s"] = None
    except NotImplementedError as e:
        refused["request_deadline_s"] = str(e)
    out["refused"] = refused
    # an engine over a model built sharded (cfg.int8_mesh: the strategy
    # comes from the config) serves what one built from the whole weights does
    reqs = [([5, 6, 7, 8, 9], 6), ([1, 2, 3], 5), ([9, 8, 7, 6, 5, 4, 3], 4)]
    built = ServeEngine(model, None, n_slots=2, device="cpu")
    from_whole = ServeEngine(TransformerLM(whole_cfg), whole, n_slots=2, device="cpu",
                             strategy=tp)
    out["prebuilt"] = [run_stream(e, reqs) for e in (built, from_whole)]
    out["prebuilt_tp"] = built.tp_stats()["tp"]
    return out
