"""Driver entry points of the port: the one-device forward and the
multi-rank dry run — the twin of the repository's ``__graft_entry__.py``.

    python -m pytorch_distributed_training_tutorials_tpu_torch.graft_entry      # entry()
    python -m pytorch_distributed_training_tutorials_tpu_torch.graft_entry 8    # dry run, 8 ranks
    python -m pytorch_distributed_training_tutorials_tpu_torch.graft_entry 2 --device cpu

:func:`entry` gives the flagship model's eval forward and its example
arguments. :func:`dryrun_multichip` runs every parallelism the port ships
for one step in a world of ``n`` spawned ranks on tiny shapes and prints
one line a section (rank 0), asserting the sections' shard shapes as the
JAX dry run asserts its own, restated for the port's layouts (a
``Linear`` weight (out, in), a projection (K, N), an int8 ``qt`` (N, K)).
The world runs on the card — one rank a card, gloo on card 0 when ``n``
exceeds the cards — unless ``device="cpu"``, and raises without a GPU
otherwise. Unlike the JAX dry run, which re-executes itself in a child
that falls back to a CPU mesh when the ambient backend fails, there is no
fallback: a failing section fails the call.
"""

from __future__ import annotations

import sys

import numpy as np


def entry(device=None):
    """``(fn, example_args)``: the eval forward of ResNet-18 (cifar stem,
    10 classes) and ``(state_dict, x)`` with ``x`` zeros of shape (8, 28,
    28, 1) — the JAX entry's shape; the port's ResNet is NHWC too. ``fn``
    runs the model on the given weights (``torch.func.functional_call``),
    so the caller may pass other ones (the weight bridge's)."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models import init_params, resnet18

    dev = resolve_device(device)
    model = resnet18(num_classes=10, stem="cifar", in_channels=1)
    model.load_state_dict(init_params(model, seed=0, device=dev), assign=True)
    x = torch.zeros((8, 28, 28, 1), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fwd(state_dict, x):
        return torch.func.functional_call(model, state_dict, (x,), {"train": False})

    return fwd, (model.state_dict(), x)


SECTIONS = ("dp", "pp", "fsdp", "dp x pp (spmd)", "dp x pp (GPipe)", "dp x tp x sp",
            "sp (ulysses)", "hybrid fsdp", "grad accum", "int8 x tp", "dp x ep")


def sections(n: int) -> list[str]:
    """The sections a world of ``n`` ranks runs, in their order."""
    wide = {"pp": n >= 2, "fsdp": n >= 2, "dp x pp (spmd)": n >= 4 and n % 2 == 0,
            "dp x pp (GPipe)": n >= 4 and n % 2 == 0, "dp x tp x sp": n >= 8 and n % 4 == 0,
            "sp (ulysses)": n >= 8 and n % 4 == 0, "hybrid fsdp": n >= 4 and n % 2 == 0,
            "int8 x tp": n >= 8 and n % 4 == 0, "dp x ep": n >= 4 and n % 2 == 0}
    return [name for name in SECTIONS if wide.get(name, True)]


def dryrun_multichip(n_devices: int, device=None) -> list[str]:
    """Run the dry run in a spawned world of ``n_devices`` ranks on
    ``device`` (``cuda`` unless the caller passes another) and return rank
    0's lines (each also printed). Sections by world: dp, grad accum
    (n >= 1); pp, fsdp (n >= 2); dp x pp, hybrid fsdp, dp x ep (n >= 4,
    even); dp x tp x sp, its Ulysses / ring / flash cross-check and int8 x
    tp (n >= 8, a multiple of 4)."""
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.examples import run_world

    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return run_world(_dryrun_rank, n_devices, (dev.type,), device=dev)[0]


def _dryrun_rank(world, device: str) -> list[str]:
    import torch.distributed as dist

    lines: list[str] = []
    primary = dist.get_rank() == 0

    def say(line: str) -> None:
        lines.append(line)
        if primary:
            print(line, flush=True)

    _dryrun_impl(dist.get_world_size(), device, say)
    return lines


def _dryrun_impl(n: int, device: str, say) -> None:
    """The sections, every rank alike (module docstring)."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.data import (
        ArrayDataset,
        ShardedLoader,
        synthetic_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.models import MLP, resnet18
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        FSDP,
        ManualPipeline,
        create_mesh,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import mesh_device
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw, sgd

    rng = np.random.Generator(np.random.PCG64(0))
    mesh = create_mesh({"data": n}, device=device)
    dev = mesh_device(mesh)

    # -- dp: a ResNet-18 train step, batch split over the data axis ----------
    rows = 4 * n
    ds = ArrayDataset((rng.standard_normal((rows, 8, 8, 1)).astype(np.float32),
                       rng.integers(0, 10, rows).astype(np.int32)))
    t = Trainer(resnet18(num_classes=10, stem="cifar", in_channels=1),
                ShardedLoader(ds, 4, mesh), sgd(1e-2), loss="cross_entropy", quiet=True)
    m = t._run_epoch(0)
    assert np.isfinite(m["loss"]), m
    say(f"dryrun dp: {n}-device mesh OK, loss {m['loss']:.4f}")

    # -- pp: the 2-stage pipeline, each rank's on two stage devices ----------
    if n >= 2:
        pipe = ManualPipeline.from_module(resnet18(num_classes=10, stem="cifar", in_channels=1),
                                          devices=[dev, dev], loss="cross_entropy",
                                          optimizer=sgd(1e-2))
        xb = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
        yb = rng.integers(0, 10, 4).astype(np.int64)
        loss = float(pipe.train_step(torch.as_tensor(xb), torch.as_tensor(yb)))
        assert np.isfinite(loss)
        say(f"dryrun pp: 2-stage pipeline OK, loss {loss:.4f}")
        for line in pipe.placement_audit():
            say(f"  {line}")

    # -- fsdp: ZeRO-3 over the data axis -------------------------------------
    if n >= 2:
        fs_ds = ArrayDataset((rng.standard_normal((4 * n, 16)).astype(np.float32),
                              rng.integers(0, 4, 4 * n).astype(np.int32)))
        t_fs = Trainer(MLP(features=(16 * n, 4), in_dim=16), ShardedLoader(fs_ds, 4, mesh),
                       adamw(1e-3, weight_decay=0.0), strategy=FSDP(mesh, min_size=64),
                       loss="cross_entropy", quiet=True)
        m_fs = t_fs._run_epoch(0)
        assert np.isfinite(m_fs["loss"]), m_fs
        kernel = t_fs.model.denses[0].parametrizations.weight.original
        # flax's (16, 16n) kernel sharded (None, "data"): the port's Linear
        # (out, in) holds (16n / n, 16) a rank
        assert t_fs.strategy.plan["denses.0.weight"].spec == (None, "data")
        assert tuple(kernel.shape) == (16, 16), kernel.shape
        assert tuple(_moment(t_fs, "denses.0.weight").shape) == (16, 16)  # moments follow
        say(f"dryrun fsdp: {n}-way param shard OK, loss {m_fs['loss']:.4f}, "
            f"kernel shard {tuple(kernel.shape)}")

    if n >= 4 and n % 2 == 0:
        _dp_pp(n, device, rng, say)
    if n >= 8 and n % 4 == 0:
        _dp_tp_sp(n, device, rng, say)
        _ulysses(n, device, rng, say)
    if n >= 4 and n % 2 == 0:
        _hybrid(n, device, say)

    # -- grad accumulation: 4 microbatches == the full batch -----------------
    ga_ds = ArrayDataset((rng.standard_normal((8 * n, 16)).astype(np.float32),
                          rng.integers(0, 4, 8 * n).astype(np.int32)))
    full = Trainer(MLP(features=(16, 4), in_dim=16), ShardedLoader(ga_ds, 8, mesh), sgd(1e-2),
                   loss="cross_entropy", seed=7, quiet=True)
    acc = Trainer(MLP(features=(16, 4), in_dim=16), ShardedLoader(ga_ds, 8, mesh), sgd(1e-2),
                  loss="cross_entropy", seed=7, grad_accum_steps=4, quiet=True)
    full.train(1)
    acc.train(1)
    worst = max(float((a - b).abs().max()) for a, b in
                zip(full.model.state_dict().values(), acc.model.state_dict().values()))
    assert worst < 1e-5, f"grad accum diverges from the full batch: {worst}"
    say(f"dryrun grad accum: 4 microbatches == full batch (max param delta {worst:.1e})")

    if n >= 8 and n % 4 == 0:
        _int8_tp(n, device, rng, say)
    if n >= 4 and n % 2 == 0:
        _dp_ep(n, device, say)


def _moment(trainer, name: str):
    """AdamW's first moment of parameter ``name`` (its name before
    sharding)."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import param_names

    model = trainer.state.model
    names = [n for n, p in zip(param_names(model), model.parameters()) if p.requires_grad]
    return trainer.state.opt_state.mu[names.index(name)]


def _lm_cfg(**kw):
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig

    return TransformerConfig(**{**dict(vocab_size=32, d_model=32, n_layers=2, n_heads=2), **kw})


def _dp_pp(n: int, device: str, rng, say) -> None:
    """dp x pp: the single-program pipeline over ranks, then GPipe."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_lm
    from pytorch_distributed_training_tutorials_tpu_torch.models import resnet18
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        GPipe,
        PipelinedTransformerLM,
        PipelineParallel,
        create_mesh,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import mesh_device
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw, sgd

    mesh_pp = create_mesh({"data": n // 2, "stage": 2}, device=device, stage_ranks=True)
    model = PipelinedTransformerLM(_lm_cfg(), mesh_pp, num_microbatches=2)
    batch = 2 * 2 * (n // 2)  # 2 microbatches x 2 rows a data rank
    loader = ShardedLoader(synthetic_lm(size=batch, seq_len=8, vocab_size=32), batch, mesh_pp,
                           batch_mode="global")
    t_pp = Trainer(model, loader, adamw(1e-3, weight_decay=0.0),
                   strategy=PipelineParallel(mesh_pp, num_microbatches=2),
                   loss="cross_entropy", quiet=True)
    m = t_pp._run_epoch(0)
    assert np.isfinite(m["loss"]), m
    blocks = {name.split(".")[1] for name in t_pp.model.state_dict() if name.startswith("blocks.")}
    assert len(blocks) == 1, blocks  # one of the 2 layers a stage
    say(f"dryrun dp x pp (spmd): {n // 2}x2 mesh OK, loss {m['loss']:.4f}, "
        f"layer stack stage-sharded (blocks {sorted(blocks)} here)")

    dev = mesh_device(create_mesh(device=device))
    gmesh = create_mesh({"data": n, "stage": 2}, device=device, stage_devices=[dev, dev])
    gp = GPipe.from_module(resnet18(num_classes=10, stem="cifar", in_channels=1), devices=gmesh,
                           num_microbatches=2, loss="cross_entropy", optimizer=sgd(1e-2))
    xb = rng.standard_normal((2 * 2 * gp.dp_size, 8, 8, 1)).astype(np.float32)
    yb = rng.integers(0, 10, len(xb)).astype(np.int64)
    loss = float(gp.train_step(torch.as_tensor(xb), torch.as_tensor(yb)))
    assert np.isfinite(loss)
    say(f"dryrun dp x pp (GPipe): {gp.dp_size}-wide columns OK, loss {loss:.4f}")


def _dp_tp_sp(n: int, device: str, rng, say) -> None:
    """dp x tp x sp: the Megatron split with ring attention over seq."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_lm
    from pytorch_distributed_training_tutorials_tpu_torch.models import TP_RULES, TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
        make_ring_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw

    mesh3 = create_mesh({"data": n // 4, "seq": 2, "model": 2}, device=device)
    cfg = _lm_cfg(attention_fn=make_ring_attention(mesh3))
    loader = ShardedLoader(synthetic_lm(size=16, seq_len=16, vocab_size=32), 4, mesh3,
                           batch_spec=("data", "seq"))
    t3 = Trainer(TransformerLM(cfg), loader, adamw(1e-3, weight_decay=0.0),
                 strategy=TensorParallel(mesh3, TP_RULES, seq_axis="seq"),
                 loss="cross_entropy", quiet=True)
    m = t3._run_epoch(0)
    assert np.isfinite(m["loss"]), m
    q = t3.model.blocks[0].attn.q_proj.weight
    # flax (32, 2, 16) q kernel, heads split over model: (32, 1, 16) a rank;
    # the port's (K, N) = (32, H*D / 2)
    assert tuple(q.shape) == (32, 16), q.shape
    say(f"dryrun dp x tp x sp: {n // 4}x2x2 mesh OK, loss {m['loss']:.4f}, "
        f"q_proj shard {tuple(q.shape)}")


def _sp_logits(mesh, make_attention, whole: dict, x):
    """The rank's logits block of a 4-head LM whose attention is
    ``make_attention(mesh)``, on its rows and positions of ``x``."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import TP_RULES, TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        shard_params,
    )

    tp = TensorParallel(mesh, TP_RULES, seq_axis="seq")
    cfg = dataclasses.replace(_lm_cfg(n_heads=4), attention_fn=make_attention(mesh),
                              int8_mesh=tp)
    model = TransformerLM(cfg, device=x.device)
    model.load_state_dict(shard_params(whole, tp.rank, tp.tp_size, head_dim=cfg.head_dim),
                          assign=True)
    with torch.no_grad():
        return model(_block(x, tp))


def _block(x, tp):
    rows, cols = x.shape[0] // tp.num_devices, x.shape[1] // tp.seq_size
    return x[tp.data_rank * rows:(tp.data_rank + 1) * rows,
             tp.seq_rank * cols:(tp.seq_rank + 1) * cols]


def _ulysses(n: int, device: str, rng, say) -> None:
    """sp: Ulysses' all-to-all against the ring on one batch, and both
    against the flash kernel on the whole sequence."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM, init_lm
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
        make_ring_attention,
        make_ulysses_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import mesh_device

    mesh = create_mesh({"data": n // 4, "seq": 2, "model": 2}, device=device)
    dev = mesh_device(mesh)
    whole = init_lm(_lm_cfg(n_heads=4), seed=0, device=dev)
    x = torch.as_tensor(rng.integers(0, 32, (2 * (n // 4), 16)), device=dev)
    ring = _sp_logits(mesh, make_ring_attention, whole, x)
    uly = _sp_logits(mesh, make_ulysses_attention, whole, x)
    diff = float((ring - uly).abs().max())
    assert diff < 1e-3, f"ring vs ulysses logits diverge: {diff}"
    # the third witness: the flash kernel on the whole sequence, one device
    flash_lm = TransformerLM(dataclasses.replace(_lm_cfg(n_heads=4), attention_fn=flash_attention),
                             device=dev)
    flash_lm.load_state_dict(whole, assign=True)
    with torch.no_grad():
        full = flash_lm(x)
    tp = TensorParallel(mesh, seq_axis="seq")
    fdiff = float((_block(full, tp) - ring).abs().max())
    assert fdiff < 1e-3, f"flash vs ring logits diverge: {fdiff}"
    say(f"dryrun sp (ulysses): all-to-all == ring == flash kernel on the same batch, "
        f"max logit diff {max(diff, fdiff):.2e}")


def _hybrid(n: int, device: str, say) -> None:
    """hybrid fsdp: TP rules over model, FSDP over data."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_lm
    from pytorch_distributed_training_tutorials_tpu_torch.models import TP_RULES, TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import HybridFSDP, create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw

    mesh = create_mesh({"data": n // 2, "model": 2}, device=device)
    strategy = HybridFSDP(mesh, TP_RULES, min_size=64)
    loader = ShardedLoader(synthetic_lm(size=16, seq_len=8, vocab_size=32), 4, mesh)
    t = Trainer(TransformerLM(_lm_cfg()), loader, adamw(1e-3, weight_decay=0.0),
                strategy=strategy, loss="cross_entropy", quiet=True)
    m = t._run_epoch(0)
    assert np.isfinite(m["loss"]), m
    gate = t.model.blocks[0].mlp.gate_proj.parametrizations.weight.original
    # flax (32, 128): TP splits dim 1 over model, FSDP dim 0 over data
    assert strategy.leaf_plan(t.model, "blocks.0.mlp.gate_proj.weight").spec == ("data", "model")
    want = (32 // (n // 2), 64)
    assert tuple(gate.shape) == want, gate.shape
    assert tuple(_moment(t, "blocks.0.mlp.gate_proj.weight").shape) == want  # moments follow
    say(f"dryrun hybrid fsdp: {n // 2}x2 mesh OK, loss {m['loss']:.4f}, gate_proj 2D-sharded "
        f"{want} (moments follow)")


def _int8_tp(n: int, device: str, rng, say) -> None:
    """int8 x tp: the quantized LM over a model axis of 4 against the
    replicated int8 model: logits, and greedy tokens equal but at
    verified ties."""
    import dataclasses

    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerLM,
        generate,
        init_quantized_lm,
        place_int8_lm_params,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import mesh_device

    mesh = create_mesh({"data": n // 4, "model": 4}, device=device)
    dev = mesh_device(mesh)
    base = dataclasses.replace(_lm_cfg(vocab_size=64, n_heads=4, max_seq_len=32),
                               quantized=True)
    params = init_quantized_lm(base, seed=2, device=dev)
    toks = torch.as_tensor(rng.integers(0, 64, (2, 8)), device=dev)
    rep = TransformerLM(base, device=dev)
    rep.load_state_dict(params, assign=True)
    tp_cfg = dataclasses.replace(base, int8_mesh=TensorParallel(mesh))
    placed = place_int8_lm_params(params, tp_cfg)
    tp_lm = TransformerLM(tp_cfg, device=dev)
    tp_lm.load_state_dict(placed, assign=True)
    with torch.no_grad():
        lg_rep, lg_tp = rep(toks), tp_lm(toks)
    rel = float((lg_tp - lg_rep).abs().max() / lg_rep.abs().max())
    assert rel < 0.05, rel
    out_rep = generate(rep, None, toks[:, :4], 4, device=dev)
    out_tp = generate(tp_lm, None, toks[:, :4], 4, device=dev)
    with torch.no_grad():
        la = rep(out_rep[:, :-1])
    scale = float(la.abs().max())
    for row in range(out_rep.shape[0]):
        diffs = torch.nonzero(out_rep[row] != out_tp[row]).flatten()
        if diffs.numel():
            t = int(diffs[0])
            assert t >= 4, "prompt tokens never differ"
            gap = float((la[row, t - 1, out_rep[row, t]] - la[row, t - 1, out_tp[row, t]]).abs())
            assert gap < 0.02 * scale, f"row {row} diverges at {t}, gap {gap}: not a tie"
    q_shape = tuple(placed["blocks.0.attn.q_proj.qt"].shape)
    head_shape = tuple(placed["lm_head.qt"].shape)
    # the JAX shards q (32, 8) and lm_head q (32, 16), (K, N/4); the port's
    # int8 qt is (N/4, K)
    assert q_shape == (8, 32) and head_shape == (16, 32), (q_shape, head_shape)
    agree = float((out_rep == out_tp).float().mean())
    say(f"dryrun int8 x tp: {n // 4}x4 mesh OK, logits rel diff {rel:.3f} vs replicated, "
        f"greedy agreement {agree:.2f} (divergences are verified ties), rule-placed q_proj qt "
        f"{q_shape}, lm_head qt {head_shape}")


def _dp_ep(n: int, device: str, say) -> None:
    """dp x ep: the MoE transformer with its experts split over expert."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_lm
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM, ep_rules
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw

    mesh = create_mesh({"data": n // 2, "expert": 2}, device=device)
    cfg = _lm_cfg(n_layers=1, moe_experts=2, moe_top_k=1)
    loader = ShardedLoader(synthetic_lm(size=16, seq_len=8, vocab_size=32), 4, mesh)
    t = Trainer(TransformerLM(cfg), loader, adamw(1e-3, weight_decay=0.0),
                strategy=TensorParallel(mesh, ep_rules()), loss="cross_entropy",
                aux_loss_weight=0.01, quiet=True)
    m = t._run_epoch(0)
    assert np.isfinite(m["loss"]), m
    w = t.model.blocks[0].moe.w_gate
    assert tuple(w.shape) == (1, 32, 128), w.shape  # one of the 2 experts a rank
    say(f"dryrun dp x ep: {n // 2}x2 mesh OK, loss {m['loss']:.4f}, w_gate shards "
        f"{tuple(w.shape)}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=None,
                    help="run the dry run in a world of this many ranks (else: entry())")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.n_devices is not None:
        dryrun_multichip(args.n_devices, args.device)
        return 0
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
