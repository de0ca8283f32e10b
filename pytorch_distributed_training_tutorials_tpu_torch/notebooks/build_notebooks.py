"""Generate the port's four tutorial notebooks (twins of the JAX package's
``notebooks/``, which twin the reference's 01/02/03 lessons).

    python -m pytorch_distributed_training_tutorials_tpu_torch.notebooks.build_notebooks
    python -m pytorch_distributed_training_tutorials_tpu_torch.notebooks.build_notebooks --execute
    python -m pytorch_distributed_training_tutorials_tpu_torch.notebooks.build_notebooks \\
        --execute --out /tmp/nb --device cpu

Each lesson reproduces its reference lesson's observable on the port:

- 01: the per-rank batch split — a global batch of 32 over a world of 2
  ranks is a (16, 32) block a rank (the reference's four GPUs take 8
  rows each);
- 02: the data shards — ``launch.train_ddp`` prints ``Steps 64]`` at a
  world of 1 (its per-process entry, in the notebook) and ``Steps 16]`` at
  a world of 4 (``--nprocs 4``);
- 03: the model-parallel placement audit (an int8 checkpoint streamed onto
  the card, the toy two-stage split) and the split ResNet-50 (25,557,032
  parameters) timed against one device; the timing runs on a card only;
- 04: scaling out — FSDP's parameter and optimizer bytes a rank against
  DataParallel's, and an elastic restart of that FSDP world that resumes
  at epoch 2 from its checkpoint.

The ``.ipynb`` files are written with the standard library (no
``nbformat``). :func:`build` keeps the committed outputs of unchanged code
cells (matched by their deterministic ids), so regenerating is
byte-stable; an edited cell drops its output until ``--execute`` runs it
again. ``--execute`` runs every code cell of each notebook in one fresh
interpreter (a namespace a notebook) and stores each cell's printed
output; ``--out DIR`` writes the
executed notebooks there instead of over the committed ones. The notebooks
run on the card (``TUTORIAL_DEVICE``, set from ``--device``, names
another); without one and without ``--device cpu`` the first cell raises.
Every time or rate a cell prints is followed by the device it was taken
on: the card's ``nvidia-smi`` name and power limit, or ``cpu``. The card's
machine has no ``matplotlib``, so lesson 03's chart of the JAX notebook is
a printed table here.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE_ENV = "TUTORIAL_DEVICE"

SETUP = """
# the lessons run on the card; TUTORIAL_DEVICE=cpu runs them on the CPU
import os, subprocess, sys, tempfile, textwrap
import torch
import pytorch_distributed_training_tutorials_tpu_torch as pkg
from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.obs import environment_stamp

DEVICE = resolve_device(os.environ.get("TUTORIAL_DEVICE", "cuda")).type
CARDS = torch.cuda.device_count() if DEVICE == "cuda" else 0
stamp = environment_stamp(device=DEVICE)
DEVICE_NAME = stamp["nvidia_smi"] or stamp["device_name"]  # name and power limit, or cpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def run(args, timeout=900):
    \"\"\"A command in a child interpreter; its output printed here.\"\"\"
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         timeout=timeout, env=ENV)
    print(out.stdout, end="")
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def run_script(text, *args):
    \"\"\"A lesson's script (its own file: spawned ranks import its
    functions by name) run in a child interpreter.\"\"\"
    path = os.path.join(tempfile.mkdtemp(), "lesson.py")
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return run([path, *args])


print(f"device: {DEVICE} ({DEVICE_NAME}), {CARDS} card(s)")
"""

# -- 01: data parallelism, the per-rank split -----------------------------------
NB01 = [
    ("md", """
# 01 — Data parallelism: the per-rank batch split

Twin of the reference's `01.data_parallel.ipynb`. There, one process drives
four GPUs with `nn.DataParallel`: every step it replicates the module,
scatters a batch of 32 into four blocks of 8 (the reference's `Input shape:
[8, 32]` prints), runs four GIL-bound threads and gathers the outputs. The
port runs one process a card (the DDP model of lesson 02): each rank's
loader yields its own block of the global batch, and the gradients meet in
one all-reduce. The observable is the same, at two ranks here: **32 rows
split into two blocks of 16** (four ranks would take 8 each).
"""),
    ("code", SETUP),
    ("md", """
## The dataset and the global-batch loader
`RandomDataset(32, 1024)` twin: 1,024 samples of `randn(32)`.
`batch_mode="global"` makes 32 the whole step's batch, which the ranks
divide (everywhere else the batch is per rank, the reference's
`--batch_size`). In this one process the world is one rank: it holds the
whole batch.
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, random_dataset
from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh

ds = random_dataset(size=32, length=1024)
loader = ShardedLoader(ds, 32, create_mesh(device=DEVICE), batch_mode="global", shuffle=False)
print("world of 1: global batch", tuple(next(iter(loader)).shape), f"({len(loader)} steps)")
"""),
    ("md", """
## The split: a world of two ranks
Two spawned processes (one a card; on fewer cards they share card 0 and
their collectives go through host memory with gloo). Each takes its rows
of every global batch, and one `SampleModel` step (`Linear(32, 2)`, the
lesson's `loss = output.sum()`) averages the gradients across them.
"""),
    ("code", """
run_script('''
    import sys

    def rank_body(world, device):
        import torch
        from pytorch_distributed_training_tutorials_tpu_torch.data import (
            ShardedLoader, random_dataset)
        from pytorch_distributed_training_tutorials_tpu_torch.models import SampleModel
        from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
        from pytorch_distributed_training_tutorials_tpu_torch.train import TrainState, adamw
        from pytorch_distributed_training_tutorials_tpu_torch.parallel import DataParallel

        mesh = create_mesh(device=device)
        loader = ShardedLoader(random_dataset(size=32, length=1024), 32, mesh,
                               batch_mode="global", shuffle=False)
        x = next(iter(loader))
        model = SampleModel().to(x.device)
        state = DataParallel(mesh).shard_state(TrainState.create(model=model, tx=adamw(1e-3)))
        loss = model(x).sum()  # the lesson's toy objective
        grads = torch.autograd.grad(loss, state.params)
        state.grad_sync([*grads, loss.detach()])  # the all-reduce of DDP
        return {"rank": world.rank, "shape": tuple(x.shape), "steps": len(loader),
                "grad": float(grads[0].abs().sum())}

    if __name__ == "__main__":
        from pytorch_distributed_training_tutorials_tpu_torch.examples import run_world

        ranks = run_world(rank_body, 2, (sys.argv[1],), device=sys.argv[1])
        for r in ranks:
            print(f"rank {r['rank']}: Input shape: {r['shape']} "
                  f"({r['steps']} steps an epoch), averaged |grad| {r['grad']:.4f}")
        assert len({r["grad"] for r in ranks}) == 1  # every rank holds the same average
        print("per-rank batch (16, 32): 32 rows over 2 ranks")
''', DEVICE)
"""),
    ("md", """
## What replaced what

| `nn.DataParallel` (every step) | the port's DDP (one process a card) |
|---|---|
| replicate the module to N GPUs | parameters broadcast **once** at the start |
| scatter the batch's dim 0 | each rank's loader reads its own rows |
| N Python threads run forward | N processes, no shared GIL |
| gather outputs to GPU 0 | outputs stay on their rank |
| gradients reduced to the master | one all-reduce of the gradients |
"""),
]

# -- 02: DDP, the data shards ----------------------------------------------------
NB02 = [
    ("md", """
# 02 — Distributed data parallelism

Twin of the reference's `02.ddp_toy_example.ipynb`: **all-to-one = reduce**,
**one-to-all = broadcast**, every process has a **rank** in `[0,
world_size)`. The same trainer launched at two world sizes proves the data
*shards*: `Steps 64` alone, `Steps 16` at world size 4.
"""),
    ("code", SETUP),
    ("md", """
## The trainer, in this notebook
The exact `ddp_gpus.py` workload: `Linear(20, 1)` on 2,048 synthetic
samples, SGD(1e-2), batch 32 **a rank**, through the launcher's
per-process entry (`launch.train_ddp`'s `main`, what `--nprocs 1` runs).
One process is a world of one: 2,048 / 32 = **64 steps**, the reference's
cell 11 output.
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.launch import train_ddp

train_ddp.main(rank=0, world_size=1, max_epochs=1, batch_size=32, device=DEVICE)
print(f"(rates on {DEVICE_NAME})")
"""),
    ("md", """
## Launch contract 1 — spawn (explicit ranks)
The `mp.spawn` twin: the parent forks N processes, hands each its rank and
fixes the rendezvous address first (`ddp_gpus.py:12-17,104-105`). Four
ranks: 2,048 / 32 / 4 = **16 steps** an epoch. On fewer than four cards
ranks share a card, and `train_ddp` forms their group with gloo (NCCL
refuses two ranks on one device). The environment-discovered launch (`torchrun ... -m
pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp_env`,
the `ddp_gpus_torchrun.py` twin) differs only in where the topology comes
from.
"""),
    ("code", """
ddp = ["-m", "pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp",
       "--max_epochs", "1", "--batch_size", "32", "--device", DEVICE]
out = run(ddp + ["--nprocs", "4"])
assert "Steps 16]" in out   # 2048 / 32 / 4: the sharding proof
print(f"(rates on {DEVICE_NAME})")
"""),
]

# -- 03: model parallelism ----------------------------------------------------------
NB03 = [
    ("md", """
# 03 — Model parallelism

Twin of the reference's `03.model_parallel.ipynb`, three lessons:

1. **Quantize on load + placement audit** (`device_map="auto"` +
   `load_in_8bit=True`): a checkpoint streamed leaf by leaf, its matmul
   weights int8, every leaf's device and dtype audited;
2. **the toy two-stage split**: `Linear(10000, 10) -> relu -> Linear(10, 5)`
   with the activation hopping devices mid-forward;
3. **the split ResNet-50**, timed against one device.
"""),
    ("code", SETUP),
    ("md", """
## Lesson 1 — quantize on load, then the placement audit
The serving example's synthetic checkpoint of a small LM, streamed back
int8 (each matmul weight read, quantized and placed before the next read),
then every entry's shape, dtype and device — the reference's cell 4 audit:
int8 matmul weights, float norms and embedding.
"""),
    ("code", """
import dataclasses
from pytorch_distributed_training_tutorials_tpu_torch.examples import serve_llm_int8 as ex
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import audit_placement

cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, max_seq_len=64)
ckpt = os.path.join(tempfile.mkdtemp(), "lm")
print(f"params: {ex.write_synthetic_checkpoint(cfg, ckpt):,}")
params = ex.load_streamed(cfg, ckpt, device=DEVICE)
lines = audit_placement(params)
print(f"placement audit ({len(lines)} entries):")
for line in lines[:6]:
    print(" ", line)
"""),
    ("md", """
### Lesson 1b — serve it
The reference loads its model 8-bit but never generates. Here the int8
weights serve greedy generation through the int8 matmul kernel.
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM, generate

lm = TransformerLM(dataclasses.replace(cfg, quantized=True))
prompt = (torch.arange(8)[None].repeat(2, 1)) % cfg.vocab_size
out = generate(lm, params, prompt, 8, device=DEVICE)
print("generated:", out[:, 8:].tolist())
"""),
    ("md", """
## Lesson 2 — the toy two-device split
The reference pins `net1` to `cuda:0`, `net2` to `cuda:1` and calls
`x.to("cuda:1")` mid-forward (cells 7/12). `ManualPipeline` does the same:
each stage's weights on its device, the hop an explicit copy, the backward
crossing it in reverse. With one card both stages sit on it.
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.models import ToyModel
from pytorch_distributed_training_tutorials_tpu_torch.parallel import ManualPipeline
from pytorch_distributed_training_tutorials_tpu_torch.train import sgd

STAGES = ([f"cuda:{i}" for i in range(2)] if CARDS >= 2 else [DEVICE, DEVICE])
pipe = ManualPipeline.from_module(ToyModel(), devices=STAGES, loss="mse",
                                  optimizer=sgd(1e-3))
for line in pipe.placement_audit():
    print(line)
gen = torch.Generator().manual_seed(0)
for step in range(3):
    x, y = torch.randn(20, 10000, generator=gen), torch.randn(20, 5, generator=gen)
    print(f"step {step}: loss {float(pipe.train_step(x, y)):.4f}")
"""),
    ("md", """
## Lesson 3 — the split ResNet-50
conv1..layer2 on the first stage, layer3..fc on the second (cells 18/26).
The parameter count does not depend on the cut: **25,557,032** (cells
20/22).
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.models import resnet50

BATCH, IMG = 120, 128  # the reference's 120 images of 3 x 128 x 128
rpipe = ManualPipeline.from_module(resnet50(num_classes=1000), devices=STAGES, loss="mse",
                                   optimizer=sgd(1e-3))
counts = rpipe.stage_param_counts()
print("per-stage params:", [f"{c:,}" for c in counts])
print(f"total {sum(counts):,} == unsplit 25,557,032:", sum(counts) == 25_557_032)
"""),
    ("md", """
The reference's `timeit.repeat` benchmark (cell 28), as a table (the
card's machine has no `matplotlib` for the reference's bar chart): one
train step of the split model against the same model on one device, each
timed with CUDA events over 5 steps after a warmup step. It needs a card.
"""),
    ("code", """
from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer

if DEVICE != "cuda":
    print("timing: needs a card (this run is on the cpu); the audit above stands")
else:
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(BATCH, IMG, IMG, 3, generator=gen)
    y = torch.randn(BATCH, 1000, generator=gen)
    single = Trainer(resnet50(num_classes=1000),
                     ShardedLoader(ArrayDataset((x.numpy(), y.numpy())), BATCH,
                                   create_mesh(device=DEVICE)), sgd(1e-3), loss="mse",
                     quiet=True)
    batch = next(iter(single.loader))

    def single_step():
        single.state, m = single.train_step(single.state, batch)
        return m["loss"]

    def timed(step, reps=5):
        step()  # warmup: first launches, cuDNN's choices
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times), sum(times) / reps

    rows = [("2-stage pipeline", *timed(lambda: rpipe.train_step(x, y))),
            ("single device", *timed(single_step))]
    print(f"ResNet-50 train step, batch {BATCH} @ {IMG}x{IMG}x3, on {DEVICE_NAME} "
          f"({len(set(STAGES))} card(s) for the stages)")
    print("| model | min ms | mean ms |")
    print("|---|---|---|")
    for name, best, mean in rows:
        print(f"| {name} | {best:.2f} | {mean:.2f} |")
"""),
    ("md", """
As in the reference, the sequential two-stage split is **not** faster than
one device: one batch flows stage 0 then stage 1 and each stage idles in
turn. The split buys memory (each device holds about half the parameters),
not speed; microbatching (lesson 04's pipelines) is the classic fix.
"""),
]

# -- 04: scaling out --------------------------------------------------------------
NB04 = [
    ("md", """
# 04 — Scaling out: FSDP and elastic training

The reference *declares* deepspeed and megatron-fsdp in its environment and
writes its torchrun script against an elastic agent, but builds neither.
This lesson makes both real on the port, in one world of two ranks:
parameters sharded over the ranks, and a world that restarts after a crash
and resumes from its checkpoint.
"""),
    ("code", SETUP),
    ("md", """
## FSDP / ZeRO, and an elastic restart
DataParallel keeps every parameter and optimizer moment on every rank.
FSDP keeps each rank's shard of them and gathers a weight when it is used
(its gradient reduce-scattered back): a rank's bytes drop to about
`1/world` of the sharded leaves', the numbers unchanged. Below,
`MLP(features=(256, 4))` under AdamW with FSDP, checkpointed every epoch
(an FSDP checkpoint gathers the shards; rank 0 writes the layout an
unsharded state writes).

torchrun's elastic agent restarts a failed world — from scratch, since the
reference never checkpoints. Here `spawn(max_restarts=1)` tears the world
down the moment a rank dies, forks it again with a fresh rendezvous, and
the Trainer resumes from its latest checkpoint: rank 1 kills itself
(`os._exit`) on the first attempt once epochs 0-1 are saved, and the new
world prints **`resumed at epoch 2`** and finishes the third epoch.
"""),
    ("code", """
workdir = tempfile.mkdtemp()
out = run_script(\'\'\'
    import os, sys

    def worker(rank, workdir, device):
        import numpy as np
        from pytorch_distributed_training_tutorials_tpu_torch.data import (
            ArrayDataset, ShardedLoader)
        from pytorch_distributed_training_tutorials_tpu_torch.launch import world_backend
        from pytorch_distributed_training_tutorials_tpu_torch.models import MLP
        from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
            FSDP, create_mesh, distributed)
        from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw

        backend = world_backend(2, device)
        if device == "cuda" and backend == "gloo":
            os.environ["LOCAL_RANK"] = "0"  # fewer cards than ranks: both on card 0
        distributed.init(device=device, backend=backend)  # the topology from the environment
        rng = np.random.Generator(np.random.PCG64(0))
        labels = rng.integers(0, 4, 512).astype(np.int32)
        centers = rng.standard_normal((4, 64)).astype(np.float32) * 3
        x = centers[labels] + 0.1 * rng.standard_normal((512, 64)).astype(np.float32)
        mesh = create_mesh(device=device)
        t = Trainer(MLP(features=(256, 4), in_dim=64),
                    ShardedLoader(ArrayDataset((x, labels)), 8, mesh),
                    adamw(1e-3, weight_decay=0.0), strategy=FSDP(mesh, min_size=256),
                    loss="cross_entropy", quiet=True)
        ckpt = os.path.join(workdir, "ckpt")
        sentinel = os.path.join(workdir, "crashed_once")
        if os.path.exists(ckpt):
            t.restore(ckpt)
            print(f"[rank {rank}] resumed at epoch {t.epoch}", flush=True)
        elif rank == 0:
            opt = t.state.opt_state
            mine = sum(p.nbytes for p in t.state.params)
            moments = sum(a.nbytes + b.nbytes for a, b in zip(opt.mu, opt.nu))
            whole = sum(p.numel() * 4 for p in MLP(features=(256, 4), in_dim=64).parameters())
            print(f"FSDP: {mine:,} parameter + {moments:,} moment bytes per rank; "
                  f"DataParallel: {whole:,} + {2 * whole:,} ({mine / whole:.3f} of them)",
                  flush=True)
        while t.epoch < 3:
            m = t.train(t.epoch + 1)
            t.save(ckpt)
            if t.epoch == 2 and rank == 1 and not os.path.exists(sentinel):
                open(sentinel, "w").write("1")
                os._exit(17)  # a hard crash mid-training
        if rank == 0:
            print(f"epoch {t.epoch - 1}: loss {m['loss']:.4f}", flush=True)
        distributed.shutdown()

    if __name__ == "__main__":
        from pytorch_distributed_training_tutorials_tpu_torch.launch import spawn

        spawn(worker, 2, args=tuple(sys.argv[1:]), env_contract=True, max_restarts=1,
              join_timeout_s=600)
        print("RESTART-AND-RESUME OK")
\'\'\', workdir, DEVICE)
assert "resumed at epoch 2" in out and "RESTART-AND-RESUME OK" in out
assert os.path.exists(os.path.join(workdir, "crashed_once"))
"""),
    ("md", """
Both recipes are the same code on more cards: only the world gets wider,
and the collectives move from gloo to NCCL.
"""),
]

NOTEBOOKS = {
    "01_data_parallel.ipynb": NB01,
    "02_ddp.ipynb": NB02,
    "03_model_parallel.ipynb": NB03,
    "04_scaling_out.ipynb": NB04,
}

# what each executed notebook must print (the lessons' observables)
PROOFS = {
    "01_data_parallel.ipynb": ["Input shape: (16, 32)", "per-rank batch (16, 32)"],
    "02_ddp.ipynb": ["Steps 16]", "Steps 64]"],
    "03_model_parallel.ipynb": ["placement audit", "25,557,032", "int8"],
    "04_scaling_out.ipynb": ["moment bytes per rank", "resumed at epoch 2",
                             "RESTART-AND-RESUME OK"],
}


def _lines(text: str) -> list[str]:
    return text.splitlines(keepends=True)


def _dumps(nb: dict) -> str:
    return json.dumps(nb, indent=1, sort_keys=True, ensure_ascii=False) + "\n"


def _read(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build(name: str, cells: list, directory: str = HERE) -> str:
    """Write one notebook into ``directory``, keeping the outputs of the
    code cells whose source is unchanged (matched by id)."""
    path = os.path.join(directory, name)
    prior = {}
    old = _read(path)
    for c in (old or {}).get("cells", []):
        if c.get("cell_type") == "code":
            prior[c.get("id")] = c
    out_cells = []
    for i, (kind, src) in enumerate(cells):
        src = src.strip("\n")
        cid = f"cell-{i}"
        if kind == "md":
            cell = {"cell_type": "markdown", "id": cid, "metadata": {}, "source": _lines(src)}
        else:
            cell = {"cell_type": "code", "execution_count": None, "id": cid, "metadata": {},
                    "outputs": [], "source": _lines(src)}
            was = prior.get(cid)
            if was is not None and "".join(was.get("source", [])) == src:
                cell["outputs"] = was.get("outputs", [])
                cell["execution_count"] = was.get("execution_count")
        out_cells.append(cell)
    nb = {"cells": out_cells,
          "metadata": {"kernelspec": {"display_name": "Python 3", "language": "python",
                                      "name": "python3"},
                       "language_info": {"name": "python"}},
          "nbformat": 4, "nbformat_minor": 5}
    with open(path, "w") as f:
        f.write(_dumps(nb))
    return path


def build_all(directory: str = HERE) -> list[str]:
    return [build(name, cells, directory) for name, cells in NOTEBOOKS.items()]


def execute(path: str) -> None:
    """Run every code cell of the notebook at ``path`` in this interpreter
    (a fresh one, started by the command line for the notebooks it
    executes; each notebook has a namespace of its own) from a scratch
    working directory, and store each cell's printed output."""
    import tempfile

    repo = os.path.dirname(os.path.dirname(HERE))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    os.environ["PYTHONPATH"] = repo + os.pathsep + os.environ.get("PYTHONPATH", "")
    nb = _read(path)
    ns: dict = {"__name__": "__main__"}
    count = 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for cell in nb["cells"]:
                if cell["cell_type"] != "code":
                    continue
                count += 1
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    exec(compile("".join(cell["source"]), f"{os.path.basename(path)}"
                                 f"[{cell['id']}]", "exec"), ns)
                text = buf.getvalue()
                cell["outputs"] = ([{"name": "stdout", "output_type": "stream",
                                     "text": _lines(text)}] if text else [])
                cell["execution_count"] = count
        finally:
            os.chdir(cwd)
    with open(path, "w") as f:
        f.write(_dumps(nb))


def outputs_text(path: str) -> str:
    """Every code cell's stored output of a notebook, joined."""
    nb = _read(path)
    return "".join("".join(o.get("text", [])) for c in nb["cells"] if c["cell_type"] == "code"
                   for o in c.get("outputs", []))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--execute", nargs="*", default=None, metavar="NOTEBOOK",
                    help="execute these notebooks (none named: all four)")
    ap.add_argument("--out", default=None,
                    help="write (and execute) the notebooks here instead of over the "
                         "committed ones")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the lessons run (default cuda; raises without a GPU)")
    ap.add_argument("--_execute_in_child", nargs="+", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args._execute_in_child:
        for path in args._execute_in_child:
            execute(path)
        return 0
    directory = args.out or HERE
    os.makedirs(directory, exist_ok=True)
    for path in build_all(directory):
        print("wrote", path)
    if args.execute is None:
        return 0
    unknown = [n for n in args.execute if n not in NOTEBOOKS]
    if unknown:
        ap.error(f"unknown notebook(s) {unknown}; choose from {sorted(NOTEBOOKS)}")
    env = {**os.environ, DEVICE_ENV: args.device or "cuda"}
    names = args.execute or list(NOTEBOOKS)
    paths = [os.path.join(directory, name) for name in names]
    subprocess.run([sys.executable, os.path.abspath(__file__), "--_execute_in_child", *paths],
                   check=True, env=env)
    for name, path in zip(names, paths):
        missing = [p for p in PROOFS[name] if p not in outputs_text(path)]
        if missing:
            raise SystemExit(f"{name}: proof {missing} missing from its outputs")
        print("executed", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
