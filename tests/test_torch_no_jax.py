"""The PyTorch port imports nothing of JAX and nothing of the JAX package.

Two checks: at run time, a fresh interpreter imports every module of the
port (and ``chip_smoke.py``) and then finds no ``jax*``, ``flax``,
``optax`` or ``orbax`` module and no module of
``pytorch_distributed_training_tutorials_tpu`` in ``sys.modules`` (the
pattern of ``tests/test_prefix.py``'s host-only pin); statically, no
import statement in the port's sources or ``chip_smoke.py`` names them.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = "pytorch_distributed_training_tutorials_tpu_torch"
JAX_PACKAGE = "pytorch_distributed_training_tutorials_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PACKAGE)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted((REPO / PORT).rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_modules_import_no_jax():
    mods = _port_modules()
    assert f"{PORT}.serve.engine" in mods and f"{PORT}.ops.quant" in mods
    # the DDP main path's modules, each imported below
    ddp = ("data.sampler", "data.datasets", "data.native", "data.loader", "data.resident",
           "models.mlp", "models.resnet", "models.utils", "parallel.distributed",
           "parallel.mesh", "parallel.collective", "parallel.data_parallel", "utils.logging", "obs.metrics",
           "train.trainer", "train.optim", "launch._spawn", "launch.train_ddp",
           "launch.train_ddp_env", "bench.harness", "bench.headline")
    assert {f"{PORT}.{m}" for m in ddp} <= set(mods)
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "import chip_smoke\n"
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        + "assert not bad, bad\n"
        + "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_import():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    found.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not found, found
    # and no source text reaches into the JAX package by dotted name
    for path in files:
        assert f"{JAX_PACKAGE}." not in "\n".join(
            ln for ln in path.read_text().splitlines()
            if ln.lstrip().startswith(("import ", "from "))
        ), path
