"""The PyTorch port imports nothing of JAX and nothing of the JAX package.

Two checks: at run time, a fresh interpreter imports every module of the
port (and ``chip_smoke.py``) and then finds no ``jax*``, ``flax``,
``optax`` or ``orbax`` module and no module of
``pytorch_distributed_training_tutorials_tpu`` in ``sys.modules`` (the
pattern of ``tests/test_prefix.py``'s host-only pin); statically, no
import statement in the port's sources or ``chip_smoke.py`` names them.
A third check reads paths: no string of the port's code or
``chip_smoke.py`` (docstrings and ``file.py:LINE`` citations aside) names
a file inside the JAX package's directory, and no path join takes that
directory as a component.
"""

import ast
import os
import re
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
           "launch.train_ddp_env", "bench.harness", "bench.headline",
           # the rest of the training path: streaming input, guardrails, benches
           "utils.chaos", "data.prefetch", "data.streaming", "obs.receipt", "obs.timing",
           "bench.scaling", "bench.__main__", "launch.pod",
           # the LoRA slice: the port's own copy of the registry, the bank, lora
           "adapters", "adapters.registry", "adapters.bank", "adapters.lora",
           # serving's failure handling: the port's own copies of the fleet
           # router, the flight recorder and its histograms
           "serve.router", "obs.flight", "obs.histogram",
           # tensor-parallel serving: the strategy, its rules and spawn_tp
           "parallel.tensor_parallel",
           # the last parallel strategies: the pipeline over ranks, ring and
           # Ulysses attention, mixture-of-experts with expert parallelism
           "parallel.pipeline_spmd", "parallel.ring_attention", "parallel.ulysses",
           "models.moe",
           # serving's SLO tiers: the port's own copy of the JAX slo module
           "serve.slo",
           # the contract sentry: the port's own copy of the JAX sentry
           "obs.sentry")
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


# a "file.py:LINE" citation of a JAX kernel (the ``replaces`` field of
# chip_smoke.py's kernels line) names a line, not a file that is read
_CITATION = re.compile(rf"^{JAX_PACKAGE}/[\w/]+\.py:\d+$")


def _docstring_nodes(tree) -> set[int]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _reaches_jax_package(text: str) -> bool:
    """A string that names a path inside the JAX package's directory: the
    directory name followed by ``/``, or joined with ``csrc``."""
    if _CITATION.match(text):
        return False
    return (f"{JAX_PACKAGE}/" in text or f"{JAX_PACKAGE}\\" in text
            or re.search(rf"{JAX_PACKAGE}\W*csrc", text) is not None)


def _path_findings(path: Path, root: Path = REPO) -> list[str]:
    """Every string constant outside a docstring that names a path in the
    JAX package, and every ``Path`` / ``os.path.join`` join that takes the
    package's directory name as a component (reported relative to
    ``root``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    where = path.relative_to(root)
    docs = _docstring_nodes(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) not in docs and _reaches_jax_package(node.value):
                found.append(f"{where}:{node.lineno} {node.value!r}")
        operands = []
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            operands = [node.left, node.right]  # pathlib: base / "name"
        elif isinstance(node, ast.Call):
            operands = list(node.args)  # Path(...), os.path.join(...)
        for op in operands:
            if isinstance(op, ast.Constant) and op.value == JAX_PACKAGE:
                found.append(f"{where}:{node.lineno} joins {JAX_PACKAGE!r}")
    return found


def test_port_sources_read_no_file_of_the_jax_package():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = [f for path in files for f in _path_findings(path)]
    assert not found, found
    # C and CUDA sources include nothing of the JAX package either
    for path in sorted((REPO / PORT / "csrc").iterdir()):
        for i, ln in enumerate(path.read_text().splitlines(), 1):
            assert not (ln.lstrip().startswith("#include") and JAX_PACKAGE in ln), (path, i)


def test_path_check_catches_each_form(tmp_path):
    """The check above fails on each way a source could reach into the JAX
    package's directory, and passes the forms the port uses."""
    bad = [
        f'SOURCE = REPO / "{JAX_PACKAGE}" / "csrc" / "fastgather.cpp"\n',
        f'SOURCE = os.path.join(REPO, "{JAX_PACKAGE}", "csrc", "x.cpp")\n',
        f'SOURCE = Path("{JAX_PACKAGE}")\n',
        f'SOURCE = "{JAX_PACKAGE}/csrc/fastgather.cpp"\n',
        f'SOURCE = f"{{REPO}}/{JAX_PACKAGE}/data/loader.py"\n',
        f'SOURCE = "{JAX_PACKAGE}csrc"\n',
    ]
    for i, src in enumerate(bad):
        p = tmp_path / f"bad{i}.py"
        p.write_text("import os\nfrom pathlib import Path\n" + src)
        assert _path_findings(p, tmp_path), src
    good = tmp_path / "good.py"
    good.write_text(
        f'"""Port of ``{JAX_PACKAGE}/ops/quant.py``."""\n'
        f'REPLACES = "{JAX_PACKAGE}/ops/quant.py:141"\n'
        'SOURCE = Path(__file__).parent / "csrc" / "fastgather.cpp"\n'
    )
    assert not _path_findings(good, tmp_path)


def test_native_gather_builds_from_the_port():
    from pytorch_distributed_training_tutorials_tpu_torch.data import native

    assert native.SOURCE == REPO / PORT / "csrc" / "fastgather.cpp"
    assert native.SOURCE.exists()
