"""The port's tutorial notebooks (``notebooks/build_notebooks.py`` and
the four ``.ipynb`` files it writes), the twins of the JAX package's.

- regenerating them is byte-stable: the builder, run over a copy of the
  committed files, writes the same bytes (unchanged cells keep their
  committed outputs);
- the committed notebooks carry an output for every code cell and each
  lesson's proof strings (``Input shape: (16, 32)``; ``Steps 16]`` and
  ``Steps 64]``; the placement audit and 25,557,032; the FSDP bytes and
  ``resumed at epoch 2``), and every output that prints a time or a rate
  names its device;
- executing every cell (on the CPU) is ``slow``, as the JAX notebooks'
  execution test is.
"""

import json
import shutil

import pytest

from pytorch_distributed_training_tutorials_tpu_torch.notebooks import build_notebooks as bn


def _committed(name: str) -> str:
    with open(f"{bn.HERE}/{name}") as f:
        return f.read()


def test_notebooks_regenerate_byte_stable(tmp_path):
    for name in bn.NOTEBOOKS:
        shutil.copy(f"{bn.HERE}/{name}", tmp_path / name)
    bn.build_all(str(tmp_path))
    for name in bn.NOTEBOOKS:
        assert (tmp_path / name).read_text() == _committed(name), f"{name} is stale"
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    bn.build_all(str(fresh))  # no prior file: every code cell without output
    nb = json.loads((fresh / "02_ddp.ipynb").read_text())
    assert all(not c["outputs"] for c in nb["cells"] if c["cell_type"] == "code")


def test_committed_notebooks_carry_their_proofs():
    for name in bn.NOTEBOOKS:
        nb = json.loads(_committed(name))
        assert nb["nbformat"] == 4
        code = [c for c in nb["cells"] if c["cell_type"] == "code"]
        assert code and all(c["outputs"] for c in code), f"{name}: a code cell has no output"
        text = bn.outputs_text(f"{bn.HERE}/{name}")
        for proof in bn.PROOFS[name]:
            assert proof in text, f"{name}: proof {proof!r} missing"
        device = text.splitlines()[0]
        assert device.startswith("device: ")
        for out in (o for c in code for o in c["outputs"]):
            block = "".join(out["text"])
            if "steps/s" in block or " ms |" in block:
                assert "rates on " in block or " on " in block, block


@pytest.mark.slow
def test_notebooks_execute(tmp_path):
    assert bn.main(["--execute", "--out", str(tmp_path), "--device", "cpu"]) == 0
    for name in bn.NOTEBOOKS:
        text = bn.outputs_text(str(tmp_path / name))
        assert all(p in text for p in bn.PROOFS[name]), name
