"""``examples/train_llm_3d.py`` of the port at a world of 4 on the CPU
(gloo): the data axis wider than one beside the other axes, the
compositions the JAX example and dry run build —
``{"data": 2, "stage": 2}`` (``--mode pp``) and ``{"data": 2, "seq": 2,
"model": 1}`` (``--mode tp_sp`` at N 4). Each starts from weights drawn
in the JAX layout and carried across the weight bridge, and its first
step's loss over the global batch (the twin's own rows: two data ranks'
blocks) is held to the JAX package's single-device ``TransformerLM`` on
the same weights and rows within ``rel 1e-5`` (float32), as
``tests/torch_sp_worker.py``'s worlds are held to the JAX single-device
step; every rank reports the same loss bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_examples_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_examples_train import bridged, example_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("examples_world4")
    jcfg, tree = bridged(workdir, stacked=False)
    ranks = spawn_tp(torch_examples_worker.examples_world4_case, 4, (str(workdir),),
                     backend="gloo", device="cpu")
    x, y = example_dataset().arrays
    model = jt.TransformerLM(jcfg)

    def jax_loss(rows):
        logits = jax.jit(model.apply)({"params": tree}, jnp.asarray(x[rows]))
        return float(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y[rows])).mean())

    return {"ranks": ranks, "jax_loss": jax_loss}


@pytest.mark.parametrize("mode,axes", [("pp", {"data": 2, "stage": 2}),
                                       ("tp_sp", {"data": 2, "seq": 2, "model": 1})])
def test_first_step_loss_matches_the_jax_single_device_step(setup, mode, axes):
    ranks = setup["ranks"]
    rows = ranks[0][mode]["rows"]
    assert len(rows) == 16  # 8 rows a data rank, two data ranks
    want = setup["jax_loss"](rows)
    for r in ranks:
        assert r[mode]["axes"] == axes
        assert r[mode]["rows"] == rows
        assert r[mode]["loss"] == ranks[0][mode]["loss"]
        assert r[mode]["loss"] == pytest.approx(want, rel=1e-5)
