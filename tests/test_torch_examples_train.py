"""The port's training examples (``examples/train_llm_3d.py``,
``examples/train_resnet_mnist.py``) in a gloo world of 2 on the CPU,
against the JAX package's ``examples/train_llm_3d.py``.

- ``train_llm_3d --mode pp`` at a world of 2 (``{"data": 1, "stage":
  2}``), the JAX toy config, started from weights drawn in the JAX layout
  and carried across the weight bridge: its first batch is the JAX
  example's (``ShardedLoader`` over the same ``synthetic_lm``, read on a
  JAX mesh of the same shape) and its first step's loss equals the JAX
  example's model (``PipelinedTransformerLM`` on that mesh) on the same
  weights and rows within ``rel 1e-5`` (float32; the JAX pipeline test
  holds its loss to ``1e-6`` of the unpipelined model's, the port's
  schedule adds the two stages' cross-rank reductions);
- ``train_resnet_mnist --fsdp --ckpt`` on a 256-row slice of the MNIST
  surrogate (the module's ``mnist`` replaced inside the ranks): one epoch
  saved, then a second run resumed at epoch 1 (its ``resumed at epoch 1``
  line), evaluated over 64 rows of the test split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_examples_worker
from pytorch_distributed_training_tutorials_tpu.data import ShardedLoader as JShardedLoader
from pytorch_distributed_training_tutorials_tpu.data import synthetic_lm as jsynthetic_lm
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline_spmd import (
    PipelinedTransformerLM as JaxPipelined,
)
from pytorch_distributed_training_tutorials_tpu_torch.examples import train_llm_3d
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_train import jax_float_tree, to_np

torch.set_num_threads(1)
SPEC = dict(vocab_size=train_llm_3d.VOCAB, d_model=train_llm_3d.D_MODEL,
            n_layers=train_llm_3d.LAYERS, n_heads=train_llm_3d.HEADS, max_seq_len=64)


def example_dataset():
    return jsynthetic_lm(size=train_llm_3d.ROWS, seq_len=train_llm_3d.SEQ,
                         vocab_size=train_llm_3d.VOCAB)


def bridged(tmp, stacked: bool):
    """The JAX-layout tree and its port state dict, saved for the ranks."""
    jcfg = jt.TransformerConfig(**SPEC, scan_layers=stacked)
    tree = jax_float_tree(jcfg)
    torch.save(from_jax_params(to_np(tree), TransformerConfig(**SPEC), device="cpu"),
               tmp / "llm.pt")
    return jcfg, tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    workdir = tmp_path_factory.mktemp("examples_train")
    jcfg, tree = bridged(workdir, stacked=True)
    ranks = spawn_tp(torch_examples_worker.examples_case, 2, (str(workdir),),
                     backend="gloo", device="cpu")
    mesh = jax_mesh({"data": 1, "stage": 2}, devices=devices[:2])
    ds = example_dataset()
    jx, jy = next(iter(JShardedLoader(ds, 8, mesh)))
    pipe = JaxPipelined(jcfg, mesh, num_microbatches=2)
    logits = jax.jit(pipe.apply)({"params": tree}, jx)
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, jy).mean()
    return {"ranks": ranks, "ds": ds, "jax_batch": (np.asarray(jx), np.asarray(jy)),
            "jax_loss": float(loss)}


def test_pp_reads_the_jax_examples_first_batch(setup):
    x, y = setup["ds"].arrays
    for r in setup["ranks"]:
        rows = r["pp"]["rows"]
        assert r["pp"]["axes"] == {"data": 1, "stage": 2}
        np.testing.assert_array_equal(x[rows], setup["jax_batch"][0])
        np.testing.assert_array_equal(y[rows], setup["jax_batch"][1])


def test_pp_first_step_loss_matches_the_jax_example(setup):
    for r in setup["ranks"]:
        assert r["pp"]["loss"] == pytest.approx(setup["jax_loss"], rel=1e-5)


def test_resnet_fsdp_checkpoint_resumes(setup):
    first, second = setup["ranks"][0]["resnet"]["runs"]
    assert first["resumed_at"] is None and first["epoch"] == 1
    assert second["resumed_at"] == 1 and second["epoch"] == 2
    assert "resumed at epoch 1" in second["stdout"]
    assert "eval: {" in second["stdout"]
    assert second["eval"]["samples"] == torch_examples_worker.RESNET_TEST_ROWS
    assert np.isfinite(second["eval"]["loss"])
    other = setup["ranks"][1]["resnet"]["runs"]
    assert other[1]["resumed_at"] == 1 and other[1]["stdout"] == ""  # rank 0 prints
    assert other[1]["eval"] == second["eval"]


def test_examples_refuse_without_a_gpu_or_a_usable_world():
    from pytorch_distributed_training_tutorials_tpu_torch.examples import train_resnet_mnist

    for main in (train_llm_3d.main, train_resnet_mnist.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--max_epochs", "1"])
    with pytest.raises(ValueError, match="even world"):
        train_llm_3d.main(["--mode", "pp", "--nprocs", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="multiple of 4"):
        train_llm_3d.main(["--mode", "tp_sp", "--nprocs", "2", "--device", "cpu"])
