"""The port's ``GPipe`` over a data axis: a gloo world of 4, each rank
holding both stages on the CPU (``{"data": 4, "stage": 2}``), against the
JAX ``GPipe`` on its ``{"data": 4, "stage": 2}`` mesh of fake CPU
devices.

The case and tolerances of ``tests/test_torch_gpipe.py`` (ResNet-18, 8
filters, 16 images of 8x8 in 4 microbatches, float64 compute on both
sides, ``rtol 5e-4 / atol 5e-5``). Each rank takes its row of every
microbatch; the gradients and the loss are averaged over the data group
and BatchNorm's sums taken over it, so every rank ends with the same
bytes. Microbatches of 2 rows over 4 data ranks are refused.
"""

import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

import torch_strategy_worker
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu_torch.models import from_jax_params, resnet18
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_gpipe import LR, M, NF, RTOL, images, jax_gpipe_run, jax_leaf, mismatches


@pytest.fixture(scope="module")
def setup(devices, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("gpipe_dp")
    with enable_x64(True):
        jax_run = jax_gpipe_run(jax_mesh({"data": 4, "stage": 2}, devices=devices))
    tm = resnet18(num_classes=10, stem="cifar", num_filters=NF)
    x, y = images()
    torch.save({"state": from_jax_params(jax_run["start"]["params"], tm, "cpu",
                                         batch_stats=jax_run["start"]["batch_stats"]),
                "nf": NF, "m": M, "lr": LR, "x": torch.tensor(x), "y": torch.tensor(y)},
               workdir / "gpipe.pt")
    ranks = spawn_tp(torch_strategy_worker.gpipe_dp_case, 4, (str(workdir),),
                     backend="gloo", device="cpu")
    return {"jax": jax_run, "ranks": ranks}


def test_data_by_stage_step_matches_jax(setup):
    ranks = setup["ranks"]
    assert [r["dp"] for r in ranks] == [(4, 0), (4, 1), (4, 2), (4, 3)]
    np.testing.assert_allclose(ranks[0]["loss"], setup["jax"]["loss"], rtol=RTOL)
    assert mismatches(ranks[0]["state"], setup["jax"]) == []


def test_every_rank_holds_the_same_bytes(setup):
    ranks = setup["ranks"]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        assert all(torch.equal(r["state"][k], ranks[0]["state"][k]) for k in r["state"])
    # BatchNorm's sums ran over the group: the statistics are the global
    # microbatches' (no rank's own rows give the JAX value alone)
    key = "bn1.mean"
    np.testing.assert_allclose(ranks[0]["state"][key].numpy(),
                               jax_leaf(setup["jax"]["stepped"], key), rtol=RTOL, atol=1e-12)


def test_microbatch_rows_must_divide_the_data_width(setup):
    for r in setup["ranks"]:
        assert r["refusal"] == "microbatch 2 rows not divisible by dp width 4"
