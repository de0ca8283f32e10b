"""Checkpoints of an FSDP-sharded train state in the PyTorch port
(``train/trainer.py`` ``save`` / ``restore`` / the loss-spike rollback
under ``parallel.FSDP``), in a gloo world of 2 (``{"data": 2}``) on the
CPU, against the JAX package's contract that a checkpoint's files do not
depend on the sharding that wrote them (its ``Trainer.save`` /
``restore``).

- save -> train on -> restore under FSDP gives back every shard, moment,
  the step and the epoch bitwise (AdamW and SGD with momentum);
- an optimizer-state list field that the state class does not name as
  per-parameter comes back as it was saved, not gathered or sliced,
  although it has one entry a parameter;
- a DataParallel checkpoint written at world 1 restores under FSDP to
  exactly each rank's block of every leaf, and an FSDP checkpoint
  restores under DataParallel (in the world, and at world 1 in this
  process) to exactly the whole leaves: the gathered ones are the ranks'
  shards concatenated, bitwise;
- a rollback under FSDP restores the saved state bitwise;
- a tensor-parallel state's checkpoint is still refused.
"""

import os

import numpy as np
import pytest
import torch

import torch_examples_worker
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp

torch.set_num_threads(1)


def _data():
    rng = np.random.Generator(np.random.PCG64(3))
    labels = rng.integers(0, 4, 64).astype(np.int32)
    centers = rng.standard_normal((4, 16)).astype(np.float32) * 3
    x = centers[labels] + 0.1 * rng.standard_normal((64, 16)).astype(np.float32)
    toks = rng.integers(0, 32, (8, 17))
    return {"x": torch.tensor(x), "y": torch.tensor(labels),
            "tok_x": torch.tensor(toks[:, :-1]), "tok_y": torch.tensor(toks[:, 1:])}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fsdp_ckpt")
    saved = _data()
    torch.save(saved, workdir / "data.pt")
    # a world-1 DataParallel checkpoint, one epoch in
    dp = torch_examples_worker._mlp_trainer(saved, None)
    dp.train(1)
    dp.save(str(workdir / "dp_world1"))
    ranks = spawn_tp(torch_examples_worker.fsdp_ckpt_case, 2, (str(workdir),),
                     backend="gloo", device="cpu")
    # the FSDP checkpoint restored at world 1
    one = torch_examples_worker._mlp_trainer(saved, None)
    one.restore(str(workdir / "fsdp_adamw"))
    return {"ranks": ranks, "dp_world1": torch_examples_worker._shards(dp),
            "fsdp_at_world1": torch_examples_worker._shards(one)}


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _block(t: torch.Tensor, dim, rank: int) -> torch.Tensor:
    if dim is None:
        return t
    n = t.shape[dim] // 2
    return t.narrow(dim, rank * n, n)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_fsdp_save_restore_is_bitwise(setup, opt):
    for r in setup["ranks"]:
        before, after = r[opt]["before"], r[opt]["after"]
        _equal(before["model"], after["model"])
        for k in before["moments"]:
            _equal(before["moments"][k], after["moments"][k])
        assert (before["step"], before["epoch"]) == (after["step"], after["epoch"])
        assert any(".parametrizations." in k for k in after["model"])  # really sharded
        assert r[opt]["collectives"]["checkpoint_gather"] > 0


def test_fsdp_checkpoint_keeps_a_list_field_that_is_not_per_parameter(setup):
    for r in setup["ranks"]:
        before, after = r["tally"]["before"], r["tally"]["after"]
        for k in ("trace", "tally"):
            _equal(before["moments"][k], after["moments"][k])
        assert all(t.shape == (2,) for t in after["moments"]["tally"].values())
        assert all(t[0] == before["step"] for t in after["moments"]["tally"].values())
        _equal(before["model"], after["model"])


def test_dataparallel_checkpoint_restores_under_fsdp(setup):
    whole = setup["dp_world1"]
    for r in setup["ranks"]:
        got, plan = r["from_dp"], r["plan"]
        for key, t in got["model"].items():
            name = key.replace(".parametrizations.", ".").removesuffix(".original")
            dim = plan[name] if name != key else None
            assert torch.equal(t, _block(whole["model"][name], dim, r["rank"])), key
        for k, ts in got["moments"].items():
            assert ts.keys() == whole["moments"][k].keys()
            for n, t in ts.items():
                assert torch.equal(t, _block(whole["moments"][k][n], plan[n], r["rank"])), n
        assert got["epoch"] == whole["epoch"] == 1 and got["step"] == whole["step"]


def test_fsdp_checkpoint_restores_under_dataparallel(setup):
    r0, r1 = setup["ranks"]
    plan = r0["plan"]
    for r in (r0, r1):
        _equal(r["to_dp"]["model"], setup["fsdp_at_world1"]["model"])
        for k in r["to_dp"]["moments"]:
            _equal(r["to_dp"]["moments"][k], setup["fsdp_at_world1"]["moments"][k])
    # the whole leaves are the two ranks' shards at save, concatenated
    for key, t in r0["adamw"]["before"]["model"].items():
        name = key.replace(".parametrizations.", ".").removesuffix(".original")
        whole = setup["fsdp_at_world1"]["model"][name]
        if name == key:
            assert torch.equal(t, whole)
        else:
            joined = torch.cat([t, r1["adamw"]["before"]["model"][key]], dim=plan[name])
            assert torch.equal(joined, whole), key


def test_rollback_under_fsdp_restores_the_saved_state(setup):
    for r in setup["ranks"]:
        rb = r["rollback"]
        assert rb["rollbacks"] == 1
        _equal(rb["saved"]["model"], rb["after"]["model"])
        for k in rb["saved"]["moments"]:
            _equal(rb["saved"]["moments"][k], rb["after"]["moments"][k])
        assert rb["after"]["epoch"] == 2  # the data position is kept


def test_tensor_parallel_checkpoints_stay_refused(setup):
    for r in setup["ranks"]:
        assert "tensor-parallel train state" in r["tp_refusal"]
