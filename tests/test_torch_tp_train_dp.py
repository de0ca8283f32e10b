"""Data x tensor parallel training in the PyTorch port, in a gloo world
of 4 (``{"data": 2, "model": 2}``, the model axis inner), against the JAX
package's single-device train step at the same global batch.

The toy LM and tolerances of ``tests/test_torch_tp_train.py``, at a
global batch of 4 rows: each data coordinate trains on its 2 rows, and
its two model ranks on the same ones. The data axis averages the
gradients (one bucketed ``all_reduce`` a step, counted
``data_all_reduce``); the ranks' losses are the global mean, the same
bytes everywhere. The guard: a chaos NaN gradient at the last step under
``skip_nonfinite`` makes all four ranks skip it together, and the run
ends bitwise where a clean run one step shorter ends (every step takes
the same batch). The three loaders hand every model rank of a data
coordinate the same rows and the coordinates disjoint ones.
"""

import numpy as np
import pytest
import torch

import torch_tp_train_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    spawn_tp,
)
from helpers import requires_pallas_interpret
from test_torch_tp_train import (
    LOSSES,
    REPLICATED,
    SPEC,
    STEPS,
    assert_trained_like_jax,
    jax_train,
    per_step,
)
from test_torch_train import jax_float_tree, to_np

pytestmark = requires_pallas_interpret

BATCH = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_train_dp")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    rng = np.random.Generator(np.random.PCG64(4))
    toks = rng.integers(0, SPEC["vocab_size"], (BATCH, SPEC["max_seq_len"] + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    torch.save({"spec": SPEC, "params": from_jax_params(to_np(tree), cfg, device="cpu"),
                "x": torch.tensor(x), "y": torch.tensor(y)}, workdir / "train.pt")
    ranks = spawn_tp(torch_tp_train_worker.train_dp_case, 4, (str(workdir), STEPS),
                     backend="gloo", device="cpu")
    jax_runs = {loss: jax_train(jcfg, tree, x, y, loss, STEPS) for loss in LOSSES}
    return {"ranks": ranks, "cfg": cfg, "jax": jax_runs}


def test_data_by_model_mesh_and_strategy(setup):
    for r in setup["ranks"]:
        assert r["num_devices"] == 2
        assert r["mesh_shape"] == {"data": 2, "model": 2}
    assert [(r["data_rank"], r["rank"]) for r in setup["ranks"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("loss", LOSSES)
def test_trainer_steps_match_jax_single_device(setup, loss):
    ranks = setup["ranks"]
    assert_trained_like_jax(ranks, f"train_{loss}", setup["jax"][loss], setup["cfg"], loss,
                            STEPS)
    # the data axis: one bucket of every gradient and the loss a step
    want = {**per_step(loss, SPEC["n_layers"]), "data_all_reduce": 1}
    for r in ranks:
        assert r[f"train_{loss}"]["collectives"] == {k: v * STEPS for k, v in want.items()}
    # the data coordinates' shards of one model rank agree bitwise too
    for a, b in ((0, 2), (1, 3)):
        pa, pb = ranks[a][f"train_{loss}"]["params"], ranks[b][f"train_{loss}"]["params"]
        assert all(torch.equal(pa[n], pb[n]) for n in pa)


def test_chaos_nan_gradient_skips_every_rank_together(setup):
    for r in setup["ranks"]:
        chaos, clean = r["chaos"], r["clean_shorter"]
        assert chaos["skipped"] == 1 and clean["skipped"] == 0
        assert chaos["step"] == clean["step"] == STEPS - 1
        assert all(torch.equal(chaos["params"][n], clean["params"][n])
                   for n in chaos["params"]), r["rank"]
        # a flag MIN over the model group each step of the guarded runs
        assert chaos["collectives"]["flag_min"] == STEPS
        for name in REPLICATED:
            assert torch.equal(chaos["params"][name],
                               setup["ranks"][0]["chaos"]["params"][name])


def test_loaders_give_a_data_coordinates_model_ranks_the_same_rows(setup):
    ranks = setup["ranks"]
    for kind in ("sharded", "resident", "streaming"):
        rows = [r["loaders"][kind] for r in ranks]
        assert rows[0] == rows[1] and rows[2] == rows[3], kind
        assert not set(rows[0]) & set(rows[2]), kind
        assert sorted(rows[0] + rows[2]) == list(range(32)), kind
