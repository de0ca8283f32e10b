"""The port's ``fused_cross_entropy_tp`` against the JAX package's, in
gloo worlds of 2 (``{"model": 2}``) and 4 (``{"data": 2, "model": 2}``).

The JAX op runs here on meshes of the forced 8-device CPU mesh (its
kernels in interpret mode; ``tests/test_fused_loss.py:125``'s layout:
rows over ``data``, the vocabulary over ``model``); the port's op runs on
spawned ranks (``tests/torch_tp_train_worker.py``, the plain versions of
kernels 6-8), each with its vocab shard of W and its data coordinate's
rows, and sums dW over the data axis once, as the ``Trainer``'s gradient
average does — a dW the op itself summed over ``data`` would come out
doubled. Tolerances are the JAX test's (``tests/test_fused_loss.py:133-
154``): losses 2e-5 absolute and relative, dh and dW 5e-6 absolute and
5e-5 relative. The refusals and the out-of-shard targets (negative on the
ranks past a target's owner, ``>= V_local`` before it) are pinned here
too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_tp_train_worker
from pytorch_distributed_training_tutorials_tpu.ops.fused_loss import (
    fused_cross_entropy_tp as j_fused_cross_entropy_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as tfl
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    spawn_tp,
)
from helpers import requires_pallas_interpret

pytestmark = requires_pallas_interpret

N, D, V = 48, 32, 48  # V_local 24 on a model axis of 2
WORLDS = {"model2": {"model": 2}, "data2_model2": {"data": 2, "model": 2}}
LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-6, rtol=5e-5)


def _operands():
    rng = np.random.Generator(np.random.PCG64(9))
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    y = rng.integers(0, V, (N,))
    return h, w, y


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    workdir = tmp_path_factory.mktemp("tp_fused_loss")
    h, w, y = _operands()
    torch.save({"h": torch.tensor(h), "w": torch.tensor(w), "y": torch.tensor(y)},
               workdir / "fce.pt")
    out = {}
    for name, axes in WORLDS.items():
        world = int(np.prod(list(axes.values())))
        ranks = spawn_tp(torch_tp_train_worker.fused_ce_case, world, (str(workdir), axes),
                         backend="gloo", device="cpu")
        mesh = Mesh(np.array(devices[:world]).reshape(tuple(axes.values())), tuple(axes))

        def op(hh, ww, mesh=mesh):
            return j_fused_cross_entropy_tp(hh, ww, jnp.asarray(y), mesh, block_n=16,
                                            block_v=8)

        loss = op(jnp.asarray(h), jnp.asarray(w))
        dh, dw = jax.grad(lambda hh, ww: op(hh, ww).mean(), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))
        out[name] = {"ranks": ranks, "loss": np.asarray(loss), "dh": np.asarray(dh),
                     "dw": np.asarray(dw)}
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_tp_fused_loss_matches_jax(setup, world):
    run = setup[world]
    vl = V // WORLDS[world]["model"]
    by_coord = {}
    for r in run["ranks"]:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["loss"].numpy(), run["loss"][lo:hi], **LOSS_TOL)
        np.testing.assert_allclose(r["dh"].numpy(), run["dh"][lo:hi], **GRAD_TOL)
        cols = slice(r["rank"] * vl, (r["rank"] + 1) * vl)
        np.testing.assert_allclose(r["dw"].numpy(), run["dw"][:, cols], **GRAD_TOL)
        # one MAX and one stacked SUM forward, one dh SUM backward
        assert r["collectives"] == {"all_reduce": 0, "all_gather": 0, "lse_max": 1,
                                    "lse_sum": 1, "dh": 1}
        by_coord.setdefault(r["data_rank"], []).append(r)
    for coord in by_coord.values():  # a data coordinate's model ranks: the same bytes
        assert all(torch.equal(c["loss"], coord[0]["loss"]) for c in coord)
        assert all(torch.equal(c["dh"], coord[0]["dh"]) for c in coord)


def test_tp_fused_loss_refusals(setup):
    """The JAX op's ValueErrors (``ops/fused_loss.py:513-527``) and the
    port's shard-width check, raised on ranks of a real group before any
    collective; a mesh without a model axis."""
    for r in setup["model2"]["ranks"]:
        msgs = r["errors"]
        assert len(msgs) == 3
        assert "not divisible" in msgs[0]
        assert "vocab shard" in msgs[1]
        assert "mismatch" in msgs[2]
    h, w, y = (torch.tensor(a) for a in _operands())
    with pytest.raises(ValueError, match="no 'model' axis"):
        tfl.fused_cross_entropy_tp(h, w, y, create_mesh({"data": 1}, device="cpu"),
                                   vocab_size=V)


@pytest.mark.parametrize("shifted", [-5, -1, 24, 30])
def test_out_of_shard_targets_contribute_nothing_in_the_plain_versions(shifted):
    """A shifted target outside ``[0, V_local)`` — negative on the ranks past
    its owner, ``>= V_local`` on those before it — hits no column: its
    target logit is exactly 0, and dh and dW are bitwise those of a target
    no column can hold (-1), on every block size."""
    h, w, _ = (torch.tensor(a) for a in _operands())
    w = w[:, :24].contiguous()
    y = torch.full((N,), shifted)
    none = torch.full((N,), -1)
    for bn, bv in ((16, 8), (512, 512)):
        lse, tgt = tfl.fused_ce_fwd_reference(h, w, y, bn, bv)
        lse0, _ = tfl.fused_ce_fwd_reference(h, w, none, bn, bv)
        assert torch.equal(tgt, torch.zeros_like(tgt)) and torch.equal(lse, lse0)
        g = torch.full((N,), 1.0 / N)
        assert torch.equal(tfl.fused_ce_dh_reference(h, w, y, lse, g, bn, bv),
                           tfl.fused_ce_dh_reference(h, w, none, lse, g, bn, bv))
        assert torch.equal(tfl.fused_ce_dw_reference(h, w, y, lse, g, bn, bv),
                           tfl.fused_ce_dw_reference(h, w, none, lse, g, bn, bv))
