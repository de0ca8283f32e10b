"""The port's ``int8_matmul_tp`` against the unsharded int8 matmul, its
plain shard composition and the JAX package's ``int8_matmul_tp``.

One gloo world of 2 and one of 4 spawned ranks
(``tests/torch_tp_worker.py``, no JAX) run both splits on the same x, q
and scale, drawn with numpy from a seed; the JAX function runs here on
the forced 8-device CPU mesh (``{"model": 2}`` and ``{"model": 4}``).

Tolerances and why:

- column: bitwise the unsharded plain version's columns (a column's
  arithmetic does not see the others);
- row: at tp 2 bitwise ``int8_matmul_tp_reference`` and the JAX
  function (a 2-wide sum adds the same two partials in either order); at
  tp 4 within 4 float32 ulps of the largest output (``_sum_order_tol``:
  the reduction may add the four partials in another order, each
  addition rounding once); against the
  UNSHARDED kernel only within 5% of the output's scale (K 256 over 4
  ranks quantizes activations per local 64-wide tile, a regrouping — the
  JAX test's own bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker
from pytorch_distributed_training_tutorials_tpu.ops import quant as jq
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    Int8Linear,
    Int8Param,
    int8_matmul_reference,
    int8_matmul_tp,
    int8_matmul_tp_reference,
    quantize_int8,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    spawn_tp,
)

M, K, N = 16, 256, 512


def _draw(seed, shape):
    return np.random.Generator(np.random.PCG64(seed)).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def operands(tmp_path_factory):
    x = _draw(12, (M, K))
    w = quantize_int8(torch.tensor(_draw(13, (K, N))))
    workdir = tmp_path_factory.mktemp("tp_quant")
    torch.save({"x": torch.tensor(x), "qt": w.q.t().contiguous(),
                "scale": w.scale.reshape(1, -1).contiguous()}, workdir / "quant.pt")
    return x, w, str(workdir)


@pytest.fixture(scope="module")
def worlds(operands):
    """Each width's ranks' results (one spawned world per width)."""
    return {tp: spawn_tp(torch_tp_worker.quant_cases, tp, (operands[2],), backend="gloo",
                         device="cpu")
            for tp in (2, 4)}


def _sum_order_tol(ref) -> float:
    """4 float32 ulps at the output's largest magnitude: the rounding of a
    4-term float32 sum taken in another order."""
    return 4 * float(np.finfo(np.float32).eps) * float(np.abs(np.asarray(ref)).max())


def _w(w):
    return Int8Param(q=w.q, scale=w.scale.reshape(1, -1))


@pytest.mark.parametrize("tp", [2, 4])
def test_column_split_is_the_unsharded_columns(operands, worlds, tp):
    x, w, _ = operands
    whole = int8_matmul_reference(torch.tensor(x), _w(w))
    nl = N // tp
    for r, got in enumerate(worlds[tp]):
        assert torch.equal(got["column"], whole[:, r * nl:(r + 1) * nl]), r
    assert torch.equal(int8_matmul_tp_reference(torch.tensor(x), _w(w), tp, "column"), whole)


@pytest.mark.parametrize("tp", [2, 4])
def test_row_split_is_the_shard_composition(operands, worlds, tp):
    x, w, _ = operands
    ref = int8_matmul_tp_reference(torch.tensor(x), _w(w), tp, "row")
    for r, got in enumerate(worlds[tp]):
        assert torch.equal(got["row"], worlds[tp][0]["row"]), r  # every rank the same bytes
        if tp == 2:
            assert torch.equal(got["row"], ref)
        else:
            np.testing.assert_allclose(got["row"].numpy(), ref.numpy(), rtol=0,
                                       atol=_sum_order_tol(ref))
        # one all_reduce (row), no collective for the column split
        assert got["collectives"] == {"all_reduce": 1, "all_gather": 0}
        # the {"model": tp} mesh over the world serves as the group
        assert got["mesh_names"] == ("model",)
        assert torch.equal(got["mesh"][0], got["column"])
        assert torch.equal(got["mesh"][1], got["row"])
        assert got["launches"] == 0  # CPU tensors: the plain version, no kernel
    base = int8_matmul_reference(torch.tensor(x), _w(w))
    assert float((worlds[tp][0]["row"] - base).abs().max()) < 0.05 * float(base.abs().max())


@pytest.mark.parametrize("tp", [2, 4])
def test_row_and_column_match_jax_int8_matmul_tp(operands, worlds, tp):
    x, w, _ = operands
    jw = jq.quantize_int8(jnp.asarray(_draw(13, (K, N))))
    np.testing.assert_array_equal(np.asarray(jw.q), w.q.numpy())  # the same weights
    mesh = jax_mesh({"model": tp})
    jrow = np.asarray(jq.int8_matmul_tp(jnp.asarray(x), jw, mesh, kind="row"))
    jcol = np.asarray(jq.int8_matmul_tp(jnp.asarray(x), jw, mesh, kind="column"))
    nl = N // tp
    for r, got in enumerate(worlds[tp]):
        np.testing.assert_array_equal(got["column"].numpy(), jcol[:, r * nl:(r + 1) * nl])
        if tp == 2:
            np.testing.assert_array_equal(got["row"].numpy(), jrow)
        else:
            np.testing.assert_allclose(got["row"].numpy(), jrow, rtol=0,
                                       atol=_sum_order_tol(jrow))


def test_int8_matmul_tp_validates():
    """The JAX function's four refusals, with its messages. The widths'
    checks come before any collective, so a strategy whose width is set
    by hand stands in for an 8-rank group."""
    x = torch.tensor(_draw(1, (8, 64)))
    w = quantize_int8(torch.tensor(_draw(2, (64, 64))))
    with pytest.raises(ValueError, match="no 'model' axis"):
        int8_matmul_tp(x, w, LocalMesh(torch.device("cpu")), kind="column")
    eight = TensorParallel()
    eight.tp_size = 8
    with pytest.raises(ValueError, match="column split needs"):
        int8_matmul_tp(x, quantize_int8(torch.tensor(_draw(3, (64, 36)))), eight,
                       kind="column")
    with pytest.raises(ValueError, match="row split needs"):
        int8_matmul_tp(torch.tensor(_draw(4, (8, 36))),
                       quantize_int8(torch.tensor(_draw(5, (36, 64)))), eight, kind="row")
    with pytest.raises(ValueError, match="kind must be"):
        int8_matmul_tp(x, w, eight, kind="diag")


def test_one_rank_strategy_is_the_unsharded_call():
    """A strategy of one rank (no group) splits nothing: both kinds are
    the unsharded call, with no collective; a mesh whose model axis is 1
    is taken as one."""
    x = torch.tensor(_draw(6, (4, 128)))
    w = _w(quantize_int8(torch.tensor(_draw(7, (128, 96)))))
    one = TensorParallel(LocalMesh(torch.device("cpu"), ("model",)))
    assert one.tp_size == 1 and one.group is None
    whole = int8_matmul_reference(x, w)
    for kind in ("column", "row"):
        assert torch.equal(int8_matmul_tp(x, w, one, kind=kind), whole)
    assert one.collectives == {"all_reduce": 0, "all_gather": 0}


def test_int8_linear_shard_kind_needs_a_strategy():
    with pytest.raises(ValueError, match="shard_kind"):
        Int8Linear(64, 64, shard_kind="row")
    with pytest.raises(ValueError, match="shard_kind"):
        Int8Linear(64, 64, shard_kind="diag", strategy=TensorParallel())


def _stub(tp: int, rank: int) -> TensorParallel:
    """A strategy whose width and rank are set by hand, for what reads
    only them (shapes, rules, audit lines): no collective is issued."""
    strat = TensorParallel()
    strat.tp_size, strat.rank = tp, rank
    return strat


def test_slot_state_shards_on_the_kv_head_axis():
    """``SLOT_STATE_RULES``: K/V split on their head axis (the scales on
    their last), everything else whole; a head count the width does not
    divide stays whole, and the audit flags that KV leaf."""
    strat = _stub(2, 1)
    k = torch.arange(2 * 3 * 5 * 4 * 8, dtype=torch.float32).reshape(2, 3, 5, 4, 8)
    tree = {"k": k, "k_scale": k[..., 0], "index": torch.arange(3)}
    got = strat.shard_state(tree)
    assert torch.equal(got["k"], k[:, :, :, 2:]) and got["k"].is_contiguous()
    assert torch.equal(got["k_scale"], k[:, :, :, 2:, 0])
    assert got["index"] is tree["index"]
    assert strat.shard_shapes({n: t.shape for n, t in tree.items()}) == {
        n: tuple(t.shape) for n, t in got.items()}
    lines = strat.audit({"tok_emb.weight": torch.zeros(64, 32)},
                        {"k": (2, 3, 5, 3, 8), "v": (2, 3, 5, 4, 8)})
    assert lines[0] == "tok_emb.weight: (64, 32) -> None"
    assert "WARNING" in lines[1] and lines[1].startswith("k: (2, 3, 5, 3, 8) -> None")
    assert lines[2] == "v: (2, 3, 5, 4, 8) -> 3"


def test_model_axis_mesh_without_a_group():
    """``create_mesh({"model": 1})`` in one process is a mesh of one; a
    data x model mesh or a model axis wider than the world raise (a world
    mismatch: the data x model mesh itself is TP training's,
    ``tests/test_torch_tp_train_dp.py``)."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    mesh = create_mesh({"model": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("model",) and TensorParallel(mesh).tp_size == 1
    assert create_mesh({"data": 1, "model": -1}, device="cpu").mesh_dim_names == (
        "data", "model")
    with pytest.raises(ValueError, match="data axis of 2"):
        create_mesh({"data": 2, "model": 1}, device="cpu")
    with pytest.raises(ValueError, match="model axis of 2"):
        create_mesh({"model": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="stage"):
        create_mesh({"model": 1, "stage": 1}, device="cpu")
