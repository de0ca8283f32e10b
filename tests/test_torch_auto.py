"""The port's checkpoints and placement (``parallel/auto.py``) and its
streaming int8 LM loader (``models/transformer.py:load_quantized_lm``)
against the JAX package's ``parallel/auto.py`` and ``load_quantized_lm``.

The JAX package writes orbax checkpoints and the port its own
(safetensors) ones; each package saves the same numpy tree (drawn from a
seed) and loads it, and the outputs are compared:

- round trips, ``restore_leaf``, ``load_sharded``, ``load_quantized``:
  bitwise (the bytes come back; the quantizer is bitwise the JAX one);
- ``load_quantized_lm``: bitwise ``from_jax_params`` of the JAX
  ``load_quantized_lm`` output, unrolled and stacked;
- a toy int8 model bound with the port's load: logits within ``atol
  1e-4`` of the JAX model's on its own load, the tolerance of
  ``tests/test_torch_transformer.py`` for the int8 pair (float64
  attention statistics in the port; an ulp of ``cos``/``sin`` can move
  one int8 activation code);
- host memory: ``tests/test_torch_auto_rss.py``.
"""

import builtins
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel import auto as jax_auto
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    INT8_TP_RULES,
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    load_quantized_lm,
    stack_quantized_lm_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import Int8Param
from pytorch_distributed_training_tutorials_tpu_torch.parallel import auto
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    shard_params,
    split_dim,
)
from helpers import requires_pallas_interpret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
ATOL = 1e-4


def _tree(seed=0):
    """A small mixed tree: f32 kernels and biases, a bf16 and an int8 leaf."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return {
        "Dense_0": {"kernel": rng.standard_normal((16, 64)).astype(np.float32),
                    "bias": rng.standard_normal((64,)).astype(np.float32)},
        "Dense_1": {"kernel": rng.standard_normal((64, 8)).astype(np.float32),
                    "bias": np.zeros((8,), np.float32)},
        "half": torch.tensor(rng.standard_normal((6, 4)), dtype=torch.bfloat16),
        "codes": torch.tensor(rng.integers(-127, 128, (5, 3)), dtype=torch.int8),
    }


def _as_t(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            w = _as_t(want[k])
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_round_trip_overwrite_and_safetensors_interop(tmp_path):
    path = tmp_path / "ckpt.safetensors"
    auto.save_checkpoint(path, _tree(1))
    auto.save_checkpoint(path, _tree(0))  # an existing checkpoint is overwritten
    assert sorted(os.listdir(tmp_path)) == ["ckpt.safetensors"]  # no temporary left
    back = auto.restore_checkpoint(path)
    _assert_tree_equal(back, _tree(0))
    assert back["Dense_0"]["kernel"].device.type == "cpu"
    # the file is a standard safetensors file: the safetensors package reads it
    from safetensors.torch import load_file

    flat = load_file(str(path))
    assert set(flat) == {"Dense_0/kernel", "Dense_0/bias", "Dense_1/kernel", "Dense_1/bias",
                         "half", "codes"}
    assert torch.equal(flat["half"], _tree(0)["half"])
    meta = dict(auto.checkpoint_leaf_metadata(path))
    assert meta[("Dense_0", "kernel")] == auto.LeafMeta((16, 64), torch.float32)
    assert meta[("codes",)].dtype == torch.int8 and meta[("half",)].ndim == 2


def test_restore_with_like_tree(tmp_path):
    path = tmp_path / "ckpt"
    auto.save_checkpoint(path, _tree())
    like = {"Dense_1": {"kernel": torch.zeros(64, 8, dtype=torch.float64),
                        "bias": np.zeros(8, np.float16)}}
    back = auto.restore_checkpoint(path, like)
    assert set(back) == {"Dense_1"}
    assert back["Dense_1"]["kernel"].dtype == torch.float64
    assert back["Dense_1"]["bias"].dtype == torch.float16
    np.testing.assert_array_equal(back["Dense_1"]["kernel"].numpy(),
                                  _tree()["Dense_1"]["kernel"].astype(np.float64))


def _spy_reads(monkeypatch, path):
    """Sizes of every read of ``path``'s file objects (``read`` and
    ``readinto``), observed on the real file objects."""
    reads: list[int] = []
    real_open = builtins.open

    class Spy:
        def __init__(self, fh):
            self._fh = fh

        def read(self, n=-1):
            out = self._fh.read(n)
            reads.append(len(out))
            return out

        def readinto(self, b):
            n = self._fh.readinto(b)
            reads.append(n)
            return n

        def __getattr__(self, name):
            return getattr(self._fh, name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return self._fh.__exit__(*exc)

    def spying_open(p, *a, **kw):
        fh = real_open(p, *a, **kw)
        return Spy(fh) if os.fspath(p) == os.fspath(path) else fh

    monkeypatch.setattr(builtins, "open", spying_open)
    return reads


def test_restore_leaf_reads_only_its_bytes(tmp_path, monkeypatch):
    path = tmp_path / "ckpt"
    auto.save_checkpoint(path, _tree())
    f = auto.SafetensorsFile(path)  # header parsed before the spy
    size = os.path.getsize(path)
    reads = _spy_reads(monkeypatch, path)
    leaf = auto.restore_leaf(path, ("Dense_0", "kernel"), file=f)
    assert reads and sum(reads) == 16 * 64 * 4 < size
    assert torch.equal(leaf, torch.from_numpy(_tree()["Dense_0"]["kernel"]))
    # a dim-0 block reads its rows' bytes alone
    reads.clear()
    blk = auto.restore_leaf(path, ("Dense_0", "kernel"), auto.Shard(0, 1, 4), file=f)
    assert sum(reads) == 4 * 64 * 4
    assert torch.equal(blk, torch.from_numpy(_tree()["Dense_0"]["kernel"][4:8]))


def test_load_sharded_blocks_and_values(tmp_path):
    path = tmp_path / "ckpt"
    tree = _tree()
    auto.save_checkpoint(path, tree)

    def rule(kp, meta):
        if meta.ndim == 2 and meta.shape[0] % 8 == 0:
            return auto.Shard(0, 1, 8)
        if kp[-1] == "bias" and meta.shape[0] % 8 == 0:
            return auto.Shard(-1, 3, 8)
        return "cpu"

    placed = auto.load_sharded(path, rule)
    k0 = placed["Dense_0"]["kernel"]
    assert k0.shape == (2, 64)  # 16 rows / 8, block 1
    np.testing.assert_array_equal(k0.numpy(), tree["Dense_0"]["kernel"][2:4])
    assert placed["Dense_1"]["kernel"].shape == (8, 8)
    np.testing.assert_array_equal(placed["Dense_0"]["bias"].numpy(),
                                  tree["Dense_0"]["bias"][24:32])
    assert placed["codes"].shape == (5, 3)  # 5 rows do not split: whole
    with pytest.raises(ValueError, match="does not split"):
        auto.load_sharded(path, lambda kp, meta: auto.Shard(0, 0, 3))


def test_tp_rules_placement_is_shard_params(tmp_path):
    """A checkpoint of the port's int8 state dict, loaded per rank with a
    placement from the int8 tensor-parallel rules: each rank's dict is
    ``shard_params``'s."""
    cfg = TransformerConfig(**TOY, quantized=True)
    whole = from_jax_params(_lm_tree(jt.TransformerConfig(**TOY)), cfg, device="cpu")
    path = tmp_path / "int8"
    auto.save_checkpoint(path, whole)
    units = {"head": cfg.head_dim}
    for rank in range(2):
        def placement(kp, meta):
            dim = split_dim(".".join(kp), meta.shape, INT8_TP_RULES, 2, units)
            return "cpu" if dim is None else auto.Shard(dim, rank, 2)

        got = auto.load_sharded(path, placement)
        want = shard_params(whole, rank, 2, head_dim=cfg.head_dim, rules=INT8_TP_RULES)
        _assert_tree_equal(got, want)
    assert got["blocks.0.attn.q_proj.qt"].shape == (32, 64)


def test_load_quantized_bitwise_jax(tmp_path):
    rng = np.random.Generator(np.random.PCG64(1))
    tree = {f"layer_{i}": {"kernel": rng.standard_normal((64, 128)).astype(np.float32),
                           "bias": rng.standard_normal((128,)).astype(np.float32)}
            for i in range(3)}
    jax_auto.save_checkpoint(tmp_path / "orbax", tree)
    auto.save_checkpoint(tmp_path / "port", tree)
    want = jax_auto.load_quantized(tmp_path / "orbax")
    got = auto.load_quantized(tmp_path / "port", device="cpu")
    for i in range(3):
        g, w = got[f"layer_{i}"]["kernel"], want[f"layer_{i}"]["kernel"]
        assert isinstance(g, Int8Param) and g.q.dtype == torch.int8
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        np.testing.assert_array_equal(got[f"layer_{i}"]["bias"].numpy(),
                                      tree[f"layer_{i}"]["bias"])
    # placed as column blocks: quantized whole, then cut (scales per column)
    cols = auto.load_quantized(tmp_path / "port",
                               placement=lambda kp, m: auto.Shard(-1, 1, 4) if m.ndim == 2
                               else "cpu")
    k = cols["layer_0"]["kernel"]
    w = got["layer_0"]["kernel"]
    assert k.q.shape == (64, 32) and k.scale.shape == (1, 32)
    assert torch.equal(k.q, w.q[:, 32:64]) and torch.equal(k.scale, w.scale[:, 32:64])
    # row blocks keep the whole column's scales
    rows = auto.load_quantized(tmp_path / "port",
                               placement=lambda kp, m: auto.Shard(0, 1, 2) if m.ndim == 2
                               else "cpu")
    k = rows["layer_0"]["kernel"]
    assert torch.equal(k.q, w.q[32:]) and torch.equal(k.scale, w.scale)


def test_audit_placement_lines(tmp_path):
    path = tmp_path / "ckpt"
    auto.save_checkpoint(path, {k: v for k, v in _tree().items() if k.startswith("Dense")})
    loaded = auto.load_quantized(path, device="cpu")
    lines = auto.audit_placement(loaded)
    assert lines == [
        "Dense_0/kernel/q: (16, 64) int8 on cpu",
        "Dense_0/kernel/scale: (1, 64) float32 on cpu",
        "Dense_0/bias: (64,) float32 on cpu",
        "Dense_1/kernel/q: (64, 8) int8 on cpu",
        "Dense_1/kernel/scale: (1, 8) float32 on cpu",
        "Dense_1/bias: (8,) float32 on cpu",
    ]
    assert auto.audit_placement({"a": np.zeros((2,), np.float32)}) == [
        "a: (2,) float32 on host"]
    # a flat state dict keeps its names
    assert auto.audit_placement({"blocks.0.attn.q_proj.qt": torch.zeros(2, 3, dtype=torch.int8)}
                                ) == ["blocks.0.attn.q_proj.qt: (2, 3) int8 on cpu"]


def _lm_tree(jcfg, seed=0):
    """Float JAX params for ``jcfg`` drawn with numpy (kernels and the
    embedding N(0, 0.15^2), norm scales 1 + N(0, 0.1^2))."""
    shapes = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return (1.0 + 0.1 * x if str(path[-1].key) == "scale" else 0.15 * x).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


@pytest.fixture(scope="module")
def lm_loads(tmp_path_factory):
    """The toy LM's float tree saved by both packages, unrolled and
    stacked, and both packages' ``load_quantized_lm`` of each."""
    d = tmp_path_factory.mktemp("lm")
    jcfg = jt.TransformerConfig(**TOY)
    tree = _lm_tree(jcfg)
    out = {"tree": tree}
    for layout, t in (("unrolled", tree),
                      ("stacked", jax.tree_util.tree_map(
                          np.asarray, jt.stack_quantized_lm_params(tree)))):
        jax_auto.save_checkpoint(d / f"orbax_{layout}", t)
        auto.save_checkpoint(d / f"port_{layout}", t)
        jq = jax.tree_util.tree_map(
            np.asarray, jt.load_quantized_lm(str(d / f"orbax_{layout}"), materialize=False))
        out[layout] = (load_quantized_lm(d / f"port_{layout}", device="cpu"), jq)
    return out


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_load_quantized_lm_bitwise_jax(lm_loads, layout):
    got, jq = lm_loads[layout]
    cfg = TransformerConfig(**TOY, quantized=True)
    want = from_jax_params(jq, cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert got[k].is_contiguous()
    # and the whole-tree bridge on the float tree gives the same bits
    whole = from_jax_params(lm_loads["tree"], cfg, device="cpu")
    assert all(torch.equal(got[k], whole[k]) for k in whole)


def test_stack_quantized_lm_params_matches_jax(lm_loads):
    tree = lm_loads["tree"]
    got = stack_quantized_lm_params({k: {kk: v for kk, v in sub.items()}
                                     for k, sub in tree.items()})
    want = jax.tree_util.tree_map(np.asarray, jt.stack_quantized_lm_params(tree))

    def walk(a, b):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k])

    walk(got, want)
    with pytest.raises(ValueError, match="no block_"):
        stack_quantized_lm_params(got)


@requires_pallas_interpret
def test_loaded_toy_model_logits_match_jax(lm_loads):
    got, jq = lm_loads["unrolled"]
    cfg = TransformerConfig(**TOY, quantized=True)
    model = TransformerLM(cfg)
    bind_params(model, got)
    tokens = np.random.Generator(np.random.PCG64(5)).integers(0, TOY["vocab_size"], (2, 12))
    jm = jt.TransformerLM(dataclasses.replace(jt.TransformerConfig(**TOY), quantized=True))
    jl = np.asarray(jax.jit(jm.apply)({"params": jq}, jnp.asarray(tokens, jnp.int32)))
    tl = model(torch.tensor(tokens))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)


def test_new_modules_import_no_jax_or_hf_packages():
    code = (
        "import sys\n"
        "import pytorch_distributed_training_tutorials_tpu_torch.parallel.auto\n"
        "import pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama\n"
        "import pytorch_distributed_training_tutorials_tpu_torch.models\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'orbax', 'ml_dtypes', 'safetensors', 'transformers', "
        "'pytorch_distributed_training_tutorials_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
