"""The port's HF-layout Llama loader (``parallel/hf_llama.py``) against
``transformers.LlamaForCausalLM`` and the JAX package's
``parallel/hf_llama.py``.

Each test saves a toy ``LlamaForCausalLM`` (vocab 128, hidden 32, 2
layers, 4 heads, 2 KV heads) in the standard HF layout with
``save_pretrained`` (nothing downloads), as the JAX package's
``tests/test_hf_llama.py`` does. Tolerances and why:

- logits of the port's float model on the loaded weights against
  ``transformers``: ``rtol`` and ``atol`` 2e-4, the JAX test's (float32
  sums in other orders, float64 attention statistics in the port);
- the state dict: bitwise ``from_jax_params`` of the JAX
  ``load_hf_llama`` output (the same transposes and quantizer);
- int8 against float logits: mean |difference| under 0.15 of the float
  logits' std, the JAX test's gate; a load with ``o_proj`` left
  untransposed (square here) must fail it.
"""

import builtins
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import transformers

from pytorch_distributed_training_tutorials_tpu.parallel import hf_llama as jax_hf
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerLM,
    bind_params,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel import hf_llama

HF_CFG = dict(
    vocab_size=128,
    hidden_size=32,
    intermediate_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=64,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    tie_word_embeddings=False,
    attention_bias=False,
    mlp_bias=False,
)
TOL = 2e-4
GATE = 0.15


def _save_hf_llama(path, seed=0, max_shard_size=None, dtype=None, **cfg_over):
    cfg = transformers.LlamaConfig(**{**HF_CFG, **cfg_over})
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg).eval()
    if dtype is not None:
        model = model.to(dtype)
    kw = {} if max_shard_size is None else {"max_shard_size": max_shard_size}
    model.save_pretrained(path, safe_serialization=True, **kw)
    return model


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens.astype(np.int64))).logits.float().numpy()


def _port_logits(cfg, params, tokens):
    model = TransformerLM(cfg)
    bind_params(model, params)
    with torch.no_grad():
        return model(torch.from_numpy(tokens.astype(np.int64))).float().numpy()


def _tokens(seed, shape):
    return np.random.Generator(np.random.PCG64(seed)).integers(0, HF_CFG["vocab_size"], shape)


def test_load_hf_llama_matches_transformers_logits(tmp_path):
    """Full pipeline: config.json mapping, transposes, head splits, rope,
    RMSNorm eps — one wrong convention anywhere and the logits diverge."""
    hf_model = _save_hf_llama(tmp_path)
    cfg, params = hf_llama.load_hf_llama(tmp_path, device="cpu")
    assert cfg.n_kv_heads == 2 and cfg.norm_eps == 1e-5 and not cfg.quantized
    assert params["blocks.0.attn.k_proj.weight"].shape == (32, 16)  # (K, N): 2 KV heads
    tokens = _tokens(0, (2, 12))
    np.testing.assert_allclose(_port_logits(cfg, params, tokens), _hf_logits(hf_model, tokens),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["index", "bare_shards", "tied"])
def test_layouts_match_transformers(tmp_path, layout):
    """The sharded layout with its index (the reference's 33-shard case),
    the same shards without the index (each shard's header lists its
    tensors), and tied embeddings (no ``lm_head.weight``)."""
    if layout == "tied":
        hf_model = _save_hf_llama(tmp_path, tie_word_embeddings=True)
        assert "lm_head.weight" not in hf_llama.HFCheckpoint(tmp_path)
    else:
        hf_model = _save_hf_llama(tmp_path, max_shard_size="40KB")
        index = tmp_path / "model.safetensors.index.json"
        assert len(set(json.loads(index.read_text())["weight_map"].values())) >= 2
        if layout == "bare_shards":
            os.remove(index)
    cfg, params = hf_llama.load_hf_llama(tmp_path, device="cpu")
    tokens = _tokens(3, (2, 10))
    np.testing.assert_allclose(_port_logits(cfg, params, tokens), _hf_logits(hf_model, tokens),
                               rtol=TOL, atol=TOL)


def _jax_bridge(path, cfg, quantize):
    """The JAX package's load of ``path``, through the whole-tree bridge."""
    _, jparams = jax_hf.load_hf_llama(path, quantize=quantize, materialize=False)
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                           dataclasses.replace(cfg, quantized=quantize), device="cpu")


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_state_dict_bitwise_jax_loader(tmp_path, quantize):
    _save_hf_llama(tmp_path, max_shard_size="40KB")
    cfg, got = hf_llama.load_hf_llama(tmp_path, quantize=quantize, device="cpu")
    want = _jax_bridge(tmp_path, cfg, quantize)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_bf16_checkpoint(tmp_path):
    """A bfloat16 checkpoint: read by its bits, cast to float32 exactly —
    bitwise the JAX loader's (through ``ml_dtypes``), and the logits of
    the same weights in float32 in ``transformers``."""
    hf_model = _save_hf_llama(tmp_path, dtype=torch.bfloat16)
    ckpt = hf_llama.HFCheckpoint(tmp_path)
    assert ckpt.get("model.embed_tokens.weight").dtype == torch.bfloat16
    cfg, got = hf_llama.load_hf_llama(tmp_path, device="cpu")
    want = _jax_bridge(tmp_path, cfg, False)
    assert all(torch.equal(got[k], want[k]) for k in want)
    tokens = _tokens(4, (1, 9))
    np.testing.assert_allclose(_port_logits(cfg, got, tokens),
                               _hf_logits(hf_model.float(), tokens), rtol=TOL, atol=TOL)


def _gate(tmp_path, transpose_o=True):
    """mean |int8 - float| / std(float) of the logits of an int8 load
    (``o_proj`` untransposed when not ``transpose_o``: a planted fault)."""
    cfg, fparams = hf_llama.load_hf_llama(tmp_path, device="cpu")
    real = hf_llama._llama_layer_entries

    def untransposed_o(i, c):
        return [(p, n, (lambda w: w.reshape(c.n_heads, c.head_dim, c.d_model))
                 if p[-2] == "o_proj" else t) for p, n, t in real(i, c)]

    if not transpose_o:
        hf_llama._llama_layer_entries = untransposed_o
    try:
        _, qparams = hf_llama.load_hf_llama(tmp_path, quantize=True, device="cpu")
    finally:
        hf_llama._llama_layer_entries = real
    tokens = _tokens(5, (2, 16))
    ref = _port_logits(cfg, fparams, tokens)
    got = _port_logits(dataclasses.replace(cfg, quantized=True), qparams, tokens)
    return float(np.mean(np.abs(got - ref)) / np.std(ref))


def test_quantized_load_against_float_and_a_planted_fault(tmp_path):
    _save_hf_llama(tmp_path)
    sound = _gate(tmp_path)
    fault = _gate(tmp_path, transpose_o=False)
    assert sound < GATE, sound
    assert fault >= GATE, (sound, fault)


def test_config_from_hf_overrides(tmp_path):
    _save_hf_llama(tmp_path)
    cfg = hf_llama.config_from_hf(tmp_path, max_seq_len=16, quantized=True)
    assert cfg.max_seq_len == 16 and cfg.quantized
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.kv_heads, cfg.ff_dim) == (32, 2, 4, 2, 64)


@pytest.mark.parametrize("field,value,match", [
    ("rope_scaling", {"type": "linear", "factor": 2.0}, "rope_scaling"),
    ("hidden_act", "gelu", "hidden_act"),
    ("model_type", "mistral", "model_type"),
    ("sliding_window", 4096, "sliding_window"),
    ("head_dim", 16, "head_dim"),
])
def test_config_from_hf_refusals(tmp_path, field, value, match):
    """The JAX function's two refusals and the port's three more: each of
    these loads in the JAX package and then serves wrong."""
    _save_hf_llama(tmp_path)
    cfg_path = tmp_path / "config.json"
    hf = json.loads(cfg_path.read_text())
    assert hf["model_type"] == "llama" and hf.get("head_dim") in (None, 8)
    hf_llama.config_from_hf(tmp_path)  # the saved config itself loads
    hf[field] = value
    cfg_path.write_text(json.dumps(hf))
    with pytest.raises(ValueError, match=match):
        hf_llama.config_from_hf(tmp_path)


def test_strict_refuses_unconsumed_tensors(tmp_path):
    """``attention_bias=True`` checkpoints carry ``*.bias`` tensors the
    model has no slot for: refused before a tensor is read; an explicit
    ``strict=False`` drops them."""
    _save_hf_llama(tmp_path, attention_bias=True)
    with pytest.raises(ValueError, match="not consumed"):
        hf_llama.load_hf_llama(tmp_path, device="cpu")
    _, params = hf_llama.load_hf_llama(tmp_path, strict=False, device="cpu")
    assert "blocks.0.attn.q_proj.weight" in params


def test_streaming_reads_one_tensor_at_a_time(tmp_path, monkeypatch):
    """``SafetensorsFile.get`` reads only the requested tensor's bytes,
    observed on the real file object's reads."""
    _save_hf_llama(tmp_path)
    st_path = os.path.join(tmp_path, "model.safetensors")
    f = hf_llama.SafetensorsFile(st_path)
    size = os.path.getsize(st_path)
    reads: list[int] = []
    real_open = builtins.open

    class Spy:
        def __init__(self, fh):
            self._fh = fh

        def readinto(self, b):
            n = self._fh.readinto(b)
            reads.append(n)
            return n

        def read(self, n=-1):
            out = self._fh.read(n)
            reads.append(len(out))
            return out

        def __getattr__(self, name):
            return getattr(self._fh, name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return self._fh.__exit__(*exc)

    monkeypatch.setattr(builtins, "open", lambda p, *a, **kw: (
        Spy(real_open(p, *a, **kw)) if os.fspath(p) == st_path else real_open(p, *a, **kw)))
    name = "model.embed_tokens.weight"
    arr = f.get(name)
    _, shape, (start, end) = f.tensors[name]
    assert arr.shape == shape
    assert reads and sum(reads) == end - start < size


def test_port_writer_layout_loads(tmp_path):
    """A checkpoint written with the port's own ``save_safetensors`` (as
    ``chip_smoke.py`` writes one where ``transformers`` is absent) in
    shards with an index loads to the bits of the ``save_pretrained``
    one."""
    ref_dir, own_dir = tmp_path / "ref", tmp_path / "own"
    _save_hf_llama(ref_dir)
    ckpt = hf_llama.HFCheckpoint(ref_dir)
    names = sorted(ckpt.keys())
    own_dir.mkdir()
    (own_dir / "config.json").write_text((ref_dir / "config.json").read_text())
    weight_map = {}
    for j, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        fname = f"model-{j + 1:05d}-of-00002.safetensors"
        hf_llama.save_safetensors(own_dir / fname, {n: ckpt.get(n) for n in part})
        weight_map.update(dict.fromkeys(part, fname))
    (own_dir / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    _, want = hf_llama.load_hf_llama(ref_dir, device="cpu")
    _, got = hf_llama.load_hf_llama(own_dir, device="cpu")
    assert all(torch.equal(got[k], want[k]) for k in want)
