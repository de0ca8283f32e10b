"""Published-checkpoint ingestion: HF-layout (safetensors) Llama weights.

Port of the JAX package's ``parallel/hf_llama.py``. A directory in the
Hugging Face layout — ``config.json`` + ``model.safetensors`` (or
``model.safetensors.index.json`` plus shards, or bare shards) — loads
into the state dict of the port's
:class:`..models.transformer.TransformerLM`, **streaming one tensor at a
time** and placing each entry on the device as soon as it is made, so
neither the host nor the card ever holds the whole float checkpoint;
``quantize=True`` quantizes each matmul weight to int8 as it is read
(the ``load_in_8bit=True`` twin). Entirely offline.

The safetensors container (8-byte little-endian header length, a JSON
header mapping tensor name -> dtype / shape / byte offsets, then raw
little-endian data) is parsed and written here by hand
(:class:`SafetensorsFile`, :func:`save_safetensors`): a tensor is one
``seek`` + ``readinto`` of its own bytes, with no package beyond torch.
bfloat16 tensors are read as bytes and viewed as ``torch.bfloat16``.
The port's own checkpoints (:mod:`.auto`) use the same container.

Weight layouts (torch ``nn.Linear`` stores ``(out, in)``; the flax
kernels of the JAX package's tree are ``(in, out)``), each tensor taken
to the flax layout and then through the one per-leaf weight bridge
(:func:`..models.convert.jax_leaf_to_port`), so a load gives the bits of
``from_jax_params`` on the flax tree:

- ``model.embed_tokens.weight`` (V, d)          -> ``tok_emb/embedding``
- ``...self_attn.{q,k,v}_proj.weight`` (H*D, d) -> ``block_i/attn/{q,k,v}_proj/kernel``
  (d, H, D): transpose, then split heads
- ``...self_attn.o_proj.weight`` (d, H*D)       -> ``block_i/attn/o_proj/kernel``
  (H, D, d): transpose, then split heads
- ``...mlp.{gate,up}_proj.weight`` (ff, d)      -> (d, ff): transpose
- ``...mlp.down_proj.weight`` (d, ff)           -> (ff, d): transpose
- ``input_layernorm`` / ``post_attention_layernorm`` / ``model.norm``
  -> ``attn_norm`` / ``mlp_norm`` / ``final_norm`` scales
- ``lm_head.weight`` (V, d) -> ``lm_head/kernel`` (d, V); absent when
  ``tie_word_embeddings`` — then the embedding matrix is reused.

The rotary convention matches by construction: HF checkpoints are
permuted for ``rotate_half``, which is :func:`..models.transformer.apply_rope`'s
``[:half] / [half:]`` split. ``tests/test_torch_hf_llama.py`` holds the
logits against ``transformers.LlamaForCausalLM``.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device

# safetensors dtype tag <-> torch dtype
_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TAGS = {v: k for k, v in _DTYPES.items()}


def _torch_dtype(tag: str) -> torch.dtype:
    try:
        return _DTYPES[tag]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {tag!r}") from None


def _readinto(f, view: memoryview) -> None:
    """Fill ``view`` from ``f``'s position, or raise."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"{f.name}: file ends {len(view) - got} bytes early")
        got += n


class SafetensorsFile:
    """Lazy per-tensor reader for one ``.safetensors`` file.

    ``get(name)`` seeks to that tensor's byte range and reads it alone
    into a new host tensor — the file is never mapped or read whole, so
    host memory is bounded by the largest single tensor whatever the
    file's size. ``rows=(lo, hi)`` reads only those rows of dimension 0.
    The tensor's memory is an anonymous mapping of its own, returned to
    the system when the tensor is freed (a ``malloc`` buffer of a few MB
    can stay in the C heap after it is freed, and a loop over hundreds of
    leaves then grows the process by many of them).
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(header_len))
        self._data_start = 8 + header_len
        header.pop("__metadata__", None)
        self.tensors = {
            name: (str(info["dtype"]), tuple(info["shape"]), tuple(info["data_offsets"]))
            for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0])
        }

    def keys(self):
        return self.tensors.keys()

    def get(self, name: str, rows: tuple[int, int] | None = None) -> torch.Tensor:
        tag, shape, (start, end) = self.tensors[name]
        dtype = _torch_dtype(tag)
        if rows is not None:
            row_bytes = (end - start) // shape[0] if shape[0] else 0
            start, end = start + rows[0] * row_bytes, start + rows[1] * row_bytes
            shape = (rows[1] - rows[0], *shape[1:])
        n = end - start
        if not n:
            return torch.empty(shape, dtype=dtype)
        buf = mmap.mmap(-1, n)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + start)
            _readinto(f, memoryview(buf))
        return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


def _as_tensor(x) -> torch.Tensor:
    """A tensor, a numpy array or a number as a tensor, without a copy
    where one is not needed."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # torch tensors are writable: hand it a copy
        a = a.copy()
    return torch.from_numpy(a)


def save_safetensors(path: str | os.PathLike, tensors: Mapping) -> None:
    """Write ``tensors`` (name -> tensor or array, on any device) as one
    safetensors file in their order: the header first, then each
    tensor's bytes, copied to the host one tensor at a time."""
    header, offset = {}, 0
    for name, x in tensors.items():
        t = _as_tensor(x)
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for x in tensors.values():
            t = _as_tensor(x).contiguous().to("cpu").reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))


class HFCheckpoint:
    """A HF-layout checkpoint directory: tensor name -> file resolution.

    Handles the single-file layout (``model.safetensors``), the sharded
    layout (``model.safetensors.index.json`` with a ``weight_map``), and a
    bare set of ``*.safetensors`` shards (each shard's own header lists
    its tensors — the index file is an optimization, not a requirement).
    """

    def __init__(self, path: str | os.PathLike):
        self.dir = os.fspath(path)
        index = os.path.join(self.dir, "model.safetensors.index.json")
        self._files: dict[str, SafetensorsFile] = {}
        self._where: dict[str, str] = {}
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self._where[name] = os.path.join(self.dir, fname)
        else:
            shards = sorted(fn for fn in os.listdir(self.dir) if fn.endswith(".safetensors"))
            if not shards:
                raise FileNotFoundError(f"no .safetensors files under {self.dir}")
            for fn in shards:
                full = os.path.join(self.dir, fn)
                for name in SafetensorsFile(full).keys():
                    self._where[name] = full

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def keys(self):
        return self._where.keys()

    def get(self, name: str) -> torch.Tensor:
        path = self._where[name]
        f = self._files.get(path)
        if f is None:
            f = self._files[path] = SafetensorsFile(path)
        return f.get(name)


def config_from_hf(path: str | os.PathLike, **overrides):
    """Build a :class:`..models.transformer.TransformerConfig` from a
    checkpoint's ``config.json``.

    Maps the HF Llama field names (hidden_size, num_hidden_layers,
    num_attention_heads, num_key_value_heads, intermediate_size,
    max_position_embeddings, rope_theta, rms_norm_eps) onto the port's
    config. ``overrides`` win — e.g. ``max_seq_len=2080`` to serve with a
    smaller cache than the model's trained maximum, or ``quantized=True``.

    Refuses, as the JAX function does, an activation other than SiLU and
    any ``rope_scaling``; and, where the JAX function loads a checkpoint
    that then serves wrong, a ``model_type`` other than ``llama``, a
    ``sliding_window`` (the port's attention is full causal) and a
    ``head_dim`` other than ``hidden_size / num_attention_heads`` (the
    port's head width).
    """
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    with open(os.path.join(os.fspath(path), "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type") != "llama":
        raise ValueError(
            f"unsupported model_type {hf.get('model_type')!r}: the mapping is "
            "Llama's — another architecture's tensors would load into the "
            "wrong places or serve with the wrong attention"
        )
    act = hf.get("hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(
            f"unsupported hidden_act {act!r}: TransformerLM's FFN is "
            "SwiGLU (silu) — loading this checkpoint would silently "
            "change the activation"
        )
    if hf.get("rope_scaling") is not None:
        raise ValueError(
            "rope_scaling is not supported: apply_rope implements plain "
            "rotary embedding; a scaled-rope checkpoint would produce "
            "wrong positions beyond the original context"
        )
    if hf.get("sliding_window") is not None:
        raise ValueError(
            f"sliding_window={hf['sliding_window']} is not supported: the "
            "port's attention reads the whole causal window, so a "
            "sliding-window model would serve wrong logits past it"
        )
    heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim")
    if head_dim is not None and head_dim * heads != hf["hidden_size"]:
        raise ValueError(
            f"head_dim {head_dim} != hidden_size {hf['hidden_size']} / "
            f"num_attention_heads {heads}: the port's heads are "
            "d_model / n_heads wide"
        )
    kw = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=hf.get("num_key_value_heads"),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 2048),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def _llama_layer_entries(i: int, cfg):
    """(flax key path, hf tensor name, transform) for layer ``i``.

    Transforms take the float32 tensor to the flax kernel layout. ``d`` =
    d_model, ``h``/``kv`` = query/KV head counts, ``hd`` the head width.
    """
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    pre = f"model.layers.{i}."
    blk = f"block_{i}"

    def qkv(heads):
        return lambda w: w.t().reshape(d, heads, hd)

    def o(w):
        return w.t().reshape(h, hd, d)

    def t(w):
        return w.t().contiguous()

    return [
        ((blk, "attn", "q_proj", "kernel"), pre + "self_attn.q_proj.weight", qkv(h)),
        ((blk, "attn", "k_proj", "kernel"), pre + "self_attn.k_proj.weight", qkv(kv)),
        ((blk, "attn", "v_proj", "kernel"), pre + "self_attn.v_proj.weight", qkv(kv)),
        ((blk, "attn", "o_proj", "kernel"), pre + "self_attn.o_proj.weight", o),
        ((blk, "attn_norm", "scale"), pre + "input_layernorm.weight", None),
        ((blk, "mlp", "gate_proj", "kernel"), pre + "mlp.gate_proj.weight", t),
        ((blk, "mlp", "up_proj", "kernel"), pre + "mlp.up_proj.weight", t),
        ((blk, "mlp", "down_proj", "kernel"), pre + "mlp.down_proj.weight", t),
        ((blk, "mlp_norm", "scale"), pre + "post_attention_layernorm.weight", None),
    ]


def load_hf_llama(path: str | os.PathLike, cfg=None, *, quantize: bool = False,
                  strict: bool = True, device=None):
    """Load a HF-layout Llama checkpoint into a TransformerLM state dict.

    Returns ``(cfg, state_dict)``, the state dict on ``device`` (``cuda``
    unless the caller passes another). ``cfg`` defaults to
    :func:`config_from_hf` on the directory's ``config.json``. Tensors
    stream one at a time: read (its bytes only) -> placed on ``device``
    -> cast to float32 -> transposed / reshaped to the flax layout ->
    converted through :func:`..models.convert.jax_leaf_to_port`
    (quantized to int8 when ``quantize``) — each entry is on the device
    as soon as it is made, and the float checkpoint is never resident in
    full, on the host or on the card.

    ``quantize=True`` gives the int8 serving layout (``qt`` / ``scale``
    per matmul weight, norms and embedding float): serve it with
    ``dataclasses.replace(cfg, quantized=True)``. The state dict is
    float32 otherwise (the port's float model holds float32 parameters
    and computes in ``cfg.dtype``), so the JAX function's ``dtype`` has
    no counterpart; nor have ``scan_layers`` (the port holds one module a
    layer) and ``materialize`` (a tensor placed on the card is resident
    already).

    ``strict=True`` (default) fails loud, before anything is read, if the
    checkpoint holds tensors the mapping does not consume — e.g.
    ``attention_bias=True`` checkpoints store ``*.bias`` tensors
    TransformerLM has no slot for; dropping them silently would serve
    wrong logits.
    """
    from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
        _check_schema,
        jax_leaf_to_port,
    )

    dev = resolve_device(device)
    ckpt = HFCheckpoint(path)
    if cfg is None:
        cfg = config_from_hf(path)
    layers = [e for i in range(cfg.n_layers) for e in _llama_layer_entries(i, cfg)]
    tied = "lm_head.weight" not in ckpt
    entries = [(("tok_emb", "embedding"), "model.embed_tokens.weight", None),
               (("final_norm", "scale"), "model.norm.weight", None),
               *([] if tied else [(("lm_head", "kernel"), "lm_head.weight",
                                   lambda w: w.t().contiguous())]),
               *layers]
    if strict:
        leftover = sorted(set(ckpt.keys()) - {name for _, name, _ in entries})
        if leftover:
            raise ValueError(
                f"{len(leftover)} checkpoint tensor(s) were not consumed "
                f"by the Llama mapping (first few: {leftover[:5]}) — "
                "loading would silently drop weights. Pass strict=False "
                "only if you know they are genuinely unused."
            )
    out: dict[str, torch.Tensor] = {}
    for flax_path, name, transform in entries:
        leaf = ckpt.get(name).to(dev).float()
        if transform is not None:
            leaf = transform(leaf)
        out.update(jax_leaf_to_port(flax_path, leaf, quantized=quantize))
        del leaf
        if tied and flax_path == ("tok_emb", "embedding"):
            # tie_word_embeddings: the head is the embedding matrix, (d, V)
            out.update(jax_leaf_to_port(("lm_head", "kernel"), out["tok_emb.weight"].t(),
                                        quantized=quantize))
    return cfg, _check_schema(out, dataclasses.replace(cfg, quantized=quantize))

