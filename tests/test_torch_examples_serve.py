"""The port's serving example (``examples/serve_llm_int8.py``) at
``--preset toy --device cpu`` against the JAX package's
``examples/serve_llm_int8.py`` (imported by its path; orbax on the JAX
side).

- the synthetic checkpoint: the same subtree files, and every leaf
  bitwise the JAX writer's for ``seed=0`` (the same numpy PCG64 draws in
  the same leaf order);
- the one-shot arm: every row's greedy tokens equal the JAX example's
  ``load_streamed`` + ``generate`` on those weights, token-exact; a
  near-tie flip at a row's first difference is held teacher-forced, the
  JAX model's two candidates within 4% of its logit scale (ROADMAP §C);
- ``--server``: every request of the timed stream equals the port's
  ``generate`` of its prompt; the receipt is a valid ``serving``
  receipt carrying the sentry's fields, balanced (fetched = budgeted, no
  violation); ``--no-sentry`` drops them;
- ``--server --paged --page-size 8 --requests 6 --slots 2``: the
  asserts of ``tests/test_examples.py``'s paged test; ``--paged-kernel
  --kv-bits 8`` completes; ``--max_seq_len 128 --flash --prompt_len 48``
  completes on the reused checkpoint; ``--hf_checkpoint`` serves a
  locally written HF-layout Llama directory (the names and (out, in)
  layout ``save_pretrained`` writes); without ``--device cpu`` it raises.
"""

import dataclasses
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import TransformerLM as JTransformerLM
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jgenerate
from pytorch_distributed_training_tutorials_tpu.models.transformer import (
    stack_quantized_lm_params as jstack,
)
from pytorch_distributed_training_tutorials_tpu_torch.examples import serve_llm_int8 as ex
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM, generate
from pytorch_distributed_training_tutorials_tpu_torch.obs import validate_receipt
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import restore_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE_SHARE = 0.04


def jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_llm_int8", os.path.join(REPO, "examples", "serve_llm_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_example")
    jex = jax_example()
    jcfg = jex.presets()["toy"]
    jdir, pdir = str(tmp / "jax_ck"), str(tmp / "port_ck")
    jex.write_synthetic_checkpoint(jcfg, jdir, seed=0)
    one_shot = ex.main(["--preset", "toy", "--device", "cpu", "--ckpt_dir", pdir])
    # the JAX example's serving of its own checkpoint (load_streamed, the
    # stacked int8 tree, generate) on the example's prompt
    jparams = jstack(jex.load_streamed(jcfg, jdir, None))
    jlm = JTransformerLM(dataclasses.replace(jcfg, quantized=True, scan_layers=True))
    rng = np.random.Generator(np.random.PCG64(7))
    prompt = rng.integers(0, jcfg.vocab_size, (4, 32))
    jout = np.asarray(jgenerate(jlm, jparams, jnp.asarray(prompt, jnp.int32), 32))
    return {"tmp": tmp, "jdir": jdir, "pdir": pdir, "one_shot": one_shot, "prompt": prompt,
            "jout": jout, "jlm": jlm, "jparams": jparams}


def test_synthetic_checkpoint_is_the_jax_writers(setup):
    jdir, pdir = setup["jdir"], setup["pdir"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    names = [n for n in sorted(os.listdir(pdir)) if n != "COMPLETE"]
    assert len(names) == 2 + 2 + 1  # blocks, final_norm, lm_head, tok_emb
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler()) as ckptr:
        for name in names:
            want = dict(leaves(ckptr.restore(os.path.join(jdir, name))))
            got = dict(leaves(restore_checkpoint(os.path.join(pdir, name))))
            assert want.keys() == got.keys(), name
            for kp in want:
                assert got[kp].dtype == np.float32
                np.testing.assert_array_equal(got[kp], want[kp], err_msg=str(kp))


def test_one_shot_tokens_equal_the_jax_example(setup):
    got = np.asarray(setup["one_shot"]["generated"])
    want = setup["jout"][:, 32:]
    assert got.shape == want.shape == (4, 32)
    assert setup["one_shot"]["sample"] == got[0, :12].tolist()
    for row in range(got.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:  # a near-tie: the JAX model's logits at the first difference
            t = int(diff[0])
            seq = np.concatenate([setup["prompt"][row], got[row, :t]])[None]
            logits = np.asarray(setup["jlm"].apply({"params": setup["jparams"]},
                                                   jnp.asarray(seq, jnp.int32)))[0, -1]
            gap = abs(logits[got[row, t]] - logits[want[row, t]])
            assert gap <= TIE_SHARE * np.abs(logits).max(), (row, t, gap)


def _server(setup, *extra):
    path = str(setup["tmp"] / f"r{abs(hash(extra))}.json")
    r = ex.main(["--preset", "toy", "--device", "cpu", "--ckpt_dir", setup["pdir"],
                 "--prompt_len", "8", "--new_tokens", "4", "--batch", "2", "--server",
                 "--json", path, *extra])
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(r))
    return r


def test_server_tokens_equal_generate_and_the_sentry_balances(setup):
    r = _server(setup, "--requests", "6")
    assert validate_receipt(r, kind="serving") == []
    assert r["checkpoint_reused"] and r["server_completed"] == 6
    model = TransformerLM(dataclasses.replace(ex.presets()["toy"], quantized=True))
    params = ex.load_streamed(ex.presets()["toy"], setup["pdir"], device="cpu")
    for s in r["server_streams"]:
        ref = generate(model, params, [s["prompt"]], 4, device="cpu")[0, len(s["prompt"]):]
        assert s["tokens"] == ref.tolist()
    assert r["sentry"] == 1 and r["sentry_budget_violations"] == 0
    assert r["sentry_fetched"] == r["sentry_budgeted"] > 0
    assert r["sentry_steady_recompiles"] == 0 and r["sentry_reuploads"] == 0
    off = _server(setup, "--requests", "2", "--no-sentry")
    assert off["sentry"] == 0 and not [k for k in off if k.startswith("sentry_")]


def test_server_paged_receipt(setup):
    r = _server(setup, "--requests", "6", "--slots", "2", "--paged", "--page-size", "8")
    assert r["paged"] == 1 and r["page_size"] == 8
    assert r["pool_pages"] == 16  # 2 slots x a 64-token window / 8-token pages
    assert r["hbm_high_water_bytes"] > 0
    assert r["pages_in_use"] == 0  # drained clean
    k = _server(setup, "--requests", "4", "--paged", "--page-size", "8", "--paged-kernel",
                "--kv-bits", "8")
    assert k["paged_kernel"] and k["kv_bits"] == 8 and k["server_completed"] == 4


def test_long_window_flash_on_a_reused_checkpoint(setup):
    r = ex.main(["--preset", "toy", "--device", "cpu", "--ckpt_dir", setup["pdir"],
                 "--max_seq_len", "128", "--flash", "--prompt_len", "48", "--new_tokens", "4",
                 "--batch", "2"])
    assert r["checkpoint_reused"] and r["flash_prefill"] and r["max_seq_len"] == 128
    assert np.asarray(r["generated"]).shape == (2, 4)


HF_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              rms_norm_eps=1e-5, rope_theta=10000.0)


def write_hf_dir(path) -> None:
    """A HF-layout Llama directory (``config.json`` and one
    ``model.safetensors``, every weight named and laid out (out, in) as
    ``LlamaForCausalLM.save_pretrained`` writes it), random weights."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
        save_safetensors,
    )

    c = HF_CFG
    d, ff, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = d // c["num_attention_heads"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    gen = torch.Generator().manual_seed(0)
    shapes = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,),
              "lm_head.weight": (v, d)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        shapes.update({pre + "input_layernorm.weight": (d,),
                       pre + "post_attention_layernorm.weight": (d,),
                       pre + "self_attn.q_proj.weight": (q, d),
                       pre + "self_attn.k_proj.weight": (kv, d),
                       pre + "self_attn.v_proj.weight": (kv, d),
                       pre + "self_attn.o_proj.weight": (d, q),
                       pre + "mlp.gate_proj.weight": (ff, d), pre + "mlp.up_proj.weight": (ff, d),
                       pre + "mlp.down_proj.weight": (d, ff)})
    os.makedirs(path)
    save_safetensors(os.path.join(path, "model.safetensors"),
                     {n: (1.0 + 0.02 * torch.randn(sh, generator=gen)) if len(sh) == 1
                      else 0.05 * torch.randn(sh, generator=gen) for n, sh in shapes.items()})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama", **c,
                   "hidden_act": "silu", "tie_word_embeddings": False}, f)


def test_hf_checkpoint(setup, capsys):
    hf = setup["tmp"] / "hf"
    write_hf_dir(hf)
    r = ex.main(["--hf_checkpoint", str(hf), "--device", "cpu", "--prompt_len", "8",
                 "--new_tokens", "4", "--batch", "2"])
    out = capsys.readouterr().out
    assert "HF layout" in out and "serve:" in out and r["preset"] == "hf"
    assert r["n_params"] == sum(math.prod(t.shape) for t in restore_checkpoint(
        os.path.join(hf, "model.safetensors")).values())
    assert np.asarray(r["generated"]).shape == (2, 4)


def test_refuses_without_a_gpu(setup):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(["--preset", "toy", "--ckpt_dir", setup["pdir"]])
