"""Host memory of the port's streaming int8 LM loader
(``models/transformer.py:load_quantized_lm``), the port's twin of the JAX
package's ``tests/test_auto.py::test_load_quantized_streams_bounded_host_peak``:
a ~0.5 GB float LM checkpoint written by ``parallel/auto.py`` and loaded
in two fresh processes (no JAX), streamed and whole-tree."""

import json
import os
import subprocess
import sys

import numpy as np

from pytorch_distributed_training_tutorials_tpu_torch.parallel import auto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_RSS_CHILD = """
import json, sys
import torch
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig, from_jax_params, load_quantized_lm)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import restore_checkpoint

def status_kb(field):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise RuntimeError(field)

path, mode, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
torch.set_num_threads(1)
base = status_kb("VmRSS")
if mode == "stream":
    sd = load_quantized_lm(path, device="cpu")
else:  # the whole float tree on the host first, as the comparison
    tree = restore_checkpoint(path)
    sd = from_jax_params(tree, TransformerConfig(**spec, quantized=True), device="cpu")
    del tree
print(json.dumps({"base_kb": base, "peak_kb": status_kb("VmHWM"),
                  "int8": sum(t.dtype == torch.int8 for t in sd.values())}))
"""


def test_streamed_load_bounds_host_peak(tmp_path):
    """A ~0.5 GB float LM checkpoint loaded in a fresh process twice:
    streamed (``load_quantized_lm``) and whole (``restore_checkpoint`` +
    ``from_jax_params``). The streamed peak RSS growth (VmHWM over the
    RSS before the load: an upper bound, read only) stays under 40% of
    the whole load's. Both children run with glibc's mmap threshold
    fixed at 1 MB (``MALLOC_MMAP_THRESHOLD_``), so that RSS follows live
    memory: by default glibc raises its threshold to the size of the
    last large block freed, and the CPU quantizer's freed multi-MB
    temporaries then stay in the C heap, by an amount that varies from
    run to run (the loader's own reads are anonymous mappings either
    way)."""
    spec = dict(vocab_size=4096, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
                max_seq_len=64)
    rng = np.random.Generator(np.random.PCG64(0))
    tree = {}
    d, h, hd, ff, v = 1024, 8, 128, 4096, 4096

    def draw(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02)

    tree["tok_emb"] = {"embedding": draw(v, d)}
    for i in range(spec["n_layers"]):
        tree[f"block_{i}"] = {
            "attn_norm": {"scale": np.ones(d, np.float32)},
            "attn": {"q_proj": {"kernel": draw(d, h, hd)}, "k_proj": {"kernel": draw(d, h, hd)},
                     "v_proj": {"kernel": draw(d, h, hd)}, "o_proj": {"kernel": draw(h, hd, d)}},
            "mlp_norm": {"scale": np.ones(d, np.float32)},
            "mlp": {"gate_proj": {"kernel": draw(d, ff)}, "up_proj": {"kernel": draw(d, ff)},
                    "down_proj": {"kernel": draw(ff, d)}},
        }
    tree["final_norm"] = {"scale": np.ones(d, np.float32)}
    tree["lm_head"] = {"kernel": draw(d, v)}
    ckpt_bytes = sum(x.nbytes for _, x in auto.tree_leaves(tree))
    path = tmp_path / "lm"
    auto.save_checkpoint(path, tree)
    del tree

    env = {k: val for k, val in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=REPO, MALLOC_MMAP_THRESHOLD_=str(1 << 20))
    procs = {mode: subprocess.Popen([sys.executable, "-c", _RSS_CHILD, str(path), mode,
                                     json.dumps(spec)], env=env, cwd=REPO, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for mode in ("stream", "whole")}
    res = {}
    for mode, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        res[mode] = json.loads(out.strip().splitlines()[-1])
    stream, whole = res["stream"], res["whole"]
    n_int8 = 8 * 7 + 1
    assert stream["int8"] == whole["int8"] == n_int8
    stream_kb = stream["peak_kb"] - stream["base_kb"]
    whole_kb = whole["peak_kb"] - whole["base_kb"]
    assert whole_kb * 1024 > 0.9 * ckpt_bytes, (stream_kb, whole_kb, ckpt_bytes)
    assert stream_kb < 0.4 * whole_kb, (stream_kb, whole_kb, ckpt_bytes)
