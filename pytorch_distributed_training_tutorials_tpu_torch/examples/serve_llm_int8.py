"""Serve a billion-parameter LM int8-quantized from a streamed checkpoint —
the twin of the JAX package's ``examples/serve_llm_int8.py``.

The reference's model-parallel demo loads Llama-7B with
``from_pretrained(..., BitsAndBytesConfig(load_in_8bit=True),
device_map="auto")`` (``03.model_parallel.ipynb`` cells 2-4). This example
is that loop at the 1b preset's scale, on the card:

1. write a synthetic float32 checkpoint of the preset once, one top-level
   subtree at a time in the port's checkpoint format
   (:func:`..parallel.auto.save_checkpoint`; a ``COMPLETE`` marker when
   every subtree landed), drawing the same numpy PCG64 values in the same
   leaf order as the JAX writer, so both examples serve the same weights
   from the same seed;
2. stream it back leaf by leaf through
   :func:`..models.transformer.load_quantized_lm` (each matmul weight read,
   quantized to int8 with per-column scales, placed on the card and freed
   before the next read: the host holds one leaf, the card a quarter of
   the float bytes);
3. serve: ``generate`` (prefill + KV-cache decode through kernel 1, the
   int8 matmul, in every projection), reporting decode tokens/s as the
   better of 2 timings and a ``sample:`` line; or, with ``--server``, a
   stream of mixed-length requests through the continuous-batching
   :class:`..serve.ServeEngine` (``--paged --paged-kernel``: decode
   attention through kernel 2; ``--flash``: prefill through kernel 3),
   with the contract sentry on unless ``--no-sentry``; ``--replicas`` /
   ``--disaggregate`` serve it through a :class:`..serve.FleetRouter`.

::

    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.serve_llm_int8 --preset 1b
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.serve_llm_int8 \\
        --preset 1b --server --json serving.json
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.serve_llm_int8 \\
        --preset toy --server --device cpu

``--tp N`` spawns N ranks (one a card; gloo on card 0 when N exceeds the
cards), each streaming its shard of the int8 weights
(``INT8_TP_RULES``) and serving through ``TensorParallel`` +
``ServeEngine(strategy=)``; rank 0 prints and writes the receipt.
``--json PATH`` writes a ``graft-receipt/v1`` ``serving`` receipt. Runs
on ``cuda`` unless given ``--device cpu``.

The JAX ``--unrolled`` (L block copies instead of the stacked ``nn.scan``
body) is not offered: the port holds one module a layer, and ``scan_layers``
is not ported on purpose.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import resource
import sys
import tempfile
import threading
import time

PRESETS = {
    # ~1.20B params (16 layers x 67.1M + 2 x 65.5M embedding / head): a
    # float32 checkpoint of 4.8 GB, int8 + scales + norms ~1.4 GB resident
    "1b": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, d_ff=8192,
               max_seq_len=512),
    # the Llama-2/3 serving layout: 4 KV heads shared by 16 query heads
    "1b-gqa": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=4,
                   d_ff=8192, max_seq_len=512),
    "toy": dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=64),
}


def presets() -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig

    return {name: TransformerConfig(**kw) for name, kw in PRESETS.items()}


def rss_gb() -> float:
    """The process's peak resident set so far (GB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class RssSampler:
    """The resident set's growth over a region, sampled every 2 ms from
    ``/proc/self/status`` (``ru_maxrss`` is the process's lifetime peak:
    an earlier, larger peak would hide the region's). ``growth_bytes`` is
    None where the file does not exist."""

    def __init__(self):
        self.growth_bytes = None
        self._stop = threading.Event()

    @staticmethod
    def _rss_kb() -> int | None:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            return None
        return None

    def __enter__(self):
        self._base = self._rss_kb()
        self._peak = self._base
        if self._base is not None:
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def _sample(self):
        while not self._stop.is_set():
            self._peak = max(self._peak, self._rss_kb() or 0)
            self._stop.wait(0.002)

    def __exit__(self, *exc):
        if self._base is None:
            return
        self._stop.set()
        self._thread.join()
        self._peak = max(self._peak, self._rss_kb() or 0)
        self.growth_bytes = (self._peak - self._base) * 1024


def flax_lm_shapes(cfg) -> dict:
    """The JAX ``TransformerLM``'s parameter tree for ``cfg`` as nested
    dicts of shapes in the flax layout (kernels (in, out), q/k/v (d, H,
    D), o_proj (H, D, d)), every level's keys sorted as JAX flattens a
    dict (``block_10`` before ``block_2``)."""
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim
    block = {
        "attn": {"k_proj": {"kernel": (d, kv, hd)}, "o_proj": {"kernel": (h, hd, d)},
                 "q_proj": {"kernel": (d, h, hd)}, "v_proj": {"kernel": (d, kv, hd)}},
        "attn_norm": {"scale": (d,)},
        "mlp": {"down_proj": {"kernel": (ff, d)}, "gate_proj": {"kernel": (d, ff)},
                "up_proj": {"kernel": (d, ff)}},
        "mlp_norm": {"scale": (d,)},
    }
    tree = {"final_norm": {"scale": (d,)}, "lm_head": {"kernel": (d, cfg.vocab_size)},
            "tok_emb": {"embedding": (cfg.vocab_size, d)},
            **{f"block_{i}": block for i in range(cfg.n_layers)}}
    return {k: tree[k] for k in sorted(tree)}


def _leaf_shapes(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_shapes(v)
        else:
            yield v


def count_params(cfg) -> int:
    """The preset's parameter count, from its schema alone."""
    total = 0
    for shape in _leaf_shapes(flax_lm_shapes(cfg)):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def write_synthetic_checkpoint(cfg, path: str, seed: int = 0) -> int:
    """Write a random float32 checkpoint of ``cfg`` at ``path`` without
    ever holding the whole model: each top-level subtree (one block, ~67M
    parameters at the 1b preset) is drawn leaf by leaf —
    ``N(0, 1) * 0.02`` from ``numpy``'s ``PCG64(seed)``, in JAX's sorted
    leaf order, so the values are the JAX writer's — written as
    ``path/<name>`` (``{name: subtree}``, so key paths keep their parent)
    and freed. A ``COMPLETE`` marker last: a torn write never looks
    reusable. Returns the parameter count."""
    import shutil

    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import save_checkpoint

    rng = np.random.Generator(np.random.PCG64(seed))
    if os.path.isdir(path):  # a torn earlier attempt: regenerate from clean
        shutil.rmtree(path)
    os.makedirs(path)

    def leaf(shape):
        x = rng.standard_normal(shape)
        x *= 0.02  # in place: the bits of ``x * 0.02``
        return x.astype(np.float32)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

    for name, sub in flax_lm_shapes(cfg).items():
        part = draw(sub)
        save_checkpoint(os.path.join(path, name), {name: part})
        del part
    with open(os.path.join(path, "COMPLETE"), "w") as f:
        f.write("ok\n")
    return count_params(cfg)


def load_streamed(cfg, path: str, mesh=None, device=None) -> dict:
    """Stream-quantize every subtree of a :func:`write_synthetic_checkpoint`
    checkpoint into the int8 serving state dict on ``device`` (``cuda``
    unless the caller passes another); with ``mesh`` (a tensor-parallel
    strategy) only this rank's shard per ``INT8_TP_RULES``."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import load_quantized_lm

    params = {}
    for name in sorted(os.listdir(path)):
        if name == "COMPLETE":
            continue
        params.update(load_quantized_lm(os.path.join(path, name), mesh, device=device))
    return params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=tuple(PRESETS), default="toy")
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of the model axis for sharded int8 serving")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--hf_checkpoint", default=None, metavar="DIR",
                    help="serve a HF-layout Llama checkpoint (config.json + *.safetensors), "
                         "streamed tensor by tensor and quantized on load")
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--new_tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a graft-receipt/v1 serving receipt to PATH")
    ap.add_argument("--max_seq_len", type=int, default=None,
                    help="serve at another window than the preset's (weights are "
                         "window-agnostic)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples (with --top_k / --top_p)")
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--kv_cache_dtype", choices=("f32", "bf16", "int8"), default="f32",
                    help="KV-cache storage (reduced dtypes round stored K/V)")
    ap.add_argument("--flash", action="store_true",
                    help="prefill through the flash-attention kernels")
    ap.add_argument("--server", action="store_true",
                    help="serve a request stream through ServeEngine instead of the "
                         "one-shot generate leg")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tokens_per_launch", type=int, default=8)
    ap.add_argument("--prefix-overlap", type=float, default=0.0, dest="prefix_overlap")
    ap.add_argument("--prefix-cache-mb", type=int, default=None, dest="prefix_cache_mb")
    ap.add_argument("--spec-k", type=int, default=0, dest="spec_k")
    ap.add_argument("--spec-ngram", type=int, default=3, dest="spec_ngram")
    ap.add_argument("--adapters", type=int, default=0)
    ap.add_argument("--lora-rank", type=int, default=8, dest="lora_rank")
    ap.add_argument("--deadline-s", type=float, default=None, dest="deadline_s")
    ap.add_argument("--flight-log", default=None, dest="flight_log")
    ap.add_argument("--no-sentry", action="store_true", dest="no_sentry",
                    help="turn the contract sentry off (on by default for --server)")
    ap.add_argument("--pipeline-depth", type=int, default=1, dest="pipeline_depth")
    ap.add_argument("--prefill-chunk", type=int, default=0, dest="prefill_chunk")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=64, dest="page_size")
    ap.add_argument("--pool-pages", type=int, default=0, dest="pool_pages",
                    help="0 sizes the pool to slots * window / page_size")
    ap.add_argument("--kv-bits", type=int, choices=(8, 4), default=None, dest="kv_bits")
    ap.add_argument("--paged-kernel", action="store_true", dest="paged_kernel",
                    help="decode attention through the paged-attention kernel")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop Poisson arrivals at this rate (0: all up front)")
    ap.add_argument("--hedge-after", type=float, default=None, dest="hedge_after")
    ap.add_argument("--disaggregate", default=None, metavar="NpMd")
    ap.add_argument("--slo", action="store_true",
                    help="two SLO classes: every 4th request class 0")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap


def serve_config(args):
    """The serving config: the preset (or the HF checkpoint's), its window,
    flash prefill and KV storage."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    if args.hf_checkpoint:
        from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
            config_from_hf,
        )

        cfg = config_from_hf(args.hf_checkpoint)
    else:
        cfg = presets()[args.preset]
    if args.max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=args.max_seq_len)
    if args.flash:
        cfg = dataclasses.replace(cfg, attention_fn=flash_attention)
    kv = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}[args.kv_cache_dtype]
    if args.kv_bits is not None:
        kv = "int4" if args.kv_bits == 4 else torch.int8
    return dataclasses.replace(cfg, kv_cache_dtype=kv)


def _checked(ap, args):
    if args.slo and (args.replicas > 1 or args.disaggregate):
        ap.error("--slo is the single-engine arm; drop --replicas/--disaggregate")
    if args.kv_bits is not None and args.kv_cache_dtype != "f32":
        ap.error("--kv-bits replaces --kv_cache_dtype; pass only one")
    if args.paged_kernel and not args.paged:
        ap.error("--paged-kernel requires --server --paged")
    if args.disaggregate:
        _parse_disaggregate(args.disaggregate)
    return args


def main(argv=None) -> dict:
    """Parse ``argv``, write the checkpoint if it is missing, then serve
    (in this process, or on ``--tp`` spawned ranks). Returns the receipt
    payload (rank 0's)."""
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.examples import run_world

    ap = build_parser()
    args = _checked(ap, ap.parse_args(argv))
    resolve_device(args.device)  # no GPU and no --device cpu: raise before any work
    cfg = serve_config(args)
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"llm_int8_{args.preset}")
    receipt = {"preset": args.preset, "tp": args.tp, "kv_bits": args.kv_bits or 0,
               "paged_kernel": bool(args.paged_kernel), "paged": int(args.paged)}
    t0 = time.perf_counter()
    if args.hf_checkpoint:
        n_params = count_params(cfg)
        receipt.update(hf_checkpoint=os.path.abspath(args.hf_checkpoint), preset="hf")
        print(f"checkpoint: HF layout at {args.hf_checkpoint} ({n_params/1e9:.2f}B params)")
    elif not os.path.isfile(os.path.join(ckpt, "COMPLETE")):
        n_params = write_synthetic_checkpoint(cfg, ckpt)
        receipt["checkpoint_write_s"] = time.perf_counter() - t0
        print(f"checkpoint: wrote {n_params/1e9:.2f}B params ({4*n_params/1e9:.1f} GB f32) "
              f"to {ckpt} in {time.perf_counter()-t0:.0f}s, peak RSS {rss_gb():.1f} GB")
    else:
        n_params = count_params(cfg)
        receipt["checkpoint_reused"] = True
        print(f"checkpoint: reusing {ckpt}")
    receipt.update(n_params=n_params, checkpoint_gb_f32=round(4 * n_params / 1e9, 2),
                   ckpt_dir=None if args.hf_checkpoint else ckpt)
    if args.tp > 1:
        return run_world(_rank, args.tp, (args, receipt), device=args.device)[0]
    return run(args, receipt)


def _rank(world, args, receipt) -> dict:
    return run(args, receipt, world)


def _kernel_counts() -> dict:
    """The serving kernels' launch and route counters (cumulative)."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    return {"int8_matmul_launches": quant.int8_matmul.launches,
            "int8_matmul_routes": dict(quant.int8_matmul.routes),
            "paged_attention_launches": paged_attention.launches,
            "paged_attention_routes": dict(paged_attention.routes),
            "flash_launches": dict(flash_attention.launches)}


def _kernel_delta(before: dict) -> dict:
    now = _kernel_counts()
    out = {}
    for k, v in now.items():
        out[k] = ({r: n - before[k].get(r, 0) for r, n in v.items()} if isinstance(v, dict)
                  else v - before[k])
    return out


def run(args, receipt: dict, world=None) -> dict:
    """One rank's load and serve (the world, if any, formed already): the
    receipt payload. Rank 0 prints and writes ``--json``."""
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM, generate
    from pytorch_distributed_training_tutorials_tpu_torch.obs import MinOfN

    dev = resolve_device(args.device)
    primary = world is None or world.rank == 0
    say = print if primary else (lambda *a, **k: None)
    receipt = dict(receipt)
    cfg = serve_config(args)
    tp = world if world is not None and args.tp > 1 else None
    rss_before = rss_gb()
    t0 = time.perf_counter()
    with RssSampler() as rss:
        if args.hf_checkpoint:
            from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
                load_hf_llama,
            )

            _, params = load_hf_llama(args.hf_checkpoint, cfg=cfg, quantize=True, device=dev)
        else:
            params = load_streamed(cfg, receipt["ckpt_dir"], tp, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    n_bytes = sum(t.nbytes for t in params.values())
    f32_gb = 4 * sum(t.numel() for t in params.values() if t.dtype == torch.int8) / 1e9
    ckpt_bytes = 4 * receipt["n_params"]
    if tp is not None:
        f32_gb *= args.tp  # a rank holds its shard of the int8 weights
    receipt.update(load_s=load_s, load_gb_per_s=ckpt_bytes / load_s / 1e9,
                   resident_gb=round(n_bytes / 1e9, 4), f32_equivalent_gb=round(f32_gb, 2),
                   peak_rss_gb=round(rss_gb(), 2), rss_before_load_gb=round(rss_before, 2),
                   load_rss_growth_bytes=rss.growth_bytes)
    say(f"load: streamed+quantized in {load_s:.1f}s ({ckpt_bytes / load_s / 1e9:.2f} GB/s of "
        f"the f32 checkpoint) — resident {n_bytes/1e9:.2f} GB (int8+scales+float norms), "
        f"load RSS growth {(rss.growth_bytes or 0) / 1e9:.2f} GB (the full f32 tree would be "
        f"{f32_gb:.1f} GB)")
    serve_cfg = dataclasses.replace(cfg, quantized=True, int8_mesh=tp)
    if args.hf_checkpoint and tp is not None:
        from pytorch_distributed_training_tutorials_tpu_torch.models import place_int8_lm_params

        params = place_int8_lm_params(params, serve_cfg)
    lm = TransformerLM(serve_cfg)
    rng = np.random.Generator(np.random.PCG64(7))
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    if args.server:
        if args.replicas > 1 or args.disaggregate:
            serve_fleet_stream(args, cfg, lm, params, receipt, dev, tp, say)
        else:
            serve_request_stream(args, cfg, lm, params, receipt, dev, tp, say)
        return _finish(args, receipt, dev, primary, say)
    gen_kw = {}
    if args.temperature > 0:
        gen_kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    before = _kernel_counts()
    holder = {}

    def run_gen():
        gen = (torch.Generator(device=dev).manual_seed(7) if args.temperature > 0 else None)
        holder["out"] = generate(lm, params, prompt, args.new_tokens, device=dev,
                                 generator=gen, **gen_kw)
        int(holder["out"][0, -1])  # close the region with a real fetch

    t0 = time.perf_counter()
    run_gen()
    compile_s = time.perf_counter() - t0
    timing = MinOfN(n=2, warmup=False).measure(run_gen)
    out = holder["out"].cpu()
    toks = args.batch * args.new_tokens
    receipt.update(
        batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        max_seq_len=cfg.max_seq_len, flash_prefill=bool(args.flash),
        kv_cache_dtype=args.kv_cache_dtype, temperature=args.temperature,
        **(dict(top_k=args.top_k, top_p=args.top_p) if args.temperature > 0 else {}),
        decode_tok_per_s=toks / timing.best_s,
        decode_s_samples=list(timing.samples_s), decode_stalled_samples=timing.n_stalled,
        first_call_incl_compile_s=compile_s, backend=dev.type,
        generated=out[:, args.prompt_len:].tolist(),
        sample=out[0, args.prompt_len:args.prompt_len + 12].tolist(),
        forwards=3 * args.new_tokens, kernels=_kernel_delta(before),
    )
    say(f"serve: {args.batch}x({args.prompt_len} prompt + {args.new_tokens} new) in "
        f"{timing.best_s:.3f}s ({toks / timing.best_s:.1f} tok/s; first call {compile_s:.1f}s)")
    say("sample:", receipt["sample"])
    return _finish(args, receipt, dev, primary, say)


def _finish(args, receipt: dict, dev, primary: bool, say) -> dict:
    """Stamp the card and, on rank 0 with ``--json``, write the receipt."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt, write_receipt

    enveloped = make_receipt("serving", receipt, device=dev)
    if primary and args.json:
        write_receipt(args.json, enveloped)
        say(f"receipt -> {args.json}")
    return enveloped


def _reset_serving_counters(engine) -> None:
    """Zero the engine's traffic counters after the warmup, so the timed
    stream's receipt measures serving, not first launches."""
    engine.refills = dict.fromkeys(engine.refills, 0)
    for name in ("n_chains", "n_chunks", "n_host_syncs", "generated_tokens",
                 "prefix_hit_tokens", "n_verify_forwards", "spec_steps_consumed",
                 "spec_drafts_accepted", "adapter_requests", "adapter_rejected",
                 "n_deadline_expired", "n_cancelled", "nonfinite_quarantined",
                 "n_prefill_errors", "n_handoffs_out", "n_handoffs_in", "n_swaps_out",
                 "n_swaps_in"):
        if hasattr(engine, name):
            setattr(engine, name, 0)
    if engine.prefix is not None:
        engine.prefix.hits = engine.prefix.misses = 0


def _parse_disaggregate(spec: str) -> tuple[int, int]:
    """``"1p2d"`` -> ``(1, 2)``; both counts at least 1."""
    m = re.fullmatch(r"(\d+)p(\d+)d", spec)
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise SystemExit(f"--disaggregate wants NpMd with N,M >= 1 (e.g. 1p2d), got {spec!r}")
    return int(m.group(1)), int(m.group(2))


def _paged_kwargs(args, window: int) -> dict:
    """The engine's paged geometry; ``--pool-pages 0`` sizes the pool to
    the whole-slot footprint."""
    if not args.paged:
        return {}
    pool = args.pool_pages or args.slots * window // args.page_size
    return dict(paged=True, page_size=args.page_size, pool_pages=pool,
                paged_kernel=bool(args.paged_kernel))


def _prompt_lengths(args, window: int) -> list[int]:
    p, new = args.prompt_len, args.new_tokens
    return sorted({max(1, p // 2), min(p, window - new), min(p + p // 2, window - new)})


def _bank(args, lm, dev, flight=None):
    """An ``--adapters`` bank: rows 1..N-1 synthetic tenants (factors drawn
    from ``PCG64(13)``, the same on every replica)."""
    if not args.adapters:
        return None
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.adapters import AdapterBank

    bank = AdapterBank(lm, n_adapters=args.adapters, rank=args.lora_rank, device=dev)
    frng = np.random.Generator(np.random.PCG64(13))
    for aid in range(1, args.adapters):
        zeros = bank.row_zeros()
        bank.register(f"tenant-{aid}", {
            k: torch.from_numpy((frng.standard_normal(tuple(zeros[k].shape)) * 0.02)
                                .astype(np.float32))
            for k in sorted(zeros)})
        if flight is not None:
            flight.record("adapter_register", adapter=aid, tenant=f"tenant-{aid}")
    return bank


def _request_maker(args, cfg, lengths):
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    rng = np.random.Generator(np.random.PCG64(11))
    shared = rng.integers(0, cfg.vocab_size, (max(lengths),)).tolist()

    def mk_request(i: int, deadline_s: float | None = None) -> Request:
        p_len = lengths[i % len(lengths)]
        k = min(p_len, int(round(args.prefix_overlap * p_len)))
        tail = rng.integers(0, cfg.vocab_size, (p_len - k,)).tolist()
        return Request(prompt=shared[:k] + tail, max_new_tokens=args.new_tokens, seed=i,
                       deadline_s=deadline_s,
                       adapter=(i % args.adapters) if args.adapters else 0,
                       priority=(0 if i % 4 == 0 else 1) if args.slo else 0)

    return mk_request


def _arrivals(args) -> list[float]:
    """Open-loop Poisson arrival times (``--qps``), or all at 0."""
    import numpy as np

    arng = np.random.Generator(np.random.PCG64(17))
    t, out = 0.0, []
    for _ in range(args.requests):
        if args.qps > 0:
            t += float(arng.exponential(1.0 / args.qps))
        out.append(t)
    return out


def _engine_kwargs(args, cache_mb: int, window: int, dev, tp) -> dict:
    return dict(n_slots=args.slots, tokens_per_launch=args.tokens_per_launch,
                max_queue=max(64, args.requests), temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, prefix_cache_bytes=cache_mb * 2**20,
                speculative_k=args.spec_k, spec_ngram=args.spec_ngram,
                default_deadline_s=args.deadline_s, pipeline_depth=args.pipeline_depth,
                prefill_chunk=args.prefill_chunk, device=dev, strategy=tp,
                **_paged_kwargs(args, window))


def _streams(prompts: dict, done: list) -> list:
    """The timed stream's requests in submission order: each prompt and the
    tokens its completion carries (None: not completed)."""
    tokens = {c.request_id: list(c.tokens) for c in done}
    return [{"prompt": p, "tokens": tokens.get(rid)} for rid, p in prompts.items()]


def _stream_fields(args, lengths, window, cache_mb, wall_s, toks, compile_s, dev) -> dict:
    return dict(server=True, server_requests=args.requests, server_slots=args.slots,
                tokens_per_launch=args.tokens_per_launch, server_prompt_lengths=lengths,
                new_tokens=args.new_tokens, max_seq_len=window,
                temperature=args.temperature, qps=args.qps, server_wall_s=wall_s,
                server_tok_per_s=toks / wall_s, server_generated_tokens=toks,
                server_compile_s=compile_s, prefix_overlap=args.prefix_overlap,
                prefix_cache_mb=cache_mb, flash_prefill=bool(args.flash),
                kv_cache_dtype=args.kv_cache_dtype, backend=dev.type)


def serve_fleet_stream(args, cfg, lm, params, receipt: dict, dev, tp, say) -> None:
    """The ``--server --replicas N`` / ``--disaggregate NpMd`` arm: the
    stream through a :class:`..serve.FleetRouter` over replica engines
    sharing the weights (their own KV caches), one contract sentry shared
    by the fleet and stamping into the router's recorder; ``--qps``
    arrivals open-loop, a ``QueueFull`` arrival shed and counted."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        QueueFull,
        ServeEngine,
    )

    window = int(cfg.max_seq_len)
    lengths = _prompt_lengths(args, window)
    cache_mb = args.prefix_cache_mb
    if cache_mb is None:
        cache_mb = 512 if args.prefix_overlap > 0 else 0
    n_pre, n_dec = _parse_disaggregate(args.disaggregate) if args.disaggregate else (0, 0)
    t0 = time.perf_counter()
    router_flight = FlightRecorder(capacity=4096, t0=t0)
    sentry = None
    if not args.no_sentry:
        from pytorch_distributed_training_tutorials_tpu_torch.obs import ContractSentry

        sentry = ContractSentry(flight=router_flight).install()

    def mk_engine(role=None):
        kw = _engine_kwargs(args, cache_mb, window, dev, tp)
        kw.update(adapter_bank=_bank(args, lm, dev), sentry=sentry,
                  flight=FlightRecorder(capacity=4096, t0=t0))
        if role == "prefill":
            kw.update(role="prefill", speculative_k=0, pipeline_depth=1)
            for k in ("paged", "page_size", "pool_pages", "paged_kernel"):
                kw.pop(k, None)
        elif role == "decode":
            kw.update(role="decode", prefix_cache_bytes=0, prefill_chunk=0)
        return ServeEngine(lm, params, **kw)

    if args.disaggregate:
        engines = [mk_engine("prefill") for _ in range(n_pre)] + \
                  [mk_engine("decode") for _ in range(n_dec)]
    else:
        engines = [mk_engine() for _ in range(args.replicas)]
    if tp is not None:
        audit = engines[n_pre if args.disaggregate else 0].audit_decode()
        say(f"tp={args.tp} decode audit: ok={audit['ok']} collectives={audit['collectives']}")
    router = FleetRouter(engines, hedge_after_s=args.hedge_after, flight=router_flight)
    mk_request = _request_maker(args, cfg, lengths)
    t_compile = time.perf_counter()
    warm_dl = 1e9 if args.deadline_s is not None else None
    if args.disaggregate:
        # the handoff path driven directly: every prefill replica prefills
        # each prompt length once, every decode replica accepts a handoff
        pre, dec = engines[:n_pre], engines[n_pre:]
        for j in range(max(n_pre, n_dec)):
            pe, de = pre[j % n_pre], dec[j % n_dec]
            for i in range(len(lengths)):
                req = mk_request(i, deadline_s=warm_dl)
                rid = pe.submit(dataclasses.replace(req))
                pe.run_until_idle()
                de.accept(req, pe.take_handoff(rid))
            de.run_until_idle()
    else:
        for eng in engines:
            for i in range(len(lengths)):
                eng.submit(mk_request(i, deadline_s=warm_dl))
            eng.run_until_idle()
    compile_s = time.perf_counter() - t_compile
    for eng in engines:
        _reset_serving_counters(eng)
        eng._flight.reset()
    router.n_handoffs_moved = 0
    router_flight.reset()
    if sentry is not None:
        sentry.mark_steady()
    before = _kernel_counts()
    arrivals = _arrivals(args)
    shed, next_i = 0, 0
    prompts, done = {}, []
    t_start = time.perf_counter()
    while next_i < len(arrivals):
        due = t_start + arrivals[next_i]
        if time.perf_counter() >= due:
            req = mk_request(len(lengths) + next_i)
            try:
                prompts[router.submit(req)] = list(req.prompt)
            except QueueFull:
                shed += 1
            next_i += 1
            continue
        if router.idle:
            time.sleep(min(0.001, max(0.0, due - time.perf_counter())))
        else:
            done += router.step()
    done += router.run_until_idle()  # its last round fetched its chains: the region is closed
    wall_s = time.perf_counter() - t_start
    rstats = router.stats()
    if sentry is not None:
        sentry.uninstall()
    toks = sum(e.generated_tokens for e in engines)
    receipt.update(
        **_stream_fields(args, lengths, window, cache_mb, wall_s, toks, compile_s, dev),
        server_shed=shed, server_completed=len(done),
        server_finish_reasons=sorted({c.finish_reason for c in done}),
        server_streams=_streams(prompts, done),
        server_chains=sum(e.n_chains for e in engines),
        server_prefills=sum(e.n_prefills for e in engines),
        server_handoffs=sum(e.n_handoffs_in for e in engines),
        server_host_syncs=sum(e.n_host_syncs for e in engines),
        server_p50_latency_s=rstats.get("e2e_p50_s", 0.0),
        server_p95_latency_s=rstats.get("e2e_p95_s", 0.0),
        server_ttft_p50_s=rstats.get("ttft_p50_s", 0.0),
        server_ttft_p95_s=rstats.get("ttft_p95_s", 0.0),
        forwards=sum(e.n_prefills + e.n_splices + e.n_chains * e.tokens_per_launch
                     for e in engines),
        kernels=_kernel_delta(before), **rstats,
    )
    problems = router.ledger.verify()
    receipt["ledger_ok"] = not problems
    if problems:
        receipt["ledger_problems"] = problems
    if args.flight_log:
        router.dump_fleet(args.flight_log, reason="end_of_stream")
        say(f"fleet flight log -> {args.flight_log}")
    geometry = (f"{n_pre}p+{n_dec}d role replicas" if args.disaggregate
                else f"{args.replicas} replicas")
    say(f"fleet: {args.requests} requests over {geometry} x {args.slots} slots in "
        f"{wall_s:.2f}s — {toks / wall_s:.1f} tok/s aggregate, qps {args.qps or 'burst'} "
        f"({shed} shed), p95 {receipt['server_p95_latency_s']:.3f}s, ttft p95 "
        f"{receipt['server_ttft_p95_s']:.3f}s, states {router.replica_states()} "
        f"(first launches {compile_s:.1f}s)")


def serve_request_stream(args, cfg, lm, params, receipt: dict, dev, tp, say) -> None:
    """The ``--server`` arm: a stream of mixed-length requests through one
    :class:`..serve.ServeEngine` with its flight recorder and (unless
    ``--no-sentry``) the contract sentry. A warmup request a prompt length
    first (first launches, kernel builds), then the counters, recorder and
    sentry reset to steady state, then the timed stream; p50/p95 latency
    and TTFT from the recorder's histograms."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    flight = FlightRecorder(capacity=4096, dump_path=args.flight_log)
    sentry = None
    if not args.no_sentry:
        from pytorch_distributed_training_tutorials_tpu_torch.obs import ContractSentry

        sentry = ContractSentry(flight=flight).install()
    bank = _bank(args, lm, dev, flight)
    window = int(cfg.max_seq_len)
    lengths = _prompt_lengths(args, window)
    cache_mb = args.prefix_cache_mb
    if cache_mb is None:
        cache_mb = 512 if args.prefix_overlap > 0 else 0
    engine = ServeEngine(lm, params, **_engine_kwargs(args, cache_mb, window, dev, tp),
                         adapter_bank=bank, flight=flight, sentry=sentry,
                         priority_classes=2 if args.slo else 0)
    if tp is not None:
        audit = engine.audit_decode()
        say(f"tp={args.tp} decode audit: ok={audit['ok']} collectives={audit['collectives']}")
    mk_request = _request_maker(args, cfg, lengths)
    t0 = time.perf_counter()
    for i in range(len(lengths)):
        engine.submit(mk_request(i, deadline_s=1e9 if args.deadline_s is not None else None))
    engine.run_until_idle()
    compile_s = time.perf_counter() - t0
    _reset_serving_counters(engine)
    flight.reset()
    if sentry is not None:
        sentry.mark_steady()
    before = _kernel_counts()
    prompts, done = {}, []

    def submit(i):
        req = mk_request(len(lengths) + i)
        prompts[engine.submit(req)] = list(req.prompt)

    t0 = time.perf_counter()
    if args.qps > 0:
        arrivals, next_i = _arrivals(args), 0
        while next_i < len(arrivals):
            due = t0 + arrivals[next_i]
            if time.perf_counter() >= due:
                submit(next_i)
                next_i += 1
                continue
            if engine.idle:
                time.sleep(min(0.001, max(0.0, due - time.perf_counter())))
            else:
                done += engine.step()
    else:
        for i in range(args.requests):
            submit(i)
    done += engine.run_until_idle()  # its last step fetched its chain: the region is closed
    wall_s = time.perf_counter() - t0
    lat_h, ttft_h = flight.hist["e2e"], flight.hist["ttft"]
    toks = engine.generated_tokens
    receipt.update(
        **_stream_fields(args, lengths, window, cache_mb, wall_s, toks, compile_s, dev),
        server_completed=len(done),
        server_finish_reasons=sorted({c.finish_reason for c in done}),
        server_streams=_streams(prompts, done),
        server_chains=engine.n_chains, server_prefills=engine.n_prefills,
        server_host_syncs=engine.n_host_syncs,
        server_p50_latency_s=lat_h.quantile(0.50), server_p95_latency_s=lat_h.quantile(0.95),
        server_ttft_p50_s=ttft_h.quantile(0.50), server_ttft_p95_s=ttft_h.quantile(0.95),
        forwards=(engine.n_prefills + engine.n_splices
                  + engine.n_chains * engine.tokens_per_launch),
        decode_steps=engine.n_chains * engine.tokens_per_launch,
        kernels=_kernel_delta(before), **engine.stats(),
    )
    if args.flight_log:
        flight.dump(reason="end_of_stream")
        say(f"flight log -> {args.flight_log}")
    note = ""
    if engine.prefix is not None:
        st = engine.prefix_stats()
        note += (f", prefix hit rate {st['prefix_hit_rate']:.2f} ({engine.n_splices} splices, "
                 f"{engine.prefix_hit_tokens} tokens reused)")
    if args.spec_k:
        ss = engine.spec_stats()
        note += (f", spec-k {args.spec_k}: mean accepted {ss['spec_mean_accepted_len']:.2f}, "
                 f"{ss['n_verify_forwards']} verify forwards for {toks} tokens")
    if bank is not None:
        ast = engine.adapter_stats()
        note += (f", adapters: {ast['adapters_registered']}/{ast['n_adapters'] - 1} tenants "
                 f"(rank {ast['lora_rank']}), {ast['adapter_requests']} tenant requests")
    if args.deadline_s is not None:
        note += f", deadline {args.deadline_s}s: {engine.fault_stats()['deadline_expired']} expired"
    if args.pipeline_depth > 1 or args.prefill_chunk:
        ps = engine.pipeline_stats()
        note += (f", pipeline depth {ps['pipeline_depth']} (chunk {ps['prefill_chunk']}, "
                 f"{ps['n_chunks']} chunks)")
    if args.slo:
        st = engine.slo_stats()
        note += (f", slo: {st['priority_classes']} classes, {st['n_preemptions']} preemptions "
                 f"({st['n_swaps_out']} out / {st['n_swaps_in']} in)")
    if sentry is not None:
        sentry.uninstall()
        note += (f", sentry: {sentry.n_steady_recompiles} steady recompiles, fetched "
                 f"{sentry.n_fetched} of a budget of {sentry.n_budgeted}, "
                 f"{sentry.reupload_bytes} B re-uploaded")
    say(f"server: {args.requests} requests (prompts {lengths}, {args.new_tokens} new each) "
        f"over {args.slots} slots in {wall_s:.2f}s — {toks / wall_s:.1f} tok/s, p50 "
        f"{receipt['server_p50_latency_s']:.3f}s / p95 {receipt['server_p95_latency_s']:.3f}s a "
        f"request, ttft p50 {receipt['server_ttft_p50_s']:.3f}s, {engine.n_chains} chains + "
        f"{engine.n_prefills} prefills{note} (first launches {compile_s:.1f}s)")


if __name__ == "__main__":
    main()
    sys.exit(0)
