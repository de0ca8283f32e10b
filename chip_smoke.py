#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100, sm_90a).

    python3 chip_smoke.py                 # every phase, from the repo root
    python3 chip_smoke.py --kernel-only   # phases 0-2: build, check, time

It drives the port (``pytorch_distributed_training_tutorials_tpu_torch``)
on the card and fails — non-zero exit, no result line — if a phase fails.
Every phase prints one JSON line:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. the build of every hand-written kernel from ``csrc/`` (seconds, ptxas);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: the max abs difference (expected 0) and CUDA-event times
   (median of 25 launches, L2 flushed before each) beside the bound;
3. a 2-layer model at the 1b preset's widths, on the card (kernel) against
   the CPU (plain version): logits and greedy tokens;
4. the slice: the 1b preset at full depth serving the ``--server`` stream
   of ``examples/serve_llm_int8.py`` (12 requests, prompts {16, 32, 48},
   32 new tokens, greedy) through ``ServeEngine(n_slots=4,
   tokens_per_launch=8)``, with the kernel-launch and host-sync counts
   checked and two requests held against ``generate``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Needs no network and one card. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "pytorch_distributed_training_tutorials_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# int8 tensor-core ops/s — the roofline every bound below is taken against
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# the 1b preset of examples/serve_llm_int8.py
PRESET_1B = dict(
    vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, d_ff=8192,
    max_seq_len=512,
)
# (K, N) of every int8 matmul of one 1b forward and its count per forward:
# q/k/v/o (16 layers x 4), gate/up (x 2), down, and the lm_head
DECODE_MIX = [((2048, 2048), 64), ((2048, 8192), 32), ((8192, 2048), 16),
              ((2048, 32000), 1)]
LIBRARY_NOTE = (
    "no single PyTorch call computes an int8 matmul with dynamic "
    "per-(row, 512-column tile) activation quantization and f32 "
    "accumulation across tiles (torch._int_mm takes one whole-K int8 "
    "product with no per-tile scales)"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(m: int, k: int, n: int) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, ops) of one int8_matmul call: x read in
    f32, the int8 weight and f32 scales read once, the f32 output written
    once; 2*M*N*K int8 operations."""
    nbytes = m * k * 4 + k * n + n * 4 + m * n * 4
    ops = 2.0 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def time_ms(fn, torch, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, the L2 cache
    flushed (a 256 MB write) before each, outside the timed region."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, quant, gpu: str) -> dict:
    """Phase 2: the kernel against its plain version at every listed shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    shapes = [(m, k, n) for m in (1, 4, 16, 32, 64)
              for (k, n) in ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32000))]
    shapes.append((3, 200, 130))  # ragged M and N, K padded to a 256 tile
    shapes.append((5, 201, 67))  # K % 4 != 0: the kernel's byte-load path
    results = {}
    max_err = 0.0
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=dev)
        wq = quant.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        w = quant.Int8Param(q=wq.q.t().contiguous().t(), scale=wq.scale)
        got = quant.int8_matmul(x, w)
        want = quant.int8_matmul_reference(x, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_bad = int((got != want).sum())
        # expected bitwise; the only admissible difference is a double
        # rounding of the plain version's float64 fma (a few float32 ulps)
        tol = 4 * 2.0**-24 * float(want.abs().max())
        if not err <= tol:
            raise AssertionError(
                f"int8_matmul kernel != plain at M={m} K={k} N={n}: max abs "
                f"err {err} > {tol} ({n_bad} elements differ)"
            )
        max_err = max(max_err, err)
        ms = time_ms(lambda: quant.int8_matmul(x, w), torch, flush)
        plain_ms = time_ms(lambda: quant.int8_matmul_reference(x, w), torch, flush)
        b_ms, b_by, nbytes, ops = bound(m, k, n)
        results[(m, k, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
        emit({
            "phase": "kernel_vs_plain", "kernel": "int8_matmul",
            "M": m, "K": k, "N": n, "block_k": quant.block_k_for(k),
            "max_abs_err": err, "n_mismatch": n_bad, "tolerance": tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "roofline_share": b_ms / ms,
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
            "library_ms": None, "library_note": LIBRARY_NOTE, "gpu": gpu,
        })
    return {"results": results, "max_abs_err": max_err}


def phase_model(torch, gpu: str) -> None:
    """Phase 3: a 2-layer model at the 1b widths, card against CPU."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        KVCache,
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_quantized_lm,
    )

    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": 2}, quantized=True)
    params = init_quantized_lm(cfg, seed=1, device="cuda")
    on_card, on_cpu = TransformerLM(cfg), TransformerLM(cfg)
    bind_params(on_card, params)
    bind_params(on_cpu, {k: v.cpu() for k, v in params.items()})
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (8, 1, 1), generator=g)
    caches = {d: KVCache.zeros(cfg, 1, device=d) for d in ("cuda", "cpu")}
    outs = {"cuda": [], "cpu": []}
    for dev, model in (("cuda", on_card), ("cpu", on_cpu)):
        outs[dev].append(model(prompt.to(dev), caches[dev], prefill=True)[:, -1])
        for tok in steps:  # teacher-forced: both sides read the same tokens
            outs[dev].append(model(tok.to(dev), caches[dev], decode=True)[:, -1])
    # card vs CPU differ in transcendental ulps (cos/sin/exp/pow of two
    # libms); a one-ulp change of an activation can move its int8 code by
    # one step (1/127 of the tile's absmax), which the tolerance covers
    max_diff, scale, greedy_checked, greedy_equal = 0.0, 0.0, 0, 0
    per_step = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a = a.cpu()
        d = float((a - b).abs().max())
        per_step.append(d)
        max_diff, scale = max(max_diff, d), max(scale, float(b.abs().max()))
    tol = 2e-2 * scale
    for a, b in zip(outs["cuda"], outs["cpu"]):
        top2 = b.topk(2, dim=-1).values[0]
        if float(top2[0] - top2[1]) > tol:
            greedy_checked += 1
            greedy_equal += int(int(a.argmax()) == int(b.argmax()))
    ok = max_diff <= tol and greedy_equal == greedy_checked
    emit({
        "phase": "model_card_vs_cpu", "layers": 2, "widths": "1b",
        "prefill_tokens": 32, "decode_steps": 8,
        "max_abs_diff": max_diff, "per_step_max_abs_diff": per_step,
        "logit_max_abs": scale, "tolerance": tol,
        "greedy_checked": greedy_checked, "greedy_equal": greedy_equal,
        "ok": ok, "gpu": gpu,
    })
    if not ok:
        raise AssertionError("model logits on the card disagree with the CPU")


def percentile(vals, q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def profile_chain(torch, engine, mk_request, gpu: str) -> None:
    """Where a decode chain's time goes: ``torch.profiler`` over one
    ``step()`` that runs a chain of ``tokens_per_launch`` decode steps on 4
    active slots (no prefill inside). Device time by kernel name, the
    device's busy and idle share of the step's wall time, kernels per
    decode step."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(engine.n_slots):
        engine.submit(mk_request(100 + i))
    engine.step()  # the prefills and a first chain, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run_until_idle()
    events = prof.key_averages()
    kernels = [
        e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    cpu_ops = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda e: -e.self_cpu_time_total,
    )[:10]
    emit({
        "phase": "profile_decode_chain", "decode_steps": engine.tokens_per_launch,
        "slots_active": engine.n_slots, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_decode_step":
            sum(e.count for e in kernels) / engine.tokens_per_launch,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
        "top_host_ops_self_ms": {
            e.key[:80]: [e.self_cpu_time_total / 1e3, e.count] for e in cpu_ops
        },
        "gpu": gpu,
    })


def phase_serve(torch, quant, gpu: str) -> int:
    """Phase 4: the 1b preset at full depth through ServeEngine. Returns
    the kernel launches of the timed stream."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        generate,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    cfg = TransformerConfig(**PRESET_1B, quantized=True)
    t0 = time.perf_counter()
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = TransformerLM(cfg)
    n_slots, tpl, new, n_req = 4, 8, 32, 12
    engine = ServeEngine(model, params, n_slots=n_slots, tokens_per_launch=tpl,
                         max_queue=64, device="cuda")
    window = cfg.max_seq_len
    lengths = sorted({16, min(32, window - new), min(48, window - new)})
    rng = np.random.Generator(np.random.PCG64(11))

    def mk_request(i: int) -> Request:
        p_len = lengths[i % len(lengths)]
        prompt = rng.integers(0, cfg.vocab_size, (p_len,)).tolist()
        return Request(prompt=prompt, max_new_tokens=new, seed=i)

    engine.submit(mk_request(0))  # warmup: first launches, cuBLAS handles
    engine.run_until_idle()
    torch.cuda.synchronize()
    base = (engine.n_prefills, engine.n_chains, engine.n_host_syncs)
    torch.cuda.reset_peak_memory_stats()
    reqs = [mk_request(len(lengths) + i) for i in range(n_req)]
    quant.int8_matmul.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = quant.int8_matmul.launches
    prefills = engine.n_prefills - base[0]
    chains = engine.n_chains - base[1]
    syncs = engine.n_host_syncs - base[2]
    peak = torch.cuda.max_memory_allocated()
    forwards = prefills + chains * tpl
    per_forward = 16 * 7 + 1
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} completions for {n_req} requests")
    for c in done:
        if c.finish_reason != "length" or len(c.tokens) != new:
            raise AssertionError(
                f"request {c.request_id}: {c.finish_reason} with "
                f"{len(c.tokens)} tokens, want length with {new}"
            )
    if launches != per_forward * forwards:
        raise AssertionError(
            f"int8_matmul launched {launches} times, want {per_forward} x "
            f"({prefills} prefills + {chains} chains x {tpl}) = "
            f"{per_forward * forwards}"
        )
    if syncs != chains + prefills:
        raise AssertionError(
            f"{syncs} host syncs != {chains} chains + {prefills} prefills"
        )
    by_id = {c.request_id: c for c in done}
    checked = []
    for r in reqs[:2]:
        ref = generate(model, None, [r.prompt], new, device="cuda")
        ref = ref[0, len(r.prompt):].tolist()
        if by_id[r.request_id].tokens != ref:
            raise AssertionError(
                f"request {r.request_id}: engine {by_id[r.request_id].tokens} "
                f"!= generate {ref}"
            )
        checked.append(r.request_id)
    profile_chain(torch, engine, mk_request, gpu)
    toks = sum(len(c.tokens) for c in done)
    lat = [c.latency_s for c in done]
    ttft = [c.ttft_s for c in done]
    emit({
        "phase": "serve_1b", "preset": "1b", "layers": cfg.n_layers,
        "n_slots": n_slots, "tokens_per_launch": tpl, "requests": n_req,
        "prompt_lengths": lengths, "new_tokens": new,
        "completed": len(done), "generated_tokens": toks,
        "prefills": prefills, "chains": chains, "decode_steps": chains * tpl,
        "int8_matmul_launches": launches,
        "launches_per_forward": per_forward, "host_syncs": syncs,
        "checked_vs_generate": checked,
        "wall_s": wall_s, "aggregate_tok_s": toks / wall_s,
        "latency_p50_s": percentile(lat, 0.5),
        "latency_p95_s": percentile(lat, 0.95),
        "ttft_p50_s": percentile(ttft, 0.5),
        "ttft_p95_s": percentile(ttft, 0.95),
        "max_memory_allocated_bytes": peak, "weights_init_s": init_s,
        "gpu": gpu,
    })
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 2 (build, check and time the kernels)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pytorch_distributed_training_tutorials_tpu_torch.ops import _build, quant

    # plain float32 matmuls stay float32 on the card (TF32 off, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    emit({
        "phase": "device", "nvidia_smi": gpu, "torch": torch.__version__,
        "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    })

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "kernels": {
            name: {
                "seconds": v["seconds"],
                "ptxas": [ln.strip() for ln in v["log"].splitlines()
                          if "registers" in ln or "spill" in ln],
            }
            for name, v in info.items()
        },
    })

    kern = phase_kernels(torch, quant, gpu)
    if args.kernel_only:
        return 0
    phase_model(torch, gpu)
    launches = phase_serve(torch, quant, gpu)

    # the kernels line: one decode forward's 113 int8 matmuls at M = 4
    # (the slot count) — time, plain time and bound summed over the mix
    res = kern["results"]
    ms = sum(res[(4, k, n)]["ms"] * c for (k, n), c in DECODE_MIX)
    plain_ms = sum(res[(4, k, n)]["plain_ms"] * c for (k, n), c in DECODE_MIX)
    nbytes = sum(bound(4, k, n)[2] * c for (k, n), c in DECODE_MIX)
    ops = sum(bound(4, k, n)[3] * c for (k, n), c in DECODE_MIX)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    emit({"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": f"{PKG}/csrc/int8_matmul.cu",
        "replaces": "pytorch_distributed_training_tutorials_tpu/ops/quant.py:141",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "work": "one 1b decode forward: 113 calls at M=4",
    }]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
