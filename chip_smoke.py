#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100, sm_90a).

    python3 chip_smoke.py                 # every phase, from the repo root
    python3 chip_smoke.py --kernel-only   # phases 0-2: build, check, time

It drives the port (``pytorch_distributed_training_tutorials_tpu_torch``)
on the card and fails — non-zero exit, no result line — if a phase fails.
Every phase prints JSON lines:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. the build of every hand-written kernel from ``csrc/`` (one ``nvcc`` per
   source, all started together; seconds, ptxas);
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: the max abs difference against a stated tolerance and
   CUDA-event times (median of 25 launches, L2 flushed before each) beside
   the bound and, where one PyTorch call computes the same function, its
   time — ``int8_matmul`` (expected bitwise), then ``flash_fwd``,
   ``flash_dq`` and ``flash_dkv`` at the 760m train shape (B 2, S 2048, H
   16, D 96) in bf16 and f32, D 64 and 128, a ragged S 1000 (strided
   inputs) and S 8, each output held element by element to the bound of
   ``ops.flash_attention.KERNEL_TOLERANCE``;
3. serving: a 2-layer model at the 1b preset's widths, on the card (kernel)
   against the CPU (plain version): logits and greedy tokens;
4. the serving slice: the 1b preset at full depth serving the ``--server``
   stream of ``examples/serve_llm_int8.py`` (12 requests, prompts {16, 32,
   48}, 32 new tokens, greedy) through ``ServeEngine(n_slots=4,
   tokens_per_launch=8)``, with the kernel-launch and host-sync counts
   checked and two requests held against ``generate``;
5. training: a 2-layer model at the 760m preset's widths, S 256, flash
   attention, in float32 and bfloat16, on the card (kernels) against the
   CPU (plain versions): the loss and every gradient;
6. the train slice: the port's ``bench.lm_headline`` default arm (760m at
   full depth and width, seq 2048, batch 2, bf16, flash, remat "dots",
   AdamW) for a warmup chain and 2 timed chains of 6 steps and one
   profiled step: finite, falling loss, exactly 48 / 24 / 24 flash
   forward / dq / dk-dv launches per step, step time, MFU, peak memory.

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

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8
# and bf16 tensor-core ops/s, float32 outside the tensor cores — the
# roofline every bound below is taken against
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# the 760m preset of bench/lm_headline.py
PRESET_760M = dict(vocab_size=32768, d_model=1536, n_layers=24, n_heads=16)
N_PARAMS_760M = 1_006_708_224
# flash launches per 760m train step: 24 layers, the forward run twice
# (remat "dots" recomputes it in the backward), one dq and one dk/dv
FLASH_PER_STEP = {"fwd": 48, "dq": 24, "dkv": 24}
# (B, S, H, D, dtype, strided) of the flash checks; the first is the main
# shape of the 760m train step
FLASH_SHAPES = [
    (2, 2048, 16, 96, "bf16", False),
    (2, 2048, 16, 96, "f32", False),
    (2, 2048, 16, 64, "bf16", False),
    (2, 2048, 16, 128, "bf16", False),
    (2, 1000, 16, 96, "bf16", True),
    (2, 8, 16, 96, "bf16", False),
]
FLASH_REPLACES = {
    "fwd": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:50",
    "dq": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:113",
    "dkv": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:157",
}
# products of B*H*S(S+1)/2*D multiply-adds each kernel runs (causal work)
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}

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


def flash_bound(kind: str, b: int, s: int, h: int, d: int, elem: int,
                flops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of one flash kernel call: its causal products
    (2 FLOPs per multiply-add over the S(S+1)/2 query-key pairs) at the
    card's peak for the input type, against its bytes — each (B, S, H, D)
    input read once, each output written once, the f32 (B, H, S) lse and
    delta."""
    pairs = b * h * s * (s + 1) / 2
    ops = FLASH_PRODUCTS[kind] * 2.0 * pairs * d
    t = b * s * h * d * elem
    row = b * h * s * 4
    nbytes = {"fwd": 4 * t + row, "dq": 5 * t + 2 * row, "dkv": 6 * t + 2 * row}[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash(torch, fa, gpu: str) -> dict:
    """Phase 2 (flash): the forward, dq and dk/dv kernels against their
    plain versions on the same inputs, at every shape of FLASH_SHAPES."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    blocks = (1024, 1024)  # the bench's --block_q/--block_k: the plain blocks
    results, max_err = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    worst = dict(max_err)  # the largest error-to-bound ratio
    for i, (b, s, h, d, dt, strided) in enumerate(FLASH_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(10 + i)

        def draw():
            if strided:  # (B, H, S, D) storage seen as (B, S, H, D)
                return torch.randn((b, h, s, d), generator=gen, device=dev,
                                   dtype=dtype).transpose(1, 2)
            return torch.randn((b, s, h, d), generator=gen, device=dev, dtype=dtype)

        q, k, v, do = draw(), draw(), draw(), draw()
        o, lse = fa.flash_fwd(q, k, v)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, *blocks)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_dq(q, k, v, do, lse, delta)
        dq_ref = fa.flash_dq_reference(q, k, v, do, lse, delta, *blocks)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
        dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, *blocks)
        torch.cuda.synchronize()
        # each output held element by element to fa.KERNEL_TOLERANCE
        errs = {}
        for name, got, want in (("O", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            errs[name] = fa.kernel_error(got, want)
            if not errs[name]["worst_ratio"] <= 1.0:
                raise AssertionError(
                    f"flash {name} kernel != plain at B={b} S={s} H={h} D={d} {dt}: "
                    f"{errs[name]}"
                )
        for kind, names in (("fwd", ("O", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            max_err[kind] = max(max_err[kind], *(errs[n]["max_abs_err"] for n in names))
            worst[kind] = max(worst[kind], *(errs[n]["worst_ratio"] for n in names))
        # the library yardstick: SDPA on (B, H, S, D) copies, never used by the port
        ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        dol = do.transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        timed = {
            "fwd": (lambda: fa.flash_fwd(q, k, v),
                    lambda: fa.flash_fwd_reference(q, k, v, *blocks),
                    lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)),
            "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                   lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, *blocks),
                   lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), dol, retain_graph=True)),
            "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                    lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, *blocks),
                    None),
        }
        flops = BF16_FLOPS if dt == "bf16" else F32_FLOPS
        for kind, (kern, plain, lib) in timed.items():
            ms = time_ms(kern, torch, flush)
            plain_ms = time_ms(plain, torch, flush)
            lib_ms = time_ms(lib, torch, flush) if lib is not None else results[
                (i, "dq")]["library_ms"]
            b_ms, b_by = flash_bound(kind, b, s, h, d, q.element_size(), flops)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
            results[(i, kind)] = row
            emit({
                "phase": "kernel_vs_plain", "kernel": f"flash_{kind}",
                "B": b, "S": s, "H": h, "D": d, "dtype": dt, "strided_inputs": strided,
                "errors": {n: errs[n] for n in {"fwd": ("O", "lse"), "dq": ("dq",),
                                                "dkv": ("dk", "dv")}[kind]},
                **row, "roofline_share": b_ms / ms,
                "library": "F.scaled_dot_product_attention(is_causal=True)"
                           + (" forward" if kind == "fwd" else
                              " backward (dq, dk, dv in one call; the same number "
                              "stands for flash_dq and flash_dkv)"),
                "gpu": gpu,
            })
        del ql, kl, vl, sdpa_out
    return {"results": results, "max_abs_err": max_err, "worst_ratio": worst}


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


def phase_train_card_vs_cpu(torch, gpu: str) -> None:
    """Phase 5: a 2-layer model at the 760m widths, S 256, flash attention,
    in float32 and in bfloat16 (the train step's compute type): the loss
    and every gradient on the card (kernels, TF32 off) against the CPU
    (plain versions), on the same weights and tokens."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _compute_loss

    seq = 256
    rng = np.random.Generator(np.random.PCG64(6))
    toks = torch.as_tensor(rng.integers(0, PRESET_760M["vocab_size"], (2, seq + 1)),
                           dtype=torch.int64)
    # float32: sums in other orders (cuBLAS against oneDNN over up to 6144
    # terms, the kernels' 64-key tiles against the plain 256-key block):
    # 1e-5 relative on the loss, 1e-3 of each gradient's largest entry.
    # bfloat16: both sides round every activation, p and ds to bf16 from f32
    # sums taken in other orders; a flipped rounding (2^-8 of a value)
    # travels through two layers and back: 2^-10 relative on the loss, and
    # each gradient's error norm within 2^-5 of its norm
    tols = {
        torch.float32: {"loss_rel": 1e-5, "grad_rel_to_max": 1e-3},
        torch.bfloat16: {"loss_rel": 2.0 ** -10, "grad_rel_norm": 2.0 ** -5},
    }
    for dtype, tol in tols.items():
        cfg = TransformerConfig(**{**PRESET_760M, "n_layers": 2}, max_seq_len=seq, dtype=dtype,
                                attention_fn=make_flash_attention(1024, 1024), quantized=False)
        params = init_lm(cfg, seed=5, device="cpu")
        out = {}
        before = dict(flash_attention.launches)
        for dev in ("cuda", "cpu"):
            model = TransformerLM(cfg)
            bind_params(model, {k: v.to(dev) for k, v in params.items()})
            x, y = toks[:, :-1].to(dev), toks[:, 1:].to(dev)
            named = list(model.named_parameters())
            loss = _compute_loss("cross_entropy", model(x), y)
            grads = torch.autograd.grad(loss, [p for _, p in named])
            out[dev] = (float(loss.detach()),
                        {n: g.double().cpu() for (n, _), g in zip(named, grads)})
        launched = {k: flash_attention.launches[k] - before[k] for k in before}
        if launched != {"fwd": 2, "dq": 2, "dkv": 2}:
            raise AssertionError(f"card side launched {launched}, want 2 of each")
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        worst_max, worst_norm = (0.0, ""), (0.0, "")
        for name, g_cpu in out["cpu"][1].items():
            diff = out["cuda"][1][name] - g_cpu
            worst_max = max(worst_max, (float(diff.abs().max() / g_cpu.abs().max()), name))
            worst_norm = max(worst_norm, (float(diff.norm() / g_cpu.norm()), name))
        grad_err = worst_max[0] if "grad_rel_to_max" in tol else worst_norm[0]
        ok = (loss_err <= tol["loss_rel"] * abs(out["cpu"][0])
              and grad_err <= tol.get("grad_rel_to_max", tol.get("grad_rel_norm")))
        emit({
            "phase": "train_card_vs_cpu", "layers": 2, "widths": "760m", "seq": seq,
            "batch": 2, "dtype": str(dtype).removeprefix("torch."), "attention": "flash",
            "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0], "loss_abs_err": loss_err,
            "grad_worst_rel_to_max": worst_max[0], "grad_worst_rel_to_max_param": worst_max[1],
            "grad_worst_rel_norm": worst_norm[0], "grad_worst_rel_norm_param": worst_norm[1],
            "tolerance": tol, "flash_launches": launched, "ok": ok, "gpu": gpu,
        })
        if not ok:
            raise AssertionError(
                f"{dtype} training loss or gradients on the card disagree with the CPU")


def phase_train(torch, gpu: str) -> dict:
    """Phase 6: the 760m train step through the port's bench entry point,
    with the flash launch counts of exactly this run."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    argv = ["--steps", "6", "--reps", "2", "--trace"]
    args = lm_headline.parse(argv)
    for k in flash_attention.launches:
        flash_attention.launches[k] = 0
    r = lm_headline.measure(args)
    launches = dict(flash_attention.launches)
    steps = r["steps_run"]
    losses = r["losses_first_chain"]
    problems = []
    if not r["all_losses_finite"]:
        problems.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall over the first chain: {losses}")
    want = {k: n * steps for k, n in FLASH_PER_STEP.items()}
    if launches != want:
        problems.append(f"flash launches {launches} != {want} ({steps} steps)")
    if r["n_params"] != N_PARAMS_760M:
        problems.append(f"n_params {r['n_params']} != {N_PARAMS_760M}")
    emit({
        "phase": "train_760m", "argv": argv,
        "note": "6 chained steps and 2 timed chains (the bench default is 12 and 3) "
                "to fit the smoke's time",
        "flash_launches": launches, "launches_per_step": {
            k: v / steps for k, v in launches.items()},
        **{k: r[k] for k in (
            "preset", "n_layers", "d_model", "seq", "batch", "attn", "remat_policy",
            "n_params", "steps_run", "losses_first_chain", "step_ms", "chain_ms_samples",
            "wall_s_samples", "tokens_per_s", "model_tflops_per_step", "mfu",
            "peak_memory_bytes", "init_s", "trace")},
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
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
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )

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
    flash = phase_flash(torch, fa, gpu)
    if args.kernel_only:
        return 0
    phase_model(torch, gpu)
    launches = phase_serve(torch, quant, gpu)
    phase_train_card_vs_cpu(torch, gpu)
    train_launches = phase_train(torch, gpu)

    # the kernels line: one decode forward's 113 int8 matmuls at M = 4
    # (the slot count) — time, plain time and bound summed over the mix
    res = kern["results"]
    ms = sum(res[(4, k, n)]["ms"] * c for (k, n), c in DECODE_MIX)
    plain_ms = sum(res[(4, k, n)]["plain_ms"] * c for (k, n), c in DECODE_MIX)
    nbytes = sum(bound(4, k, n)[2] * c for (k, n), c in DECODE_MIX)
    ops = sum(bound(4, k, n)[3] * c for (k, n), c in DECODE_MIX)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    kernels = [{
        "name": "int8_matmul", "route": "cuda",
        "source": f"{PKG}/csrc/int8_matmul.cu",
        "replaces": "pytorch_distributed_training_tutorials_tpu/ops/quant.py:141",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "work": "one 1b decode forward: 113 calls at M=4",
    }]
    # the flash kernels: one 760m train step's launches at the main shape
    # (FLASH_SHAPES[0]), times, bound and library time summed over them
    for kind, per_step in FLASH_PER_STEP.items():
        row = flash["results"][(0, kind)]
        kernels.append({
            "name": f"flash_{kind}", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[kind],
            "launches": train_launches[kind], "max_abs_err": flash["max_abs_err"][kind],
            "worst_ratio": flash["worst_ratio"][kind],
            "ms": row["ms"] * per_step, "plain_ms": row["plain_ms"] * per_step,
            "bound_ms": row["bound_ms"] * per_step, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"] * per_step,
            "work": f"one 760m train step: {per_step} calls at B=2 S=2048 H=16 D=96 bf16",
            "library_note": "F.scaled_dot_product_attention(is_causal=True) "
                            + ("forward" if kind == "fwd" else
                               "backward, one number for flash_dq and flash_dkv "
                               "together (it computes dq, dk and dv in one call)"),
        })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
