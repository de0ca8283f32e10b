"""The port's ``obs/trace.py`` StepReport and ``utils/profiling.py``
against the JAX package's, on the CPU.

- A synthetic trace in kineto's chrome layout, as a card's
  ``torch.profiler`` trace prints it: the GPU lane is a process named
  ``python`` whose ``process_labels`` say ``GPU 0``. The JAX
  ``device_op_durations`` looks for "GPU" in the process NAME, so on that
  layout it finds no device lane and returns nothing (pinned); with the
  lane renamed ``GPU 0`` both functions give equal totals, name by name.
  The port reads the kernel, memcpy and memset events by their category,
  and leaves a ``record_function``'s device span out.
- StepReport's category strings and ``to_dict`` keys are the JAX
  module's.
- Kernels are classified by the op that launched them (``External id``),
  the port's own by the symbol table (launches counted, none by name
  alone); a kernel known only by its name lands in ``heuristic_us``.
- A kernel whose launch the trace holds but whose device record it lost
  is listed (``lost_launches``); ``capture_report`` traces one call and
  reads the launch counters around it.
- A real CPU ``torch.profiler`` trace of a tiny ``TransformerLM`` step
  (weights through ``from_jax_params``): the categories sum to the total,
  the total plus the framework frames' time is every op's own time once
  (less than the ops' summed durations), at least 90% classified, matmul
  present.
"""

import glob
import gzip
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import TransformerConfig as JaxConfig
from pytorch_distributed_training_tutorials_tpu.models import TransformerLM as JaxLM
from pytorch_distributed_training_tutorials_tpu.obs import trace as jtrace
from pytorch_distributed_training_tutorials_tpu.utils import profiling as jprofiling
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs import trace as ttrace
from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import (
    COLLECTIVE_PREFIX,
    MATMUL,
    PORT_KERNELS,
    StepReport,
    classify_op,
    read_counters,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
    TrainState,
    _train_step_fn,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (name, dur, cat, launching op or None)
CARD_EVENTS = [
    ("void (anonymous namespace)::fwd_sm90_kernel<96>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Args)", 300.0, "kernel", "tpu_torch::flash_attention"),
    ("(anonymous namespace)::dw_sm90_kernel(CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::Args)", 200.0, "kernel", None),
    ("void (anonymous namespace)::adamw_kernel((anonymous namespace)::Table, "
     "(anonymous namespace)::Hyper, (anonymous namespace)::Scalars)", 120.0, "kernel", None),
    ("nvjet_tst_64x8_64x16_1x4_h_bz_NNT", 100.0, "kernel", "aten::mm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 90.0, "kernel",
     "aten::cudnn_convolution"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>", 80.0, "kernel",
     "aten::sum"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     70.0, "kernel", "aten::add_"),
    ("void at::native::bfloat16_copy_kernel_cuda", 60.0, "kernel", "aten::_to_copy"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::index_put_kernel>", 50.0,
     "kernel", "aten::index_put_"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 40.0,
     "kernel", "c10d::allreduce_"),
    ("Memcpy DtoD (Device -> Device)", 30.0, "gpu_memcpy", "aten::copy_"),
    ("Memset (Device)", 20.0, "gpu_memset", "aten::zero_"),
    ("ampere_sgemm_128x64_nn", 15.0, "kernel", None),  # known by its name alone
    ("my_mystery_kernel", 5.0, "kernel", None),
]


def _write_card_trace(logdir, events, gpu_process_name="python", annotation=False):
    """A trace in kineto's chrome layout: a CPU process with the launching
    ops (``cpu_op``, ``External id``), the GPU lane (process ``python``
    labelled ``GPU 0``, as a card's trace prints it) with the kernels."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 118, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 118, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": gpu_process_name}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7 "}},
    ]
    ts = 1000.0
    for i, (name, dur, cat, op) in enumerate(events, start=1):
        args = {"device": 0, "stream": 7, "correlation": 100 + i}
        if op is not None:
            ev.append({"ph": "X", "cat": "cpu_op", "name": op, "pid": 118, "tid": 118,
                       "ts": ts, "dur": 5.0, "args": {"External id": i}})
            args["External id"] = i
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts + 10,
                   "dur": dur, "args": args})
        ts += dur + 20
    if annotation:
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0,
                   "tid": 7, "ts": 1000.0, "dur": ts - 1000.0, "args": {}})
    os.makedirs(logdir, exist_ok=True)
    with gzip.open(os.path.join(logdir, "host_1.0.pt.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_card_layout_jax_reader_finds_no_lane_port_reads_every_event(tmp_path):
    logdir = str(tmp_path / "card")
    _write_card_trace(logdir, CARD_EVENTS)
    want = sum(d for _, d, _, _ in CARD_EVENTS)
    got = profiling.device_op_durations(logdir)
    assert sum(got.values()) == pytest.approx(want)
    assert list(got.values()) == sorted(got.values(), reverse=True)
    # the JAX reader looks for "GPU" in the process name; kineto puts it in
    # the labels, so the card's own layout gives the JAX function nothing
    assert jprofiling.device_op_durations(logdir) == {}


def test_gpu_named_lane_equal_totals_with_the_jax_reader(tmp_path):
    logdir = str(tmp_path / "named")
    _write_card_trace(logdir, CARD_EVENTS, gpu_process_name="GPU 0")
    got = profiling.device_op_durations(logdir)
    want = jprofiling.device_op_durations(logdir)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(sum(want.values()))


def test_device_span_of_a_record_function_is_left_out(tmp_path):
    logdir = str(tmp_path / "ann")
    _write_card_trace(logdir, CARD_EVENTS, gpu_process_name="GPU 0", annotation=True)
    got = profiling.device_op_durations(logdir)
    assert "step" not in got
    assert sum(got.values()) == pytest.approx(sum(d for _, d, _, _ in CARD_EVENTS))
    # the JAX reader sums every timed event of the lane, the span included
    assert "step" in jprofiling.device_op_durations(logdir)


def _with_launches(logdir, lost=0):
    """The card trace with a host launch event for each kernel (paired by
    ``correlation``), the first ``lost`` kernels' device records dropped."""
    _write_card_trace(logdir, CARD_EVENTS)
    path = os.path.join(logdir, "host_1.0.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        ev = json.load(f)["traceEvents"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    for k in kernels:
        args = {"correlation": k["args"]["correlation"]}
        if "External id" in k["args"]:
            args["External id"] = k["args"]["External id"]
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 118,
                   "tid": 118, "ts": k["ts"] - 5, "dur": 3.0, "args": args})
    for k in kernels[:lost]:
        ev.remove(k)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def test_lost_kernel_records_are_listed_and_the_capture_reads_counters(tmp_path, monkeypatch):
    _with_launches(str(tmp_path / "whole"))
    assert profiling.lost_launches(str(tmp_path / "whole")) == []
    _with_launches(str(tmp_path / "lossy"), lost=2)
    r = StepReport.from_trace(str(tmp_path / "lossy"))
    # the first two launches (at 0 and 0.32 ms) lost their kernels' records
    assert r.lost_launches == [(0.0, "tpu_torch::flash_attention"), (0.32, None)]
    assert r.port_launches == {"adamw": 1}
    # capture_report: one traced call in a fresh directory, removed after
    # it; the counters read around the call
    seen = []
    monkeypatch.setattr(fused_adamw, "launches", fused_adamw.launches)

    def record(logdir):
        seen.append(logdir)
        _with_launches(logdir)
        fused_adamw.launches += 1  # as the kernel's wrapper counts a launch
        return "measured"

    report, counted, recorded = ttrace.capture_report(record, steps=3)
    assert recorded == "measured" and report.steps == 3 and report.lost_launches == []
    assert report.port_launches == {"flash_fwd": 1, "fused_ce_dw": 1, "adamw": 1}
    assert counted == {"fused_adamw.launches": 1} == {
        k: v for k, v in report.counter_launches().items() if k.startswith("fused_adamw")}
    assert not any(os.path.exists(d) for d in seen)


def test_the_primer_is_left_out_of_every_reading(tmp_path):
    """A card window opens with a primer (``profiling.open_window``): its
    spin kernels and their launches, inside the PRIMER range, count
    nowhere — neither as device time nor, where their records are the
    lost ones, as lost launches."""
    logdir = str(tmp_path / "primed")
    _with_launches(logdir)
    path = os.path.join(logdir, "host_1.0.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        ev = json.load(f)["traceEvents"]
    ev.append({"ph": "X", "cat": "user_annotation", "name": profiling.PRIMER, "pid": 118,
               "tid": 118, "ts": 100.0, "dur": 50.0, "args": {}})
    for i in range(4):  # four primer launches; the first two records lost
        corr = 900 + i
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 118,
                   "tid": 118, "ts": 105.0 + 10 * i, "dur": 2.0, "args": {"correlation": corr}})
        if i >= 2:
            ev.append({"ph": "X", "cat": "kernel", "name": "at::cuda::spin_kernel(long)",
                       "pid": 0, "tid": 7, "ts": 110.0 + 10 * i, "dur": 1.0,
                       "args": {"correlation": corr}})
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    assert profiling.lost_launches(logdir) == []
    assert not any("spin" in name for name in profiling.device_op_durations(logdir))
    r = StepReport.from_trace(logdir)
    assert r.total_us == pytest.approx(sum(d for _, d, _, _ in CARD_EVENTS))


def test_category_strings_and_to_dict_keys_are_the_jax_modules(tmp_path):
    for name in ("CONVOLUTION", "MATMUL", "REDUCE", "COPY", "DUS", "ELEMENTWISE", "OTHER",
                 "COLLECTIVE_PREFIX"):
        assert getattr(ttrace, name) == getattr(jtrace, name), name
    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    with gzip.open(os.path.join(jdir, "fake.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/device:TPU:0"}},
            {"ph": "X", "pid": 7, "tid": 1, "name": "dot", "dur": 25.0, "ts": 0}]}, f)
    tdir = str(tmp_path / "port")
    _write_card_trace(tdir, CARD_EVENTS)
    jrep, trep = jtrace.StepReport.from_trace(jdir, steps=5), StepReport.from_trace(tdir, steps=5)
    assert set(trep.to_dict()) == set(jrep.to_dict())
    json.dumps(trep.to_dict())
    assert trep.to_dict()["steps"] == 5
    assert "ms/step" in trep.render(top=3)


def test_kernels_classified_by_launching_op_and_port_table(tmp_path):
    logdir = str(tmp_path / "card")
    _write_card_trace(logdir, CARD_EVENTS)
    r = StepReport.from_trace(logdir, steps=2)
    cats = {name: cat for name, _, cat in r.ops}
    by = {CARD_EVENTS[i][0]: c for i, c in enumerate([
        MATMUL, MATMUL, "elementwise", MATMUL, "convolution", "reduce", "elementwise",
        "convert/copy", "dynamic-update-slice", COLLECTIVE_PREFIX + "all-reduce",
        "convert/copy", "elementwise", MATMUL, "other"])}
    assert cats == by
    # the port's kernels by the symbol table: counted, under their counters
    assert r.port_launches == {"flash_fwd": 1, "fused_ce_dw": 1, "adamw": 1}
    assert r.counter_launches() == {"flash_attention.launches[fwd]": 1,
                                    "fused_cross_entropy.launches[dw]": 1,
                                    "fused_adamw.launches": 1}
    assert r.port_us == {"flash_fwd": 300.0, "fused_ce_dw": 200.0, "adamw": 120.0}
    assert r.port_unmatched == []
    # only the kernel with no op and no table entry is read from its name
    assert r.heuristic_us == pytest.approx(15.0)
    assert r.unplaced == {"ampere_sgemm_128x64_nn <- None": 15.0,
                          "my_mystery_kernel <- None": 5.0}
    assert r.unclassified_fraction == pytest.approx(5.0 / r.total_us)
    assert r.collective_us == {COLLECTIVE_PREFIX + "all-reduce": pytest.approx(40.0)}
    assert math.isclose(sum(r.by_category.values()), r.total_us)
    assert r.wrapper_us == 0.0 and r.step_us == pytest.approx(r.total_us / 2)
    assert "name-heuristic share" in r.render()


@pytest.mark.parametrize("kid,name", [
    ("flash_fwd", "void (anonymous namespace)::fwd_sm90_kernel<96>(CUtensorMap_st)"),
    ("flash_dq", "void (anonymous namespace)::dq_sm90_kernel<64>(CUtensorMap_st)"),
    ("flash_dkv", "void (anonymous namespace)::dkv_sm90_kernel<128>(CUtensorMap_st)"),
    ("flash_fwd_v1", "void (anonymous namespace)::fwd_kernel<float, 96>((anonymous "
                     "namespace)::Args)"),
    ("flash_dq_v1", "void (anonymous namespace)::dq_kernel<__nv_bfloat16, 64>(Args)"),
    ("flash_dkv_v1", "void (anonymous namespace)::dkv_kernel<float, 128>(Args)"),
    ("fused_ce_fwd", "(anonymous namespace)::fwd_sm90_kernel(CUtensorMap_st, CUtensorMap_st)"),
    ("fused_ce_dh", "(anonymous namespace)::dh_sm90_kernel(CUtensorMap_st, CUtensorMap_st)"),
    ("fused_ce_fwd_v1", "void (anonymous namespace)::fwd_kernel<float>((anonymous "
                        "namespace)::Args)"),
    ("fused_ce_dh_v1", "void (anonymous namespace)::dh_kernel<__nv_bfloat16>(Args)"),
    ("fused_ce_dw_v1", "void (anonymous namespace)::dw_kernel<float>(Args)"),
    ("int8_gemm", "void (anonymous namespace)::gemm_sm90_kernel<64, true>(CUtensorMap_st)"),
    ("int8_gemm_v1", "void (anonymous namespace)::gemm_tiles<true>(signed char const*)"),
    ("int8_quantize", "(anonymous namespace)::quantize_tiles(float const*, signed char*)"),
    ("paged_attention", "void (anonymous namespace)::paged_sm90_kernel<float, 0>(CUtensorMap_st)"),
    ("paged_attention_v1", "void (anonymous namespace)::paged_attention_kernel<float, 8>(float "
                           "const*)"),
])
def test_port_symbol_table_places_each_kernel(kid, name):
    assert ttrace.port_kernel(name)[0] == kid
    # a library's kernel in its own anonymous namespace is not the port's
    assert ttrace.port_kernel("void at::native::(anonymous namespace)::fwd_kernel<float>(x)") \
        is None


def test_only_a_port_symbol_the_table_misses_is_unmatched(tmp_path):
    logdir = str(tmp_path / "ns")
    _write_card_trace(logdir, [
        ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
         "at::native::arange_cuda_out(c10::Scalar const&)>(int)", 10.0, "kernel", "aten::arange"),
        ("void (anonymous namespace)::fwd_sm90_kernel<float, 96>(CUtensorMap_st)", 20.0,
         "kernel", None),
    ])
    r = StepReport.from_trace(logdir)
    assert r.port_unmatched == ["void (anonymous namespace)::fwd_sm90_kernel<float, 96>"
                                "(CUtensorMap_st)"]
    assert r.port_launches == {} and r.by_category["elementwise"] == 10.0


def test_counters_cover_the_table_and_read_on_the_cpu():
    counters = read_counters()
    named = {c for *_, c in PORT_KERNELS if c is not None}
    assert set(counters) == named
    assert all(isinstance(v, int) for v in counters.values())


@pytest.mark.parametrize("op,cat", [
    ("aten::mm", MATMUL), ("aten::addmm", MATMUL), ("aten::bmm", MATMUL),
    ("aten::cudnn_convolution", "convolution"), ("aten::convolution_backward", "convolution"),
    ("aten::native_batch_norm", "reduce"), ("aten::sum", "reduce"), ("aten::amax", "reduce"),
    ("aten::copy_", "convert/copy"), ("aten::_to_copy", "convert/copy"),
    ("aten::index_put_", "dynamic-update-slice"), ("aten::slice_scatter", "dynamic-update-slice"),
    ("aten::add_", "elementwise"), ("aten::_foreach_mul_", "elementwise"),
    ("aten::_foreach_norm", "reduce"), ("c10d::allreduce_", COLLECTIVE_PREFIX + "all-reduce"),
    ("c10d::_reduce_scatter_base_", COLLECTIVE_PREFIX + "reduce-scatter"),
    ("gloo:all_gather", COLLECTIVE_PREFIX + "all-gather"),
    ("nccl:all_to_all", COLLECTIVE_PREFIX + "all-to-all"),
    ("tpu_torch::flash_attention", MATMUL), ("aten::no_such_op", "other"),
])
def test_classify_op_tables(op, cat):
    assert classify_op(op) == cat


def _lm_step_trace(logdir):
    cfg = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, max_seq_len=32)
    jparams = JaxLM(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    tcfg = TransformerConfig(**cfg, quantized=False)
    model = TransformerLM(tcfg)
    bind_params(model, from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                       device="cpu"))
    state = TrainState.create(model=model, tx=adamw(1e-3))
    step = _train_step_fn("cross_entropy")
    toks = torch.as_tensor(np.random.Generator(np.random.PCG64(0)).integers(0, 64, (4, 17)))
    batch = (toks[:, :-1], toks[:, 1:])
    state, _ = step(state, batch)  # warm
    with profiling.trace(logdir, device="cpu"):
        for _ in range(2):
            state, m = step(state, batch)
    assert math.isfinite(float(m["loss"]))


def test_real_cpu_trace_of_a_transformer_step(tmp_path):
    logdir = str(tmp_path / "lm")
    _lm_step_trace(logdir)
    # the trace lands where the JAX package's glob looks
    assert glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True)
    r = StepReport.from_trace(logdir, steps=2)
    raw = profiling.device_op_durations(logdir)
    events = profiling.load_events(logdir)
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    assert r.total_us > 0 and r.wrapper_us > 0
    assert math.isclose(sum(r.by_category.values()), r.total_us, rel_tol=1e-9)
    assert math.isclose(r.total_us + r.wrapper_us, sum(raw.values()), rel_tol=1e-9)
    # each op counted for its own time: a wrapper's time inside its child
    # ops is not counted twice
    assert sum(raw.values()) < 0.9 * sum(e["dur"] for e in ops)
    linear = [e for e in ops if e["name"] == "aten::linear"]
    if linear:
        assert raw.get("aten::linear", 0.0) < sum(e["dur"] for e in linear)
    assert r.unclassified_fraction <= 0.10, r.render(top=15)
    assert r.fraction(MATMUL) > 0, r.render(top=15)
    assert r.heuristic_us == 0.0 and r.port_launches == {}
