"""Trace classification: where the step's device time went (port of the
JAX package's ``obs/trace.py``).

:class:`StepReport` grows :func:`..utils.profiling.device_events` into a
categorized breakdown — convolution / matmul / collectives split by kind
/ dynamic-update-slice / convert-copy / reduce / elementwise — under the
JAX module's category strings, which receipts and tests read.

The JAX module classifies an XLA fusion by what its fused computation in
the HLO contains, never by its display name. A ``torch.profiler`` trace
has no HLO; its own correlation plays that part. Every kernel event's
``External id`` names the op that launched it (:func:`..utils.profiling.
device_events`), so a kernel is classified by that op: ``aten::mm`` /
``addmm`` / ``bmm`` -> matmul, ``aten::cudnn_convolution`` ->
convolution, ``aten::sum`` / ``amax`` / the batch-norm ops -> reduce,
``aten::copy_`` / ``_to_copy`` -> convert/copy, ``aten::index_put_`` /
``slice_scatter`` -> dynamic-update-slice, the NCCL and gloo collectives
by kind. (``hlo=`` has no torch meaning and is gone.)

The port's own kernels launch through ``ctypes`` (``ops/_build.py``), so
no op is sure to enclose them: they are classified from
:data:`PORT_KERNELS`, a table of the ``csrc/`` kernel symbols and what
each computes, and counted in ``port_launches``. A kernel that neither
the table nor its op places is classified from its name alone (a cuBLAS
``gemm``, an NCCL ``AllReduce``) and its time is tallied in
``heuristic_us``, as the JAX report tallies a fusion read without HLO:
a report that leans on guessed names says so.

On the CPU (the tests) each ``cpu_op``'s own time stands for device
time; the autograd engine's and its nodes' frames (``autograd::...``,
``MmBackward0``) are bookkeeping around their child ops and count as
``wrapper_us``, as the JAX report's executor and region wrappers do.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from pytorch_distributed_training_tutorials_tpu_torch.utils.profiling import (
    device_events,
    load_events,
    lost_launches,
)

# Category names (stable strings: they appear in receipts and tests).
CONVOLUTION = "convolution"
MATMUL = "matmul"
REDUCE = "reduce"
COPY = "convert/copy"
DUS = "dynamic-update-slice"
ELEMENTWISE = "elementwise"
OTHER = "other"
COLLECTIVE_PREFIX = "collective:"

# the port's hand-written kernels (csrc/, each in an anonymous namespace):
# (id, pattern on the demangled kernel name, what it computes, the launch
# counter it adds to — "module.counter[key]", None: counted by no wrapper).
# Two sources share a symbol (fwd_kernel, fwd_sm90_kernel, quantize_tiles):
# flash's kernels are templated on the head width, the fused loss's are not
# (sm90) or on the element type alone (sm80); both quantize_tiles compute
# the same thing. quantize_tiles is a reduce: each (row, 512-column) tile's
# absmax, then the tile scaled and rounded to int8 — the reduce ranks
# first, as the JAX classifier ranks a fusion whose body holds a reduce.
_NS = r"^(?:void )?\(anonymous namespace\)::"
PORT_KERNELS = (
    ("flash_fwd", _NS + r"fwd_sm90_kernel<\d+>", MATMUL, "flash_attention.launches[fwd]"),
    ("flash_dq", _NS + r"dq_sm90_kernel<\d+>", MATMUL, "flash_attention.launches[dq]"),
    ("flash_dkv", _NS + r"dkv_sm90_kernel<\d+>", MATMUL, "flash_attention.launches[dkv]"),
    ("flash_fwd_v1", _NS + r"fwd_kernel<[^<>,]+, ?\d+>", MATMUL, "flash_attention.launches[fwd]"),
    ("flash_dq_v1", _NS + r"dq_kernel<[^<>,]+, ?\d+>", MATMUL, "flash_attention.launches[dq]"),
    ("flash_dkv_v1", _NS + r"dkv_kernel<[^<>,]+, ?\d+>", MATMUL, "flash_attention.launches[dkv]"),
    ("fused_ce_fwd", _NS + r"fwd_sm90_kernel\(", MATMUL, "fused_cross_entropy.launches[fwd]"),
    ("fused_ce_dh", _NS + r"dh_sm90_kernel\(", MATMUL, "fused_cross_entropy.launches[dh]"),
    ("fused_ce_dw", _NS + r"dw_sm90_kernel\(", MATMUL, "fused_cross_entropy.launches[dw]"),
    ("fused_ce_fwd_v1", _NS + r"fwd_kernel<[^<>,]+>", MATMUL, "fused_cross_entropy.launches[fwd]"),
    ("fused_ce_dh_v1", _NS + r"dh_kernel<[^<>,]+>", MATMUL, "fused_cross_entropy.launches[dh]"),
    ("fused_ce_dw_v1", _NS + r"dw_kernel<[^<>,]+>", MATMUL, "fused_cross_entropy.launches[dw]"),
    ("int8_gemm", _NS + r"gemm_sm90_kernel\b", MATMUL, "int8_matmul.launches"),
    ("int8_gemm_v1", _NS + r"gemm_tiles\b", MATMUL, "int8_matmul.launches"),
    ("int8_quantize", _NS + r"quantize_tiles\b", REDUCE, None),
    ("paged_attention", _NS + r"paged_sm90_kernel\b", MATMUL, "paged_attention.launches"),
    ("paged_attention_v1", _NS + r"paged_attention_kernel\b", MATMUL,
     "paged_attention.launches"),
    ("adamw", _NS + r"adamw_kernel\b", ELEMENTWISE, "fused_adamw.launches"),
)
_PORT = [(kid, re.compile(pat), cat) for kid, pat, cat, _ in PORT_KERNELS]
# every __global__ symbol of csrc/: a kernel named so that no table row
# places (another template form) is the port's, unmatched. PyTorch has
# kernels of its own in a top-level anonymous namespace too (arange's
# elementwise_kernel_with_index), so the namespace alone says nothing
_PORT_SYMBOLS = re.compile(_NS + r"(fwd_kernel|dq_kernel|dkv_kernel|dh_kernel|dw_kernel|"
                           r"fwd_sm90_kernel|dq_sm90_kernel|dkv_sm90_kernel|dh_sm90_kernel|"
                           r"dw_sm90_kernel|gemm_tiles|gemm_sm90_kernel|quantize_tiles|"
                           r"paged_attention_kernel|paged_sm90_kernel|adamw_kernel)\b")
# where each launch counter lives: function name -> module under the package
_COUNTER_HOMES = {"flash_attention": "ops.flash_attention",
                  "fused_cross_entropy": "ops.fused_loss", "int8_matmul": "ops.quant",
                  "paged_attention": "ops.paged_attention", "fused_adamw": "ops.fused_optim"}


def read_counters() -> dict[str, int]:
    """Every launch counter :data:`PORT_KERNELS` names, read now, under its
    name there (``"flash_attention.launches[fwd]"``, ``"fused_adamw.launches"``)."""
    import importlib

    out: dict[str, int] = {}
    for _, _, _, counter in PORT_KERNELS:
        if counter is None or counter in out:
            continue
        fn_name, attr = counter.split(".", 1)
        mod = importlib.import_module(
            f"pytorch_distributed_training_tutorials_tpu_torch.{_COUNTER_HOMES[fn_name]}")
        count = getattr(mod, fn_name).launches
        key = attr[len("launches"):].strip("[]")
        out[counter] = count[key] if key else count
    return out

# collective kinds, by the normalized op or kernel name (lower case, no
# "_"): reduce-scatter before all-reduce ("reducescatter" holds no
# "allreduce", but a fused name might hold both)
_COLLECTIVES = (
    ("reducescatter", COLLECTIVE_PREFIX + "reduce-scatter"),
    ("allreduce", COLLECTIVE_PREFIX + "all-reduce"),
    ("allgather", COLLECTIVE_PREFIX + "all-gather"),
    ("alltoall", COLLECTIVE_PREFIX + "all-to-all"),
    ("broadcast", COLLECTIVE_PREFIX + "broadcast"),
    ("send", COLLECTIVE_PREFIX + "permute"),
    ("recv", COLLECTIVE_PREFIX + "permute"),
    ("barrier", COLLECTIVE_PREFIX + "barrier"),
)
# ops that are collectives: the c10d dispatcher's and the backends' ranges
_COLLECTIVE_SPACES = ("c10d::", "nccl:", "gloo:", "record_param_comms")

_MATMUL_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear", "addmv", "mv",
    "dot", "vdot", "einsum", "tensordot", "_addmm_activation", "_scaled_mm", "_int_mm",
    "_weight_int8pack_mm", "linear_backward", "mkldnn_linear",
})
_REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "aminmax", "argmax", "argmin", "norm",
    "linalg_vector_norm", "_foreach_norm", "_foreach_max", "native_batch_norm",
    "_native_batch_norm_legit", "_native_batch_norm_legit_no_training", "cudnn_batch_norm",
    "native_batch_norm_backward", "cudnn_batch_norm_backward", "batch_norm_stats",
    "batch_norm_gather_stats_with_counts", "batch_norm_backward_reduce",
    "native_layer_norm", "native_layer_norm_backward", "_fused_rms_norm",
    "_fused_rms_norm_backward", "rms_norm", "layer_norm", "group_norm",
    "native_group_norm", "native_group_norm_backward", "var", "std", "var_mean",
    "std_mean", "logsumexp", "softmax", "_softmax", "log_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "nll_loss_forward",
    "nll_loss2d_forward", "mse_loss", "cumsum", "cumprod", "prod", "all", "any",
    "topk", "count_nonzero", "_cdist_forward", "nonzero", "unique", "_unique2",
})
_COPY_OPS = frozenset({
    "copy", "_to_copy", "to", "clone", "contiguous", "_copy_from", "_copy_from_and_resize",
    "view", "_unsafe_view", "reshape", "_reshape_alias", "as_strided", "transpose", "t",
    "permute", "expand", "expand_as", "unsqueeze", "squeeze", "flatten", "unflatten",
    "select", "slice", "narrow", "split", "split_with_sizes", "chunk", "unbind", "alias",
    "detach", "lift_fresh", "view_as", "movedim", "unfold", "diagonal", "resolve_conj",
    "resolve_neg", "pad", "constant_pad_nd", "reflection_pad2d", "_pin_memory",
    "pin_memory", "_local_scalar_dense", "item", "type_as", "view_as_real",
    "view_as_complex", "numpy_T", "mT", "swapaxes", "_reshape_copy",
})
_DUS_OPS = frozenset({
    "index_put", "_index_put_impl", "_unsafe_index_put", "slice_scatter", "select_scatter",
    "index_copy", "masked_scatter", "diagonal_scatter", "as_strided_scatter",
    "slice_backward", "select_backward",
})
_ELEMENTWISE_OPS = frozenset({
    "add", "sub", "mul", "div", "rsub", "neg", "abs", "sign", "sgn", "exp", "exp2", "log",
    "log2", "log10", "log1p", "expm1", "sqrt", "rsqrt", "pow", "square", "reciprocal",
    "sin", "cos", "tan", "tanh", "sigmoid", "silu", "gelu", "relu", "threshold",
    "threshold_backward", "silu_backward", "gelu_backward", "sigmoid_backward",
    "tanh_backward", "hardtanh", "hardtanh_backward", "leaky_relu", "elu", "softplus",
    "clamp", "clamp_min", "clamp_max", "clip", "where", "masked_fill", "fill", "zero",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "empty",
    "empty_like", "empty_strided", "new_empty", "new_zeros", "new_ones", "new_full",
    "new_empty_strided", "arange", "linspace", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "isfinite", "isnan", "isinf", "nan_to_num", "floor", "ceil",
    "round", "trunc", "frac", "fmod", "remainder", "lerp", "addcmul", "addcdiv",
    "maximum", "minimum", "fmax", "fmin", "atan2", "erf", "erfinv", "sort", "argsort",
    "multinomial", "normal", "uniform", "bernoulli", "randn", "rand", "randint",
    "randperm", "random", "exponential", "rand_like", "randn_like", "embedding",
    "embedding_dense_backward", "embedding_backward", "index_select", "gather", "index",
    "take", "take_along_dim", "scatter", "scatter_add", "scatter_reduce", "index_add",
    "index_fill", "cat", "stack", "flip", "roll", "repeat", "repeat_interleave", "tril",
    "triu", "one_hot", "dropout", "native_dropout", "native_dropout_backward", "resize",
    "set", "masked_select", "bucketize", "searchsorted", "copysign", "xlogy", "hypot",
    "nll_loss_backward", "nll_loss2d_backward", "mse_loss_backward", "_fused_adamw",
    "_fused_adam", "_fused_sgd", "lift", "record_stream", "_assert_async", "polar",
    "signbit", "heaviside", "logaddexp", "cross_entropy_loss", "binary_cross_entropy",
    "_efficientzerotensor", "_has_compatible_shallow_copy_type", "scalar_tensor",
    "_to_dense", "detach_copy", "conj", "is_nonzero", "to_padded_tensor", "gather_backward",
    "index_select_backward", "result_type", "real", "imag", "floor_divide", "true_divide",
})
# framework frames on the CPU: the autograd engine and its nodes hold the
# ops that do the work
_NODE = re.compile(r"^[A-Z]\w*Backward\d*$")


def base_name(op: str) -> str:
    """An op's bare name: no ``aten::`` namespace, no in-place or ``out``
    suffix (``aten::add_`` -> ``add``; ``_foreach_mul_`` -> ``_foreach_mul``)."""
    name = op.split("::", 1)[1] if op.startswith("aten::") else op
    if name.endswith("_out"):
        name = name[:-4]
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def is_wrapper(op: str) -> bool:
    """True for the CPU trace's framework frames, which hold the ops that
    do the work: the autograd engine's (``autograd::engine::...``), its
    gradient accumulation (``torch::autograd::AccumulateGrad``) and its
    nodes (``MmBackward0``)."""
    return op.startswith(("autograd::", "torch::autograd::")) or bool(_NODE.match(op))


def _collective(name: str) -> str | None:
    flat = name.lower().replace("_", "").replace("-", "")
    for key, cat in _COLLECTIVES:
        if key in flat:
            return cat
    return None


def classify_op(op: str) -> str:
    """Category of an op (an ``aten::`` op, a c10d or backend collective,
    a custom op) by its name; :data:`OTHER` when no table knows it."""
    if op.startswith(_COLLECTIVE_SPACES):
        return _collective(op) or OTHER
    name = base_name(op)
    if "convolution" in name or name.startswith(("conv1d", "conv2d", "conv3d", "_slow_conv")):
        return CONVOLUTION
    if name in _MATMUL_OPS or "attention" in name:
        return MATMUL
    if name in _REDUCE_OPS:
        return REDUCE
    if name in _DUS_OPS:
        return DUS
    if name in _COPY_OPS:
        return COPY
    if name.startswith("_foreach_") or name in _ELEMENTWISE_OPS:
        return ELEMENTWISE
    return OTHER


def port_kernel(name: str) -> tuple[str, str] | None:
    """``(id, category)`` of a port kernel from its demangled name
    (:data:`PORT_KERNELS`), or None."""
    for kid, pat, cat in _PORT:
        if pat.search(name):
            return kid, cat
    return None


def classify_name(name: str) -> str:
    """Name-token fallback for a kernel that neither the port's table nor
    its op places: a library kernel's name says what it does, as far as
    names can (:data:`OTHER` when it says nothing)."""
    low = name.lower()
    if "nccl" in low or "gloo" in low:
        return _collective(name) or OTHER
    if "conv" in low or "dgrad" in low or "wgrad" in low:
        return CONVOLUTION
    if any(t in low for t in ("gemm", "gemv", "xmma", "nvjet", "cutlass", "matmul")):
        return MATMUL
    if "reduce" in low or "norm" in low or "softmax" in low:
        return REDUCE
    if "copy" in low or "transpose" in low or "cast" in low:
        return COPY
    if "elementwise" in low or "pointwise" in low or "fill" in low:
        return ELEMENTWISE
    return OTHER


@dataclass
class StepReport:
    """Categorized device-time breakdown of a captured trace.

    ``total_us`` is the classified device time (on the CPU, the framework
    frames' own time is tallied in ``wrapper_us`` instead); ``by_category``
    always sums to ``total_us`` exactly. ``heuristic_us`` is the share
    classified from kernel names alone, with no launching op or port
    table to place them (``unplaced``: their time by ``"kernel <- op"``).
    ``port_launches`` counts each port kernel's events
    (:data:`PORT_KERNELS` ids), ``port_us`` their time; ``port_unmatched``
    names kernels with a port symbol that no table row places;
    ``by_op`` is the time by launching op (descending); ``lost_launches``
    lists the launches whose kernel record the trace lost
    (:func:`..utils.profiling.lost_launches`: any, and the counts are
    short)."""

    total_us: float
    wrapper_us: float
    by_category: dict[str, float]
    ops: list[tuple[str, float, str]] = field(default_factory=list)
    heuristic_us: float = 0.0
    steps: int = 1
    port_launches: dict[str, int] = field(default_factory=dict)
    port_us: dict[str, float] = field(default_factory=dict)
    port_unmatched: list[str] = field(default_factory=list)
    unplaced: dict[str, float] = field(default_factory=dict)
    by_op: dict[str, float] = field(default_factory=dict)
    lost_launches: list[tuple[float, str | None]] = field(default_factory=list)

    @classmethod
    def from_trace(cls, logdir: str, steps: int = 1) -> "StepReport":
        """Build a report from a trace directory written by
        :func:`..utils.profiling.trace` (or ``export``). ``steps``: how many
        train steps the traced region ran — used only for the per-step
        properties."""
        total = wrapper = heuristic = 0.0
        by_cat: dict[str, float] = {}
        ops: dict[tuple[str, str], float] = {}
        launches: dict[str, int] = {}
        port_us: dict[str, float] = {}
        unmatched: set[str] = set()
        unplaced: dict[str, float] = {}
        by_op: dict[str, float] = {}
        events = load_events(logdir)
        for ev in device_events(events):
            if ev.cat == "cpu_op" and is_wrapper(ev.name):
                wrapper += ev.us
                continue
            port = port_kernel(ev.name) if ev.cat == "kernel" else None
            if port is not None:
                kid, cat = port
                launches[kid] = launches.get(kid, 0) + 1
                port_us[kid] = port_us.get(kid, 0.0) + ev.us
            else:
                if ev.cat == "kernel" and _PORT_SYMBOLS.match(ev.name):
                    unmatched.add(ev.name)
                cat = _placed(ev)
            if cat is None:  # read from its name alone
                cat = classify_name(ev.name)
                heuristic += ev.us if cat != OTHER else 0.0
                key = f"{ev.name[:80]} <- {ev.op}"
                unplaced[key] = unplaced.get(key, 0.0) + ev.us
            total += ev.us
            by_cat[cat] = by_cat.get(cat, 0.0) + ev.us
            op = ev.op or "(no op)"
            by_op[op] = by_op.get(op, 0.0) + ev.us
            ops[(ev.name, cat)] = ops.get((ev.name, cat), 0.0) + ev.us
        return cls(
            total_us=total,
            wrapper_us=wrapper,
            by_category=dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            ops=sorted(((n, us, c) for (n, c), us in ops.items()), key=lambda r: -r[1]),
            heuristic_us=heuristic,
            steps=max(1, steps),
            port_launches=launches,
            port_us=port_us,
            port_unmatched=sorted(unmatched),
            unplaced=unplaced,
            by_op=dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
            lost_launches=lost_launches(events),
        )

    def counter_launches(self) -> dict[str, int]:
        """The traced port kernels' launches under the launch counters
        that count them (:data:`PORT_KERNELS`; :func:`read_counters` reads
        the counters themselves)."""
        out: dict[str, int] = {}
        for kid, _, _, counter in PORT_KERNELS:
            if counter is not None and self.port_launches.get(kid):
                out[counter] = out.get(counter, 0) + self.port_launches[kid]
        return out

    @property
    def step_us(self) -> float:
        return self.total_us / self.steps

    @property
    def unclassified_fraction(self) -> float:
        if self.total_us <= 0:
            return 0.0
        return self.by_category.get(OTHER, 0.0) / self.total_us

    @property
    def collective_us(self) -> dict[str, float]:
        """Collective time split by kind."""
        return {k: v for k, v in self.by_category.items() if k.startswith(COLLECTIVE_PREFIX)}

    def fraction(self, category: str) -> float:
        if self.total_us <= 0:
            return 0.0
        return self.by_category.get(category, 0.0) / self.total_us

    def render(self, top: int = 0) -> str:
        """The "where did the step go" table."""
        lines = [
            f"device time: {self.total_us / 1e3:.2f} ms over "
            f"{self.steps} step(s) -> {self.step_us / 1e3:.3f} ms/step",
            "| class | ms | % of device time |",
            "|---|---|---|",
        ]
        for cat, us in self.by_category.items():
            lines.append(
                f"| {cat} | {us / 1e3:.2f} | {100 * us / self.total_us:.1f}% |"
                if self.total_us else f"| {cat} | 0.00 | 0.0% |")
        if self.heuristic_us:
            lines.append(
                f"(name-heuristic share, no launching op or port table entry: "
                f"{100 * self.heuristic_us / self.total_us:.1f}%)")
        for op, us, cat in self.ops[: top or 0]:
            lines.append(f"  {op[:100]}: {us / 1e3:.3f} ms [{cat}]")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-ready payload (the receipt form; the JAX report's keys)."""
        return {
            "total_us": round(self.total_us, 3),
            "wrapper_us": round(self.wrapper_us, 3),
            "step_us": round(self.step_us, 3),
            "steps": self.steps,
            "by_category": {k: round(v, 3) for k, v in self.by_category.items()},
            "heuristic_us": round(self.heuristic_us, 3),
            "unclassified_fraction": round(self.unclassified_fraction, 4),
        }


def capture_report(record, steps: int = 1):
    """``record(logdir)`` traces one call into a fresh directory (and
    returns what else it measured); the trace is classified into a
    :class:`StepReport`, and the launch counters (:func:`read_counters`)
    are read around the call. Returns ``(report, counted, recorded)``: the
    report, the counters' nonzero deltas, ``record``'s return."""
    import shutil
    import tempfile

    logdir = tempfile.mkdtemp(prefix="step-trace-")
    try:
        before = read_counters()
        recorded = record(logdir)
        counted = {k: n - before[k] for k, n in read_counters().items() if n - before[k]}
        return StepReport.from_trace(logdir, steps=steps), counted, recorded
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def _placed(ev) -> str | None:
    """A non-port event's category from what ran — the trace's own
    category, the launching op — or None when only its name is left."""
    if ev.cat == "gpu_memcpy":
        return COPY
    if ev.cat == "gpu_memset":
        return ELEMENTWISE
    if ev.op is not None:
        cat = classify_op(ev.op)
        if cat != OTHER or ev.cat == "cpu_op":
            return cat
    return None
