"""Benchmark harness: what a bench reads on the card besides its own
CUDA-event timings (the JAX package's ``bench/harness.py`` times XLA
programs; PyTorch returns before the device finishes, so the benches
time with CUDA events, ``bench.headline.time_epoch`` and ``time_chain``).

:func:`profile_step` reads a ``torch.profiler`` trace of one call (device
busy and idle share, kernels, the top kernels), and :func:`trace_step`
hands that same trace to :class:`..obs.trace.StepReport` too;
:func:`count_host_syncs` counts the synchronizing CUDA calls made inside a
block (PyTorch's sync debug mode). All need a card.
"""

from __future__ import annotations

import contextlib
import time
import warnings


def profile_step(run_step, torch, logdir: str | None = None) -> dict:
    """``torch.profiler`` over one step: device busy and idle share of its
    wall time, kernels per step, the top kernels by device time (the
    window opens with :func:`..utils.profiling.open_window`'s primer,
    whose spin kernels the sums leave out). With ``logdir``, the same
    trace is also written there
    (:func:`..utils.profiling.export`) for :class:`..obs.trace.StepReport`
    — the step is profiled once. A ``record_function`` range's device-side
    span (a user annotation) overlaps the kernels inside it and is left
    out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import port_kernel
    from pytorch_distributed_training_tutorials_tpu_torch.utils.profiling import (
        PRIMER,
        close_window,
        export,
        open_window,
    )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_window(torch)
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        close_window(torch)
    export_s = None
    if logdir is not None:
        t = time.perf_counter()
        export(prof, logdir, compress=False)
        export_s = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.key != PRIMER
               and "spin_kernel" not in e.key]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels),
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
        # the port's hand-written kernels (obs.trace.PORT_KERNELS), whatever
        # their rank
        "port_kernels_ms": {k[:80]: v / 1e3 for k, v in dev_us.items() if port_kernel(k)},
        "export_s": export_s,
    }


def trace_step(run_step, model_flops: float, peak: float | None, steps: int = 1) -> dict:
    """One profiled call of ``run_step`` (``steps`` train steps), read twice
    from one trace: :func:`profile_step`'s summary and
    :class:`..obs.trace.StepReport`'s categories, with the port kernels'
    launches in the trace beside the launch counters over the call
    (:func:`..obs.trace.capture_report`), and where the trace lost kernel
    records (``trace_lost_launches``). ``trace_step_ms`` and ``trace_mfu``
    are per step (``model_flops``: a step's); ``trace_report_s`` is the
    host's seconds spent writing the trace and classifying it, the work
    :func:`profile_step` alone does not do."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import capture_report

    profiled_s = []

    def record(logdir):
        t = time.perf_counter()
        out = profile_step(run_step, torch, logdir=logdir)
        profiled_s.append(time.perf_counter() - t - out["export_s"])
        return out

    t0 = time.perf_counter()
    report, counted, summary = capture_report(record, steps=steps)
    dev_step_s = report.step_us / 1e6
    return {
        "trace": summary,
        "trace_report": report.to_dict(),
        "trace_step_ms": dev_step_s * 1e3,
        "trace_mfu": model_flops / dev_step_s / peak if peak and dev_step_s > 0 else None,
        "trace_category_sum_us": sum(report.by_category.values()),
        "trace_total_us": report.total_us,
        "trace_port_launches": report.counter_launches(),
        "trace_port_unmatched": report.port_unmatched,
        "trace_unplaced_us": report.unplaced,
        "trace_by_op_us": dict(list(report.by_op.items())[:15]),
        "trace_counted_launches": counted,
        "trace_lost_launches": lost_summary(report.lost_launches),
        "trace_report_s": time.perf_counter() - t0 - profiled_s[0],
    }


def lost_summary(lost: list) -> dict | None:
    """Where a trace's lost kernel records were: how many, the first and
    last (ms after the trace's first launch) and the ops they were
    launched in (the five most)."""
    if not lost:
        return None
    import collections

    return {"n": len(lost), "first_ms": lost[0][0], "last_ms": lost[-1][0],
            "ops": collections.Counter(op for _, op in lost).most_common(5)}


@contextlib.contextmanager
def count_host_syncs(torch):
    """Count the synchronizing CUDA calls made inside the block: PyTorch's
    sync debug mode warns on each (``.item()``, ``.tolist()``, a copy to
    the host, ``torch.cuda.synchronize`` ...), and the warnings are
    counted, not shown. Yields a list that holds, when the block ends,
    the count and then each sync's call site: the innermost frame and the
    innermost frame outside torch, ``file:line``."""
    import traceback

    sites: list[str] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        outside = [f for f in traceback.extract_stack()[:-1]
                   if "/torch/" not in f.filename and "/warnings.py" not in f.filename]
        where = f"{outside[-1].filename}:{outside[-1].lineno}" if outside else "?"
        sites.append(f"{filename}:{lineno} <- {where}")

    count = [0]
    previous = torch.cuda.get_sync_debug_mode()
    # the process's first switch to "warn" synchronizes once (seen as a
    # sync at the switch itself): make that switch here, uncounted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(previous)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    count[:] = [len(sites), *sites]
