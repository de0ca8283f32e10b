"""Benchmark harness: what a bench reads on the card besides its own
CUDA-event timings (the JAX package's ``bench/harness.py`` times XLA
programs; PyTorch returns before the device finishes, so the benches
time with CUDA events, ``bench.headline.time_epoch`` and ``time_chain``).

:func:`profile_step` reads a ``torch.profiler`` trace of one call (device
busy and idle share, kernels, the top kernels); :func:`count_host_syncs`
counts the synchronizing CUDA calls made inside a block (PyTorch's sync
debug mode). Both need a card. torch is imported by the caller, as the
benches do.
"""

from __future__ import annotations

import contextlib
import time
import warnings


def profile_step(run_step, torch) -> dict:
    """``torch.profiler`` over one step: device busy and idle share of its
    wall time, kernels per step, the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
        # the port's hand-written kernels (csrc/, each in an anonymous
        # namespace), whatever their rank
        "port_kernels_ms": {k[:80]: v / 1e3 for k, v in dev_us.items()
                            if "anonymous namespace" in k},
    }


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
