"""Profiling: ``torch.profiler`` traces around the hot loop (port of the
JAX package's ``utils/profiling.py``).

:func:`trace` captures a host + device trace of the enclosed region and
writes it as a gzipped chrome trace (``*.pt.trace.json.gz``, viewable in
Perfetto or ``chrome://tracing``); :func:`annotate` marks a host-side
region in it; :func:`device_op_durations` sums the trace's device time by
op or kernel name, and :func:`device_events` gives each timed event with
the op that launched it (:class:`..obs.trace.StepReport` classifies
those). PyTorch returns before the device finishes, so the trace, not a
host clock around a launch, says where the device time went.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time
from typing import NamedTuple

# trace categories of the timed events on a card's lanes (kineto's names);
# the device lanes' other events (``gpu_user_annotation``: a
# ``record_function`` range's device span) overlap these and are left out
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class OpTime(NamedTuple):
    """One timed event's share of the trace: ``name`` (a kernel or an op),
    ``us`` (microseconds counted for it), ``op`` (the op that launched a
    kernel, through the trace's ``External id``; an op's own name on the
    CPU; None where the trace names none), ``cat`` (its trace category)."""

    name: str
    us: float
    op: str | None
    cat: str


# A card's profiling window, late in a long-lived process, loses the
# device records of its first ~40 kernel launches (seen on an H100 with
# torch 2.11: 39–45 lost at the start of every window after ~12 minutes of
# chip_smoke.py, none in a fresh process; a 50 ms wait at the window's
# start did not help). So a window opens with a primer: PRIMER_LAUNCHES
# launches of a one-thread spin kernel under a PRIMER range, whose records
# may be the lost ones; the primer's kernels and launches are left out of
# every reading (device_events, lost_launches, profile_step's sums). The
# window then closes SETTLE_S clear of the work, the card synchronized.
PRIMER = "profiling: primer"
PRIMER_LAUNCHES = 512
SETTLE_S = 0.05


def open_window(torch) -> None:
    """The start of a card's profiling window: synchronize, launch the
    primer (module comment), synchronize."""
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with record_function(PRIMER):
        for _ in range(PRIMER_LAUNCHES):
            torch.cuda._sleep(1)
    torch.cuda.synchronize()


def close_window(torch) -> None:
    """The end of a card's profiling window: synchronize and wait
    :data:`SETTLE_S`."""
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def export(prof, logdir: str, compress: bool = True) -> str:
    """Write a finished ``torch.profiler.profile``'s chrome trace into
    ``logdir`` as ``<host>_<pid>.<n>.pt.trace.json.gz`` (``compress``
    False: ``.json``, for a trace read back at once — gzip takes seconds
    over a large step's trace); returns the path."""
    os.makedirs(logdir, exist_ok=True)
    n = len(glob.glob(os.path.join(logdir, "*.pt.trace.json*")))
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{n}.pt.trace.json"
                        + (".gz" if compress else ""))
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a host + device trace of the enclosed region into
    ``logdir``::

        with profiling.trace("build/tr"):
            trainer.train(1)

    CPU and CUDA activities; the CUDA one only where ``device`` (default:
    a card when one is present) is a card. Wrap steady-state steps: a
    cold region's trace is dominated by first-call work (kernel builds,
    allocator growth)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        if on_card:
            open_window(torch)
        yield logdir
        if on_card:
            close_window(torch)
    export(prof, logdir)


def annotate(name: str):
    """A named host-side region in the trace's timeline (context manager)."""
    from torch.profiler import record_function

    return record_function(name)


def load_events(logdir: str) -> list[dict]:
    """Every ``traceEvents`` entry of the chrome traces under ``logdir``
    (``*.trace.json.gz``, the JAX package's glob, which kineto's
    ``*.pt.trace.json.gz`` names also match, and ``*.trace.json``)."""
    events: list[dict] = []
    for pattern, opener in (("*.trace.json.gz", gzip.open), ("*.trace.json", open)):
        for f in sorted(glob.glob(os.path.join(logdir, "**", pattern), recursive=True)):
            with opener(f, "rt") as fh:
                events.extend(json.load(fh).get("traceEvents", []))
    return events


def _events(trace) -> list[dict]:
    """A trace directory's events, or the events given."""
    return load_events(trace) if isinstance(trace, (str, os.PathLike)) else trace


def _timed(e: dict) -> bool:
    return e.get("ph") == "X" and "dur" in e


def _op_name(e: dict) -> str:
    """A ``cpu_op``'s name; a collective's ``record_param_comms`` range
    by the collective it records (``c10d::allreduce``)."""
    coll = e.get("args", {}).get("Collective name")
    return f"c10d::{coll}" if coll else e["name"]


def _primed(events: list[dict]) -> set:
    """Correlation ids of the launches made inside a :data:`PRIMER` range
    (matched on the launching thread by the host's clock)."""
    spans = [(e.get("pid"), e.get("tid"), e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == PRIMER and e.get("cat") == "user_annotation" and _timed(e)]
    if not spans:
        return set()
    return {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and _timed(e)
            and any(p == e.get("pid") and t == e.get("tid") and a <= e["ts"] <= b
                    for p, t, a, b in spans)}


def device_events(trace) -> list[OpTime]:
    """The trace's device time, event by event (``trace``: a directory
    :func:`trace` wrote, or its :func:`load_events`).

    On a card: the kernel, memcpy and memset events of the GPU lanes, each
    with the op that launched it (its ``External id`` names the innermost
    ``cpu_op`` open at the launch; a kernel launched outside any op, as a
    ``ctypes`` launch can be, has ``op`` None).

    On the CPU (no device lanes: the tests' traces), the ``cpu_op``
    events stand in, each counted for its own time only: its duration
    less its child ops' on the same thread. An op with child ops is a
    wrapper of them (``aten::linear`` holds ``aten::addmm``); its time
    inside them belongs to the children, so every microsecond counts
    once, at the innermost op that spent it. (Counting strict leaves
    alone would drop a CPU ``aten::mm``'s own GEMM: it holds two
    ``aten::resolve_conj`` children.)"""
    events = _events(trace)
    if any(e.get("cat") in DEVICE_CATS for e in events):
        ops = {e["args"]["External id"]: _op_name(e) for e in events
               if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
        primed = _primed(events)
        return [OpTime(e.get("name", "?"), float(e["dur"]),
                       ops.get(e.get("args", {}).get("External id")), e["cat"])
                for e in events if e.get("cat") in DEVICE_CATS and _timed(e)
                and e.get("args", {}).get("correlation") not in primed]
    by_thread: dict[tuple, list[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and _timed(e):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out: list[OpTime] = []
    for ops in by_thread.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        inner = [0.0] * len(ops)  # time inside each op's direct children
        stack: list[int] = []
        for i, e in enumerate(ops):
            while stack and ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"] < e["ts"] + e["dur"]:
                stack.pop()
            if stack:
                inner[stack[-1]] += e["dur"]
            stack.append(i)
        out.extend(OpTime(e["name"], max(0.0, e["dur"] - inner[i]), e["name"], "cpu_op")
                   for i, e in enumerate(ops))
    return out


def lost_launches(trace) -> list[tuple[float, str | None]]:
    """Kernel launches of the trace (the host's ``cudaLaunchKernel`` /
    ``cuLaunchKernel`` events) whose kernel has no device event: records
    the profiler dropped, each as (ms after the trace's first launch, the
    op it was launched in); the primer's launches left out. A card's trace
    can lose kernel records while keeping their launches (the primer's
    module comment; also 221 of 801 in one of 60 windows of the same work
    in a fresh process, H100, torch 2.11), so a caller that counts kernels
    reads this beside the counts. Empty on the CPU (no launches)."""
    events = _events(trace)
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in DEVICE_CATS}
    ops = {e["args"]["External id"]: _op_name(e) for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    primed = _primed(events)
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")
                       and e.get("args", {}).get("correlation") not in primed),
                      key=lambda e: e["ts"])
    return [((e["ts"] - launches[0]["ts"]) / 1e3, ops.get(e.get("args", {}).get("External id")))
            for e in launches if e.get("args", {}).get("correlation") not in recorded]


def device_op_durations(logdir: str) -> dict[str, float]:
    """Device time (microseconds) by kernel or op name from the traces
    :func:`trace` wrote, descending: on a card the kernel, memcpy and
    memset events of the GPU lanes; on the CPU each ``cpu_op``'s own time
    (:func:`device_events`). The values sum to the trace's device busy
    time, nothing counted twice."""
    totals: collections.Counter = collections.Counter()
    for ev in device_events(logdir):
        totals[ev.name] += ev.us
    return dict(totals.most_common())
