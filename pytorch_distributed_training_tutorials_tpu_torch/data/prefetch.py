"""Prefetching: host batch assembly and the copy to the card overlap the
steps (port of the JAX package's ``data/prefetch.py``).

:func:`prefetch_iterable` is the generic engine: a daemon thread runs an
iterable ``depth`` items ahead through a bounded queue; its exceptions
re-raise in the consumer, and closing the consumer stops it.

:class:`Stager` moves host arrays to the device ahead of their use. On
the card the producer copies them into a ring of pinned host buffers and
uploads them with ``non_blocking=True`` on its own CUDA stream, recording
an event after each upload; a pinned buffer is refilled only once its
last upload's event has completed. The consumer makes its stream wait on
the event and marks each tensor as used there (``record_stream``), so the
caching allocator does not hand the memory out again while the compute
stream may still read it. On the CPU a batch is the host array itself.

:class:`PrefetchLoader` runs a :class:`..data.ShardedLoader`'s host
gathers and uploads ahead of the training loop and yields the batches it
would yield, byte for byte.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

_SENTINEL = object()


def prefetch_iterable(iterable, depth: int = 2):
    """Yield ``iterable``'s items, produced ``depth`` ahead in a background
    thread. Exceptions in the producer re-raise in the consumer;
    abandoning the generator stops the producer promptly."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """A blocking put that gives up when the consumer is gone (False).
        The sentinel goes through here too: a dropped sentinel would leave
        the consumer blocked."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put_or_stop(item):
                    return
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            put_or_stop(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        t.join(timeout=10)


class Stager:
    """Host arrays to ``device``: :meth:`put` in the producer, :meth:`take`
    in the consumer (the module docstring)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.on_card = device.type == "cuda"
        self.slots: list[dict] = [{"buffers": [], "event": None} for _ in range(slots)]
        self.next = 0
        self.stream = torch.cuda.Stream(device) if self.on_card else None

    def put(self, arrays: tuple[np.ndarray, ...]):
        """Start the upload of ``arrays``; returns ``(tensors, event)``."""
        if not self.on_card:
            return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), None
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot["event"] is not None:
            slot["event"].synchronize()  # its last upload has read the buffers
        bufs = slot["buffers"]
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for i, a in enumerate(arrays):
                a = np.ascontiguousarray(a)
                if i == len(bufs) or bufs[i].numel() < a.nbytes:
                    buf = torch.empty(a.nbytes, dtype=torch.uint8, pin_memory=True)
                    bufs[i:i + 1] = [buf]
                src = torch.from_numpy(a)
                host = bufs[i][:a.nbytes].view(src.dtype).view(src.shape)
                host.copy_(src)
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        slot["event"] = event
        return tuple(out), event

    def take(self, tensors: tuple[torch.Tensor, ...], event) -> tuple[torch.Tensor, ...]:
        """The uploaded tensors, ready for the consumer's stream."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors


class PrefetchLoader:
    """A :class:`..data.ShardedLoader` whose host gathers and uploads run
    ``prefetch`` steps ahead; it yields the loader's batches and delegates
    the rest of its surface (``set_epoch``, lengths, mesh)."""

    def __init__(self, loader, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self.loader = loader
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        stager = Stager(self.loader.device, self.prefetch + 2)
        staged = prefetch_iterable((stager.put(a) for a in self.loader.host_batches()),
                                   self.prefetch)
        try:
            for tensors, event in staged:
                yield self.loader.finish(stager.take(tensors, event))
        finally:
            staged.close()
