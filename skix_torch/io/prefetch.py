"""Double-buffered host→device prefetching.

Port of ``skix/io/prefetch.py``: a bounded background-thread prefetcher
over any chunk iterator (:class:`PrefetchIterator`, a copy), plus device
prefetch that keeps the next chunk's host→device copy in flight while the
current chunk computes (:func:`device_prefetch`). On the card the copy
leaves from pinned memory on a side stream; the consumer's stream waits
on the copy's event before it touches the chunk, and ``record_stream``
keeps the chunk's memory from being reused while that stream may still
read it. No stage calls it, as in skix.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

from skix_torch.utils.device import resolve_device

_SENTINEL = object()


class PrefetchIterator:
    """Wrap an iterator with a bounded background producer thread.

    Exceptions in the producer propagate to the consumer; the thread shuts
    down cleanly on early exit (``close``/GC).
    """

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce,
                                        args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — forward to consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()

    def __del__(self):  # pragma: no cover - GC path
        self.close()


def device_prefetch(iterable: Iterable, transform: Optional[Callable] = None,
                    depth: int = 2, device=None):
    """Yield each chunk (an array or tensor, after ``transform``) as a
    tensor on ``device`` (default ``cuda``), one step behind the transfer:
    the next chunk's copy is issued before the current chunk is yielded.
    ``transform`` and, on the card, the copy into pinned memory run on the
    producer thread."""
    return _prefetch(iterable, transform, depth, resolve_device(device))


def _prefetch(iterable, transform, depth: int, device: torch.device):
    on_card = device.type == "cuda"

    def host(x):
        if transform is not None:
            x = transform(x)
        x = torch.as_tensor(x)
        return x.pin_memory() if on_card and not x.is_pinned() else x

    src = PrefetchIterator(map(host, iterable), depth=depth)
    if not on_card:
        yield from (x.to(device) for x in src)
        return
    copy_stream = torch.cuda.Stream(device)

    def issue(x):
        with torch.cuda.stream(copy_stream):
            y = x.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return y, done

    def ready(pending):
        y, done = pending
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        y.record_stream(consumer)
        return y

    pending = None
    try:
        for item in src:
            nxt = issue(item)
            if pending is not None:
                yield ready(pending)
            pending = nxt
        if pending is not None:
            yield ready(pending)
    finally:
        src.close()
