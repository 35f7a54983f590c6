"""Background-thread record prefetching for the training loop.

The port's own copy of ``prefetch_iterable`` and ``Prefetcher`` from
``waldboost_tpu/io/__init__.py`` (pure Python threading): a producer thread
decodes records while the device computes, in source order.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

__all__ = ["prefetch_iterable", "Prefetcher"]


def prefetch_iterable(iterable, depth: int = 16):
    """Yield the records of ``iterable`` in order while a daemon thread
    drains it into a queue ``depth`` records deep; an exception of the
    producer is raised at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    END = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
            q.put(END)
        except BaseException as e:  # handed to the consumer, raised there
            q.put((END, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is END:
            raise item[1]
        yield item


class Prefetcher:
    """A stoppable :func:`prefetch_iterable`: :meth:`stop` joins the
    producer and returns every record it pulled from the source that was
    not consumed, in order, so a later reader of the same source loses
    none."""

    _END = object()

    def __init__(self, iterable, depth: int = 16):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._halt = threading.Event()
        self._overflow: list = []   # the record in flight when stop came
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(iterable,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Put ``item``, polling the halt flag; False if halted first."""
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterable) -> None:
        try:
            for item in iterable:
                if not self._put(item):
                    self._overflow.append(item)
                    return
        except BaseException as e:  # handed to the consumer, raised there
            self._exc = e
        # the sentinel unblocks the consumer; stop() drops it
        self._put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._exc is not None:
                    exc, self._exc = self._exc, None
                    raise exc
                return
            yield item

    def stop(self) -> list:
        """Halt the producer; return the unconsumed records in order."""
        self._halt.set()
        self._thread.join()
        residue = []
        while not self._q.empty():
            item = self._q.get_nowait()
            if item is not self._END:
                residue.append(item)
        residue.extend(self._overflow)
        self._overflow = []
        return residue
