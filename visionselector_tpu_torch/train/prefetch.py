"""Background-thread batch prefetch for the training loop.

Counterpart of ``visionselector_tpu.train.prefetch``: one daemon thread
builds the next batches (tokenize, PIL, patchify, stack, copy to the
device) while the device runs the current step, in place of the
reference's DataLoader worker processes.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional


class BatchPrefetcher:
    """Pull batches from ``make_batch`` in a daemon thread, ``size`` ahead.

    ``make_batch`` must be self-contained (own the data-stream cursor) and
    is only ever called from the prefetch thread, so generators that are
    not thread-safe are fine. Batches come out in the order they were
    made. An exception raised by ``make_batch`` is re-raised in the
    consumer on the next ``next()``, after the batches made before it.
    """

    _SENTINEL = object()

    def __init__(self, make_batch: Callable[[], object], size: int = 2):
        if size < 1:
            raise ValueError("prefetch size must be >= 1")
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._make()
                # bounded put that still honours stop requests
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            self._err = e
            try:
                self._q.put(self._SENTINEL, timeout=0.1)
            except queue.Full:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._err is not None and self._q.empty():
                    raise self._err
        if item is self._SENTINEL:
            raise self._err
        return item

    def close(self, timeout: float = 60.0):
        """Stop the worker and wait until it has exited: drain and join in
        a loop (the worker may be inside ``make_batch``), bounded by
        ``timeout`` seconds; if it is still alive then, log a warning, as
        the stream's cursor may still advance once."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            # drain so the worker's blocked put sees the stop flag
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=0.5)
            if time.monotonic() >= deadline:
                break
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "BatchPrefetcher.close(): worker still inside make_batch "
                "after %.0fs; the sample stream's cursor may advance once "
                "more before the daemon thread exits", timeout)
