"""Dynamic micro-batcher: requests -> futures -> bucketed engine batches
(vitax/serve/batcher.py).

Requests enqueue with a Future and one worker thread flushes them as one
engine batch when the largest bucket fills (`max_batch`) or the oldest
queued request has waited `max_batch_wait_ms`, whichever comes first.
HTTP handler threads only append under the condition lock and block on
their Future; all engine work happens on the one worker thread. The
`batcher_flush` fault site fires once a flush on that thread: a failure
there fails that batch's futures and the worker lives on.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from vitax_torch import faults


class QueueFull(RuntimeError):
    """submit() against a batcher whose pending queue is at queue_max; the
    server answers 503 with reason "queue_full"."""


class BatchResult:
    """Per-request slice of a flushed batch, plus the batch's accounting."""

    __slots__ = ("classes", "probs", "queue_wait_s", "infer_s", "batch_size", "bucket")

    def __init__(self, classes, probs, queue_wait_s, infer_s, batch_size, bucket):
        self.classes = classes            # (k,) int32 class ids
        self.probs = probs                # (k,) float32 probabilities
        self.queue_wait_s = queue_wait_s  # this request's time in queue
        self.infer_s = infer_s            # engine latency of its batch
        self.batch_size = batch_size      # real requests in the batch
        self.bucket = bucket              # padded bucket it executed in


class DynamicBatcher:
    """Queue + worker thread around `predict_fn(images) -> (ids, probs)`,
    where images is a stacked (n, H, W, 3) array with n <= max_batch.
    `on_batch(stats)` is called once a flushed batch (telemetry)."""

    def __init__(self, predict_fn: Callable, max_batch: int, max_wait_ms: float,
                 bucket_of: Optional[Callable[[int], int]] = None,
                 on_batch: Optional[Callable[[dict], None]] = None, queue_max: int = 0):
        if max_batch < 1 or queue_max < 0:
            raise ValueError(f"max_batch {max_batch} must be >= 1 and queue_max {queue_max} >= 0")
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.queue_max = queue_max        # 0 = unbounded
        self.bucket_of = bucket_of or (lambda n: n)
        self.on_batch = on_batch
        self.batches_flushed = 0
        self._pending: deque = deque()    # (image, Future, t_enqueue)
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True, name="vitax-torch-batcher")
        self._worker.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) image; resolves to a BatchResult. Raises
        QueueFull when `queue_max` requests are already pending."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.queue_max and len(self._pending) >= self.queue_max:
                raise QueueFull(f"{len(self._pending)} requests already pending "
                                f"(--serve_queue_max {self.queue_max})")
            self._pending.append((image, fut, time.time()))
            self._cond.notify()
        return fut

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def set_max_wait_ms(self, max_wait_ms: float) -> None:
        """Retune the flush deadline at run time (brownout shortens it)."""
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        with self._cond:
            self.max_wait_s = max_wait_ms / 1000.0
            self._cond.notify()

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work, flush what is queued, join the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                # flush when the largest bucket fills or the OLDEST request
                # hits the deadline (recomputed each wait, so
                # set_max_wait_ms() applies to queued work too)
                while len(self._pending) < self.max_batch and not self._closed:
                    remaining = self._pending[0][2] + self.max_wait_s - time.time()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = [self._pending.popleft()
                         for _ in range(min(len(self._pending), self.max_batch))]
            self._flush(batch)

    def _flush(  # vtx: ignore[VTX103] predict_fn returns host arrays: its .cpu() waits for the forward
            self, batch) -> None:
        images = np.stack([img for img, _, _ in batch])
        t_flush = time.time()
        try:
            faults.fire("batcher_flush")
            ids, probs = self.predict_fn(images)
        except Exception as e:  # noqa: BLE001 - delivered to every request, the worker lives on
            for _, fut, _ in batch:
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        infer_s = time.time() - t_flush
        n = len(batch)
        bucket = self.bucket_of(n)
        self.batches_flushed += 1
        for row, (_, fut, t_enq) in enumerate(batch):
            if not fut.cancelled():
                fut.set_result(BatchResult(classes=ids[row], probs=probs[row],
                                           queue_wait_s=t_flush - t_enq, infer_s=infer_s,
                                           batch_size=n, bucket=bucket))
        if self.on_batch is not None:
            try:
                self.on_batch({"batch_size": n, "bucket": bucket, "infer_s": infer_s,
                               "queue_wait_s_max": t_flush - batch[0][2]})
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill serving
                pass
