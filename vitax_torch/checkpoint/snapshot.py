"""Zero-stall snapshot pipeline (vitax/checkpoint/snapshot.py;
--zero_stall_ckpt, and under --replicate_steps).

save_state (checkpoint/io.py) already writes in the background, but it
copies the state to host memory on the loop thread and waits for that
copy: at the 10B width the loop stalls for the whole device-to-host copy
of its shard. This pipeline splits a save into the part that must run on
the loop thread and the rest:

  stage()   on the loop thread: queue a copy of each leaf of the rank's
            state (the local shards of DTensors) into a reused pinned
            host buffer set, on a side stream that first waits for the
            compute stream (a CUDA event, no host sync). The clip+AdamW
            kernel (B) updates params, mu and nu in place, so the copies'
            event goes into the state's `staged` list and the next step's
            update waits for it before it launches (train/step.py); the next
            step's forward and backward only read them and overlap the
            copy. What stage() costs the loop thread is the step record's
            `ckpt_stall_s` (consume_stall_s).

  worker    one background thread does everything downstream, in order:
            persist jobs (the staged host tree written by DCP and
            committed through io.write_host_state: retries, sidecar,
            marker, pruning) and replicate jobs (the staged bytes to the
            peer store and the ring buddy, checkpoint/peer.py). Each job
            first waits for the copies' event. While the pipeline is on,
            every save goes through it, the wait=True ones too, which
            drain the queue: two writers would interleave the checkpoint
            group's collectives.

The buffer sets live in a free list of at most `max_buffer_sets` (2):
steady state allocates nothing. A stage() that finds no free set while
fewer than two exist pins a new one (last_alloc_s: seconds, as cold as
save_state's first snapshot); when every set is in flight, it waits for
one. Both are charged to ckpt_stall_s. Unlike
vitax's pipeline, the persist job writes the host copies themselves, so
no second device copy of the state is made.

Nothing here changes the step's kernels: they run the same with the
pipeline on or off.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from vitax_torch.telemetry.threads import join_or_warn

def flatten_state(tree: Dict[str, object]) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a train_state_dict tree, paths "group.name" (as DCP
    joins them) or "group" for the counters, in the tree's order."""
    out = []
    for group, v in tree.items():
        if isinstance(v, dict):
            out.extend((f"{group}.{name}", t) for name, t in v.items())
        else:
            out.append((group, v))
    return out


def _index_of(t: torch.Tensor) -> Optional[List[Tuple[int, int]]]:
    """The rank's shard of `t` as global [(start, stop)] a dim: the whole
    tensor for a plain one; for a DTensor its local shape at its global
    offset; None where that is no box (a strided shard)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return [(0, int(d)) for d in t.shape]
    if any(type(p).__name__ == "_StridedShard" for p in t.placements):
        return None
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return [(int(o), int(o) + int(n)) for o, n in zip(offset, shape)]


class _LeafSpec:
    """A leaf's layout, fixed for the run: its path, global shape and
    dtype, the local shard's shape, its DTensor spec (or None) and its
    global index box."""

    __slots__ = ("path", "shape", "dtype", "local_shape", "dt_spec", "index")

    def __init__(self, path: str, t: torch.Tensor):
        from torch.distributed.tensor import DTensor
        self.path = path
        self.shape = tuple(int(d) for d in t.shape)
        self.dtype = t.dtype
        self.dt_spec = t._spec if isinstance(t, DTensor) else None
        self.local_shape = tuple((t.to_local() if isinstance(t, DTensor) else t).shape)
        self.index = _index_of(t)


class HostSnapshot:
    """One staged copy of the rank's state: what a persist or replicate job
    needs, with no reference to the live tensors. `ready` is the side
    stream's event (None on the CPU): wait_ready() before reading."""

    def __init__(self, pipeline, buffer_set, specs, *, epoch, step_in_epoch, process_count, stream_cursor,
                 ready=None):
        self._pipeline = pipeline
        self._buffer_set = buffer_set
        self._refs = 1
        self._lock = threading.Lock()
        self.specs = specs
        self.epoch = int(epoch)
        self.step_in_epoch = int(step_in_epoch)
        self.process_count = int(process_count)
        self.stream_cursor = stream_cursor
        self._ready = ready

    @property
    def version(self) -> Tuple[int, int, int]:
        """(epoch, step_in_epoch, topology): the replication version tag."""
        return (self.epoch, self.step_in_epoch, self.process_count)

    def buffers(self, leaf_i: int) -> torch.Tensor:
        return self._buffer_set[leaf_i]

    def wait_ready(self) -> None:
        if self._ready is not None:
            self._ready.synchronize()

    def host_tree(self) -> Dict[str, object]:
        """The train_state_dict tree over the host copies (DTensors over the
        copied local shards, with the live leaves' specs): what DCP writes."""
        from torch.distributed.tensor import DTensor
        tree: Dict[str, object] = {}
        for spec, buf in zip(self.specs, self._buffer_set):
            leaf = DTensor(buf, spec.dt_spec, requires_grad=False) if spec.dt_spec is not None else buf
            group, _, name = spec.path.partition(".")
            if name:
                tree.setdefault(group, {})[name] = leaf
            else:
                tree[group] = leaf
        return tree

    def retain(self) -> None:
        with self._lock:
            self._refs += 1

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            done = self._refs == 0
        if done:
            self._pipeline._return_buffers(self._buffer_set)


class SnapshotPipeline:
    """Stage on the loop thread, persist and replicate on one worker (see
    the module docstring). submit(), drain() and close() from the loop
    thread."""

    def __init__(self, max_buffer_sets: int = 2, device=None):
        assert max_buffer_sets >= 1, max_buffer_sets
        self.max_buffer_sets = int(max_buffer_sets)
        self.device = torch.device(device) if device is not None else None
        self._specs: Optional[List[_LeafSpec]] = None
        self._free: List[list] = []
        self._allocated = 0
        self._cond = threading.Condition()
        self._q: queue.Queue = queue.Queue()
        self._errors: List[BaseException] = []
        self._stall_s = 0.0
        self.last_stall_s = 0.0
        self.last_alloc_s = 0.0         # of last_stall_s, the pinning of a new buffer set (0.0 when reused)
        self._stream = None
        self._worker = threading.Thread(target=self._run, daemon=True, name="vitax-torch-snapshot-writer")
        self._worker.start()
        self._closed = False

    # -- staging (the loop thread; the only part that may stall a step) --------
    def stage(self, state, *, epoch: int, step_in_epoch: int = 0,
              stream_cursor: Optional[dict] = None) -> HostSnapshot:
        from vitax_torch.checkpoint.io import train_state_dict
        from vitax_torch.distributed import process_count
        from vitax_torch.train.state import local
        self.raise_pending()
        t0 = time.perf_counter()
        leaves = flatten_state(train_state_dict(state))
        if self._specs is None:
            self._specs = [_LeafSpec(path, t) for path, t in leaves]
        buffer_set = self._acquire_buffers()
        cuda = any(local(t).device.type == "cuda" for _, t in leaves)
        ready = None
        if cuda:
            compute = torch.cuda.current_stream()
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            side = self._stream
            side.wait_stream(compute)           # step N's results, in stream order: no host wait
            with torch.cuda.stream(side):
                for (_, t), buf in zip(leaves, buffer_set):
                    src = local(t).detach()
                    buf.copy_(src, non_blocking=True)
                    if src.device.type == "cuda":
                        src.record_stream(side)  # a replaced `count` is not reused under the copy
            ready = torch.cuda.Event()
            ready.record(side)
            state.staged.append(ready)          # the next update (B) waits for it
        else:
            for (_, t), buf in zip(leaves, buffer_set):
                buf.copy_(local(t).detach())
        snapshot = HostSnapshot(self, buffer_set, self._specs, epoch=epoch, step_in_epoch=step_in_epoch,
                                process_count=process_count(), stream_cursor=stream_cursor, ready=ready)
        self.last_stall_s = time.perf_counter() - t0
        self._stall_s += self.last_stall_s
        return snapshot

    def consume_stall_s(self) -> float:
        """The staging stall accumulated since the last call (the loop
        divides it by its record window, as loader.consume_wait_s)."""
        s, self._stall_s = self._stall_s, 0.0
        return s

    # -- dispatch --------------------------------------------------------------
    def submit(self, state, *, epoch: int, step_in_epoch: int = 0, stream_cursor: Optional[dict] = None,
               persist_to: Optional[str] = None, keep: int = 0, extra_meta: Optional[dict] = None,
               replicator=None, wait: bool = False) -> HostSnapshot:
        """stage() and queue the jobs asked for: `persist_to` writes and
        commits a DCP checkpoint of `epoch` there (io.write_host_state);
        `replicator` hands the staged bytes to the peer store and the ring
        buddy. wait=True (or VITAX_CKPT_SYNC=1) drains the queue before
        returning: the final and emergency saves."""
        from vitax_torch.checkpoint import io as ckpt_io
        wait = wait or os.environ.get("VITAX_CKPT_SYNC", "") == "1"
        group = ckpt_io.checkpoint_group() if persist_to is not None else None  # a collective: the loop thread
        snapshot = self.stage(state, epoch=epoch, step_in_epoch=step_in_epoch, stream_cursor=stream_cursor)
        jobs = []
        if persist_to is not None:
            jobs.append(lambda: self._persist(snapshot, persist_to, group, keep=keep, extra_meta=extra_meta))
        if replicator is not None:
            jobs.append(lambda: self._replicate(snapshot, replicator))
        for _ in jobs[1:]:
            snapshot.retain()
        if not jobs:
            snapshot.release()
            return snapshot
        for job in jobs:
            self._q.put((job, snapshot))
        if wait:
            self.drain()
        return snapshot

    @staticmethod
    def _persist(snapshot: HostSnapshot, ckpt_dir: str, group, *, keep: int, extra_meta: Optional[dict]) -> None:
        from vitax_torch.checkpoint import io as ckpt_io
        snapshot.wait_ready()
        ckpt_io.write_host_state(ckpt_dir, snapshot.epoch, snapshot.host_tree(), group,
                                 step_in_epoch=snapshot.step_in_epoch or None, stream_cursor=snapshot.stream_cursor,
                                 keep=keep, extra_meta=extra_meta)

    @staticmethod
    def _replicate(snapshot: HostSnapshot, replicator) -> None:
        snapshot.wait_ready()
        replicator.replicate(snapshot)

    def drain(self) -> None:
        """Block until every queued job ran; raise a worker's error."""
        self._q.join()
        self.raise_pending()

    def raise_pending(self) -> None:
        with self._cond:
            err = self._errors.pop(0) if self._errors else None
        if err is not None:
            raise RuntimeError("snapshot pipeline: a background save/replicate job failed") from err

    def close(self) -> None:
        """Drain and stop the worker. Never raises (callers sit in finally
        blocks); errors left are printed, the waited saves raised theirs."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        join_or_warn(self._worker, timeout=600.0, what="snapshot writer")
        with self._cond:
            errors = list(self._errors)
        for err in errors:
            print(f"vitax_torch.snapshot: background job failed ({type(err).__name__}: {err})", file=sys.stderr,
                  flush=True)

    # -- internals -------------------------------------------------------------
    def _acquire_buffers(self) -> list:
        with self._cond:
            while not self._free and self._allocated >= self.max_buffer_sets:
                self._cond.wait(timeout=1.0)    # every set in flight: honest backpressure, inside the stall
            self.last_alloc_s = 0.0
            if self._free:
                return self._free.pop()
            self._allocated += 1
        t0 = time.perf_counter()
        pin = torch.cuda.is_available() and (self.device is None or self.device.type == "cuda")
        buffer_set = [torch.empty(spec.local_shape, dtype=spec.dtype, pin_memory=pin) for spec in self._specs]
        self.last_alloc_s = time.perf_counter() - t0
        return buffer_set

    def _return_buffers(self, buffer_set: list) -> None:
        with self._cond:
            self._free.append(buffer_set)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            job, snapshot = item
            try:
                job()
            except BaseException as e:  # noqa: BLE001 - raised at the next submit or drain, never lost
                with self._cond:
                    self._errors.append(e)
                print(f"vitax_torch.snapshot: background job failed ({type(e).__name__}: {e})", file=sys.stderr,
                      flush=True)
            finally:
                snapshot.release()
                self._q.task_done()
