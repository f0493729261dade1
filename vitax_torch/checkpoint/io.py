"""Checkpoints of the train state (vitax/checkpoint/orbax_io.py), in the
format of torch.distributed.checkpoint (DCP).

One directory per saved epoch, `<ckpt_dir>/epoch_<N>/`, holds DCP's
`.metadata` and `.distcp` files for the state: the model's float32
state_dict under "model", the AdamW moments under "mu" and "nu" (keyed by
parameter name), `step` (int64) and `count` (int32).

Sharded (a process group, FSDP2's DTensor params, mu and nu): each rank
snapshots only its own shards, DCP writes them with the shards' global
offsets over a gloo group of its own (the background write's collectives
never meet the step's), and rank 0 writes the commit marker once every
rank has written. A restore reshards to any world size: into DTensors on
a mesh, or into whole tensors of one process (the export's read_state).
An MoE expert leaf sharded over "ep" (and "fsdp") is a DTensor at its
global (E, ...) shape, so a checkpoint saved at one ep size restores at
another, as vitax's topology-independent checkpoints do.

Commit: DCP writes into epoch_<N>/, then `commit_success.txt` (one of
vitax's COMMIT_MARKERS) is written beside its files. A directory without a
marker is torn (a crash mid-write) and is never resumed from or pruned.
Overwriting an epoch removes its marker first, so a crash mid-overwrite
leaves a torn directory, not a stale committed one.

Saves are asynchronous, as in the JAX package: save_state copies the state
to host memory on the caller's thread (the snapshot: the next step may
then update the state in place) and writes it on one background thread.
wait=True, or VITAX_CKPT_SYNC=1 on every save, blocks until the commit.
One write runs at a time: a save first waits for the previous one, so
host memory holds one snapshot, and a card's tensors are copied into
pinned host buffers kept from the previous save of the same shapes (a
pageable copy runs at a small fraction of the pinned rate); close() frees
them, after joining the writer thread for at most CLOSE_TIMEOUT_S. The
writes of the process are held by one module-level writer, as vitax holds
one Orbax checkpointer, so wait_until_finished() drains every save made
through save_state. A failed write is reported through the thread-crash
hook (telemetry/threads.py) as well as raised on the caller.
Transient OSErrors of a write are retried with capped exponential backoff
(VITAX_SAVE_RETRIES, VITAX_SAVE_RETRY_BACKOFF_S); a write that fails for
good raises from wait_until_finished() or from the next save. The
`ckpt_write` fault site (faults.py) fires once a write attempt, inside
that retry loop. write_host_state writes a tree already on the host (the
zero-stall pipeline's persist job, checkpoint/snapshot.py) on the calling
thread. restore_read_count() counts the restores read from the checkpoint
directory: a resume from the peer stores (checkpoint/peer.py) leaves it.

A mid-epoch save records `step_in_epoch`, `process_count` and the stream
cursor in the sidecar `epoch_<N>.resume.json` beside the directory,
written atomically; an epoch-boundary save of the same epoch deletes it.
Restore loads the checkpoint into the tensors of a state whose model was
built without an init (build_model(..., init=False), then to_empty on the
device), on the state's device.

Single-file export to the JAX package's npz is checkpoint/consolidate.py.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import sys
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from vitax_torch import faults
from vitax_torch.distributed import is_distributed, process_count, process_index
from vitax_torch.telemetry.threads import join_or_warn, report_thread_exception
from vitax_torch.train.state import TrainState, local
from vitax_torch.utils.logging import master_print

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")

# Files only a committed checkpoint dir holds: Orbax's metadata file and its
# explicit marker (vitax), of which this package writes the second.
COMMIT_MARKERS = ("_CHECKPOINT_METADATA", "commit_success.txt")
COMMIT_MARKER = "commit_success.txt"

# save_state's retry of a transient write failure (env-overridable)
DEFAULT_SAVE_RETRIES = 3
DEFAULT_SAVE_RETRY_BACKOFF_S = 0.5
# DCP writer threads of a save (one .distcp file each)
WRITE_THREADS = 4
# restores read from the checkpoint directory (restore_state calls) in this
# process: a resume from peer stores leaves it where it was
_RESTORE_READS = 0
_LAST_SNAPSHOT_S = 0.0
# close()'s bound on the writer thread finishing its queued writes: the full
# 10B state (121 GB) takes about 100 s at the 1.2 GB/s measured on an H100
# host (PERF.md §5), so a thread still alive after this is wedged
CLOSE_TIMEOUT_S = 600.0


class _Writer:
    """The process's background checkpoint writes, one at a time, in order,
    the pinned host buffers their snapshots of card tensors go to, and,
    sharded, the gloo group their collectives run on."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._pending: List[Future] = []
        self._staging: Dict[str, torch.Tensor] = {}
        self._group = (None, None)          # (the default group it was made under, the group)

    def group(self):
        """The checkpoint's own gloo process group over every rank, made on
        first use under each default group (a collective: every rank calls
        save_state and restore_state at the same point); None alone."""
        if not is_distributed():
            return None
        if self._group[0] is not dist.group.WORLD:
            self._group = (dist.group.WORLD, dist.new_group(backend="gloo"))
        return self._group[1]

    def snapshot(self, tree: Dict[str, object], prefix: str = "") -> Dict[str, object]:
        """A host copy of every tensor of the tree, of a DTensor its local
        shard under the same spec; call only with no write pending (the
        write reads the buffers this reuses)."""
        from torch.distributed.tensor import DTensor
        out: Dict[str, object] = {}
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = self.snapshot(v, name + ".")
            elif isinstance(v, DTensor):        # the shard, with its place in the whole
                out[k] = DTensor(self._stage(name, local(v)), v._spec, requires_grad=False)
            else:
                out[k] = self._stage(name, v)
        if not prefix and self._staging:
            torch.cuda.synchronize()            # the non-blocking copies have landed
        return out

    def _stage(self, name: str, v: torch.Tensor) -> torch.Tensor:
        if v.device.type == "cpu":
            return v.detach().clone()
        buf = self._staging.get(name)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = self._staging[name] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        return buf.copy_(v.detach(), non_blocking=True)

    def submit(self, fn: Callable, *args) -> None:
        if self._thread is None:            # a daemon thread: wait for a save before exit (train() does)
            self._queue = queue.Queue()
            self._thread = threading.Thread(target=_run_writes, args=(self._queue,), name="vitax-torch-ckpt",
                                            daemon=True)
            self._thread.start()
        fut: Future = Future()
        self._pending.append(fut)
        self._queue.put((fut, fn, args))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()                        # re-raises a write that failed for good

    def close(self) -> None:
        """Let the thread finish its queued writes and stop, for at most
        CLOSE_TIMEOUT_S (then a leaked-thread warning and the writes are
        given up); raise the error of a write that failed; free the
        pinned buffers."""
        try:
            if self._thread is not None:
                self._queue.put(None)
                joined = join_or_warn(self._thread, CLOSE_TIMEOUT_S, what="checkpoint writer", rank=process_index())
                self._thread = None
                if not joined:
                    self._pending = []
            self.wait()
        finally:
            self._staging.clear()


def _run_writes(jobs: "queue.Queue") -> None:
    """The writer thread: run each queued (future, fn, args) in order until
    None; a failure goes to the thread-crash hook and into its future."""
    while True:
        job = jobs.get()
        if job is None:
            return
        fut, fn, args = job
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - kept in the future: wait() raises it on the caller
            report_thread_exception(e)
            fut.set_exception(e)


_WRITER = _Writer()


def last_snapshot_seconds() -> float:
    """The seconds save_state's last host copy held its caller (the
    snapshot, without any wait for the commit)."""
    return _LAST_SNAPSHOT_S


def restore_read_count() -> int:
    """How many checkpoint restores (restore_state calls) this process
    read from the checkpoint directory."""
    return _RESTORE_READS


def checkpoint_group():
    """The checkpoint's own gloo group (None alone). Made on first use, a
    collective: call it on the loop thread, at the same point on every
    rank, before a background write needs it."""
    return _WRITER.group()


def wait_until_finished() -> None:
    """Block until every save started by save_state has committed; raises
    the error of a write that failed after its retries."""
    _WRITER.wait()


def close() -> None:
    """Drain pending saves and free the pinned snapshot buffers."""
    _WRITER.close()


def epoch_ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"epoch_{epoch}")


def _resume_meta_path(ckpt_dir: str, epoch: int) -> str:
    # beside the checkpoint dir, not in it; the name does not match _EPOCH_RE
    return epoch_ckpt_path(ckpt_dir, epoch) + ".resume.json"


def load_resume_step(ckpt_dir: str, epoch: int) -> Optional[int]:
    """Completed steps-in-epoch recorded with a mid-epoch save of `epoch`,
    or None for an epoch-boundary checkpoint (or an unreadable sidecar)."""
    path = _resume_meta_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            step = json.load(f)["step_in_epoch"]
        return int(step) if step and step > 0 else None
    except (json.JSONDecodeError, KeyError, TypeError, OSError):
        return None


def load_resume_meta(ckpt_dir: str, epoch: int) -> Optional[dict]:
    """The whole mid-epoch sidecar of `epoch` ({"step_in_epoch",
    "process_count", "stream_cursor"?}), or None (boundary save, missing or
    unreadable): what train/control.py elastic_resume_plan reads."""
    path = _resume_meta_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        return payload if isinstance(payload, dict) else None
    except (json.JSONDecodeError, OSError):
        return None


def load_stream_cursor(ckpt_dir: str, epoch: int) -> Optional[dict]:
    """The stream loader's cursor recorded with a mid-epoch save of `epoch`,
    or None. The resume position is derived from (seed, epoch, step); the
    cursor lets the resumed run detect a changed shard set."""
    path = _resume_meta_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cursor = json.load(f).get("stream_cursor")
        return cursor if isinstance(cursor, dict) else None
    except (json.JSONDecodeError, OSError):
        return None


def is_committed_checkpoint(path: str) -> bool:
    """Did this checkpoint dir finish its commit (does it hold a marker)?"""
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, m)) for m in COMMIT_MARKERS)


def committed_epochs(ckpt_dir: str) -> List[int]:
    """Ascending epochs with a committed checkpoint in ckpt_dir. Torn dirs
    (named epoch_<N> without a marker) are skipped, and each one is named."""
    if not os.path.isdir(ckpt_dir):
        return []
    epochs = []
    for name in sorted(os.listdir(ckpt_dir)):
        m = _EPOCH_RE.match(name)
        if not m:
            continue
        if is_committed_checkpoint(os.path.join(ckpt_dir, name)):
            epochs.append(int(m.group(1)))
        else:
            master_print(f"vitax_torch.checkpoint: skipping torn checkpoint {os.path.join(ckpt_dir, name)} "
                         f"(no commit marker — a crash mid-write left it partial)")
    return sorted(epochs)


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """Highest epoch with a committed checkpoint in ckpt_dir, or None."""
    epochs = committed_epochs(ckpt_dir)
    return max(epochs) if epochs else None


def train_state_dict(state: TrainState) -> Dict[str, object]:
    """The checkpointed tree of a state. The tensors are the state's own
    (the model's state_dict shares its parameters' storage), except `step`,
    a new int64 tensor of the host counter."""
    return {"model": state.model.state_dict(), "mu": state.mu, "nu": state.nu,
            "step": torch.tensor(state.step, dtype=torch.int64), "count": state.count}


def _transient(e: BaseException) -> bool:
    """An OSError, raised or wrapped by DCP."""
    from torch.distributed.checkpoint.api import CheckpointException
    if isinstance(e, CheckpointException):
        return any(isinstance(exc, OSError) for exc, _ in e.failures.values())
    return isinstance(e, OSError)


def _write(path: str, snapshot: Dict[str, object], retries: int, backoff_s: float, group) -> None:
    """DCP-save the snapshot into `path` (over `group` when sharded),
    retrying transient failures, then, once every rank has written, the
    commit marker from rank 0."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    attempts = max(retries, 1)
    for attempt in range(attempts):
        try:
            faults.fire("ckpt_write")           # drill point: one a write attempt, so `times` > 1 drills the retry
            os.makedirs(path, exist_ok=True)
            dcp.save(snapshot, storage_writer=dcp.FileSystemWriter(path, thread_count=WRITE_THREADS, overwrite=True),
                     process_group=group, no_dist=group is None)
            break
        except (OSError, CheckpointException) as e:
            if attempt + 1 >= attempts or not _transient(e):
                print(f"vitax_torch.checkpoint: save of {path} failed after {attempt + 1} attempt(s): "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
                raise
            delay = backoff_s * (2 ** attempt)
            print(f"vitax_torch.checkpoint: transient save failure for {path} (attempt {attempt + 1}/"
                  f"{attempts}: {type(e).__name__}: {e}); retrying in {delay:.2f}s", file=sys.stderr, flush=True)
            time.sleep(delay)
    if group is not None:
        dist.barrier(group=group)
    if process_index() == 0:
        with open(os.path.join(path, COMMIT_MARKER), "w") as f:
            f.write(f"Checkpoint commit was successful to {path}\n")


def _remove_markers(path: str) -> None:
    """An overwrite is torn until it commits (process 0)."""
    if process_index() == 0:
        for marker in COMMIT_MARKERS:
            try:
                os.remove(os.path.join(path, marker))
            except FileNotFoundError:
                pass


def _write_sidecar(ckpt_dir: str, epoch: int, step_in_epoch: Optional[int], stream_cursor: Optional[dict],
                   extra_meta: Optional[dict]) -> None:
    """Process 0 records a mid-epoch save's step, process count, stream
    cursor and `extra_meta` in the sidecar (atomically), or deletes a
    stale one for an epoch-boundary save."""
    if process_index() != 0:
        return
    meta = _resume_meta_path(ckpt_dir, epoch)
    if step_in_epoch:
        payload = {"step_in_epoch": int(step_in_epoch), "process_count": process_count()}
        if stream_cursor is not None:
            payload["stream_cursor"] = stream_cursor
        if extra_meta:
            payload.update(extra_meta)
        os.makedirs(os.path.dirname(meta), exist_ok=True)
        tmp = meta + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(payload))
        os.replace(tmp, meta)               # atomic: never a half-written sidecar
    elif os.path.exists(meta):
        os.remove(meta)


def _retry_policy() -> Tuple[int, float]:
    return (int(os.environ.get("VITAX_SAVE_RETRIES", DEFAULT_SAVE_RETRIES)),
            float(os.environ.get("VITAX_SAVE_RETRY_BACKOFF_S", DEFAULT_SAVE_RETRY_BACKOFF_S)))


def save_state(ckpt_dir: str, epoch: int, state: TrainState, wait: bool = False,
               step_in_epoch: Optional[int] = None, stream_cursor: Optional[dict] = None,
               keep: int = 0, extra_meta: Optional[dict] = None) -> str:
    """Save the train state for `epoch`; returns its directory once the
    host snapshot is taken (the write commits in the background; wait=True
    or VITAX_CKPT_SYNC=1 blocks until it has).

    step_in_epoch > 0 marks a mid-epoch save: process 0 records it, the
    process count, `stream_cursor` and `extra_meta` in the sidecar; an
    epoch-boundary save deletes a stale sidecar of the epoch. keep > 0
    prunes committed epochs beyond the newest `keep` (prune_checkpoints)."""
    global _LAST_SNAPSHOT_S
    path = epoch_ckpt_path(ckpt_dir, epoch)
    wait = wait or os.environ.get("VITAX_CKPT_SYNC", "") == "1"
    _WRITER.wait()                              # the previous write commits before this snapshot
    group = _WRITER.group()
    t0 = time.perf_counter()
    snapshot = _WRITER.snapshot(train_state_dict(state))
    _LAST_SNAPSHOT_S = time.perf_counter() - t0
    _remove_markers(path)
    _WRITER.submit(_write, path, snapshot, *_retry_policy(), group)
    if wait:
        _WRITER.wait()
    _write_sidecar(ckpt_dir, epoch, step_in_epoch, stream_cursor, extra_meta)
    master_print(f"checkpoint save {'committed' if wait else 'started'}: {path}"
                 + (f" (mid-epoch, {step_in_epoch} steps done)" if step_in_epoch else ""))
    if keep > 0 and process_index() == 0:
        prune_checkpoints(ckpt_dir, keep)
    return path


def write_host_state(ckpt_dir: str, epoch: int, tree: Dict[str, object], group,
                     step_in_epoch: Optional[int] = None, stream_cursor: Optional[dict] = None,
                     keep: int = 0, extra_meta: Optional[dict] = None) -> str:
    """Write and commit a train state that is already on the host (the
    train_state_dict tree of a staged snapshot, checkpoint/snapshot.py),
    on the calling thread: the zero-stall pipeline's persist job. `group`
    is checkpoint_group(), made beforehand on the loop thread. Retries,
    commit marker, sidecar and pruning as save_state's."""
    path = epoch_ckpt_path(ckpt_dir, epoch)
    _remove_markers(path)
    _write(path, tree, *_retry_policy(), group)
    _write_sidecar(ckpt_dir, epoch, step_in_epoch, stream_cursor, extra_meta)
    master_print(f"checkpoint save committed: {path}"
                 + (f" (mid-epoch, {step_in_epoch} steps done)" if step_in_epoch else ""))
    if keep > 0 and process_index() == 0:
        prune_checkpoints(ckpt_dir, keep)
    return path


def prune_checkpoints(ckpt_dir: str, keep: int) -> List[int]:
    """Delete committed epoch dirs (and their sidecars) beyond the newest
    `keep`; torn dirs are never touched. keep <= 0 keeps all. Returns the
    pruned epochs."""
    if keep <= 0:
        return []
    committed = committed_epochs(ckpt_dir)
    doomed = committed[:-keep] if len(committed) > keep else []
    for ep in doomed:
        shutil.rmtree(epoch_ckpt_path(ckpt_dir, ep), ignore_errors=True)
        try:
            os.remove(_resume_meta_path(ckpt_dir, ep))
        except OSError:
            pass
    if doomed:
        master_print(f"checkpoint GC: pruned committed epoch(s) {doomed} (--keep_checkpoints {keep})")
    return doomed


def restore_state(ckpt_dir: str, epoch: int, state: TrainState) -> TrainState:
    """Load the checkpoint of `epoch` into `state` in place (its params, mu,
    nu and count on their device, a sharded state's own shards; step on
    the host) and return it."""
    import torch.distributed.checkpoint as dcp
    global _RESTORE_READS
    wait_until_finished()                       # an in-flight save of this epoch commits first
    path = epoch_ckpt_path(ckpt_dir, epoch)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    _RESTORE_READS += 1                         # a peer restore leaves it alone
    target = train_state_dict(state)
    group = _WRITER.group()
    dcp.load(target, checkpoint_id=path, process_group=group, no_dist=group is None)
    state.step = int(target["step"])
    master_print(f"resumed from checkpoint {path}")
    return state


def restore_state_with_fallback(ckpt_dir: str, epoch: int, state: TrainState) -> Tuple[TrainState, int]:
    """restore_state, falling back loudly to the previous committed epoch
    when the requested one fails to restore. Returns (state, the epoch
    restored); raises only when every candidate fails."""
    from torch.distributed.checkpoint.api import CheckpointException
    candidates = [ep for ep in committed_epochs(ckpt_dir) if ep <= epoch]
    if epoch not in candidates:
        candidates.append(epoch)                # honor an explicit ask even if unmarked
    last_err: Optional[BaseException] = None
    for ep in sorted(set(candidates), reverse=True):
        try:
            return restore_state(ckpt_dir, ep, state), ep
        except (Exception, CheckpointException) as e:  # noqa: BLE001 — fall back across any restore failure
            last_err = e
            print(f"vitax_torch.checkpoint: RESTORE FAILED for epoch {ep} at {epoch_ckpt_path(ckpt_dir, ep)} "
                  f"({type(e).__name__}: {e}); falling back to the previous committed epoch",
                  file=sys.stderr, flush=True)
    raise RuntimeError(f"no committed epoch <= {epoch} in {ckpt_dir} could be restored") from last_err


def read_state(ckpt_dir: str, epoch: int,
               groups: Tuple[str, ...] = ("model", "mu", "nu", "step", "count")) -> Dict[str, object]:
    """The checkpoint of `epoch` as CPU tensors, shaped by its own metadata
    (no model or config needed): {"model": {...}, "mu": {...}, "nu": {...},
    "step": int, "count": tensor}, reading only the entries of `groups`."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    wait_until_finished()
    path = epoch_ckpt_path(ckpt_dir, epoch)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    tree: Dict[str, object] = {}
    for key, m in dcp.FileSystemReader(path).read_metadata().state_dict_metadata.items():
        if not isinstance(m, TensorStorageMetadata):
            raise ValueError(f"{path}: entry {key!r} is not a tensor; not a vitax_torch checkpoint")
        group, _, name = key.partition(".")     # DCP joins nested keys with "."
        if group not in groups:
            continue
        leaf = torch.empty(m.size, dtype=m.properties.dtype)
        if name:
            tree.setdefault(group, {})[name] = leaf
        else:
            tree[group] = leaf
    group = _WRITER.group()
    dcp.load(tree, checkpoint_id=path, process_group=group, no_dist=group is None)
    if "step" in tree:
        tree["step"] = int(tree["step"])
    return tree
