"""Shard-to-process assignment, epoch plans and the resume cursor
(vitax/data/stream/sampler.py), the JAX package's arithmetic exactly.

- Disjoint: each shard belongs to one process, by a static greedy
  assignment from the manifest and the process count, never from the
  epoch, so steps_per_epoch is the same every epoch and an epoch's plan is
  a function of (seed, epoch).
- Epoch-seeded: each epoch permutes the process's shard order and each
  shard's record order from SeedSequence streams.
- The cursor: after `step` batches a process has consumed
  step * local_batch records of its plan, which is (shard_cursor,
  record_offset) into the epoch's shard order. `check_cursor` holds a
  recorded cursor against the one derived now, so a changed shard set
  fails instead of feeding other records. A mid-epoch checkpoint records
  the cursor in its sidecar, and the train loop checks it on resume.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def assign_shards(record_counts: Sequence[int], process_count: int) -> List[List[int]]:
    """Shards, largest first (shard id breaks ties), each to the process
    with the fewest records so far (process id breaks ties). Returns each
    process's sorted shard ids: disjoint and together exhaustive."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    hosts: List[List[int]] = [[] for _ in range(process_count)]
    loads = [0] * process_count
    for shard_id in sorted(range(len(record_counts)), key=lambda i: (-record_counts[i], i)):
        h = min(range(process_count), key=lambda j: (loads[j], j))
        hosts[h].append(shard_id)
        loads[h] += record_counts[shard_id]
    for h in hosts:
        h.sort()
    return hosts


class StreamSampler:
    """A process's epoch plans over a shard manifest, and the cursor math."""

    def __init__(self, meta: Dict, global_batch: int, shuffle: bool, seed: int,
                 process_index: int = 0, process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} not divisible by {process_count} processes")
        self.shards = meta["shards"]
        self.shuffle = shuffle
        self.seed = seed
        self.global_batch = global_batch
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = global_batch // process_count
        self.record_counts = [int(s["records"]) for s in self.shards]
        # record r of shard s is sample shard_base[s] + r: the ImageFolder
        # index of the same image, which seeds its augmentation
        self.shard_base = np.concatenate(([0], np.cumsum(self.record_counts)))[:-1].astype(np.int64)
        self.assignment = assign_shards(self.record_counts, process_count)
        self.my_shards = self.assignment[process_index]
        host_records = [sum(self.record_counts[i] for i in a) for a in self.assignment]
        # drop_last per process: every process takes the same number of steps
        self.steps_per_epoch = min(hr // self.local_batch for hr in host_records)

    def shard_order(self, epoch: int) -> List[int]:
        """This process's shards in the order the epoch consumes them."""
        if not self.shuffle or len(self.my_shards) <= 1:
            return list(self.my_shards)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 1, self.process_index]))
        return [self.my_shards[i] for i in rng.permutation(len(self.my_shards))]

    def record_order(self, epoch: int, shard_id: int) -> np.ndarray:
        """The records of one shard in the epoch's order (keyed on the shard id)."""
        n = self.record_counts[shard_id]
        if not self.shuffle:
            return np.arange(n, dtype=np.int64)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 2, shard_id]))
        return rng.permutation(n).astype(np.int64)

    def epoch_entries(self, epoch: int) -> np.ndarray:
        """(steps_per_epoch, local_batch, 2) int64 (shard_id, record_id): the
        epoch's plan, shard after shard, cut to whole batches."""
        parts = []
        for shard_id in self.shard_order(epoch):
            rec = self.record_order(epoch, shard_id)
            parts.append(np.stack([np.full_like(rec, shard_id), rec], axis=1))
        flat = np.concatenate(parts) if parts else np.empty((0, 2), np.int64)
        usable = self.steps_per_epoch * self.local_batch
        return flat[:usable].reshape(self.steps_per_epoch, self.local_batch, 2)

    def global_id(self, shard_id: int, record_id: int) -> int:
        return int(self.shard_base[shard_id]) + int(record_id)

    def _locate(self, epoch: int, step: int) -> Tuple[int, int]:
        """(shard_cursor, record_offset) after `step` batches; shard_cursor
        == len(order) once the plan is consumed."""
        if not 0 <= step <= self.steps_per_epoch:
            raise ValueError(f"step {step} outside epoch of {self.steps_per_epoch} steps")
        p = step * self.local_batch
        order = self.shard_order(epoch)
        for j, shard_id in enumerate(order):
            n = self.record_counts[shard_id]
            if p < n:
                return j, p
            p -= n
        return len(order), 0

    def cursor_for_step(self, epoch: int, step: int) -> Dict:
        """Where the next record of `epoch` comes from after `step` batches."""
        shard_cursor, record_offset = self._locate(epoch, step)
        order = self.shard_order(epoch)
        return {"epoch": int(epoch), "step": int(step), "shard_cursor": int(shard_cursor),
                "record_offset": int(record_offset),
                "shard": self.shards[order[shard_cursor]]["name"] if shard_cursor < len(order) else None,
                "process_index": int(self.process_index), "process_count": int(self.process_count)}

    def check_cursor(self, cursor: Dict, epoch: int, step: int) -> None:
        """Raise if a recorded cursor disagrees with the one derived for
        (epoch, step): the shard set, seed or topology changed."""
        if int(cursor.get("process_index", self.process_index)) != self.process_index:
            return                            # another process's cursor
        expect = self.cursor_for_step(epoch, step)
        for key in ("shard_cursor", "record_offset", "shard"):
            if cursor.get(key) != expect[key]:
                raise RuntimeError(
                    f"stream resume cursor mismatch at epoch {epoch} step {step}: checkpoint recorded "
                    f"{key}={cursor.get(key)!r}, current shard set derives {expect[key]!r} — the shard "
                    f"directory, seed, or topology changed since the checkpoint was written")
