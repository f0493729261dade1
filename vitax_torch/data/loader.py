"""Host input pipeline with device prefetch (vitax/data/loader.py).

- `ShardedSampler`: the epoch-seeded, drop-last index order of the JAX
  package (DistributedSampler parity, rank-interleaved), so both packages
  visit the same samples in the same order for a seed.
- `ShardedLoader`: one process, one device. A producer thread stacks each
  batch on the host (a thread pool runs `__getitem__`), pins it when the
  device is a card, and queues it; the consumer copies it to the device
  without blocking, so the copy overlaps the previous step. A producer
  failure is re-raised on the consumer with the worker's traceback.

`build_datasets` has the fake-data source only in this slice: an
ImageFolder tree waits for the slice that ports the train transforms.
"""

from __future__ import annotations

import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from vitax_torch.config import Config
from vitax_torch.data.fake import TRAIN_SPLIT_LEN, VAL_SPLIT_LEN, FakeImageNetDataset


class LoaderWorkerError(RuntimeError):
    """A producer-thread failure, re-raised on the consuming thread with the
    worker's own traceback attached."""


class _ProducerFailure:
    __slots__ = ("exc", "tb")

    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


class ShardedSampler:
    """Epoch-seeded, per-process index shard (vitax ShardedSampler)."""

    def __init__(self, dataset_len: int, global_batch: int, shuffle: bool, seed: int,
                 process_index: int = 0, process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} not divisible by {process_count} processes")
        self.dataset_len = dataset_len
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = global_batch // process_count
        self.steps_per_epoch = dataset_len // global_batch     # drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """(steps_per_epoch, local_batch) index matrix for this process."""
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        usable = self.steps_per_epoch * self.global_batch
        order = order[:usable].reshape(self.steps_per_epoch, self.global_batch)
        return order[:, self.process_index::self.process_count]


PREFETCH = 2                              # host batches queued ahead of the step


class ShardedLoader:
    """Iterates device batches {"image", "label"} with background prefetch."""

    def __init__(self, dataset, sampler: ShardedSampler, device: torch.device, num_workers: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.device = torch.device(device)
        self.num_workers = num_workers        # threads running __getitem__
        self.steps_per_epoch = sampler.steps_per_epoch

    def _load_host(self, pool: ThreadPoolExecutor, indices: Sequence[int]) -> Dict[str, torch.Tensor]:
        items = list(pool.map(self.dataset.__getitem__, indices))
        images = np.stack([it[0] for it in items])
        if images.dtype != np.uint8:          # uint8 = device-side normalisation
            images = images.astype(np.float32)
        batch = {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(np.asarray([it[1] for it in items], np.int64))}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield device batches for one epoch; `epoch` seeds the order."""
        index_matrix = self.sampler.epoch_indices(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers,
                                        thread_name_prefix="vitax-torch-data") as pool:
                    for row in index_matrix:
                        if stop.is_set():
                            return
                        q.put(self._load_host(pool, row))
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(_ProducerFailure(e, traceback.format_exc()))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True, name="vitax-torch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerFailure):
                    raise LoaderWorkerError(
                        f"data worker failed while producing epoch {epoch}: "
                        f"{type(item.exc).__name__}: {item.exc}\n"
                        f"--- worker traceback (vitax-torch-prefetch thread) ---\n{item.tb}") from item.exc
                yield {k: v.to(self.device, non_blocking=True) for k, v in item.items()}
        finally:
            stop.set()
            # drain until the producer exits: one blocked in q.put needs a
            # free slot to see `stop`
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def build_datasets(cfg: Config, device: torch.device) -> Tuple[object, ShardedLoader, object, ShardedLoader]:
    """(train_ds, train_loader, val_ds, val_loader) for this config: the
    fake ImageNet splits (vitax/data/loader.py build_datasets)."""
    if not cfg.fake_data:
        raise ValueError(f"--data_dir {cfg.data_dir!r} without --fake_data waits for the slice that "
                         f"ports the ImageFolder dataset and its train transforms; pass --fake_data")
    train_ds = FakeImageNetDataset(cfg.image_size, TRAIN_SPLIT_LEN)
    val_ds = FakeImageNetDataset(cfg.image_size, VAL_SPLIT_LEN)
    train_sampler = ShardedSampler(len(train_ds), cfg.batch_size, shuffle=True, seed=cfg.seed)
    val_sampler = ShardedSampler(len(val_ds), cfg.batch_size, shuffle=False, seed=cfg.seed)
    return train_ds, ShardedLoader(train_ds, train_sampler, device), val_ds, ShardedLoader(val_ds, val_sampler, device)
