"""Host input pipeline with device prefetch (vitax/data/loader.py).

- `ShardedSampler`: the epoch-seeded, drop-last index order of the JAX
  package (DistributedSampler parity, rank-interleaved), so both packages
  visit the same samples in the same order for a seed.
- `ShardedLoader`: one device of one process. A producer thread builds each
  batch on the host, `prefetch` batches ahead: one GIL-free native call a
  batch where the dataset decodes natively (`load_batch`), else
  `__getitem__` on a pool of `num_workers` threads. It pins the batch when
  the device is a card and queues it; the consumer copies it to the device
  without blocking, so the copy overlaps the previous step, and adds the
  time it waited on the queue to `consume_wait_s`. A producer failure is
  re-raised on the consumer with the worker's traceback, and reported
  through the thread-crash hook (telemetry/threads.py), as is a decode
  pool worker's.

`build_datasets` builds the fake, ImageFolder or streaming splits, each
process reading its interleaved slice of every global batch (a process
of a torchrun launch: its rank and the world size). Under
`device_normalize` the batches stay uint8 and the train step normalizes
them on the card (train/step.py prepare_images).
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from vitax_torch import distributed
from vitax_torch.config import Config
from vitax_torch.data.fake import TRAIN_SPLIT_LEN, VAL_SPLIT_LEN, FakeImageNetDataset
from vitax_torch.telemetry.threads import report_thread_exception, reporting


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


def host_batch(images: np.ndarray, labels, device: torch.device) -> Dict[str, torch.Tensor]:
    """{"image", "label"} tensors on the host (labels int64), pinned when the
    device is a card so the copy to it can run without blocking."""
    if images.dtype != np.uint8:              # uint8 = normalized on the device
        images = images.astype(np.float32, copy=False)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(np.asarray(labels, np.int64))}
    if device.type == "cuda":
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch


class PrefetchLoader:
    """The producer/consumer machinery both loaders share: a producer
    thread runs `load(row)` for each row of an epoch's plan, `prefetch`
    batches ahead; the consumer moves each to the device."""

    def __init__(self, device: torch.device, num_workers: int, prefetch: int, steps_per_epoch: int):
        self.device = torch.device(device)
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.steps_per_epoch = steps_per_epoch
        self._wait_s = 0.0                    # consumer time blocked on the queue

    def consume_wait_s(self) -> float:
        """Seconds the training thread spent blocked waiting for a batch
        since the last call, then reset. A step whose time tracks this is
        input-bound. Read and written on the consumer thread only."""
        w, self._wait_s = self._wait_s, 0.0
        return w

    def _iterate(self, plan: Iterable, load: Callable, name: str, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for row in plan:
                    if stop.is_set():
                        return
                    q.put(load(row))
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                report_thread_exception(e)
                q.put(_ProducerFailure(e, traceback.format_exc()))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True, name=name)
        t.start()
        try:
            while True:
                t_wait = time.monotonic()
                item = q.get()
                self._wait_s += time.monotonic() - t_wait
                if item is None:
                    return
                if isinstance(item, _ProducerFailure):
                    raise LoaderWorkerError(
                        f"data worker failed while producing epoch {epoch}: "
                        f"{type(item.exc).__name__}: {item.exc}\n"
                        f"--- worker traceback ({name} thread) ---\n{item.tb}") from item.exc
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


class ShardedLoader(PrefetchLoader):
    """Iterates device batches {"image", "label"} over a map-style dataset."""

    def __init__(self, dataset, sampler: ShardedSampler, device: torch.device, num_workers: int = 4,
                 prefetch: int = 2):
        super().__init__(device, num_workers, prefetch, sampler.steps_per_epoch)
        self.dataset = dataset
        self.sampler = sampler

    def _load_host(self, pool: ThreadPoolExecutor, indices: Sequence[int]) -> Dict[str, torch.Tensor]:
        if getattr(self.dataset, "use_native", False):
            # the whole batch in one GIL-free native call, on its own threads
            images, labels = self.dataset.load_batch(indices, self.num_workers)
        else:
            items = list(pool.map(reporting(self.dataset.__getitem__), indices))
            images, labels = np.stack([it[0] for it in items]), [it[1] for it in items]
        return host_batch(images, labels, self.device)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield device batches for one epoch. `epoch` seeds the order and
        the augmentation; `start_step` skips that many batches exactly (the
        order is a function of (seed, epoch), so nothing skipped is read)."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        plan = self.sampler.epoch_indices(epoch)[start_step:]
        with ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="vitax-torch-data") as pool:
            yield from self._iterate(plan, lambda row: self._load_host(pool, row), "vitax-torch-prefetch", epoch)


def build_datasets(cfg: Config, device: torch.device, use_native: Optional[bool] = None
                   ) -> Tuple[object, PrefetchLoader, object, PrefetchLoader]:
    """(train_ds, train_loader, val_ds, val_loader) for this config
    (vitax/data/loader.py build_datasets): the fake ImageNet splits, an
    ImageFolder tree under cfg.data_dir/{train,val}, or, under
    `--data_format stream`, its packed shards. `use_native` picks the
    decode path of a real tree (None: native where it builds). The loaders
    read this process's rows of each global batch: the rank's of the world
    size (0 of 1 alone)."""
    device = torch.device(device)
    rank, world = distributed.process_index(), distributed.process_count()
    if cfg.data_format == "stream":
        from vitax_torch.data.stream import build_stream_datasets
        return build_stream_datasets(cfg, device, use_native, rank, world)
    if cfg.fake_data:
        train_ds = FakeImageNetDataset(cfg.image_size, TRAIN_SPLIT_LEN)
        val_ds = FakeImageNetDataset(cfg.image_size, VAL_SPLIT_LEN)
    else:
        from vitax_torch.data.imagefolder import ImageFolderDataset
        from vitax_torch.data.transforms import TrainTransform, ValTransform
        norm_on_host = not cfg.device_normalize
        train_ds = ImageFolderDataset(os.path.join(cfg.data_dir, "train"),
                                      TrainTransform(cfg.image_size, cfg.seed, normalize=norm_on_host), use_native)
        val_ds = ImageFolderDataset(os.path.join(cfg.data_dir, "val"),
                                    ValTransform(cfg.image_size, normalize=norm_on_host), use_native)
    train_sampler = ShardedSampler(len(train_ds), cfg.batch_size, shuffle=True, seed=cfg.seed,
                                   process_index=rank, process_count=world)
    val_sampler = ShardedSampler(len(val_ds), cfg.batch_size, shuffle=False, seed=cfg.seed,
                                 process_index=rank, process_count=world)
    return (train_ds, ShardedLoader(train_ds, train_sampler, device, cfg.num_workers, cfg.prefetch_batches),
            val_ds, ShardedLoader(val_ds, val_sampler, device, cfg.num_workers, cfg.prefetch_batches))
