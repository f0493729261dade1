"""Streaming dataset and loader (vitax/data/stream/loader.py): shard
records -> decode -> device.

`StreamLoader` has `ShardedLoader`'s interface (`epoch(epoch,
start_step)`, `steps_per_epoch`, `consume_wait_s()`), so the train loop
takes either. Records come from the shard reader as bytes, and a batch of
JPEG records decodes in one GIL-free native call from memory
(data/native.py process_batch_bytes); anything else goes through PIL on
a thread pool, as in the ImageFolder dataset. A record's global id, its
ImageFolder index, seeds its augmentation, so both datasets give the same
pixels for the same sample.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from vitax_torch.data import native
from vitax_torch.data.imagefolder import DecodeCounts, pil_decode, resolve_native
from vitax_torch.data.loader import PrefetchLoader, host_batch
from vitax_torch.data.stream.format import ShardReader, load_split_meta
from vitax_torch.data.stream.sampler import StreamSampler


class StreamDataset:
    """Decodes (shard_id, record_id, global_id) entries of one split.
    `use_native` as in ImageFolderDataset; `decoded` counts the items each
    path decoded."""

    def __init__(self, split_dir: str, transform=None, use_native: Optional[bool] = None):
        self.split_dir = split_dir
        self.transform = transform
        self.meta = load_split_meta(split_dir)
        self.reader = ShardReader(split_dir, self.meta)
        self.classes = list(self.meta.get("classes", []))
        self.num_records = int(self.meta["num_records"])
        self.use_native = resolve_native(use_native, transform)
        self._normalize = getattr(transform, "normalize", True)
        self.decoded = DecodeCounts()

    def set_epoch(self, epoch: int) -> None:
        if self.transform is not None and hasattr(self.transform, "set_epoch"):
            self.transform.set_epoch(epoch)

    def __len__(self) -> int:
        return self.num_records

    def __repr__(self) -> str:
        path = "native" if self.use_native else "PIL"
        return (f"StreamDataset(split_dir={self.split_dir!r}, classes={len(self.classes)}, "
                f"records={self.num_records}, shards={len(self.meta['shards'])}, decode={path})")

    def load_entries(self, entries: Sequence[Tuple[int, int, int]], n_threads: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One batch of (shard_id, record_id, global_id) entries in plan
        order. Returns (images, labels int32) as ImageFolderDataset.load_batch."""
        payloads, labels = [], []
        for shard_id, record_id, _ in entries:
            payload, label = self.reader.read_record(int(shard_id), int(record_id))
            payloads.append(payload)
            labels.append(label)
        out_size, resize_to = self.transform.image_size, getattr(self.transform, "resize_to", 0)
        images = np.empty((len(entries), out_size, out_size, 3), np.float32 if self._normalize else np.uint8)
        native_pos, params = [], []
        if self.use_native:
            for pos, (_, _, global_id) in enumerate(entries):
                size = native.jpeg_size_bytes(payloads[pos]) if native.is_jpeg_bytes(payloads[pos]) else None
                if size is not None:
                    native_pos.append(pos)
                    params.append(self.transform.native_params(size[0], size[1], int(global_id)))
        fallback = sorted(set(range(len(entries))) - set(native_pos))
        if native_pos:
            batch, failed = native.process_batch_bytes([payloads[p] for p in native_pos], params, out_size,
                                                       resize_to, n_threads, normalize=self._normalize)
            failed = set(failed)
            for j, pos in enumerate(native_pos):
                if j in failed:
                    fallback.append(pos)
                else:
                    images[pos] = batch[j]
            self.decoded.add("native", len(native_pos) - len(failed))

        def pil_item(pos: int) -> np.ndarray:
            img = pil_decode(payloads[pos], self.transform, int(entries[pos][2]))
            self.decoded.add("pil", jpeg=native.is_jpeg_bytes(payloads[pos]))
            return img

        # PIL releases the GIL while it decodes and resamples, so threads help
        with ThreadPoolExecutor(max(1, min(n_threads, len(fallback)))) as pool:
            for pos, img in zip(fallback, pool.map(pil_item, fallback)):
                images[pos] = img
        return images, np.asarray(labels, np.int32)

    def close(self) -> None:
        self.reader.close()


class StreamLoader(PrefetchLoader):
    """Device batches from a shard set: a producer thread reads and decodes
    each batch of the epoch's plan, `prefetch` batches ahead."""

    def __init__(self, dataset: StreamDataset, sampler: StreamSampler, device: torch.device,
                 num_workers: int = 4, prefetch: int = 2):
        super().__init__(device, num_workers, prefetch, sampler.steps_per_epoch)
        self.dataset = dataset
        self.sampler = sampler

    def _load_host(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        entries = [(int(s), int(r), self.sampler.global_id(s, r)) for s, r in rows]
        images, labels = self.dataset.load_entries(entries, self.num_workers)
        return host_batch(images, labels, self.device)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield device batches for one epoch; `start_step` skips that many
        batches exactly, reading none of their records."""
        self.dataset.set_epoch(epoch)
        plan = self.sampler.epoch_entries(epoch)[start_step:]
        yield from self._iterate(plan, self._load_host, "vitax-torch-stream-prefetch", epoch)

    def cursor_for_step(self, epoch: int, step: int) -> Dict:
        """The resume cursor after `step` batches of `epoch`: what a
        mid-epoch checkpoint's sidecar records."""
        return self.sampler.cursor_for_step(epoch, step)

    def check_cursor(self, cursor: Dict, resume_step: int) -> None:
        """Raise if a checkpoint's cursor disagrees with this run's position
        after `resume_step` batches of the cursor's epoch."""
        self.sampler.check_cursor(cursor, int(cursor.get("epoch", 0)), resume_step)

    def close(self) -> None:
        self.dataset.close()
