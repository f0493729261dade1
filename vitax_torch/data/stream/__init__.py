"""Streaming data plane (vitax/data/stream/): an ImageFolder tree packed
once into `.vtxshard` containers (python -m vitax_torch.tools.make_shards)
and streamed record by record, with one open file, native in-memory JPEG
decode, a static shard assignment and a deterministic epoch plan.

Selected with `--data_format stream`, `--data_dir` at the shard root;
`build_stream_datasets` is that branch of `build_datasets`
(data/loader.py), with the same return contract.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vitax_torch.config import Config
from vitax_torch.data.stream.format import ShardFormatError, ShardReader, ShardWriter, load_split_meta
from vitax_torch.data.stream.loader import StreamDataset, StreamLoader
from vitax_torch.data.stream.sampler import StreamSampler, assign_shards

__all__ = ["ShardFormatError", "ShardReader", "ShardWriter", "StreamDataset", "StreamLoader", "StreamSampler",
           "assign_shards", "build_stream_datasets", "load_split_meta"]


def build_stream_datasets(cfg: Config, device: torch.device, use_native: Optional[bool] = None,
                          process_index: int = 0, process_count: int = 1):
    """(train_ds, train_loader, val_ds, val_loader) over a shard root, the
    shards of process `process_index` of `process_count`."""
    from vitax_torch.data.transforms import TrainTransform, ValTransform
    norm_on_host = not cfg.device_normalize
    train_ds = StreamDataset(os.path.join(cfg.data_dir, "train"),
                             TrainTransform(cfg.image_size, cfg.seed, normalize=norm_on_host), use_native)
    val_ds = StreamDataset(os.path.join(cfg.data_dir, "val"), ValTransform(cfg.image_size, normalize=norm_on_host),
                           use_native)
    train_sampler = StreamSampler(train_ds.meta, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                  process_index=process_index, process_count=process_count)
    val_sampler = StreamSampler(val_ds.meta, cfg.batch_size, shuffle=False, seed=cfg.seed,
                                process_index=process_index, process_count=process_count)
    return (train_ds, StreamLoader(train_ds, train_sampler, device, cfg.num_workers, cfg.stream_prefetch),
            val_ds, StreamLoader(val_ds, val_sampler, device, cfg.num_workers, cfg.stream_prefetch))
