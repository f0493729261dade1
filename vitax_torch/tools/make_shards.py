"""Pack an ImageFolder tree into `.vtxshard` streaming containers
(tools/make_shards.py), byte for byte the JAX package's packer:

    python -m vitax_torch.tools.make_shards --src /data/imagenet --dst /data/imagenet-shards
    python -m vitax_torch.tools.make_shards --src ... --dst ... --shard_size_mb 100 --splits train

Each split (`train/`, `val/`, whichever exist) is listed as the ImageFolder
dataset lists it (data/imagefolder.py list_imagefolder), so record i is
sample i and its label the same class index. Payloads are the files'
bytes, unchanged. Per split: size-targeted `shard-NNNNN.vtxshard` files, a
JSON index per shard and a `stream_meta.json` manifest. Train from them
with `--data_format stream --data_dir <dst>`.
"""

from __future__ import annotations

import argparse
import os
import sys

from vitax_torch.data.imagefolder import list_imagefolder
from vitax_torch.data.stream.format import DEFAULT_SHARD_SIZE_MB, ShardWriter

SPLITS = ("train", "val")


def pack_split(src_split: str, dst_split: str, shard_size_mb: float = DEFAULT_SHARD_SIZE_MB,
               quiet: bool = False) -> dict:
    """Pack one ImageFolder split into shards; returns its manifest."""
    classes, samples = list_imagefolder(src_split)
    writer = ShardWriter(dst_split, classes=classes, shard_size_mb=shard_size_mb)
    for path, label in samples:
        with open(path, "rb") as f:
            writer.add(f.read(), label)
    meta = writer.close()
    if not quiet:
        print(f"{dst_split}: {meta['num_records']} records, {len(meta['shards'])} shard(s), "
              f"{len(meta['classes'])} classes")
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="pack an ImageFolder tree into .vtxshard streaming containers")
    ap.add_argument("--src", required=True, help="ImageFolder root (holds train/ and/or val/)")
    ap.add_argument("--dst", required=True, help="output shard root (mirrors the split layout)")
    ap.add_argument("--shard_size_mb", type=float, default=DEFAULT_SHARD_SIZE_MB,
                    help="target shard size in MB (default %(default)s)")
    ap.add_argument("--splits", nargs="*", default=None,
                    help=f"splits to pack (default: whichever of {SPLITS} exist under --src)")
    args = ap.parse_args(argv)
    if args.shard_size_mb <= 0:
        ap.error("--shard_size_mb must be positive")
    splits = args.splits or [s for s in SPLITS if os.path.isdir(os.path.join(args.src, s))]
    if not splits:
        ap.error(f"no {'/'.join(SPLITS)} splits under {args.src}")
    for split in splits:
        src_split = os.path.join(args.src, split)
        if not os.path.isdir(src_split):
            ap.error(f"split directory not found: {src_split}")
        pack_split(src_split, os.path.join(args.dst, split), args.shard_size_mb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
