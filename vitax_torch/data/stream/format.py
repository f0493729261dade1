"""`.vtxshard` containers (vitax/data/stream/format.py): writer, index and
a seeking record reader, byte for byte the JAX package's format.

    <root>/<split>/shard-00000.vtxshard        length-prefixed records
    <root>/<split>/shard-00000.vtxshard.json   per-shard index (offsets, lengths, labels)
    <root>/<split>/stream_meta.json            split manifest (classes, shards)

A shard is the magic b"VTXSHARD1\\n" followed by records, each a uint32le
payload length, an int32le label and the payload: the original image file's
bytes, so a streamed sample decodes to the same pixels as the ImageFolder
file it came from. The reader checks each record's header against the
index, so a torn or truncated shard raises `ShardFormatError` at the record
that hit it instead of feeding garbage.
"""

from __future__ import annotations

import json
import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

MAGIC = b"VTXSHARD1\n"
FORMAT_VERSION = 1
META_NAME = "stream_meta.json"
SHARD_SUFFIX = ".vtxshard"
INDEX_SUFFIX = ".vtxshard.json"
DEFAULT_SHARD_SIZE_MB = 100

_HEADER = struct.Struct("<Ii")  # payload_len (uint32), label (int32)


class ShardFormatError(RuntimeError):
    """A shard or index that breaks the format: torn, truncated, wrong magic
    or version."""


def _write_json_atomic(path: str, obj: Dict) -> None:
    """Readers never see a half-written index or manifest."""
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _index_path(split_dir: str, shard_name: str) -> str:
    return os.path.join(split_dir, shard_name[:-len(SHARD_SUFFIX)] + INDEX_SUFFIX)


class ShardWriter:
    """Packs records into size-targeted shards under `split_dir`:

        with ShardWriter(split_dir, classes=[...]) as w:
            w.add(payload_bytes, label)
    """

    def __init__(self, split_dir: str, classes: Optional[List[str]] = None,
                 shard_size_mb: float = DEFAULT_SHARD_SIZE_MB):
        if shard_size_mb <= 0:
            raise ValueError(f"shard size target must be positive, got {shard_size_mb}")
        self.split_dir = split_dir
        self.classes = list(classes) if classes else []
        self.target_bytes = int(shard_size_mb * 1024 * 1024)
        os.makedirs(split_dir, exist_ok=True)
        self._shards: List[Dict] = []
        self._f: Optional[BinaryIO] = None
        self._offsets: List[int] = []
        self._lengths: List[int] = []
        self._labels: List[int] = []
        self._pos = 0

    def _shard_name(self, i: int) -> str:
        return f"shard-{i:05d}{SHARD_SUFFIX}"

    def _open_shard(self) -> None:
        self._f = open(os.path.join(self.split_dir, self._shard_name(len(self._shards))), "wb")
        self._f.write(MAGIC)
        self._pos = len(MAGIC)
        self._offsets, self._lengths, self._labels = [], [], []

    def _close_shard(self) -> None:
        if self._f is None:
            return
        self._f.close()
        name = self._shard_name(len(self._shards))
        # the index is written after the shard: a shard without one is never read
        _write_json_atomic(_index_path(self.split_dir, name), {
            "version": FORMAT_VERSION, "records": len(self._offsets), "offsets": self._offsets,
            "lengths": self._lengths, "labels": self._labels, "bytes": self._pos})
        self._shards.append({"name": name, "records": len(self._offsets), "bytes": self._pos})
        self._f = None

    def add(self, payload: bytes, label: int) -> None:
        if self._f is None:
            self._open_shard()
        self._offsets.append(self._pos)
        self._lengths.append(len(payload))
        self._labels.append(int(label))
        self._f.write(_HEADER.pack(len(payload), int(label)))
        self._f.write(payload)
        self._pos += _HEADER.size + len(payload)
        if self._pos >= self.target_bytes:
            self._close_shard()

    def close(self) -> Dict:
        """Finish the open shard and write the split manifest; returns it."""
        self._close_shard()
        meta = {"version": FORMAT_VERSION, "classes": self.classes,
                "num_records": sum(s["records"] for s in self._shards), "shards": self._shards}
        _write_json_atomic(os.path.join(self.split_dir, META_NAME), meta)
        return meta

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        elif self._f is not None:
            self._f.close()                   # the partial shard has no index: never read


def load_split_meta(split_dir: str) -> Dict:
    """The split manifest, checked. FileNotFoundError when the directory
    holds no stream_meta.json."""
    path = os.path.join(split_dir, META_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {META_NAME} under {split_dir!r} — not a vitax shard directory "
                                f"(build one with python -m vitax_torch.tools.make_shards)")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ShardFormatError(f"{path}: format version {meta.get('version')!r}, reader supports {FORMAT_VERSION}")
    if not meta.get("shards"):
        raise ShardFormatError(f"{path}: empty shard list")
    return meta


def load_shard_index(split_dir: str, shard_name: str) -> Dict:
    path = _index_path(split_dir, shard_name)
    with open(path) as f:
        index = json.load(f)
    if index.get("version") != FORMAT_VERSION:
        raise ShardFormatError(f"{path}: format version {index.get('version')!r}, reader supports {FORMAT_VERSION}")
    return index


class ShardReader:
    """Record reader over one split: one open file at a time, records
    fetched by (shard_id, record_id) and checked against the index. An
    epoch plan consumes shard after shard, so the reader keeps the current
    shard open. A failed open is retried once."""

    def __init__(self, split_dir: str, meta: Optional[Dict] = None):
        self.split_dir = split_dir
        self.meta = meta if meta is not None else load_split_meta(split_dir)
        self.shards = self.meta["shards"]
        self._indexes: Dict[int, Dict] = {}
        self._f: Optional[BinaryIO] = None
        self._open_shard_id: Optional[int] = None

    def index(self, shard_id: int) -> Dict:
        if shard_id not in self._indexes:
            self._indexes[shard_id] = load_shard_index(self.split_dir, self.shards[shard_id]["name"])
        return self._indexes[shard_id]

    def _open(self, shard_id: int) -> BinaryIO:
        if self._open_shard_id == shard_id and self._f is not None:
            return self._f
        self.close()
        path = os.path.join(self.split_dir, self.shards[shard_id]["name"])
        try:
            f = open(path, "rb")
        except OSError:
            f = open(path, "rb")              # one retry: a shared store's open can fail once
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            f.close()
            raise ShardFormatError(f"{path}: bad magic {magic!r} — torn or not a {SHARD_SUFFIX} file")
        self._f, self._open_shard_id = f, shard_id
        return f

    def read_record(self, shard_id: int, record_id: int) -> Tuple[bytes, int]:
        """(payload bytes, label) of one record, its header checked."""
        idx = self.index(shard_id)
        f = self._open(shard_id)
        name = self.shards[shard_id]["name"]
        offset = idx["offsets"][record_id]
        f.seek(offset)
        header = f.read(_HEADER.size)
        if len(header) != _HEADER.size:
            raise ShardFormatError(f"{name}: truncated record header at offset {offset} (record {record_id})")
        length, label = _HEADER.unpack(header)
        if length != idx["lengths"][record_id] or label != idx["labels"][record_id]:
            raise ShardFormatError(
                f"{name}: record {record_id} header (len={length}, label={label}) disagrees with index "
                f"(len={idx['lengths'][record_id]}, label={idx['labels'][record_id]}) — torn shard or stale index")
        payload = f.read(length)
        if len(payload) != length:
            raise ShardFormatError(f"{name}: truncated payload for record {record_id} "
                                   f"(wanted {length} bytes, got {len(payload)})")
        return payload, label

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
            self._open_shard_id = None
