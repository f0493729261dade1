"""vitax_torch's streaming data plane against the JAX package's: the
packer's bytes, the shard assignment, epoch plans and resume cursor (drift
raising included), the format's errors, StreamDataset.load_entries,
StreamLoader's epoch with start_step, the stream batch against the
ImageFolder batch of the same samples, and the CLI training from shards.
Every comparison is bitwise; the trees are tests/test_torch_data.py's.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_data import SIZE, TINY, _jax_one_device_mesh, make_tree
from test_torch_data import native_lib  # noqa: F401 - the fixture, shared
from vitax_torch.config import Config
from vitax_torch.data.imagefolder import ImageFolderDataset
from vitax_torch.data.loader import build_datasets
from vitax_torch.data.stream import (ShardFormatError, ShardReader, ShardWriter, StreamDataset, StreamLoader,
                                     StreamSampler, assign_shards, load_split_meta)
from vitax_torch.data.transforms import TrainTransform, ValTransform
from vitax_torch.tools.make_shards import main as make_shards_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD_MB = 0.008                          # ~8 KB shards: about 3 records each, 5 a train split


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """(tree, the port's shards, the JAX package's shards) of one tree."""
    root = tmp_path_factory.mktemp("stream")
    tree = make_tree(root / "tree", seed=3)
    from tools.make_shards import main as jax_make_shards
    assert make_shards_main(["--src", tree, "--dst", str(root / "ours"), "--shard_size_mb", str(SHARD_MB)]) == 0
    assert jax_make_shards(["--src", tree, "--dst", str(root / "theirs"), "--shard_size_mb", str(SHARD_MB)]) == 0
    return tree, str(root / "ours"), str(root / "theirs")


def _native_or_skip(use_native, request):
    if use_native:
        request.getfixturevalue("native_lib")


def test_make_shards_writes_the_jax_packers_bytes(packed):
    """Every shard, index and manifest byte-identical to tools/make_shards.py's."""
    _, ours, theirs = packed
    for split in ("train", "val"):
        names = sorted(os.listdir(os.path.join(theirs, split)))
        assert sorted(os.listdir(os.path.join(ours, split))) == names
        assert sum(n.endswith(".vtxshard") for n in names) >= (3 if split == "train" else 1)
        for name in names:
            with open(os.path.join(ours, split, name), "rb") as a, open(os.path.join(theirs, split, name), "rb") as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("counts,procs", [([5, 5, 5], 1), ([7, 3, 3, 9, 1], 2), ([4] * 7, 3), ([10, 1], 4),
                                          ([2, 8, 8, 3, 5, 5], 4)])
def test_assign_shards_matches_jax(counts, procs):
    from vitax.data.stream.sampler import assign_shards as jax_assign
    got = assign_shards(counts, procs)
    assert got == jax_assign(counts, procs)
    assert sorted(s for h in got for s in h) == list(range(len(counts)))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("procs,rank", [(1, 0), (2, 1), (3, 2)])
def test_plans_and_cursors_match_jax(packed, shuffle, procs, rank):
    """epoch_entries, global ids and every cursor of an epoch equal the JAX
    sampler's; a cursor from another shard set raises in both."""
    from vitax.data.stream.sampler import StreamSampler as JaxSampler
    meta = load_split_meta(os.path.join(packed[1], "train"))
    ours = StreamSampler(meta, 2 * procs, shuffle, 4, process_index=rank, process_count=procs)
    theirs = JaxSampler(meta, 2 * procs, shuffle, 4, process_index=rank, process_count=procs)
    assert ours.steps_per_epoch == theirs.steps_per_epoch >= 1
    for epoch in (0, 3):
        np.testing.assert_array_equal(ours.epoch_entries(epoch), theirs.epoch_entries(epoch))
        for step in range(ours.steps_per_epoch + 1):
            assert ours.cursor_for_step(epoch, step) == theirs.cursor_for_step(epoch, step)
    assert [ours.global_id(s, 1) for s in range(len(meta["shards"]))] == \
           [theirs.global_id(s, 1) for s in range(len(meta["shards"]))]
    cursor = dict(ours.cursor_for_step(3, 1), shard="shard-99999.vtxshard")
    for sampler in (ours, theirs):
        with pytest.raises(RuntimeError, match="cursor mismatch"):
            sampler.check_cursor(cursor, 3, 1)
        sampler.check_cursor(ours.cursor_for_step(3, 1), 3, 1)


def test_format_errors_match_jax(packed, tmp_path):
    """Missing manifest, wrong magic, a torn record and a truncated payload
    raise in the port as in the JAX package's reader."""
    from vitax.data.stream.format import ShardFormatError as JaxFormatError
    from vitax.data.stream.format import ShardReader as JaxReader
    from vitax.data.stream.format import load_split_meta as jax_load_meta
    for load in (load_split_meta, jax_load_meta):
        with pytest.raises(FileNotFoundError, match="stream_meta.json"):
            load(str(tmp_path))
    split = tmp_path / "train"
    shutil.copytree(os.path.join(packed[1], "train"), split)
    meta = load_split_meta(str(split))
    first = split / meta["shards"][0]["name"]
    data = bytearray(first.read_bytes())
    cases = {"bad magic": b"NOTSHARD1\n" + data[10:],
             "disagrees with index": data[:14] + b"\x07\x00\x00\x00" + data[18:],   # record 0's label
             "truncated payload": data[:40]}
    for match, body in cases.items():
        first.write_bytes(bytes(body))
        for reader, err in ((ShardReader(str(split)), ShardFormatError), (JaxReader(str(split)), JaxFormatError)):
            with pytest.raises(err, match=match):
                reader.read_record(0, 0)
            reader.close()


def test_writer_round_trip(tmp_path):
    with ShardWriter(str(tmp_path), classes=["a", "b"], shard_size_mb=1e-6) as w:
        for i in range(5):
            w.add(bytes([i]) * (30 + i), i % 2)
    reader = ShardReader(str(tmp_path))
    assert reader.meta["num_records"] == 5 and len(reader.shards) == 5
    assert [reader.read_record(s, 0) for s in range(5)] == [(bytes([i]) * (30 + i), i % 2) for i in range(5)]
    reader.close()
    with pytest.raises(ValueError, match="positive"):
        ShardWriter(str(tmp_path / "x"), shard_size_mb=0)


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_stream_dataset_matches_jax_and_imagefolder(packed, use_native, request):
    """load_entries bitwise equal to the JAX package's, and to the
    ImageFolder batch of the same global ids (the global id seeds the
    augmentation); counts by path."""
    _native_or_skip(use_native, request)
    from vitax.data import transforms as jt
    from vitax.data.stream.loader import StreamDataset as JaxStreamDataset
    tree, ours_root, theirs_root = packed
    split = os.path.join(ours_root, "train")
    ds = StreamDataset(split, TrainTransform(SIZE, 6), use_native=use_native)
    jds = JaxStreamDataset(os.path.join(theirs_root, "train"), jt.TrainTransform(SIZE, 6, normalize=False),
                           use_native=use_native)
    folder = ImageFolderDataset(os.path.join(tree, "train"), TrainTransform(SIZE, 6), use_native=use_native)
    for d in (ds, jds, folder):
        d.set_epoch(4)
    sampler = StreamSampler(ds.meta, 16, True, 6)
    entries = [(int(s), int(r), sampler.global_id(s, r)) for s, r in sampler.epoch_entries(4)[0]]
    imgs, labels = ds.load_entries(entries, 2)
    jimgs, jlabels = jds.load_entries(entries, 2)
    fimgs, flabels = folder.load_batch([g for _, _, g in entries], 2)
    for other, other_labels in ((jimgs, jlabels), (fimgs, flabels)):
        np.testing.assert_array_equal(imgs, other)
        np.testing.assert_array_equal(labels, other_labels)
    assert ds.decoded.snapshot() == ({"native": 15, "pil": 1, "pil_jpeg": 0} if use_native
                                     else {"native": 0, "pil": 16, "pil_jpeg": 15})
    ds.close()
    jds.close()


def test_stream_loader_matches_jax(packed):
    """StreamLoader's epoch from start_step 1 on the CPU, bitwise equal to
    the JAX package's StreamLoader on a one-device mesh."""
    from vitax.data import transforms as jt
    from vitax.data.stream.loader import StreamDataset as JaxStreamDataset
    from vitax.data.stream.loader import StreamLoader as JaxStreamLoader
    from vitax.data.stream.sampler import StreamSampler as JaxSampler
    _, ours_root, theirs_root = packed
    ds = StreamDataset(os.path.join(ours_root, "train"), TrainTransform(SIZE, 1), use_native=False)
    jds = JaxStreamDataset(os.path.join(theirs_root, "train"), jt.TrainTransform(SIZE, 1, normalize=False),
                           use_native=False)
    loader = StreamLoader(ds, StreamSampler(ds.meta, 4, True, 1), torch.device("cpu"), num_workers=2, prefetch=1)
    jloader = JaxStreamLoader(jds, JaxSampler(jds.meta, 4, True, 1, 0, 1), _jax_one_device_mesh())
    got = list(loader.epoch(2, start_step=1))
    want = list(jloader.epoch(2, start_step=1))
    assert len(got) == len(want) == loader.steps_per_epoch - 1 >= 2
    for a, b in zip(got, want):
        assert a["image"].dtype == torch.uint8 and a["label"].dtype == torch.int64
        np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
        np.testing.assert_array_equal(a["label"].numpy(), np.asarray(b["label"]))
    assert loader.sampler.cursor_for_step(2, 1) == jloader.cursor_for_step(2, 1)
    assert loader.consume_wait_s() > 0
    loader.close()
    jloader.close()


def test_build_datasets_stream_branch(packed):
    tree, ours_root, _ = packed
    cfg = Config(**TINY, data_dir=ours_root, data_format="stream", num_workers=2, stream_prefetch=1).validate()
    train_ds, train_loader, val_ds, val_loader = build_datasets(cfg, torch.device("cpu"), use_native=False)
    assert isinstance(train_ds, StreamDataset) and isinstance(val_loader, StreamLoader)
    assert len(train_ds) == 16 and len(val_ds) == 7 and train_loader.prefetch == 1
    assert isinstance(val_ds.transform, ValTransform)
    batch = next(iter(val_loader.epoch(0)))
    assert batch["image"].dtype == torch.uint8 and batch["label"].tolist() == [0, 0, 0, 1]
    with pytest.raises(FileNotFoundError, match="stream_meta.json"):
        build_datasets(Config(**TINY, data_dir=tree, data_format="stream"), torch.device("cpu"))


def test_cli_packs_and_trains_from_shards(tmp_path):
    """python -m vitax_torch.tools.make_shards, then python -m
    vitax_torch.train --device cpu --data_format stream on its output."""
    tree = make_tree(tmp_path / "tree", seed=8)
    shards = str(tmp_path / "shards")
    r = subprocess.run([sys.executable, "-m", "vitax_torch.tools.make_shards", "--src", tree, "--dst", shards],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "16 records" in r.stdout, r.stdout + r.stderr
    r = subprocess.run([sys.executable, "-m", "vitax_torch.train", "--device", "cpu", "--data_format", "stream",
                        "--data_dir", shards, "--image_size", "16", "--patch_size", "8", "--embed_dim", "32",
                        "--num_heads", "2", "--num_blocks", "1", "--num_classes", "3", "--batch_size", "4",
                        "--max_steps", "2", "--log_step_interval", "1", "--num_workers", "2",
                        "--eval_max_batches", "1", "--num_epochs", "1", "--ckpt_dir", str(tmp_path / "ckpt")],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "StreamDataset(" in r.stdout and "decode path" in r.stdout and "accuracy on val" in r.stdout
