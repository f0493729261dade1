"""vitax_torch's data slice against the JAX package's, on tiny ImageFolder
trees that PIL writes under tmp dirs: the transforms (PIL path, normalize
on and off), native_params, the native decoder's file and memory calls,
ImageFolderDataset items and load_batch, the loader's epoch with
start_step, the serve body decoder, the config refusals, and the slice
as a whole (train() on the CPU against the JAX train step from the same
weights, on the same batches). Every comparison is bitwise, except the
losses (rtol 2e-4, atol 2e-5, tests/test_torch_train.py's bars) and
native against PIL (1 LSB, decode.cc's rounding).

The native tests skip only where g++ or libjpeg's header is missing; a
failed build fails them.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vitax_torch import _native
from vitax_torch.config import Config
from vitax_torch.data import native
from vitax_torch.data.imagefolder import DecodeCounts, ImageFolderDataset, list_imagefolder
from vitax_torch.data.loader import ShardedLoader, ShardedSampler, build_datasets
from vitax_torch.data.transforms import TrainTransform, ValTransform, center_crop
from vitax_torch.serve.server import decode_image_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32                                 # transform output of the tree tests
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=3,
            batch_size=4, dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)


def save_jpeg(path, w, h, seed, quality=90):
    from PIL import Image
    rng = np.random.default_rng(seed)
    # smooth colour ramps plus noise: like a photo, unlike pure noise
    base = rng.integers(0, 256, 3)
    yy, xx = np.mgrid[0:h, 0:w]
    arr = (base + 90 * np.sin(xx[..., None] / (5 + seed % 7)) + 60 * np.cos(yy[..., None] / 9.0)
           + rng.normal(0, 12, (h, w, 3)))
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path, quality=quality)


def make_tree(root, per_class=(5, 2), classes=3, seed=0):
    """root/{train,val}/c{k}/NN.jpg of sizes 40-99 px (per_class JPEGs a
    class in each split), and one PNG in train/c1 and val/c0."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "val"), per_class):
        for c in range(classes):
            d = os.path.join(root, split, f"c{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                w, h = (int(x) for x in rng.integers(40, 100, 2))
                save_jpeg(os.path.join(d, f"{i:02d}.jpg"), w, h, seed=int(rng.integers(1 << 30)))
        png_dir = os.path.join(root, split, "c1" if split == "train" else "c0")
        Image.fromarray(rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)).save(os.path.join(png_dir, "zz.png"))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="session")
def native_lib():
    """The native library, built here; skips only without g++ or jpeglib.h."""
    reason = _native.missing_toolchain()
    if reason:
        pytest.skip(f"native data path cannot be built here: {reason}")
    assert native.available(), f"native library failed to build: {_native.unavailable_reason()}"
    from vitax.data import native as jax_native
    assert jax_native.available(), "the JAX package's native library failed to build"
    return jax_native


def _pil(path):
    from PIL import Image
    with Image.open(path) as img:
        return img.convert("RGB")


# --- transforms ---------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True], ids=["uint8", "normalized"])
@pytest.mark.parametrize("kind", ["train", "val"])
def test_transforms_match_jax(tree, kind, normalize):
    """The PIL path, on arrays and on PIL images, bitwise equal to the JAX
    package's transform of the same image at the same (seed, epoch, index)."""
    from vitax.data import transforms as jt
    _, samples = list_imagefolder(os.path.join(tree, "train"))
    if kind == "train":
        ours, theirs = TrainTransform(SIZE, seed=7, normalize=normalize), jt.TrainTransform(SIZE, 7, normalize)
        ours.set_epoch(3)
        theirs.set_epoch(3)
    else:
        ours, theirs = ValTransform(SIZE, normalize=normalize), jt.ValTransform(SIZE, normalize)
    for index, (path, _) in enumerate(samples[:8]):
        img = _pil(path)
        want = theirs(img, index=index)
        for given in (img, np.asarray(img)):
            got = ours(given, index=index)
            assert got.dtype == want.dtype and got.shape == want.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(got, want)


def test_center_crop_pads_like_jax():
    """An image smaller than the crop is zero-padded, centred, as the JAX
    package's PIL paste does."""
    from PIL import Image
    from vitax.data.transforms import center_crop as jax_center_crop
    rng = np.random.default_rng(1)
    for h, w in ((10, 20), (40, 7), (33, 33), (5, 5)):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(jax_center_crop(Image.fromarray(arr), 32))
        np.testing.assert_array_equal(center_crop(arr, 32), want)


def test_native_params_match_jax():
    """The same crop and flip draws, in the same order, for every (seed,
    epoch, index), and the val pipeline's constant."""
    from vitax.data import transforms as jt
    for seed, epoch in ((0, 0), (3, 1), (11, 7)):
        ours, theirs = TrainTransform(224, seed), jt.TrainTransform(224, seed)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index, (w, h) in enumerate([(640, 480), (180, 523), (97, 101), (2000, 60), (300, 300)]):
            assert ours.native_params(w, h, index) == theirs.native_params(w, h, index)
    assert ValTransform(224).native_params(5, 5, 3) == jt.ValTransform(224).native_params(5, 5, 3)


def test_transforms_reject_other_arrays():
    with pytest.raises(ValueError, match="uint8"):
        ValTransform(16)(np.zeros((20, 20, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        TrainTransform(16)(np.zeros((20, 20), np.uint8))


# --- the native decoder ---------------------------------------------------------


def _strip_comments(src: str) -> str:
    src = re.sub(r"//[^\n]*", "", src)
    return "\n".join(line.rstrip() for line in src.splitlines() if line.strip())


def test_decoder_source_is_the_jax_packages_code():
    """The port's decode.cc is the JAX package's code, comments aside, and
    both build with the same g++ flags."""
    with open(os.path.join(REPO, "vitax", "_native", "decode.cc")) as f:
        theirs = _strip_comments(f.read())
    with open(_native.SRC) as f:
        ours = _strip_comments(f.read())
    assert ours == theirs
    assert _native.GXX_FLAGS == ("-O3", *_native.MARCH, "-shared", "-fPIC", "-std=c++17")
    assert _native.GXX_LIBS == ("-ljpeg", "-pthread")
    assert os.path.dirname(_native.lib_path()) == os.path.join(REPO, "vitax_torch", "_build")


@pytest.mark.parametrize("normalize", [False, True], ids=["uint8", "normalized"])
def test_native_file_calls_match_jax(native_lib, tree, normalize):
    """process_file and process_batch bitwise equal to the JAX package's
    library, at train and val params; within 1 LSB of PIL."""
    from vitax.data import transforms as jt
    paths = sorted(os.path.join(tree, "train", "c0", f) for f in os.listdir(os.path.join(tree, "train", "c0")))
    tt, jtt = TrainTransform(SIZE, 5, normalize), jt.TrainTransform(SIZE, 5, normalize)
    vt = ValTransform(SIZE, normalize)
    for t, resize_to in ((tt, 0), (vt, vt.resize_to)):
        params = [t.native_params(*native.jpeg_size(p), i) for i, p in enumerate(paths)]
        assert [native.jpeg_size(p) for p in paths] == [native_lib.jpeg_size(p) for p in paths]
        batch, failed = native.process_batch(paths, params, SIZE, resize_to, 3, normalize=normalize)
        jbatch, jfailed = native_lib.process_batch(paths, params, SIZE, resize_to, 3, normalize=normalize)
        assert failed == jfailed == []
        np.testing.assert_array_equal(batch, jbatch)
        for i, p in enumerate(paths):
            single = native.process_file(p, params[i], SIZE, resize_to, normalize=normalize)
            np.testing.assert_array_equal(single, native_lib.process_file(p, params[i], SIZE, resize_to,
                                                                          normalize=normalize))
            np.testing.assert_array_equal(single, batch[i])
            ref = (jtt if t is tt else jt.ValTransform(SIZE, normalize))(_pil(p), index=i)
            lsb = 0.018 if normalize else 1       # 1 uint8 LSB over the smallest std
            assert np.abs(single.astype(np.float64) - ref).max() <= lsb


def test_native_memory_calls_match_jax(native_lib, tree):
    """jpeg_size_bytes, process_bytes and process_batch_bytes bitwise equal
    to the JAX package's and to the file calls on the same bytes."""
    paths = sorted(os.path.join(tree, "train", "c2", f) for f in os.listdir(os.path.join(tree, "train", "c2")))
    blobs = [open(p, "rb").read() for p in paths]
    assert all(native.is_jpeg_bytes(b) for b in blobs) and not native.is_jpeg_bytes(b"\x89PNG\r\n")
    tt = TrainTransform(SIZE, 2)
    params = [tt.native_params(*native.jpeg_size_bytes(b), i) for i, b in enumerate(blobs)]
    assert [native.jpeg_size_bytes(b) for b in blobs] == [native_lib.jpeg_size_bytes(b) for b in blobs]
    batch, failed = native.process_batch_bytes(blobs, params, SIZE, 0, 2, normalize=False)
    jbatch, _ = native_lib.process_batch_bytes(blobs, params, SIZE, 0, 2, normalize=False)
    assert failed == [] and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, jbatch)
    for i, (p, b) in enumerate(zip(paths, blobs)):
        got = native.process_bytes(b, params[i], SIZE, 0, normalize=True)
        np.testing.assert_array_equal(got, native_lib.process_bytes(b, params[i], SIZE, 0, normalize=True))
        np.testing.assert_array_equal(got, native.process_file(p, params[i], SIZE, 0, normalize=True))


def test_native_failures(native_lib, tmp_path):
    """A corrupt file or record returns None; a batch reports the failed
    slots, as the JAX package's library does."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    good = tmp_path / "good.jpg"
    save_jpeg(str(good), 64, 48, seed=3)
    vt = ValTransform(16)
    assert native.jpeg_size(str(tmp_path / "missing.jpg")) is None
    assert native.process_file(str(bad), vt.native_params(0, 0, 0), 16, vt.resize_to) is None
    assert native.process_bytes(bad.read_bytes(), vt.native_params(0, 0, 0), 16, vt.resize_to) is None
    params = [vt.native_params(0, 0, 0)] * 2
    batch, failed = native.process_batch([str(good), str(bad)], params, 16, vt.resize_to)
    jbatch, jfailed = native_lib.process_batch([str(good), str(bad)], params, 16, vt.resize_to)
    assert failed == jfailed == [1]
    np.testing.assert_array_equal(batch[0], jbatch[0])
    with pytest.raises(ValueError, match="rows"):
        native.process_batch([str(good)], [(1, 0, 0)], 16, vt.resize_to)


def test_native_decode_releases_the_gil(native_lib, tmp_path):
    """A pure-Python counter thread keeps advancing while a batch decodes:
    ctypes drops the GIL for the call (tests/test_native.py's check)."""
    from bench import counter_rate
    paths, params = [], []
    tt = TrainTransform(224)
    for i in range(16):
        p = str(tmp_path / f"{i}.jpg")
        save_jpeg(p, 350, 300, seed=i)
        paths.append(p)
        params.append(tt.native_params(350, 300, i))
    idle = counter_rate(lambda: time.sleep(0.02), min_time=0.4)
    during = counter_rate(lambda: native.process_batch(paths, params, 224, 0, n_threads=1), min_time=0.4)
    assert during / idle > 0.15, f"counter starved during native decode: {during:.0f}/s vs {idle:.0f}/s idle"


def test_nothing_builds_at_import():
    """Importing the port's native modules compiles nothing and loads no PIL."""
    code = ("import sys, vitax_torch._native as n, vitax_torch._native.__main__, vitax_torch.data.native, "
            "vitax_torch.tools.make_shards\n"
            "assert n._lib is None and not n._reason, 'built at import'\n"
            "assert 'PIL' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# --- the dataset --------------------------------------------------------------


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_imagefolder_matches_jax(tree, use_native, request):
    """Classes, samples, items and load_batch bitwise equal to the JAX
    package's dataset on the same tree, seed and epoch; the counts say
    which path decoded each item."""
    if use_native:
        request.getfixturevalue("native_lib")
    from vitax.data import transforms as jt
    from vitax.data.imagefolder import ImageFolderDataset as JaxDataset
    ours = ImageFolderDataset(os.path.join(tree, "train"), TrainTransform(SIZE, 4), use_native=use_native)
    theirs = JaxDataset(os.path.join(tree, "train"), jt.TrainTransform(SIZE, 4, normalize=False),
                        use_native=use_native)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    assert ours.use_native == theirs.use_native == use_native
    assert ours.classes == theirs.classes and ours.samples == theirs.samples and len(ours) == 16
    for i in range(len(ours)):
        (a, la), (b, lb) = ours[i], theirs[i]
        assert la == lb and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    png = next(i for i, (p, _) in enumerate(ours.samples) if p.endswith(".png"))
    idx = [png, 0, 15, 7, 3]
    (imgs, labels), (jimgs, jlabels) = ours.load_batch(idx, 2), theirs.load_batch(idx, 2)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    n_jpeg = len(ours) - 1 + len(idx) - 1
    want = {"native": n_jpeg, "pil": 2, "pil_jpeg": 0} if use_native else {"native": 0, "pil": n_jpeg + 2,
                                                                         "pil_jpeg": n_jpeg}
    assert ours.decoded.snapshot() == want
    assert repr(ours).endswith(f"decode={'native' if use_native else 'PIL'})")


def test_imagefolder_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        ImageFolderDataset(str(tmp_path / "nope"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no class subdirectories"):
        ImageFolderDataset(str(tmp_path / "empty"))
    (tmp_path / "empty" / "a").mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        ImageFolderDataset(str(tmp_path / "empty"))


def test_use_native_without_the_library_raises(monkeypatch, tree):
    """Asking for the native path where it cannot be built raises instead
    of decoding through PIL; auto takes PIL."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_reason", "RuntimeError: g++ failed")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ImageFolderDataset(os.path.join(tree, "train"), TrainTransform(SIZE), use_native=True)
    assert not ImageFolderDataset(os.path.join(tree, "train"), TrainTransform(SIZE)).use_native


# --- the loader ---------------------------------------------------------------


def _jax_one_device_mesh():
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.parallel.mesh import build_mesh
    return build_mesh(JaxConfig(**TINY).validate(), jax.devices()[:1])


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_loader_epoch_matches_jax(tree, use_native, request):
    """ShardedLoader's epoch from start_step 1, on the CPU, bitwise equal
    to the JAX package's on a one-device mesh; labels as int64."""
    if use_native:
        request.getfixturevalue("native_lib")
    from vitax.data import transforms as jt
    from vitax.data.imagefolder import ImageFolderDataset as JaxDataset
    from vitax.data.loader import ShardedLoader as JaxLoader
    from vitax.data.loader import ShardedSampler as JaxSampler
    ds = ImageFolderDataset(os.path.join(tree, "train"), TrainTransform(SIZE, 9), use_native=use_native)
    jds = JaxDataset(os.path.join(tree, "train"), jt.TrainTransform(SIZE, 9, normalize=False), use_native=use_native)
    loader = ShardedLoader(ds, ShardedSampler(len(ds), 4, True, 9), torch.device("cpu"), num_workers=2, prefetch=1)
    jloader = JaxLoader(jds, JaxSampler(len(jds), 4, True, 9), _jax_one_device_mesh(), num_workers=2)
    got = list(loader.epoch(2, start_step=1))
    want = list(jloader.epoch(2, start_step=1))
    jloader.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["image"].dtype == torch.uint8 and a["label"].dtype == torch.int64
        np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
        np.testing.assert_array_equal(a["label"].numpy(), np.asarray(b["label"]))
    assert loader.consume_wait_s() > 0 and loader.consume_wait_s() == 0


def test_build_datasets_from_a_tree(tree):
    """uint8 batches under device_normalize, float32 under --host_normalize;
    the val split unshuffled; a missing tree names the directory."""
    cfg = Config(**TINY, data_dir=tree, num_workers=2).validate()
    train_ds, train_loader, val_ds, val_loader = build_datasets(cfg, torch.device("cpu"), use_native=False)
    assert isinstance(train_ds, ImageFolderDataset) and not train_ds.use_native
    assert len(train_ds) == 16 and len(val_ds) == 7 and train_loader.steps_per_epoch == 4
    batch = next(iter(val_loader.epoch(0)))
    assert batch["image"].shape == (4, 16, 16, 3) and batch["image"].dtype == torch.uint8
    assert batch["label"].tolist() == [0, 0, 0, 1]
    cfg = Config(**TINY, data_dir=tree, device_normalize=False).validate()
    _, loader, _, _ = build_datasets(cfg, torch.device("cpu"), use_native=False)
    it = loader.epoch(1)
    assert next(it)["image"].dtype == torch.float32
    it.close()
    with pytest.raises(FileNotFoundError, match=re.escape(os.path.join(tree, "nope", "train"))):
        build_datasets(Config(**TINY, data_dir=os.path.join(tree, "nope")), torch.device("cpu"))


# --- config ------------------------------------------------------------------


@pytest.mark.parametrize("bad,match", [
    (dict(prefetch_batches=0), "prefetch_batches"), (dict(stream_prefetch=0), "stream_prefetch"),
    (dict(data_format="tfrecord"), "data_format"), (dict(data_format="stream", fake_data=True), "contradictory"),
    (dict(data_format="stream", data_dir=""), "shard root")])
def test_config_refusals_match_jax(bad, match):
    """The data checks of vitax/config.py validate, raised as ValueError
    where the JAX package asserts."""
    from vitax.config import Config as JaxConfig
    with pytest.raises(AssertionError, match=match):
        JaxConfig(**bad).validate()
    with pytest.raises(ValueError, match=match):
        Config(**bad).validate()


def test_data_flags_match_jax():
    """Names, defaults and --host_normalize, as vitax/config.py parses them."""
    from vitax.config import build_parser as jax_parser
    from vitax_torch.config import build_parser
    args = ["--num_workers", "3", "--prefetch_batches", "5", "--data_format", "stream", "--stream_prefetch", "4",
            "--host_normalize"]
    for argv in ([], args):
        ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        for name in ("num_workers", "prefetch_batches", "data_format", "stream_prefetch", "device_normalize"):
            assert getattr(ours, name) == getattr(theirs, name), name


# --- serving ------------------------------------------------------------------


def test_decode_image_bytes_matches_jax(tree, native_lib):
    """JPEG bodies take the native decoder, PNG bodies PIL, PPM numpy; each
    bitwise equal to the JAX server's decoder, and counted by path."""
    from PIL import Image
    from vitax.data.transforms import ValTransform as JaxValTransform
    from vitax.serve.server import decode_image_bytes as jax_decode
    counts = DecodeCounts()
    jpeg = open(os.path.join(tree, "val", "c1", "00.jpg"), "rb").read()
    png = open(os.path.join(tree, "val", "c0", "zz.png"), "rb").read()
    arr = np.asarray(Image.open(os.path.join(tree, "val", "c0", "zz.png")).convert("RGB"))
    ppm = f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode() + arr.tobytes()
    for body in (jpeg, png, ppm):
        got = decode_image_bytes(body, ValTransform(SIZE), counts)
        want = jax_decode(body, JaxValTransform(SIZE, normalize=False))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert counts.snapshot() == {"native": 1, "pil": 1, "pil_jpeg": 0, "ppm": 1}


# --- the slice as a whole --------------------------------------------------------


def test_train_from_a_tree_matches_jax(tree, monkeypatch, devices8, tmp_path):
    """The port's train() on the CPU from the tree, 3 steps, against the JAX
    train step from the same weights on the JAX loader's batches of the
    same tree and seed: losses within rtol 2e-4 / atol 2e-5."""
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.data import transforms as jt
    from vitax.data.imagefolder import ImageFolderDataset as JaxDataset
    from vitax.data.loader import ShardedLoader as JaxLoader
    from vitax.data.loader import ShardedSampler as JaxSampler
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    from vitax.train.step import make_train_step as jax_make_train_step
    from vitax_torch.checkpoint.convert import params_from_jax
    from vitax_torch.train import loop
    from test_torch_train import _flat

    run = dict(TINY, data_dir=tree, steps_per_epoch=3, num_epochs=1, max_steps=3, log_step_interval=1,
               eval_max_batches=1, num_workers=2, seed=5, ckpt_dir=str(tmp_path))
    jcfg = JaxConfig(**run, scan_blocks=False).validate()
    mesh = build_mesh(jcfg, jax.devices()[:1])
    jmodel = jax_build_model(jcfg)
    tx, schedule = jax_build_optimizer(jcfg, max_iteration=3)
    jstate, sspecs, _ = make_train_state(jcfg, jmodel, tx, mesh, jax.random.key(0))
    weights = params_from_jax(_flat(jstate.params))

    jds = JaxDataset(os.path.join(tree, "train"), jt.TrainTransform(16, 5, normalize=False))
    jloader = JaxLoader(jds, JaxSampler(len(jds), 4, True, 5), mesh, num_workers=2)
    step_fn = jax_make_train_step(jcfg, jmodel, tx, mesh, sspecs, schedule=schedule)
    want = []
    for _, batch in zip(range(3), jloader.epoch(1)):
        jstate, m = step_fn(jstate, batch, jax.random.key(1))
        want.append(float(jax.device_get(m["loss"])))
    jloader.close()

    real_build = loop.build_model

    def build_from_jax_weights(cfg, device, attention_impl=None):
        model = real_build(cfg, device, attention_impl=attention_impl, init=False)
        model.load_state_dict(weights, strict=True, assign=True)
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax_weights)
    records = []
    loop.train(Config(**run).validate(), "cpu", records=records)
    steps = [r for r in records if "loss" in r]
    np.testing.assert_allclose([r["loss"] for r in steps], want, rtol=2e-4, atol=2e-5)
    assert all(r["data_wait_s"] >= 0 for r in steps) and len([r for r in records if "top1" in r]) == 1


def test_cli_trains_from_a_tree(tree, tmp_path):
    """python -m vitax_torch.train --device cpu --data_dir <tree> trains and
    names the decode path; without --device it needs a card."""
    args = ["--data_dir", tree, "--image_size", "16", "--patch_size", "8", "--embed_dim", "32", "--num_heads", "2",
            "--num_blocks", "1", "--num_classes", "3", "--batch_size", "4", "--max_steps", "2",
            "--log_step_interval", "1", "--num_workers", "2", "--eval_max_batches", "1", "--num_epochs", "1",
            "--ckpt_dir", str(tmp_path)]
    r = subprocess.run([sys.executable, "-m", "vitax_torch.train", "--device", "cpu", *args], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "ImageFolderDataset(" in r.stdout and "decode path" in r.stdout and "accuracy on val" in r.stdout
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "vitax_torch.train", *args], cwd=REPO, capture_output=True,
                           text=True, timeout=240)
        assert r.returncode == 2 and "no CUDA card" in r.stderr
