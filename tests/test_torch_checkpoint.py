"""vitax_torch's checkpoint slice: save, resume and export of the train
state, held to the JAX package where both have the function.

- The npz export: the port's save_npz against vitax's on one flat tree for
  every --dtype (keys, manifests and array bits), each package reading the
  other's file; params_to_jax / params_from_jax round trips, scanned and
  unscanned, in the JAX tree's keys and shapes; a vitax TrainState
  exported with vitax's save_npz resumes in the port, whose next step
  matches JAX's; vitax's engine serves the port's export (float, int8).
- Resume: a run saved at epoch 1 and resumed with --resume_epoch 1 ends
  bitwise equal (params, mu, nu, step, losses) to an uninterrupted run, at
  rate 0, under att_dropout 0.1, and mid-epoch from a stream cursor.
- io.py: auto-resume past a torn dir and on an empty one, pruning that
  never touches a torn dir, the snapshot taken before save_state returns,
  the retry of a transient OSError, the restore fallback, the sidecar read
  by both packages, and the elastic-resume plan against vitax's.
- The config and both CLIs.
Tiny dims, float32, inputs from numpy seeds; the JAX side on the 8-device
CPU mesh of tests/conftest.py.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint.consolidate import consolidate, load_npz, load_npz_raw, save_npz
from vitax_torch.checkpoint.convert import (params_from_jax, params_to_jax, train_state_from_jax,
                                            train_state_to_jax)
from vitax_torch.config import Config, build_parser
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.control import elastic_resume_plan
from vitax_torch.train.loop import train
from vitax_torch.train.state import TrainState, build_optimizer, make_train_state
from vitax_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=8,
            batch_size=16, dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
# two epochs of three steps on fake data, a save after each, one eval batch
RUN = dict(fake_data=True, num_epochs=2, steps_per_epoch=3, log_step_interval=1, eval_max_batches=1,
           num_workers=2, ckpt_epoch_interval=1)


def _state(cfg, init=True):
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=init).train()
    return make_train_state(model if init else model.to_empty(device="cpu"))


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and int(a.count) == int(b.count) == a.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys() == a.mu.keys() == b.nu.keys()
    for name in sa:
        for x, y in ((sa[name], sb[name]), (a.mu[name], b.mu[name]), (a.nu[name], b.nu[name])):
            assert torch.equal(x, y), name


def _losses(records, after_epoch=0):
    return [r["loss"] for r in records if "loss" in r and r["epoch"] > after_epoch]


# --- the npz export against vitax's ------------------------------------------------


def _jax_like_tree(seed=0):
    """A flat tree in the JAX layout: scanned block kernels (L, in, out),
    biases, LayerNorm scales, the conv, the head, and an int32 step."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qkv = f(2, 32, 96)
    qkv[1, :, 5] = 0.0                              # an all-zero channel: scale 1
    return {"params/blocks/attn/qkv/kernel": qkv, "params/blocks/attn/qkv/bias": f(2, 96),
            "params/blocks/norm1/scale": f(2, 32), "params/head/kernel": f(32, 8) * 40,
            "params/head/bias": f(8), "params/patch_embed/proj/kernel": f(8, 8, 3, 32),
            "params/pos_embed": f(1, 4, 32), "step": np.asarray(7, np.int32)}


def _raw(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16", "int8", "float8_e4m3"])
def test_save_npz_matches_jax(tmp_path, dtype):
    """Same flat tree: the same file keys, manifests and array bits; each
    package reads the other's file to the same leaves."""
    from vitax.checkpoint import consolidate as jc
    tree = _jax_like_tree()
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    save_npz(ours, tree, dtype=dtype)
    jc.save_npz(theirs, tree, dtype=dtype)
    a, b = _raw(ours), _raw(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    if dtype in ("int8", "float8_e4m3"):
        assert str(a["__quant__"]) == str(b["__quant__"])
        assert len(jc.parse_quant_manifest(str(a["__quant__"]))) == 3
    assert ("__bfloat16_keys__" in a) == (dtype == "bfloat16")
    # vitax reads the port's file, the port reads vitax's: the same leaves
    jflat, jscales, jman = jc.load_npz_raw(ours)
    tflat, tscales, tman = load_npz_raw(theirs)
    assert jflat.keys() == tflat.keys() == tree.keys() and jman == tman and jscales.keys() == tscales.keys()
    for k in jflat:
        want = np.asarray(jflat[k])
        got = tflat[k]
        assert got.element_size() == want.itemsize and tuple(got.shape) == want.shape, k
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == want.tobytes(), k
    for k in jscales:
        assert tscales[k].numpy().tobytes() == jscales[k].tobytes()
    # the dequantizing readers agree too
    jl, tl = jc.load_npz(theirs), load_npz(ours)
    for k in jl:
        np.testing.assert_array_equal(tl[k].float().numpy(), np.asarray(jl[k]).astype(np.float32))


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "unscanned"])
def test_params_to_jax_round_trip_and_layout(devices8, scanned):
    """params_from_jax(params_to_jax(sd)) == sd, and the JAX layout has the
    keys, shapes and dtypes of vitax's own param tree."""
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    cfg = Config(**TINY).validate()
    sd = _state(cfg).model.state_dict()
    flat = params_to_jax(sd, scanned=scanned)
    back = params_from_jax(flat)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    jcfg = JaxConfig(**TINY, scan_blocks=scanned).validate()
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), np.zeros((1, 16, 16, 3), np.float32)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten_tree(zeros).items()}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in flat.items()} == want


def _jax_state(steps, images, labels):
    """A JAX TrainState at vitax's defaults (scanned blocks) after `steps`
    steps on one batch, with its step function and mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import batch_pspec, build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state as jax_make_train_state
    from vitax.train.step import make_train_step as jax_make_train_step
    jcfg = JaxConfig(**TINY, fsdp_size=2, dp_size=4).validate()
    mesh = build_mesh(jcfg)
    jmodel = jax_build_model(jcfg)
    tx, schedule = jax_build_optimizer(jcfg, max_iteration=10)
    state, sspecs, _ = jax_make_train_state(jcfg, jmodel, tx, mesh, jax.random.key(0))
    step_fn = jax_make_train_step(jcfg, jmodel, tx, mesh, sspecs, schedule=schedule)
    sh = NamedSharding(mesh, batch_pspec())
    batch = {"image": jax.device_put(jnp.asarray(images), sh),
             "label": jax.device_put(jnp.asarray(labels.astype(np.int32)), sh)}
    for _ in range(steps):
        state, _ = step_fn(state, batch, jax.random.key(1))
    return state, step_fn, batch


def test_jax_full_state_export_resumes_in_port(devices8, tmp_path):
    """A JAX TrainState after one step, written by vitax's save_npz in the
    full-state layout, loads into the port; the next step of each matches at
    tests/test_torch_train.py's bars. The port's full-state export has the
    JAX TrainState's keys, shapes and dtypes."""
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.checkpoint.consolidate import load_npz as jax_load_npz
    from vitax.checkpoint.consolidate import save_npz as jax_save_npz
    rng = np.random.default_rng(0)
    images = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 8, size=(16,))
    jstate, step_fn, jbatch = _jax_state(1, images, labels)
    jflat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jstate)).items()}
    path = str(tmp_path / "jax_full.npz")
    jax_save_npz(path, jflat)

    loaded = load_npz(path)
    assert all(loaded[k].shape == v.shape for k, v in jflat.items())
    sd, mu, nu, step, count = train_state_from_jax(loaded)
    assert step == int(count) == 1
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(sd, strict=True, assign=True)
    state = TrainState(step=step, model=model.train(), mu=mu, nu=nu, count=count)
    optimizer, _ = build_optimizer(cfg, 10)
    state, metrics = make_train_step(cfg, optimizer, "cpu")(state, {"image": torch.from_numpy(images),
                                                                     "label": torch.from_numpy(labels)})
    jstate, jm = step_fn(jstate, jbatch, jax.random.key(1))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax.device_get(jm["loss"])), rtol=2e-4, atol=2e-5)
    want = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jstate)).items()}
    got = train_state_to_jax(state.model.state_dict(), state.mu, state.nu, state.step, state.count)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    for k in want:
        if k.startswith(("params/", "opt_state/1/0/mu/")):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3, atol=2e-5, err_msg=k)
        elif not k.startswith("opt_state/1/0/nu/"):
            assert int(got[k]) == int(want[k]) == 2, k
    # the port's full-state file reads back in vitax to the same keys
    ours = str(tmp_path / "port_full.npz")
    save_npz(ours, got)
    assert jax_load_npz(ours).keys() == want.keys()


@pytest.mark.parametrize("dtype", [None, "int8"], ids=["float32", "int8"])
def test_vitax_engine_serves_port_export(devices8, tmp_path, dtype):
    """A port checkpoint, consolidated by the port, served by vitax's
    InferenceEngine at a default (scanned) config and by the port's: the same
    top-k ids, probs within 1e-5 (tests/test_torch_serve.py's f32 bar)."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax_torch.serve import InferenceEngine
    cfg = Config(**TINY).validate()
    state = _state(cfg)
    with torch.no_grad():
        state.model.head.weight.mul_(50.0)         # spread the logits, as tests/test_torch_serve.py does
    ckpt_io.save_state(str(tmp_path / "ckpt"), 4, state, wait=True)
    out = str(tmp_path / "export.npz")
    flat = consolidate(str(tmp_path / "ckpt"), 4, out, dtype=dtype)
    assert all(k.startswith("params/") for k in flat) and "params/blocks/attn/qkv/kernel" in flat
    quant = {"serve_quant_dtype": dtype} if dtype else {}
    jeng = JaxEngine.from_npz(JaxConfig(**TINY, serve_port=0, **quant).validate(), out)
    teng = InferenceEngine.from_npz(Config(**TINY, **quant).validate(), out, "cpu")
    jeng.warmup()
    teng.warmup()
    x = np.random.default_rng(7).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    ids_j, p_j = jeng.predict(x)
    ids_t, p_t = teng.predict(x)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(p_t, p_j, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3"])
def test_quantizer_on_the_card_matches_the_host(dtype):
    """quantize_tensor on a CUDA tensor gives the codes and scales it gives
    on the host, bit for bit: the in-memory quantized engine serves what
    the export serves (a Python-number divisor would multiply by its
    reciprocal on the card and move scales by a bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.checkpoint.consolidate import quantize_tensor
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((5120, 1536)).astype(np.float32))
    q_host, s_host = quantize_tensor(w, (1,), dtype)
    q_card, s_card = quantize_tensor(w.cuda(), (1,), dtype)
    assert torch.equal(s_card.cpu(), s_host)
    assert torch.equal(q_card.cpu().view(torch.uint8), q_host.view(torch.uint8))


# --- resume equals uninterrupted -----------------------------------------------------


@pytest.mark.parametrize("arm", [{}, {"att_dropout": 0.1}], ids=["rate0", "att_dropout"])
def test_resume_equals_uninterrupted(tmp_path, arm):
    """Run A trains two epochs and saves after each; run B resumes A's
    epoch 1 with --resume_epoch 1 and trains epoch 2: B's params, mu, nu,
    step and epoch-2 losses equal A's bitwise."""
    d = str(tmp_path)
    rec_a, rec_b = [], []
    a = train(Config(**TINY, **RUN, **arm, ckpt_dir=d).validate(), "cpu", records=rec_a)
    assert ckpt_io.committed_epochs(d) == [1, 2] and a.step == 6
    assert [r["epoch"] for r in rec_a if "ckpt_stall_s" in r] == [1, 2]
    b = train(Config(**TINY, **RUN, **arm, ckpt_dir=d, resume_epoch=1).validate(), "cpu", records=rec_b)
    _assert_states_equal(a, b)
    assert _losses(rec_b) == _losses(rec_a, after_epoch=1) and len(_losses(rec_b)) == 3


def test_mid_epoch_stream_resume_equals_uninterrupted(tmp_path):
    """From .vtxshard shards: a run stopped after step 2 of epoch 1, saved
    with save_state(step_in_epoch=2, stream_cursor=...) as a preemption save
    is, then resumed with --resume_epoch 1 (the cursor checked), ends bitwise
    equal to an uninterrupted two-epoch run."""
    from test_torch_data import TINY as DATA_TINY
    from test_torch_data import make_tree
    from vitax_torch.data.loader import build_datasets
    from vitax_torch.tools.make_shards import main as make_shards_main
    tree = make_tree(tmp_path / "tree", seed=5)
    shards = str(tmp_path / "shards")
    assert make_shards_main(["--src", tree, "--dst", shards, "--shard_size_mb", "0.008"]) == 0
    run = dict(DATA_TINY, data_format="stream", data_dir=shards, num_epochs=2, log_step_interval=1,
               eval_max_batches=1, num_workers=2, ckpt_epoch_interval=99)
    rec_a, rec_b = [], []
    a = train(Config(**run, ckpt_dir=str(tmp_path / "a")).validate(), "cpu", records=rec_a)
    assert a.step == 8                              # 16 records, batch 4
    d = str(tmp_path / "pre")
    cfg_p = Config(**run, ckpt_dir=d, max_steps=2).validate()
    data = build_datasets(cfg_p, torch.device("cpu"), use_native=False)
    pre = train(cfg_p, "cpu", data=data)
    assert pre.step == 2 and ckpt_io.latest_epoch(d) is None
    cursor = data[1].cursor_for_step(1, 2)
    ckpt_io.save_state(d, 1, pre, wait=True, step_in_epoch=2, stream_cursor=cursor)
    assert ckpt_io.load_resume_step(d, 1) == 2 and ckpt_io.load_stream_cursor(d, 1) == cursor
    b = train(Config(**run, ckpt_dir=d, resume_epoch=1).validate(), "cpu", records=rec_b)
    _assert_states_equal(a, b)
    assert _losses(rec_b) == _losses(rec_a)[2:] and len(_losses(rec_b)) == 6
    # a drifted cursor fails the resume instead of feeding other records
    ckpt_io.save_state(d, 1, pre, wait=True, step_in_epoch=2, stream_cursor=dict(cursor, record_offset=1))
    with pytest.raises(RuntimeError, match="stream resume cursor mismatch"):
        train(Config(**run, ckpt_dir=d, resume_epoch=1).validate(), "cpu")
    # an epoch-boundary save of the epoch clears its sidecar
    ckpt_io.save_state(d, 1, pre, wait=True)
    assert ckpt_io.load_resume_meta(d, 1) is None


def test_auto_resume_past_torn_dir_and_fresh_start(tmp_path, capsys):
    """--resume_epoch -1 starts fresh on an empty dir (the losses of a fresh
    run), skips a torn epoch_3/ for the committed epoch 2, trains epoch 3
    and commits it over the torn dir; an explicit epoch that is not there
    fails hard."""
    d = str(tmp_path)
    rec_fresh, rec_auto = [], []
    fresh = train(Config(**TINY, **RUN, ckpt_dir=d).validate(), "cpu", records=rec_fresh)
    empty = str(tmp_path / "empty")
    auto = train(Config(**TINY, **RUN, ckpt_dir=empty, resume_epoch=-1).validate(), "cpu", records=rec_auto)
    assert "auto-resume: no checkpoint found, fresh start" in capsys.readouterr().out
    _assert_states_equal(fresh, auto)
    assert _losses(rec_auto) == _losses(rec_fresh)
    torn = os.path.join(d, "epoch_3")
    os.makedirs(torn)
    with open(os.path.join(torn, "__0_0.distcp"), "wb") as f:
        f.write(b"partial")
    assert ckpt_io.latest_epoch(d) == 2
    run3 = dict(RUN, num_epochs=3)
    resumed = train(Config(**TINY, **run3, ckpt_dir=d, resume_epoch=-1).validate(), "cpu")
    out = capsys.readouterr().out
    assert "skipping torn checkpoint" in out and "auto-resume: epoch 2" in out
    assert resumed.step == 9 and ckpt_io.latest_epoch(d) == 3
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        train(Config(**TINY, **run3, ckpt_dir=d, resume_epoch=5).validate(), "cpu")


# --- io.py -------------------------------------------------------------------------


def test_prune_never_touches_torn_dirs(tmp_path):
    d = str(tmp_path)
    cfg = Config(**TINY).validate()
    state = _state(cfg)
    for ep in (1, 2, 3):
        ckpt_io.save_state(d, ep, state, wait=True, step_in_epoch=1 if ep == 1 else None)
    for torn in ("epoch_0", "epoch_4"):
        os.makedirs(os.path.join(d, torn))
    assert ckpt_io.prune_checkpoints(d, 0) == []
    assert ckpt_io.prune_checkpoints(d, 1) == [1, 2]
    assert sorted(os.listdir(d)) == ["epoch_0", "epoch_3", "epoch_4"]      # epoch 1's sidecar went too
    ckpt_io.save_state(d, 5, state, wait=True, keep=1)
    assert sorted(os.listdir(d)) == ["epoch_0", "epoch_4", "epoch_5"]
    assert ckpt_io.committed_epochs(d) == [5]


def test_snapshot_taken_before_save_returns(tmp_path, monkeypatch):
    """save_state returns with the write still pending (held here until the
    state was updated in place); the checkpoint holds the values of save
    time (tests/test_checkpoint.py:176)."""
    import torch.distributed.checkpoint as dcp
    gate, real = threading.Event(), dcp.save

    def held_save(*args, **kwargs):
        assert gate.wait(60)
        return real(*args, **kwargs)

    monkeypatch.setattr(dcp, "save", held_save)
    d = str(tmp_path)
    cfg = Config(**TINY).validate()
    state = _state(cfg)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    path = ckpt_io.save_state(d, 7, state)
    assert not ckpt_io.is_committed_checkpoint(path)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(2.0)
        for m in state.mu.values():
            m.add_(1.0)
    state.step += 3
    state.count += 3
    gate.set()
    ckpt_io.wait_until_finished()
    assert ckpt_io.is_committed_checkpoint(path)
    restored = ckpt_io.restore_state(d, 7, _state(cfg, init=False))
    assert restored.step == 0 and int(restored.count) == 0
    assert all(torch.equal(restored.model.state_dict()[k], saved[k]) for k in saved)
    assert all(not m.any() for m in restored.mu.values())


def test_transient_write_failure_is_retried(tmp_path, monkeypatch, capfd):
    import torch.distributed.checkpoint as dcp
    real, calls = dcp.save, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError(5, "Input/output error")
        return real(*args, **kwargs)

    monkeypatch.setattr(dcp, "save", flaky)
    monkeypatch.setenv("VITAX_SAVE_RETRY_BACKOFF_S", "0.001")
    d = str(tmp_path)
    state = _state(Config(**TINY).validate())
    path = ckpt_io.save_state(d, 1, state, wait=True)
    assert len(calls) == 2 and ckpt_io.is_committed_checkpoint(path)
    assert "transient save failure" in capfd.readouterr().err
    # one attempt allowed: the failure surfaces, and the dir stays torn
    calls.clear()
    monkeypatch.setenv("VITAX_SAVE_RETRIES", "1")
    with pytest.raises(OSError, match="Input/output error"):
        ckpt_io.save_state(d, 2, state, wait=True)
    assert ckpt_io.committed_epochs(d) == [1]
    # VITAX_CKPT_SYNC=1: every save commits before it returns
    monkeypatch.setenv("VITAX_CKPT_SYNC", "1")
    assert ckpt_io.is_committed_checkpoint(ckpt_io.save_state(d, 3, state))


def test_restore_falls_back_past_a_bad_checkpoint(tmp_path, capfd):
    d = str(tmp_path)
    cfg = Config(**TINY).validate()
    state = _state(cfg)
    ckpt_io.save_state(d, 1, state, wait=True)
    state.step = 4
    ckpt_io.save_state(d, 2, state, wait=True)
    for name in os.listdir(os.path.join(d, "epoch_2")):
        if name.endswith(".distcp"):
            os.remove(os.path.join(d, "epoch_2", name))      # the marker stays
    restored, epoch = ckpt_io.restore_state_with_fallback(d, 2, _state(cfg, init=False))
    assert epoch == 1 and restored.step == 0
    assert "RESTORE FAILED for epoch 2" in capfd.readouterr().err
    with pytest.raises(BaseException):                      # DCP wraps the missing file
        ckpt_io.restore_state(d, 2, _state(cfg, init=False))


def test_sidecar_read_by_both_packages(tmp_path):
    from vitax.checkpoint import orbax_io
    d = str(tmp_path)
    state = _state(Config(**TINY).validate())
    cursor = {"epoch": 1, "step": 3, "shard_cursor": 0, "record_offset": 12, "shard": "s0"}
    ckpt_io.save_state(d, 1, state, wait=True, step_in_epoch=3, stream_cursor=cursor)
    for ours, theirs in ((ckpt_io.load_resume_step, orbax_io.load_resume_step),
                         (ckpt_io.load_resume_meta, orbax_io.load_resume_meta),
                         (ckpt_io.load_stream_cursor, orbax_io.load_stream_cursor)):
        assert ours(d, 1) == theirs(d, 1) is not None
    assert ckpt_io.load_resume_meta(d, 1) == {"step_in_epoch": 3, "process_count": 1, "stream_cursor": cursor}
    with open(ckpt_io.epoch_ckpt_path(d, 1) + ".resume.json", "w") as f:
        f.write("{not json")
    assert ckpt_io.load_resume_step(d, 1) is None and ckpt_io.load_resume_meta(d, 1) is None


@pytest.mark.parametrize("meta,count", [
    (None, 1), ({"step_in_epoch": 4, "process_count": 1}, 1), ({"step_in_epoch": 4}, 2),
    ({"step_in_epoch": 4, "process_count": 2}, 1),
    ({"step_in_epoch": 4, "process_count": 2, "stream_cursor": {"epoch": 1}}, 1),
    ({"step_in_epoch": 0, "process_count": 2, "stream_cursor": {"epoch": 1}}, 1)])
def test_elastic_resume_plan_matches_jax(meta, count):
    from vitax.train.control import elastic_resume_plan as jax_plan
    assert dataclasses.asdict(elastic_resume_plan(meta, count)) == dataclasses.asdict(jax_plan(meta, count))


# --- config and CLIs ---------------------------------------------------------------


@pytest.mark.parametrize("bad,match", [(dict(keep_checkpoints=-1), "keep_checkpoints"),
                                       (dict(ckpt_epoch_interval=0), "ckpt_epoch_interval")])
def test_config_takes_the_checkpoint_flags(bad, match):
    for ok in (dict(resume_epoch=1), dict(resume_epoch=-1), dict(keep_checkpoints=2)):
        Config(**ok).validate()
    with pytest.raises(ValueError, match=match):
        Config(**bad).validate()
    help_text = build_parser().format_help()
    for flag, default in (("--ckpt_dir", "/tmp/vit_fsdp"), ("--ckpt_epoch_interval", "10"),
                          ("--keep_checkpoints", "0"), ("--resume_epoch", "0")):
        assert flag in help_text
        assert build_parser().parse_args([]).__dict__[flag[2:]] == type(getattr(Config(), flag[2:]))(default)


def test_cli_saves_resumes_and_exports(tmp_path, capsys):
    """The train CLI stopped after epoch 1 (its main, in process), then
    python -m vitax_torch.train --resume_epoch -1, then python -m
    vitax_torch.checkpoint.consolidate --dtype int8 of epoch 2."""
    from vitax_torch.train.__main__ import main as train_main
    d, out = str(tmp_path / "ckpt"), str(tmp_path / "int8.npz")
    flags = ["--device", "cpu", "--fake_data", "--image_size", "16", "--patch_size", "8", "--embed_dim", "32",
             "--num_heads", "2", "--num_blocks", "2", "--num_classes", "4", "--batch_size", "8",
             "--num_epochs", "2", "--steps_per_epoch", "2", "--log_step_interval", "1", "--eval_max_batches", "1",
             "--ckpt_dir", d, "--ckpt_epoch_interval", "1", "--num_workers", "2"]

    def run(*args):
        r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        return r.stdout

    assert train_main([*flags, "--max_steps", "2"]) == 0
    assert "checkpoint save started" in capsys.readouterr().out and ckpt_io.committed_epochs(d) == [1]
    second = run("vitax_torch.train", *flags, "--resume_epoch", "-1")
    assert "auto-resume: epoch 1" in second and "resumed from checkpoint" in second
    assert "epoch 2 step 2, lr" in second and "epoch 1 step" not in second
    assert "checkpoint save committed" in second and ckpt_io.committed_epochs(d) == [1, 2]
    assert "consolidated" in run("vitax_torch.checkpoint.consolidate", "--ckpt_dir", d, "--epoch", "2",
                                 "--out", out, "--dtype", "int8")
    flat, scales, manifest = load_npz_raw(out)
    assert set(manifest.values()) == {"int8"} and flat["params/blocks/attn/qkv/kernel"].dtype == torch.int8
    assert flat["params/blocks/attn/qkv/kernel"].shape == (2, 32, 96)
