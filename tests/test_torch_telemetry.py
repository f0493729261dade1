"""vitax_torch.telemetry against vitax.telemetry on the same inputs: the
Recorder's step records and events, the peak table and MFU, the sinks and
build_recorder, the thread-crash hook (and the port's own threads
reporting through it), train() in both packages writing JSONL that
tools/metrics_report.py reads alike, the five flags, --debug_nans,
--log_memory and the quant gate's event. Tiny dims, the CPU."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vitax_torch.config import Config, build_parser, config_fields_from_namespace
from vitax_torch.telemetry import (REQUIRED_STEP_KEYS, SCHEMA_VERSION, Recorder, build_recorder,
                                   detect_peak_tflops, install_thread_excepthook, join_or_warn,
                                   make_tensorboard_sink, thread_crash_count)
from vitax_torch.telemetry import flops, threads
from vitax_torch.utils.logging import memory_stats_dict, memory_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4, batch_size=16,
            dtype="float32", lr=1e-3, warmup_steps=2, clip_grad_norm=1.0, seed=0)


def _configs(**kw):
    from vitax.config import Config as JaxConfig
    return JaxConfig(**{**TINY, **kw}).validate(), Config(**{**TINY, **kw}).validate()


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def close(self):
        pass


def _strip(record):
    return {k: v for k, v in record.items() if k != "time" and not k.startswith("mem_")}


@pytest.mark.parametrize("kw", [dict(sec_per_iter=0.5, data_wait_s=0.01, grad_norm=1.5, opt_update_s=0.002),
                                dict(sec_per_iter=0.0, data_wait_s=0.0),
                                dict(sec_per_iter=1e-3, data_wait_s=2e-4, ckpt_stall_s=0.1, grad_norm=0.0)])
@pytest.mark.parametrize("peak", [0.0, 42.0])
def test_recorder_records_equal_vitax(kw, peak):
    """The same record_step and event arguments into vitax's Recorder and
    the port's: equal key sets and values outside time and mem_* (MFU to
    rtol 1e-12), equal events."""
    from vitax.telemetry.record import Recorder as JaxRecorder
    jcfg, cfg = _configs(peak_tflops=peak)
    theirs, ours = ListSink(), ListSink()
    jr = JaxRecorder(jcfg, [theirs], n_devices=2, device_kind="cpu", rank=0)
    pr = Recorder(cfg, [ours], n_devices=2, device_kind="cpu", rank=0, device="cpu")
    assert (pr.peak_tflops, pr.flops_per_step, pr.tokens_per_step) == \
        (jr.peak_tflops, jr.flops_per_step, jr.tokens_per_step)
    for rec in (jr, pr):
        rec.record_step(step=7, epoch=2, step_in_epoch=3, loss=2.25, lr=5e-4, **kw)
        rec.event("eval", epoch=2, top1=0.5, top5=0.75, n=32)
    (a, ea), (b, eb) = theirs.records, ours.records
    assert set(a) == set(b)
    np.testing.assert_allclose(b.pop("mfu"), a.pop("mfu"), rtol=1e-12)
    assert _strip(a) == _strip(b) and _strip(ea) == _strip(eb)
    assert b["schema"] == SCHEMA_VERSION and b["mem_used_bytes"] == 0


def test_peak_table_and_mfu_match_vitax(capsys):
    """"cpu" and an override give vitax's peak and MFU; a card the table
    has not met gives 0 (MFU 0) and one warning naming --peak_tflops."""
    from vitax.telemetry.flops import detect_peak_tflops as jax_detect
    from vitax.telemetry.flops import mfu as jax_mfu
    jcfg, cfg = _configs()
    for kind, override in (("cpu", 0.0), ("cpu", 300.0), ("NVIDIA H100 80GB HBM3", 5.0)):
        peak = detect_peak_tflops(kind, override)
        assert peak == jax_detect(kind, override)
        for sec in (0.5, 1e-4, 0.0):
            assert flops.mfu(cfg, sec, 8, peak) == jax_mfu(jcfg, sec, 8, peak)
    assert detect_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    capsys.readouterr()
    assert detect_peak_tflops("NVIDIA Some Future GPU") == 0.0
    assert flops.mfu(cfg, 0.5, 1, 0.0) == 0.0
    err = capsys.readouterr().err
    assert err.count("--peak_tflops") == 1 and "NVIDIA Some Future GPU" in err


def test_jsonl_roundtrip(tmp_path):
    cfg = Config(**TINY, metrics_dir=str(tmp_path / "m")).validate()
    rec = build_recorder(cfg, n_devices=8, device_kind="cpu", rank=0, device="cpu")
    assert rec is not None
    for i in range(1, 4):
        rec.record_step(step=i, epoch=1, step_in_epoch=i, loss=2.0 - 0.1 * i, lr=1e-3, sec_per_iter=0.5,
                        data_wait_s=0.01, grad_norm=1.5)
    rec.event("restore", path="dcp", epoch=1, resume_step=0)
    rec.close()
    records = [json.loads(ln) for ln in (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "kind" not in r]
    assert len(steps) == 3 and [r.get("kind") for r in records if "kind" in r] == ["restore"]
    for r in steps:
        assert set(REQUIRED_STEP_KEYS) <= set(r) and r["schema"] == SCHEMA_VERSION and 0.0 < r["mfu"] <= 1.0
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert steps[0]["images_per_sec"] == pytest.approx(16 / 0.5)
    assert steps[0]["tokens_per_sec"] == pytest.approx(16 * 4 / 0.5)


def test_recorder_none_when_off_or_nonzero_rank(tmp_path):
    assert build_recorder(Config(**TINY), 8, "cpu", rank=0) is None
    cfg = Config(**TINY, metrics_dir=str(tmp_path / "m"))
    assert build_recorder(cfg, 8, "cpu", rank=1) is None
    assert not (tmp_path / "m").exists()


def test_recorder_fail_soft_on_unwritable_dir(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    cfg = Config(**TINY, metrics_dir=str(blocker / "sub"))
    assert build_recorder(cfg, 8, "cpu", rank=0) is None
    err = capsys.readouterr().err
    assert "not writable" in err and "telemetry disabled" in err


def test_tensorboard_sink_degrades_without_package(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboard.summary", None)
    assert make_tensorboard_sink(str(tmp_path / "tb")) is None
    assert capsys.readouterr().err.count("tensorboard sink disabled") == 1
    cfg = Config(**TINY, metrics_dir=str(tmp_path / "m"), tensorboard=True).validate()
    rec = build_recorder(cfg, 1, "cpu")
    assert rec is not None and len(rec.sinks) == 1      # the JSONL stays


def test_tensorboard_sink_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    cfg = Config(**TINY, metrics_dir=str(tmp_path / "m"), tensorboard=True).validate()
    rec = build_recorder(cfg, 1, "cpu", device="cpu")
    assert len(rec.sinks) == 2
    rec.record_step(step=1, epoch=1, step_in_epoch=1, loss=2.0, lr=1e-3, sec_per_iter=0.5, data_wait_s=0.0)
    rec.event("eval", epoch=1, top1=1.0, top5=1.0, n=8)       # events: TB no-op
    rec.close()
    assert any("tfevents" in f for f in os.listdir(tmp_path / "m" / "tb"))


@pytest.fixture
def hook(monkeypatch):
    """A fresh crash hook (the module's state and threading.excepthook are
    restored afterwards) with a recorder over a list sink."""
    monkeypatch.setattr(threading, "excepthook", threading.excepthook)
    for name, value in (("_recorder", None), ("_rank", 0), ("_crash_count", 0)):
        monkeypatch.setattr(threads, name, value)
    sink = ListSink()
    install_thread_excepthook(Recorder(Config(**TINY), [sink], 1, "cpu", rank=3), rank=3)
    return sink


def _run_thread(target):
    t = threading.Thread(target=target, name="vitax-test-worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def test_crashing_thread_becomes_an_event(hook, capsys):
    def boom():
        raise ValueError("boom")
    _run_thread(boom)
    assert thread_crash_count() == 1
    (ev,) = hook.records
    assert (ev["kind"], ev["rank"], ev["thread"], ev["error"]) == ("thread_crash", 3, "vitax-test-worker",
                                                                   "ValueError: boom")
    assert "[vitax_torch.threads rank 3]" in capsys.readouterr().err
    _run_thread(lambda: sys.exit(0))            # SystemExit: a deliberate exit, ignored
    assert thread_crash_count() == 1 and len(hook.records) == 1


def test_join_or_warn_times_out_loudly(capsys):
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="vitax-wedged")
    t.start()
    try:
        assert join_or_warn(t, timeout=0.05, rank=2) is False
        err = capsys.readouterr().err
        assert "`vitax-wedged` still alive" in err and "rank 2" in err
    finally:
        release.set()
    assert join_or_warn(t, timeout=10) is True and not t.is_alive()
    assert join_or_warn(None, timeout=0) is True


def test_loader_and_checkpoint_threads_report_through_the_hook(hook):
    """A decode-pool worker failure reaches the hook once (its producer,
    which re-raises it, does not count it again), and the consumer still
    raises LoaderWorkerError; a failed checkpoint write reaches the hook
    and is raised by close(), which joins the writer thread."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.data.loader import LoaderWorkerError, ShardedLoader, ShardedSampler

    class Broken:
        def __getitem__(self, i):
            raise OSError(f"unreadable item {i}")

    loader = ShardedLoader(Broken(), ShardedSampler(16, 4, shuffle=False, seed=0), torch.device("cpu"),
                           num_workers=2)
    with pytest.raises(LoaderWorkerError, match="unreadable item"):
        next(iter(loader.epoch(1)))
    assert thread_crash_count() == 1 and hook.records[0]["thread"].startswith("vitax-torch-data")

    def failing_write():
        raise OSError("disk gone")
    writer = ckpt_io._Writer()
    writer.submit(failing_write)
    with pytest.raises(OSError, match="disk gone"):
        writer.close()
    assert thread_crash_count() == 2 and hook.records[1]["thread"] == "vitax-torch-ckpt"
    assert writer._thread is None


def _tiny_run(tmp_path, name):
    return dict(TINY, fake_data=True, num_epochs=1, steps_per_epoch=3, log_step_interval=1,
                ckpt_dir=str(tmp_path / name / "ckpt"), ckpt_epoch_interval=99, test_epoch_interval=99,
                num_workers=2, eval_max_batches=1, metrics_dir=str(tmp_path / name / "metrics"))


def _read(path):
    records = [json.loads(ln) for ln in open(path)]
    return [r for r in records if "kind" not in r], {r["kind"]: r for r in records if "kind" in r}


def _report(path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), path, "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_train_writes_the_jsonl_vitax_writes(tmp_path, devices8, capsys):
    """train() of both packages on one tiny config (fake data, 3 steps, a
    record a step, an eval): the same step-record keys, steps, epochs,
    lrs (rtol 1e-6), run_start FLOPs and batch, an eval event and 0 < MFU
    <= 1 in both; metrics_report --json reads both files with the same
    summary keys. The inits differ (threefry and torch), so the losses are
    tests/test_torch_train.py's to compare."""
    from vitax.config import Config as JaxConfig
    from vitax.train.loop import train as jax_train
    from vitax_torch.train.loop import train
    jax_train(JaxConfig(**_tiny_run(tmp_path, "jax")).validate())
    train(Config(**_tiny_run(tmp_path, "port")).validate(), "cpu")
    out = capsys.readouterr().out
    assert out.count(", mem: n/a") >= 3               # --log_memory (on by default) on the CPU
    paths = [str(tmp_path / name / "metrics" / "metrics.jsonl") for name in ("jax", "port")]
    (jsteps, jevents), (psteps, pevents) = (_read(p) for p in paths)
    assert len(jsteps) == len(psteps) == 3
    for a, b in zip(jsteps, psteps):
        assert set(a) == set(b) and set(REQUIRED_STEP_KEYS) <= set(b)
        assert (a["step"], a["epoch"], a["step_in_epoch"]) == (b["step"], b["epoch"], b["step_in_epoch"])
        np.testing.assert_allclose(b["lr"], a["lr"], rtol=1e-6)
        assert 0.0 < a["mfu"] <= 1.0 and 0.0 < b["mfu"] <= 1.0
        assert b["opt_update_s"] > 0.0 and b["ckpt_stall_s"] == 0.0
    assert [b["step"] for b in psteps] == [1, 2, 3]
    for key in ("flops_per_step", "batch_size", "device_kind", "peak_tflops"):
        assert pevents["run_start"][key] == jevents["run_start"][key], key
    assert pevents["run_start"]["n_devices"] == 1 and "eval" in jevents
    assert (pevents["eval"]["epoch"], pevents["eval"]["n"]) == (jevents["eval"]["epoch"], jevents["eval"]["n"])
    theirs, ours = (_report(p) for p in paths)
    assert set(theirs) == set(ours)
    assert ours["records"] == theirs["records"] == 3 and ours["thread_crashes"] == theirs["thread_crashes"] == 0


def test_five_flags_parse_as_vitax_and_validate_refuses_alike():
    from vitax.config import Config as JaxConfig
    from vitax.config import build_parser as jax_parser
    argv = ["--metrics_dir", "/tmp/m", "--tensorboard", "--peak_tflops", "123.5", "--debug_nans",
            "--no_log_memory"]
    names = ("metrics_dir", "tensorboard", "peak_tflops", "debug_nans", "log_memory")
    ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert [getattr(ours, n) for n in names] == [getattr(theirs, n) for n in names] == \
        ["/tmp/m", True, 123.5, True, False]
    defaults = build_parser().parse_args([])
    assert [getattr(defaults, n) for n in names] == [getattr(jax_parser().parse_args([]), n) for n in names]
    Config(**config_fields_from_namespace(ours)).validate()
    for bad in (dict(peak_tflops=-5.0), dict(tensorboard=True)):
        with pytest.raises(AssertionError) as want:
            JaxConfig(**{**TINY, **bad}).validate()
        with pytest.raises(ValueError) as got:
            Config(**{**TINY, **bad}).validate()
        assert str(got.value) == str(want.value)


class _NaNLoader:
    """One float batch holding NaN a call of epoch()."""
    steps_per_epoch = 2

    def epoch(self, epoch, start_step=0):
        images = torch.zeros((8, 16, 16, 3))
        images[0, 0, 0, 0] = float("nan")
        yield {"image": images, "label": torch.zeros(8, dtype=torch.int64)}

    def consume_wait_s(self):
        return 0.0


def test_debug_nans_names_the_step_and_resets_anomaly_mode(tmp_path):
    """A NaN batch under --debug_nans: FloatingPointError naming step 1;
    anomaly mode and the thread hook are as they were before train()."""
    from vitax_torch.train.loop import train
    cfg = Config(**{**TINY, "batch_size": 8}, debug_nans=True, num_epochs=1, log_step_interval=10,
                 ckpt_dir=str(tmp_path / "ckpt")).validate()
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    hook = threading.excepthook
    assert not before[0]
    with pytest.raises(FloatingPointError, match="step 1"):
        train(cfg, "cpu", data=(None, _NaNLoader(), None, _NaNLoader()))
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    assert threading.excepthook is hook             # train() put the process's hook back


def test_memory_stats_on_the_cpu():
    assert memory_stats_dict("cpu") == {} and memory_summary("cpu") == "mem: n/a"
    from vitax_torch.telemetry import memory_stats_bytes
    assert memory_stats_bytes("cpu") == {"mem_used_bytes": 0}


class _Engine:
    """The predict surface eval_engine reads: top-k ids a row."""

    def __init__(self, ids, weights_dtype, **attrs):
        self.ids, self.weights_dtype, self.buckets = ids, weights_dtype, [1, 2, 4]
        self.__dict__.update(attrs)
        self.at = 0

    def predict(self, images):
        n = images.shape[0]
        out, self.at = self.ids[self.at:self.at + n], (self.at + n) % len(self.ids)
        return out, None


def test_quant_gate_event_has_vitax_fields():
    from vitax.serve.quant import run_quant_gate as jax_gate
    from vitax_torch.serve.quant import run_quant_gate
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, size=12)
    ids_f = np.stack([labels] + [rng.integers(0, 10, size=12) for _ in range(4)], axis=1)
    ids_q = ids_f[:, ::-1].copy()
    images = np.zeros((12, 4, 4, 3), np.float32)
    events = []
    for gate in (jax_gate, run_quant_gate):
        sink = ListSink()
        rec = Recorder(Config(**TINY), [sink], 1, "cpu")
        got = gate(_Engine(ids_f, "float32"), _Engine(ids_q, "int8", act_quant="int8", fused_dequant=True),
                   images, labels, recorder=rec)
        (ev,) = sink.records
        assert ev["kind"] == "quant_gate" and _strip(ev) == _strip({**got, "kind": "quant_gate", "rank": 0,
                                                                      "schema": 1})
        events.append(_strip(ev))
    assert events[0] == events[1]
