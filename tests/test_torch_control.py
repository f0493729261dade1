"""vitax_torch's control plane and preemption against vitax's, and the
SIGTERM drill against an uninterrupted port run.

- train/control.py: pack_word / unpack_word and Signals on every word,
  the refused words, agree_peer_restore, ControlPlane.poll on vitax's
  cadence with injected folds (the same scripted signals into both
  planes give the same agreed words, collective calls and events), the
  barrier_timeout site, warmup; PeerLiveness on a fake KV (a silent peer
  lost once with its published cause, a peer that never wrote, the
  bounded exit, peer_loss_suspected) and StoreKV over a real c10d store;
  the control events of both planes and the supervisor's topology_change,
  folded by tools/metrics_report.py into the same summary.
- train/preempt.py in a subprocess (signal.signal needs the main thread).
- The SIGTERM drill: a supervised CLI run SIGTERMed at step 2 commits a
  mid-epoch save (step_in_epoch 2) and exits 0 through the supervisor; a
  resumed run re-enters at step 3 and ends bitwise the uninterrupted run.
Tiny dims, float32, the CPU.
"""

import datetime
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from vitax_torch import faults
from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.config import Config
from vitax_torch.train import control
from vitax_torch.train.control import (BIT_ESCALATE, BIT_FAULT, BIT_PEER_LOST, BIT_PEER_RESTORE, BIT_PREEMPT,
                                       ControlPlane, PeerLiveness, Signals, StoreKV, agree_peer_restore, pack_word,
                                       store_client, unpack_word)
from vitax_torch.telemetry.watchdog import EXIT_HANG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4, batch_size=8,
            dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
RUN = dict(fake_data=True, num_epochs=2, steps_per_epoch=3, log_step_interval=1, eval_max_batches=1,
           test_epoch_interval=99, ckpt_epoch_interval=1, num_workers=1)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


def _wait_until(cond, timeout_s=5.0, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return cond()


# --- the control word -----------------------------------------------------------------


@pytest.mark.parametrize("word", range(16))
def test_pack_unpack_and_signals_match_vitax(word):
    from vitax.train import control as jc
    flags = dict(preempt=bool(word & 1), escalate=bool(word & 2), fault=bool(word & 4), peer_lost=bool(word & 8))
    assert pack_word(**flags) == jc.pack_word(**flags) == word
    ours, theirs = unpack_word(word), jc.unpack_word(word)
    for attr in ("preempt", "escalate", "fault", "peer_lost", "word", "any", "emergency"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.describe() == theirs.describe() == Signals(**flags).describe()


@pytest.mark.parametrize("bad", [-1, 16, BIT_PEER_RESTORE, 0xFF, 1 << 20])
def test_unpack_refuses_words_outside_the_layout_as_vitax(bad):
    from vitax.train import control as jc
    with pytest.raises(ValueError) as theirs:
        jc.unpack_word(bad)
    with pytest.raises(ValueError) as ours:
        unpack_word(bad)
    assert str(ours.value) == str(theirs.value)
    assert (BIT_PREEMPT, BIT_ESCALATE, BIT_FAULT, BIT_PEER_LOST, BIT_PEER_RESTORE) == (
        jc.BIT_PREEMPT, jc.BIT_ESCALATE, jc.BIT_FAULT, jc.BIT_PEER_LOST, jc.BIT_PEER_RESTORE)


@pytest.mark.parametrize("local_ok", [True, False])
@pytest.mark.parametrize("peer_word", [0, BIT_PEER_RESTORE])
@pytest.mark.parametrize("count", [1, 2])
def test_agree_peer_restore_folds_as_vitax(local_ok, peer_word, count):
    from vitax.train import control as jc
    fold = lambda w: w | peer_word     # noqa: E731 - the other process's vote
    assert (agree_peer_restore(local_ok, process_count=count, collective=fold)
            == jc.agree_peer_restore(local_ok, process_count=count, collective=fold))


@pytest.mark.parametrize("count", [1, 2], ids=["alone", "two_processes"])
def test_poll_cadence_words_calls_and_events_match_vitax(count, monkeypatch):
    from vitax.train import control as jc
    from vitax.train import preempt as jpreempt
    from vitax_torch.train import preempt
    monkeypatch.setattr(preempt, "requested", lambda: False)
    monkeypatch.setattr(jpreempt, "requested", lambda: False)
    outs = []
    for module in (control, jc):
        calls, events = [], []
        plane = module.ControlPlane(sync_steps=3, process_index=0, process_count=count,
                                    collective=lambda w, c=calls: c.append(w) or w | (BIT_PREEMPT if len(c) > 2 else 0),
                                    on_event=events.append)
        words = [plane.poll(step_in_epoch=s, epoch=1).word for s in range(2)]
        plane.set_fault("drill")
        words += [plane.poll(step_in_epoch=s, epoch=1).word for s in range(2, 7)]
        words.append(plane.poll(step_in_epoch=None, epoch=2).word)
        plane.warmup()
        outs.append((words, calls, events))
    assert outs[0] == outs[1]
    words, calls, events = outs[0]
    if count == 1:                      # alone: every poll reads the local word, no collective
        assert calls == [] and words == [0, 0] + [BIT_FAULT] * 6
    else:                               # on cadence only: steps 2 and 5, the epoch boundary, warmup's 0
        assert calls == [BIT_FAULT, BIT_FAULT, BIT_FAULT, 0]
    assert [e["event"] for e in events] == ["fault_flagged", "agreed_escalation"]


def test_barrier_timeout_site_fires_inside_the_agreement():
    faults.install('{"site": "barrier_timeout", "action": "oserror", "at": 1}')
    plane = ControlPlane(sync_steps=1, process_index=0, process_count=2, collective=lambda w: w)
    with pytest.raises(OSError):
        plane.poll(step_in_epoch=0)
    alone = ControlPlane(sync_steps=1, process_index=0, process_count=1, collective=lambda w: 1 / 0)
    assert alone.poll(step_in_epoch=0) == Signals()      # alone: no agreement, no site


# --- peer liveness --------------------------------------------------------------------


class FakeKV:
    """The KV interface (vitax's client's method names) over a dict."""

    def __init__(self):
        self.store, self.lock = {}, threading.Lock()

    def key_value_set(self, key, value, allow_overwrite=False):
        with self.lock:
            self.store[key] = value

    def blocking_key_value_get(self, key, timeout_in_ms):
        with self.lock:
            if key in self.store:
                return self.store[key]
        raise KeyError(key)


class FakeWatchdog:
    def __init__(self):
        self.requests, self.running, self.armed = [], False, 0

    def escalation_requested(self):
        return bool(self.requests)

    def request_escalation(self, reason="external"):
        self.requests.append(reason)

    def arm_exit_deadline(self):
        self.armed += 1


@pytest.mark.parametrize("package", ["port", "vitax"])
def test_liveness_declares_a_silent_peer_lost_once_with_cause(package):
    from vitax.train import control as jc
    cls = PeerLiveness if package == "port" else jc.PeerLiveness
    kv = FakeKV()
    kv.key_value_set("vitax/fault/1", "hang_hard_exit")
    losses = []
    live = cls(process_index=0, process_count=2, interval_s=0.05, grace_s=0.25, client=kv,
               on_loss=lambda *a: losses.append(a))
    live.start()
    try:
        for seq in range(3):
            kv.key_value_set("vitax/hb/1", str(seq))
            time.sleep(0.08)
        assert losses == []
        assert _wait_until(lambda: losses, timeout_s=3.0)
        time.sleep(0.3)
        assert len(losses) == 1
        peer, silent_s, cause = losses[0]
        assert peer == 1 and silent_s >= 0.25 and cause == "hang_hard_exit"
        assert live.lost == {1} and "vitax/hb/0" in kv.store
    finally:
        live.stop()


def test_peer_loss_escalates_and_exits_42_within_the_deadline():
    events, exits = [], []
    wd = FakeWatchdog()
    plane = ControlPlane(sync_steps=1, process_index=0, process_count=2, watchdog=wd, collective=lambda w: w,
                         on_event=events.append, hard_exit=exits.append)
    t0 = time.monotonic()
    assert plane.start_liveness(interval_s=0.05, grace_s=0.2, client=FakeKV())   # peer 1 never beats
    try:
        assert _wait_until(lambda: exits, timeout_s=5.0)
    finally:
        plane.stop()
    assert time.monotonic() - t0 < 0.2 + 0.2 + 1.0          # grace, then the deadline, with slack
    assert plane.local_word() & BIT_PEER_LOST and "peer 1 lost" in wd.requests[0]
    loss = [e for e in events if e["event"] == "peer_loss"]
    assert len(loss) == 1 and loss[0]["peer"] == 1 and loss[0]["exit_code"] == EXIT_HANG and exits == [EXIT_HANG]


def test_peer_loss_suspected_classifies_errors():
    assert ControlPlane(process_index=0, process_count=2, collective=lambda w: w).peer_loss_suspected() is None
    plane = ControlPlane(sync_steps=1, process_index=0, process_count=2, collective=lambda w: w,
                         hard_exit=lambda c: None)
    assert plane.start_liveness(interval_s=0.05, grace_s=0.2, client=FakeKV())
    try:
        assert plane.peer_loss_suspected() == 1
    finally:
        plane.stop()
    kv, stop = FakeKV(), threading.Event()
    beating = ControlPlane(sync_steps=1, process_index=0, process_count=2, collective=lambda w: w)
    assert beating.start_liveness(interval_s=0.05, grace_s=10.0, client=kv)

    def beat():
        seq = 0
        while not stop.is_set():
            seq += 1
            kv.key_value_set("vitax/hb/1", str(seq))
            time.sleep(0.02)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    try:
        assert beating.peer_loss_suspected(wait=False) is None
    finally:
        stop.set()
        t.join()
        beating.stop()
    assert ControlPlane(process_index=0, process_count=1).start_liveness(0.1, 1.0, client=FakeKV()) is False
    assert ControlPlane(process_index=0, process_count=2).start_liveness(0.1, 1.0) is False   # no group: no store


def test_arm_exit_deadline_bounds_the_barrier():
    exits = []
    plane = ControlPlane(process_index=0, process_count=2, collective=lambda w: w, hard_exit=exits.append)
    plane.arm_exit_deadline(0.1)
    plane.arm_exit_deadline(0.1)        # idempotent: the first timer wins
    assert _wait_until(lambda: exits == [EXIT_HANG], timeout_s=3.0)
    wd = FakeWatchdog()
    wd.running = True
    ControlPlane(process_index=0, process_count=2, watchdog=wd, collective=lambda w: w).arm_exit_deadline()
    assert wd.armed == 1                # the running watchdog's deadline is preferred
    alone = ControlPlane(process_index=0, process_count=1, hard_exit=exits.append)
    alone.arm_exit_deadline(0.01)
    time.sleep(0.1)
    assert exits == [EXIT_HANG]         # alone: nothing to wait on, no timer


def test_store_kv_over_a_c10d_store(tmp_path):
    import torch.distributed as dist
    assert store_client() is None       # no process group
    kv = StoreKV(dist.FileStore(str(tmp_path / "store"), 1))
    kv.key_value_set("vitax/hb/0", "3")
    kv.key_value_set("vitax/peer/0/g1/c0", b"\x00\xffbytes")
    assert kv.blocking_key_value_get("vitax/hb/0", 100) == "3"
    assert kv.blocking_key_value_get_bytes("vitax/peer/0/g1/c0", 100) == b"\x00\xffbytes"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):   # bounded: never a get that blocks for good
        kv.blocking_key_value_get("vitax/hb/1", 150)
    assert 0.14 <= time.monotonic() - t0 < 2.0
    kv.key_value_delete("vitax/hb/0")
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("vitax/hb/0", 50)
    server = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=5), wait_for_workers=False)
    tcp = StoreKV(dist.TCPStore("127.0.0.1", server.port, 1, False, timeout=datetime.timedelta(seconds=5)))
    tcp.key_value_set("k", "v")
    assert tcp.blocking_key_value_get("k", 100) == "v"


def _report(path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), str(path), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return {k: v for k, v in json.loads(r.stdout).items() if k != "path"}


def test_control_events_fold_as_vitaxs(tmp_path, monkeypatch):
    """Each package's plane writes its events as the loop wires them (kind
    "control"), beside the watchdog's last words and the supervisor's
    topology_change: metrics_report's summaries are equal."""
    from vitax.supervise import Supervisor as JaxSupervisor
    from vitax.train import control as jc
    from vitax.train import preempt as jpreempt
    from vitax_torch.supervise import Supervisor
    from vitax_torch.train import preempt
    summaries = []
    for name, module, pre, sup_cls in (("port", control, preempt, Supervisor),
                                       ("jax", jc, jpreempt, JaxSupervisor)):
        d = tmp_path / name
        d.mkdir()
        path = d / "metrics.jsonl"

        def sink(payload, kind="control", path=path):
            with open(path, "a") as f:
                f.write(json.dumps({"schema": 1, "time": 0.0, **({"kind": kind} if kind else {}), **payload}) + "\n")

        sink({"step": 1, "loss": 2.0, "sec_per_iter": 0.1}, kind=None)
        monkeypatch.setattr(pre, "requested", lambda: True)
        assert module.ControlPlane(process_index=0, process_count=1, on_event=sink).poll(0).preempt
        monkeypatch.setattr(pre, "requested", lambda: False)
        plane = module.ControlPlane(sync_steps=1, process_index=0, process_count=2, collective=lambda w: w,
                                    on_event=sink, hard_exit=lambda c: None)
        plane.set_fault("drill")
        assert plane.poll(0).emergency
        assert plane.start_liveness(interval_s=0.05, grace_s=0.1, client=FakeKV())
        assert _wait_until(lambda: plane.local_word() & BIT_PEER_LOST)
        plane.stop()
        sink({"exit_code": EXIT_HANG}, kind="hang_hard_exit")
        sup = sup_cls(["python", "t.py"], ckpt_dir=str(d), metrics_dir=str(d), spawn=lambda argv: None,
                      expect_processes=1, topology_fn=lambda: 2)
        sup._check_topology()
        summaries.append(_report(path))
    assert summaries[0] == summaries[1]
    assert summaries[0]["control_events"] == {"agreed_preemptions": 1, "agreed_escalations": 1,
                                              "peer_loss_detections": 1, "topology_changes": 1,
                                              "elastic_resumes": 0, "peer_restore_failures": 0}
    assert summaries[0]["hang_hard_exits"] == 1


def test_supervisor_topology_comes_from_world_size_and_nproc_per_node(monkeypatch):
    from vitax_torch.supervise import expected_process_count
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert expected_process_count(["python", "-m", "vitax_torch.train"]) == 0
    assert expected_process_count(["torchrun", "--nproc_per_node", "4", "-m", "vitax_torch.train"]) == 4
    assert expected_process_count(["torchrun", "--nnodes=2", "--nproc_per_node=8", "train.py"]) == 16
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert expected_process_count(["torchrun", "--nproc_per_node", "4"]) == 3


# --- preemption -----------------------------------------------------------------------

PREEMPT_CHILD = """import os, signal, threading
from vitax_torch.train import preempt
out = {}
t = threading.Thread(target=lambda: out.setdefault("thread", preempt.install()))
t.start(); t.join()
assert out["thread"] is False                   # off the main thread: unavailable, never fatal
assert preempt.install() and preempt.install()  # idempotent
assert not preempt.requested()
os.kill(os.getpid(), signal.SIGTERM)            # caught: the flag, not a death
assert preempt.requested()
preempt.reset()
assert not preempt.requested()
preempt.uninstall()
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
print("ok")
"""


def test_preempt_flag_install_and_uninstall():
    r = subprocess.run([sys.executable, "-c", PREEMPT_CHILD], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


# --- the SIGTERM drill ----------------------------------------------------------------


def test_supervised_sigterm_saves_mid_epoch_and_resumes_equal_uninterrupted(tmp_path):
    from vitax_torch.train.loop import train
    base = train(Config(**TINY, **RUN, ckpt_dir=str(tmp_path / "base")).validate(), "cpu")
    d, m = tmp_path / "ckpt", tmp_path / "m"
    flags = ["--device", "cpu", "--fake_data", "--ckpt_dir", str(d), "--metrics_dir", str(m)]
    for k, v in {**TINY, **RUN}.items():
        if k != "fake_data":
            flags += [f"--{k}", str(v)]

    def supervised(*extra):
        return subprocess.run([sys.executable, "-m", "vitax_torch.supervise", "--backoff_s", "0", "--",
                               sys.executable, "-m", "vitax_torch.train", *flags, *extra],
                              cwd=REPO, capture_output=True, text=True, timeout=240)

    r = supervised("--fault_plan", '{"site": "step", "at": 2, "action": "sigterm"}')
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "SIGTERM received: saving preemption checkpoint at epoch 1 (step 2)" in r.stdout
    assert "restart" not in r.stderr and "child completed cleanly" in r.stderr
    assert ckpt_io.committed_epochs(str(d)) == [1] and ckpt_io.load_resume_meta(str(d), 1) == {
        "step_in_epoch": 2, "process_count": 1}
    r = supervised()
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "step-granular resume: re-entering epoch 1 at step 3" in r.stdout
    got = ckpt_io.read_state(str(d), 2)
    want = ckpt_io.train_state_dict(base)
    assert got["step"] == base.step == 6 and torch.equal(got["count"], want["count"])
    for group in ("model", "mu", "nu"):
        assert got[group].keys() == want[group].keys()
        assert all(torch.equal(got[group][k], want[group][k]) for k in want[group]), group
    events = [json.loads(ln) for ln in open(m / "metrics.jsonl")]
    assert [e.get("event") for e in events if e.get("kind") == "control"] == ["agreed_preempt"]
    assert [e["kind"] for e in events if e.get("kind") == "fault"] == ["fault"]
