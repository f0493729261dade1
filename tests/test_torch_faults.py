"""vitax_torch's fault plans, watchdog and supervisor against vitax's, and
the crash and hang drills against an uninterrupted port run.

- faults.py: parse_plan on vitax's three shapes and its bad plans, the
  describe() strings, the fire windows (per-site counter, explicit index,
  the process gate), the reporter and the env fallback, all equal to
  vitax.faults on the same plans.
- The nine flags: parsed with vitax's names and defaults, refused with its
  messages.
- telemetry/watchdog.py: escalation once with exit 42, the hard exit, the
  acknowledged deadline, dump-only, last words, request_escalation.
- supervise.py: backoff_delay and ensure_auto_resume equal vitax's on the
  same inputs; the restart loop on fake children; the JSONL of both
  supervisors (with the fault and hang events) folded by
  tools/metrics_report.py into the same summary.
- Drills: the in-process hang -> emergency save -> exit 42 -> resume, and
  a supervised crash (python -m vitax_torch.supervise) and restart, each
  ending bitwise the uninterrupted port run; the supervised run's losses
  within rtol 2e-4 of vitax's uninterrupted ones from the same npz init.
Tiny dims, float32, the CPU.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vitax_torch import faults
from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.config import Config, build_parser, config_fields_from_namespace
from vitax_torch.supervise import (EXIT_BUDGET, Supervisor, backoff_delay, ensure_auto_resume, scrape_flag,
                                   terminate_child)
from vitax_torch.supervise import main as supervise_main
from vitax_torch.telemetry.watchdog import EXIT_HANG, Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4, batch_size=8,
            dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
# two epochs of three steps from vitax's init (an npz), a save after each, one eval batch at the end
DRILL = dict(fake_data=True, num_epochs=2, steps_per_epoch=3, log_step_interval=1, eval_max_batches=1,
             test_epoch_interval=99, ckpt_epoch_interval=1, num_workers=1, task="finetune")


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


# --- fault plans against vitax's -----------------------------------------------------

ONE = '{"site": "step", "action": "crash", "at": 6}'


@pytest.mark.parametrize("text", [ONE, f"[{ONE}]", f'{{"faults": [{ONE}]}}',
                                  '[{"site": "loader", "action": "stall", "seconds": 0.5, "times": 3}, '
                                  '{"site": "peer_restore", "action": "oserror", "process": 1}]',
                                  '{"site": "router_dispatch", "action": "oserror", "at": 2}'],
                         ids=["object", "list", "wrapped", "two", "serve_site"])
def test_parse_plan_matches_vitax(text):
    from vitax import faults as jf
    ours, theirs = faults.parse_plan(text), jf.parse_plan(text)
    assert [dataclasses.asdict(s) for s in ours.specs] == [dataclasses.asdict(s) for s in theirs.specs]
    assert ours.describe() == theirs.describe()
    assert faults.SITES == jf.SITES and faults.ACTIONS == jf.ACTIONS


@pytest.mark.parametrize("bad", [
    "not json at all", "42", '{"site": "nowhere", "action": "crash"}', '{"site": "step", "action": "explode"}',
    '{"site": "step"}', '{"site": "step", "action": "crash", "at": 0}',
    '{"site": "step", "action": "crash", "times": 0}', '{"site": "step", "action": "crash", "typo_key": 1}', "[]",
    '{"site": "step", "action": "hang", "seconds": -1}', '{"site": "step", "action": "crash", "process": -2}'])
def test_parse_plan_rejects_vitaxs_bad_plans(bad):
    from vitax import faults as jf
    with pytest.raises(ValueError) as theirs:
        jf.parse_plan(bad)
    with pytest.raises(ValueError) as ours:
        faults.parse_plan(bad)
    assert str(ours.value) == str(theirs.value)


def _fired(module, plan: str, calls):
    """Which of `calls` ((site, index or None)) raise under `plan`."""
    module.install(plan)
    out = []
    for site, index in calls:
        try:
            module.fire(site, index=index)
            out.append(False)
        except OSError:
            out.append(True)
    module.uninstall()
    return out


@pytest.mark.parametrize("plan,calls", [
    ('{"site": "ckpt_write", "action": "oserror", "at": 2, "times": 2}', [("ckpt_write", None)] * 5),
    ('{"site": "step", "action": "oserror", "at": 7}', [("step", 3), ("step", 7), ("step", 8), ("loader", None)]),
    ('[{"site": "loader", "action": "oserror", "at": 1}, {"site": "stream_read", "action": "oserror", "at": 2}]',
     [("loader", None), ("stream_read", None), ("stream_read", None), ("loader", None)]),
    ('{"site": "step", "action": "oserror", "at": 2, "times": 3}', [("step", None), ("step", 4), ("step", None)]),
], ids=["counter_window", "explicit_index", "two_sites", "counter_advances_under_index"])
def test_fire_windows_match_vitax(plan, calls):
    from vitax import faults as jf
    ours = _fired(faults, plan, calls)
    assert ours == _fired(jf, plan, calls) and any(ours)


def test_reporter_payload_and_no_plan_noop():
    from vitax import faults as jf
    payloads = []
    for module in (faults, jf):
        module.uninstall()
        for _ in range(3):              # nothing armed: every hook a no-op
            module.fire("step", index=1)
            module.fire("ckpt_write")
        assert not module.active()
        module.install('{"site": "step", "action": "oserror", "at": 7}')
        events = []
        module.set_reporter(events.append)
        with pytest.raises(OSError):
            module.fire("step", index=7)
        payloads.append(events)
        module.uninstall()
    assert payloads[0] == payloads[1] == [{"site": "step", "action": "oserror", "index": 7}]


def test_process_gate_reads_rank_where_vitax_reads_its_process_id(monkeypatch):
    from vitax import faults as jf
    plan = '{"site": "step", "action": "oserror", "at": 1, "process": 1}'
    for env, fires in (("0", False), ("1", True)):
        monkeypatch.setenv("RANK", env)
        monkeypatch.setenv("JAX_PROCESS_ID", env)
        assert _fired(faults, plan, [("step", 1)]) == _fired(jf, plan, [("step", 1)]) == [fires]
    monkeypatch.delenv("RANK")          # no RANK: the index the loop recorded at install
    faults.install_from_config(Config(fault_plan=plan), process_index=1)
    with pytest.raises(OSError):
        faults.fire("step", index=1)


def test_install_from_config_env_fallback(monkeypatch):
    plan = '{"site": "loader", "action": "stall", "seconds": 0}'
    monkeypatch.setenv(faults.ENV_VAR, plan)
    installed = faults.install_from_config(Config())
    assert installed is not None and installed.specs[0].site == "loader"
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.install_from_config(Config()) is None and not faults.active()


# --- the nine flags -------------------------------------------------------------------

NINE = ("zero_stall_ckpt", "replicate_steps", "peer_dir", "hang_timeout_s", "hang_action", "fault_plan",
        "control_sync_steps", "peer_heartbeat_s", "peer_grace_s")


def test_nine_flags_parse_as_vitax():
    from vitax.config import build_parser as jax_parser
    argv = ["--zero_stall_ckpt", "--replicate_steps", "4", "--peer_dir", "/p", "--hang_timeout_s", "30",
            "--hang_action", "checkpoint_exit", "--fault_plan", ONE, "--control_sync_steps", "5",
            "--peer_heartbeat_s", "2", "--peer_grace_s", "9"]
    for args in ([], argv):
        ours, theirs = vars(build_parser().parse_args(args)), vars(jax_parser().parse_args(args))
        assert {k: ours[k] for k in NINE} == {k: theirs[k] for k in NINE}
    cfg = Config(**config_fields_from_namespace(build_parser().parse_args(argv))).validate()
    assert cfg.zero_stall_ckpt and cfg.replicate_steps == 4 and cfg.hang_action == "checkpoint_exit"
    # the chip arbiter's flag parses as vitax's
    assert build_parser().parse_args(["--arbiter_url", "http://x"]).arbiter_url == \
        jax_parser().parse_args(["--arbiter_url", "http://x"]).arbiter_url == "http://x"


@pytest.mark.parametrize("bad", [dict(hang_timeout_s=-1.0), dict(hang_action="restart"), dict(fault_plan="nope"),
                                 dict(control_sync_steps=0), dict(peer_heartbeat_s=-1.0), dict(peer_grace_s=-1.0),
                                 dict(peer_grace_s=5.0), dict(replicate_steps=-1), dict(peer_dir="/p")],
                         ids=["hang_timeout_s", "hang_action", "fault_plan", "control_sync_steps", "peer_heartbeat_s",
                              "peer_grace_s", "peer_grace_s_alone", "replicate_steps", "peer_dir_alone"])
def test_validate_refuses_as_vitax(bad):
    from vitax.config import Config as JaxConfig
    with pytest.raises(AssertionError) as theirs:
        JaxConfig(**bad).validate()
    with pytest.raises(ValueError) as ours:
        Config(**bad).validate()
    assert str(ours.value) == str(theirs.value)


# --- the watchdog ---------------------------------------------------------------------


def test_watchdog_escalates_once_with_exit_42():
    from vitax.telemetry.watchdog import EXIT_HANG as JAX_EXIT_HANG
    escalations, exits, dumps = [], [], []
    wd = Watchdog(timeout_s=0.1, poll_s=0.02, action="checkpoint_exit", hard_deadline_s=30.0,
                  on_escalate=escalations.append, on_fire=dumps.append, hard_exit=exits.append).start()
    try:
        assert _wait_until(wd.escalation_requested)
        assert len(escalations) == 1 and escalations[0]["exit_code"] == EXIT_HANG == JAX_EXIT_HANG == 42
        assert "vitax-torch-watchdog" in dumps[0]["stacks"] and "mem_used_bytes" in dumps[0]
        wd.pet()                        # re-arms the dump, never the escalation
        assert _wait_until(lambda: wd.fire_count >= 2)
        assert len(escalations) == 1 and exits == []
    finally:
        wd.stop()


def test_watchdog_hard_exit_after_last_words():
    order = []
    wd = Watchdog(timeout_s=0.1, poll_s=0.02, action="checkpoint_exit", hard_deadline_s=0.15,
                  on_hard_exit=lambda p: order.append(("words", p["exit_code"])),
                  hard_exit=lambda code: order.append(("exit", code))).start()
    try:
        assert _wait_until(lambda: ("exit", EXIT_HANG) in order)
        time.sleep(0.1)
        assert order == [("words", EXIT_HANG), ("exit", EXIT_HANG)]     # once, then disarmed
    finally:
        wd.stop()


def test_watchdog_acknowledge_extends_the_deadline():
    exits = []
    wd = Watchdog(timeout_s=0.1, poll_s=0.02, action="checkpoint_exit", hard_deadline_s=0.3,
                  hard_exit=exits.append).start()
    try:
        assert _wait_until(wd.escalation_requested)
        for _ in range(10):
            wd.acknowledge_escalation()
            time.sleep(0.05)
        assert exits == []
        assert _wait_until(lambda: exits == [EXIT_HANG], timeout_s=2.0)
    finally:
        wd.stop()


def test_watchdog_dump_action_never_escalates_and_request_does():
    wd = Watchdog(timeout_s=0.1, poll_s=0.02, action="dump", hard_exit=lambda c: pytest.fail("hard exit")).start()
    try:
        assert _wait_until(lambda: wd.fire_count >= 1) and not wd.escalation_requested()
    finally:
        wd.stop()
    exits, escalations = [], []
    wd = Watchdog(timeout_s=60.0, poll_s=0.02, hard_deadline_s=0.1, on_escalate=escalations.append,
                  hard_exit=exits.append).start()
    try:
        wd.request_escalation("peer 1 lost")
        wd.request_escalation("again")  # idempotent
        assert wd.escalation_requested() and [e["reason"] for e in escalations] == ["peer 1 lost"]
        assert _wait_until(lambda: exits == [EXIT_HANG], timeout_s=2.0)
    finally:
        wd.stop()


# --- the supervisor -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 6, 12])
def test_backoff_delay_matches_vitax(n):
    from vitax.supervise import backoff_delay as jax_backoff
    for base, cap in ((0.5, 10.0), (1.0, 60.0), (0.0, 5.0)):
        assert backoff_delay(n, base, cap) == jax_backoff(n, base, cap)


@pytest.mark.parametrize("argv", [["t.py"], ["t.py", "--resume_epoch", "4"], ["t.py", "--resume_epoch=4"],
                                  ["t.py", "--resume_epoch"], ["-m", "vitax_torch.train", "--ckpt_dir", "/c"]])
def test_ensure_auto_resume_matches_vitax(argv):
    from vitax.supervise import ensure_auto_resume as jax_ensure, scrape_flag as jax_scrape
    assert ensure_auto_resume(argv) == jax_ensure(argv)
    for flag in ("--ckpt_dir", "--resume_epoch"):
        assert scrape_flag(argv, flag) == jax_scrape(argv, flag)


class FakeChild:
    """A child whose exit code is known; `delay_polls` polls of None first."""

    def __init__(self, rc, delay_polls=0):
        self.rc, self.delay_polls, self.signals = rc, delay_polls, []

    def poll(self):
        if self.delay_polls > 0:
            self.delay_polls -= 1
            return None
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        self.rc, self.delay_polls = 0, 0

    def kill(self):
        self.signals.append("KILL")
        self.rc, self.delay_polls = -9, 0


def _supervise(cls, metrics_dir, rcs, progresses, **kw):
    children, spawned, sleeps = [FakeChild(rc) for rc in rcs], [], []
    progress = iter(progresses)
    sup = cls(["python", "-m", "vitax_torch.train"], ckpt_dir=str(metrics_dir), metrics_dir=str(metrics_dir),
              spawn=lambda argv: spawned.append(argv) or children[len(spawned) - 1],
              progress_fn=lambda: next(progress), sleep=sleeps.append, **kw)
    return sup, sleeps


def test_supervisor_restarts_with_backoff_and_gives_up_on_loops_and_budget(tmp_path):
    progresses = [(0, 0), (1, 0), (1, 0), (1, 3), (1, 3)]
    sup, sleeps = _supervise(Supervisor, tmp_path / "a", [13, EXIT_HANG, 0], progresses, backoff_s=0.5,
                             backoff_max_s=10.0)
    assert sup.run() == 0 and sup.restart_count == 2 and sleeps == [0.5, 1.0]
    assert sup.child_argv[-2:] == ["--resume_epoch", "-1"]
    lines = [json.loads(ln) for ln in open(tmp_path / "a" / "metrics.jsonl")]
    assert [(e["kind"], e["exit_code"], e["schema"]) for e in lines] == [("restart", 13, 1), ("restart", 42, 1)]
    sup, sleeps = _supervise(Supervisor, tmp_path / "b", [13] * 4, [(2, 0)] * 8, crash_loop_tolerance=1,
                             backoff_s=0.25, max_restarts=50)
    assert sup.run() == EXIT_BUDGET == 3 and sup.restart_count == 1 and sleeps == [0.25]
    sup, _ = _supervise(Supervisor, tmp_path / "c", [1] * 9, [(i, 0) for i in range(20)], max_restarts=3,
                        backoff_s=0.0, crash_loop_tolerance=99)
    assert sup.run() == EXIT_BUDGET and sup.restart_count == 4 and sup.last_exit_code == 1


def test_supervisor_forwards_sigterm_once_and_passes_the_code(tmp_path):
    child = FakeChild(7, delay_polls=100)
    sup = Supervisor(["python", "t.py"], ckpt_dir=str(tmp_path), spawn=lambda argv: child,
                     progress_fn=lambda: (0, 0), sleep=lambda s: None, term_grace_s=30.0)
    sup._term_requested = True
    assert sup.run() == 0 and sup.restart_count == 0 and child.signals == [signal.SIGTERM]
    stubborn = subprocess.Popen([sys.executable, "-c", "import signal, time; signal.signal(signal.SIGTERM, "
                                 "signal.SIG_IGN); print('up', flush=True); time.sleep(60)"], stdout=subprocess.PIPE)
    stubborn.stdout.readline()
    assert terminate_child(stubborn, grace_s=0.3) == -signal.SIGKILL


def test_supervise_cli_requires_a_child_command():
    assert supervise_main([]) == 2
    assert supervise_main(["--max_restarts", "2", "--"]) == 2


def _report(path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), str(path), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_supervisor_and_fault_jsonl_fold_as_vitaxs(tmp_path):
    """Both supervisors over the same fake children, with the fault, hang
    and hang_escalation events a drill writes beside them: metrics_report
    folds the two streams into the same summary."""
    from vitax.supervise import Supervisor as JaxSupervisor
    summaries = []
    for name, cls in (("port", Supervisor), ("jax", JaxSupervisor)):
        d = tmp_path / name
        d.mkdir()
        with open(d / "metrics.jsonl", "w") as f:
            for rec in ({"schema": 1, "step": 1, "loss": 2.0, "sec_per_iter": 0.1, "data_wait_s": 0.0,
                         "ckpt_stall_s": 0.0, "mfu": 0.1, "mem_used_bytes": 0},
                        {"schema": 1, "kind": "fault", "site": "step", "action": "hang", "index": 5},
                        {"schema": 1, "kind": "hang", "stalled_s": 1.2, "timeout_s": 1.0},
                        {"schema": 1, "kind": "hang_escalation", "exit_code": 42}):
                f.write(json.dumps(rec) + "\n")
        sup, _ = _supervise(cls, d, [42, 13, 0], [(0, 0), (1, 2), (1, 2), (2, 0), (2, 0)], backoff_s=0.0)
        assert sup.run() == 0
        summaries.append({k: v for k, v in _report(d / "metrics.jsonl").items() if k != "path"})
    ours, theirs = summaries
    assert ours == theirs
    assert ours["restart_count"] == 2 and ours["last_exit_code"] == 13 and ours["fault_events"] == 1
    assert ours["hang_escalations"] == 1 and ours["hang_events"] == 1


# --- drills against the uninterrupted run ---------------------------------------------


@pytest.fixture(scope="module")
def drill(tmp_path_factory, devices8):
    """vitax's seed-3 init exported with vitax's save_npz, vitax's
    uninterrupted finetune run from it (its JSONL), and the port's
    uninterrupted run from it (its final state and JSONL)."""
    import jax
    from vitax.checkpoint.consolidate import flatten_tree, save_npz as jax_save_npz
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import build_mesh
    from vitax.programs import get_scenario as jax_get_scenario
    from vitax.train.loop import train as jax_train
    from vitax.train.state import make_train_state as jax_make_train_state
    from vitax_torch.train.loop import train
    root = tmp_path_factory.mktemp("drill")
    npz = str(root / "init.npz")
    jcfg = JaxConfig(**TINY, task="finetune", init_npz=npz).validate()
    tx, _ = jax_get_scenario("finetune").make_optimizer(jcfg, 10)
    state, _, _ = jax_make_train_state(jcfg, jax_build_model(jcfg), tx, build_mesh(jcfg, jax.devices()[:1]),
                                       jax.random.key(3))
    jax_save_npz(npz, {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(state.params)).items()})
    run = dict(TINY, **DRILL, init_npz=npz)
    jax_train(JaxConfig(**run, ckpt_dir=str(root / "jax"), metrics_dir=str(root / "jm")).validate())
    base = train(Config(**run, ckpt_dir=str(root / "base"), metrics_dir=str(root / "bm")).validate(), "cpu")
    return dict(root=root, run=run, base=base,
                jax_log=[json.loads(ln) for ln in open(root / "jm" / "metrics.jsonl")],
                port_log=[json.loads(ln) for ln in open(root / "bm" / "metrics.jsonl")])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def assert_checkpoint_is_state(ckpt_dir, epoch, state):
    """The checkpoint of `epoch` holds `state` bit for bit."""
    got = _flat(ckpt_io.read_state(str(ckpt_dir), epoch))
    want = _flat({k: v for k, v in ckpt_io.train_state_dict(state).items()})
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(got[k], int):
            assert got[k] == int(want[k]), k
        else:
            assert torch.equal(got[k], want[k]), k


def _steps(log):
    """{(epoch, step_in_epoch): loss}, the last record of each (a resumed
    child logs its steps again)."""
    return {(r["epoch"], r["step_in_epoch"]): r["loss"] for r in log if "kind" not in r}


def test_port_run_trains_vitaxs_losses(drill):
    """The uninterrupted port run from vitax's npz init: every loss within
    rtol 2e-4 of vitax's uninterrupted run."""
    ours, theirs = _steps(drill["port_log"]), _steps(drill["jax_log"])
    assert ours.keys() == theirs.keys() and len(ours) == 6
    np.testing.assert_allclose([ours[k] for k in sorted(ours)], [theirs[k] for k in sorted(theirs)],
                               rtol=2e-4, atol=2e-5)


def test_hang_escalation_emergency_save_and_resume_equal_uninterrupted(drill, tmp_path):
    """In process: a 2 s hang at step 5 starves a 1 s watchdog; under
    --hang_action checkpoint_exit the loop commits an emergency mid-epoch
    checkpoint (epoch 2, 2 steps done) and exits 42; auto-resume re-enters
    at step 3 and ends bitwise the uninterrupted run."""
    from vitax_torch.train.loop import train
    d, m = str(tmp_path / "ckpt"), str(tmp_path / "m")
    plan = '{"site": "step", "action": "hang", "at": 5, "seconds": 2.0}'
    with pytest.raises(SystemExit) as exc:
        train(Config(**drill["run"], ckpt_dir=d, metrics_dir=m, fault_plan=plan, hang_timeout_s=1.0,
                     hang_action="checkpoint_exit").validate(), "cpu")
    assert exc.value.code == EXIT_HANG
    assert ckpt_io.latest_epoch(d) == 2 and ckpt_io.load_resume_step(d, 2) == 2
    kinds = [json.loads(ln).get("kind") for ln in open(os.path.join(m, "metrics.jsonl"))]
    assert {"fault", "hang", "hang_escalation", "control"} <= set(kinds)
    resumed = train(Config(**drill["run"], ckpt_dir=d, resume_epoch=-1).validate(), "cpu")
    assert resumed.step == 6
    assert_checkpoint_is_state(d, 2, drill["base"])
    assert_checkpoint_is_state(d, 2, resumed)


def test_supervised_crash_restart_equals_uninterrupted_and_vitax(drill, tmp_path):
    """python -m vitax_torch.supervise over the train CLI, crashed (os._exit
    13) at step 5: one restart resumes epoch 1's checkpoint; the epoch-2
    checkpoint is the uninterrupted run's bit for bit; the JSONL holds the
    restart with exit code 13, the fault, and the DCP restore with its
    read; the losses are vitax's uninterrupted ones within rtol 2e-4."""
    d, m = tmp_path / "ckpt", tmp_path / "m"
    flags = ["--device", "cpu", "--init_npz", drill["run"]["init_npz"], "--ckpt_dir", str(d), "--metrics_dir", str(m),
             "--fault_plan", '{"site": "step", "at": 5, "action": "crash", "exit_code": 13}']
    for k, v in drill["run"].items():
        if k in ("init_npz", "fake_data"):
            continue
        flags += [f"--{k}", str(v)]
    r = subprocess.run([sys.executable, "-m", "vitax_torch.supervise", "--backoff_s", "0", "--",
                        sys.executable, "-m", "vitax_torch.train", "--fake_data", *flags],
                       cwd=REPO, capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, VITAX_CKPT_SYNC="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "injecting step:crash" in r.stderr and "restart 1: child exit 13" in r.stderr
    assert_checkpoint_is_state(d, 2, drill["base"])
    log = [json.loads(ln) for ln in open(m / "metrics.jsonl")]
    restore = [e for e in log if e.get("kind") == "restore"]
    assert [(e["path"], e["epoch"], e["dcp_reads"]) for e in restore] == [("dcp", 1, 1)]
    summary = _report(m / "metrics.jsonl")
    assert summary["restart_count"] == 1 and summary["last_exit_code"] == 13 and summary["fault_events"] == 1
    ours, theirs = _steps(log), _steps(drill["jax_log"])
    assert ours.keys() == theirs.keys()
    np.testing.assert_allclose([ours[k] for k in sorted(ours)], [theirs[k] for k in sorted(theirs)],
                               rtol=2e-4, atol=2e-5)
