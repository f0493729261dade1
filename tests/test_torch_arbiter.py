"""vitax_torch.arbiter against vitax.arbiter, the train side's heartbeat
and topology, the fleet's arbiter hooks, and one drill end to end on the
CPU.

- The ledger, the policy, the TrainDirector and the Arbiter, each driven in
  both packages by the same fake clock, FakeProc spawn and seams (the
  cases of vitax's tests/test_arbiter.py): equal decisions, ledger
  snapshots, events, rollbacks and metrics. Where the port differs on
  purpose it is asserted apart: the bring-up variables topology_env sets
  (torchrun's, not JAX's), and one SIGTERM a rank in a drain (vitax's
  second one kills a rank on its way out).
- ArbiterReporter's posts, refreshes and swallowed failures, in both.
- Each daemon's HTTP surface over real sockets, the same answers.
- topology_env across 2 -> 1 -> 2.
- Both routers' POST /fleet/adopt and /fleet/release over one stdlib fake
  replica (501 without hooks, 400s, a hook's 500), and both autoscalers'
  escalation ticks (the ceiling, a full agent, an unreachable arbiter).
- tools/metrics_report.py's arbiter sections on each package's stream.
- PeerReplicator.stop with a receiver that outlives its join: no last pull
  beside it.
- The drill: `python -m vitax_torch.arbiter` over two gloo training ranks
  of `python -m vitax_torch.train --device cpu`, the fleet CLI with one
  CPU replica at --max_replicas 1, and one placement agent. A hung replica
  and a burst escalate; the borrow drains both ranks to exit 0, the
  relaunch at 1 restores from the peer store with 0 directory reads, the
  agent's replica is adopted and answers; the return drains it (exit 0),
  flips the ledger and re-expands training to 2, which keeps stepping.
Socketless and fast except the HTTP cases and the drill (about 30 s).
"""

import json
import os
import random
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import vitax.arbiter as jax_arbiter
import vitax.arbiter.daemon as jax_daemon
import vitax.arbiter.ledger as jax_ledger
import vitax.arbiter.policy as jax_policy
import vitax.serve.fleet.admission as jax_admission
import vitax.serve.fleet.autoscale as jax_autoscale
import vitax.serve.fleet.placement as jax_placement
import vitax.serve.fleet.replica as jax_replica
import vitax.serve.fleet.router as jax_router
import vitax.supervise as jax_supervise
import vitax.train.control as jax_control
import vitax_torch.arbiter as arbiter
import vitax_torch.arbiter.daemon as daemon
import vitax_torch.arbiter.ledger as ledger
import vitax_torch.arbiter.policy as policy
import vitax_torch.serve.fleet.admission as admission
import vitax_torch.serve.fleet.autoscale as autoscale
import vitax_torch.serve.fleet.placement as placement
import vitax_torch.serve.fleet.replica as replica
import vitax_torch.serve.fleet.router as router
import vitax_torch.supervise as supervise
import vitax_torch.train.control as control

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = SimpleNamespace(arbiter=arbiter, daemon=daemon, ledger=ledger, policy=policy, control=control,
                       supervise=supervise, admission=admission, autoscale=autoscale, placement=placement,
                       replica=replica, router=router)
JAX = SimpleNamespace(arbiter=jax_arbiter, daemon=jax_daemon, ledger=jax_ledger, policy=jax_policy,
                      control=jax_control, supervise=jax_supervise, admission=jax_admission,
                      autoscale=jax_autoscale, placement=jax_placement, replica=jax_replica, router=jax_router)
BOTH = [PORT, JAX]
TRAIN_COUNTS = {"train": 2, "serve": 0, "free": 0}


def both(fn, *args):
    """fn(PORT, ...) and fn(JAX, ...), asserted equal; returns the port's."""
    ours, theirs = fn(PORT, *args), fn(JAX, *args)
    assert ours == theirs
    return ours


class DummyRecorder:
    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append((kind, payload))

    def of(self, event):
        return [p for k, p in self.events if k == "arbiter" and p.get("event") == event]


class FakeProc:
    """Popen stand-in; exits with `exit_code` on the first SIGTERM."""

    def __init__(self, exit_code=0, on_signal=None):
        self.rc = None
        self.signals = []
        self._exit_code = exit_code
        self._on_signal = on_signal

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        if self._on_signal is not None:
            self._on_signal(self)
        self.rc = self._exit_code

    def kill(self):
        self.rc = -9


class FakeTrain:
    """TrainDirector stand-in recording resize() calls."""

    term_grace_s = 5.0

    def __init__(self, n=2):
        self.n = n
        self.resizes = []
        self.is_healthy = True

    @property
    def process_count(self):
        return self.n

    def alive(self):
        return self.n

    def healthy(self):
        return self.is_healthy

    def resize(self, n):
        self.resizes.append(n)
        self.n = n
        return {"to_processes": n}


def _never(*args):
    raise ConnectionError("unreachable")


def _raises(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type and message are the result
        return f"{type(e).__name__}: {e}"
    return None


# --- the ledger ------------------------------------------------------------------------------------------


def _ledger_case(mod, case, tmp):
    clock = lambda: 5.0  # noqa: E731 - a fixed lease timestamp
    L = mod.ledger.HostLedger
    if case == "seed":
        led = L(["h0", "h1"], owner="train", clock=clock)
        return [led.counts(), led.owner_of("h0"), led.owner_of("nope"), led.version, led.recovered, led.snapshot()]
    if case == "assign":
        led = L(["h0", "h1"], clock=clock)
        return [led.assign("h1", "serve"), led.counts(), _raises(led.assign, "nope", "serve"),
                _raises(led.assign, "h0", "cryptominer")[:14]]
    if case == "lease_order":
        led = L(["h0", "h1", "h2"], clock=clock)
        out = [led.hosts_owned("train")]
        led.assign("h0", "serve")
        led.assign("h0", "train")
        return out + [led.hosts_owned("train"), led.hosts_owned("serve")]
    path = os.path.join(tmp, mod.__name__ if hasattr(mod, "__name__") else str(id(mod)), "ledger.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if case == "persist":
        led = L(["h0", "h1"], path=path, clock=clock)
        led.assign("h1", "serve")
        with open(path) as f:
            disk = json.load(f)
        torn = [n for n in os.listdir(os.path.dirname(path)) if ".tmp." in n]
        led2 = L(path=path, clock=clock)
        return [disk, torn, led2.recovered, led2.version, led2.owner_of("h1"), led2.counts() == led.counts()]
    if case == "merge":
        L(["h0"], path=path, clock=clock).assign("h0", "serve")
        led = L(["h0", "h1"], path=path, clock=clock)
        return [led.recovered, led.owner_of("h0"), led.owner_of("h1"), led.snapshot()]
    if case == "corrupt":
        with open(path, "w") as f:
            f.write("{not json")
        led = L(["h0"], path=path, clock=clock)
        out = [led.recovered, led.owner_of("h0")]
        with open(path, "w") as f:
            json.dump({"hosts": [], "version": "x"}, f)
        return out + [L(["h0"], path=path, clock=clock).recovered]
    if case == "in_memory":
        led = L(["h0"], clock=clock)
        led.assign("h0", "free")
        return [led.counts(), os.listdir(os.path.dirname(path))]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["seed", "assign", "lease_order", "persist", "merge", "corrupt", "in_memory"])
def test_ledger_matches_vitax(case, tmp_path):
    out = both(lambda mod: _ledger_case(SimpleNamespace(__name__="port" if mod is PORT else "jax", **vars(mod)),
                                        case, str(tmp_path)))
    if case == "seed":
        assert out[3] == 2 and out[5]["schema"] == ledger.LEDGER_SCHEMA == 1
    if case == "persist":
        assert out[0]["version"] == 3 and out[1] == [] and out[2] is True


# --- the policy ------------------------------------------------------------------------------------------


def _policy_case(mod, case):
    P = mod.policy.ArbiterPolicy
    d = lambda x: (x.action, x.reason, x.deny)  # noqa: E731 - a Decision as a tuple
    if case == "dwell_cooldown":
        pol = P("slo_bounded", dwell_s=2.0, cooldown_s=5.0)
        sig = {"shed_rate_per_s": 3.0}
        out = [d(pol.tick(sig, TRAIN_COUNTS, 0, 0.0)), d(pol.tick(sig, TRAIN_COUNTS, 0, 2.0))]
        pol.action_taken(2.0)
        return out + [d(pol.tick(sig, TRAIN_COUNTS, 1, t)) for t in (2.5, 4.5, 7.5)]
    if case == "deny_order":
        pol = P("slo_bounded", dwell_s=0.0, min_train_hosts=1)
        sig = {"shed_rate_per_s": 9.0, "train_progressing": False}
        return [d(pol.tick(sig, {"train": 1, "serve": 1, "free": 0}, 1, 0.0)), d(pol.tick(sig, TRAIN_COUNTS, 0, 1.0))]
    if case == "train_priority":
        pol = P("train_priority", dwell_s=0.0)
        return [d(pol.tick(s, TRAIN_COUNTS, 0, t)) for s, t in (({"shed_rate_per_s": 9.0}, 0.0),
                                                                 ({"escalations": 1}, 1.0),
                                                                 ({"escalations": 1, "shed_rate_per_s": 9.0}, 2.0))]
    if case == "quiet_multiples":
        return [P(name, dwell_s=2.0).quiet_dwell_s for name in mod.policy.POLICIES] + [
            P(dwell_s=2.0, quiet_dwell_s=1.5).quiet_dwell_s]
    if case == "quiet_streak":
        pol = P("slo_bounded", dwell_s=1.0)
        out = [d(pol.tick({}, TRAIN_COUNTS, b, t)) for b, t in ((0, 0.0), (1, 0.0), (1, 1.5), (1, 2.0))]
        pol.tick({"predicted_wait_overshoot": True}, TRAIN_COUNTS, 1, 2.5)
        return out + [d(pol.tick({}, TRAIN_COUNTS, 1, 3.0))]
    if case == "set_policy":
        pol = P("slo_bounded", dwell_s=2.0, cooldown_s=5.0)
        pol.tick({"shed_rate_per_s": 9.0}, TRAIN_COUNTS, 0, 0.0)
        pol.set_policy("serve_priority")
        return [d(pol.tick({"shed_rate_per_s": 9.0}, TRAIN_COUNTS, 0, 3.0)), pol.snapshot()]
    if case == "return_stalled":
        pol = P("slo_bounded", dwell_s=1.0)
        pol.tick({}, TRAIN_COUNTS, 1, 0.0)
        return [d(pol.tick({"train_progressing": False}, TRAIN_COUNTS, 1, 2.5)), d(pol.tick({}, TRAIN_COUNTS, 1, 3.0))]
    if case == "random_walk":                 # a seeded walk over every input
        rng = random.Random(11)
        out = []
        for name in mod.policy.POLICIES:
            pol = P(name, dwell_s=1.0, cooldown_s=3.0, min_train_hosts=1)
            t, borrowed = 0.0, 0
            for _ in range(200):
                t += rng.choice((0.25, 0.5, 1.0))
                sig = {"shed_rate_per_s": rng.choice((0.0, 0.5, 2.0)), "escalations": rng.choice((0, 0, 1)),
                       "predicted_wait_overshoot": rng.random() < 0.3, "train_progressing": rng.random() < 0.9}
                dec = pol.tick(sig, {"train": 2 - borrowed, "serve": borrowed, "free": 0}, borrowed, t)
                out.append(d(dec))
                if dec.action == "borrow":
                    borrowed += 1
                    pol.action_taken(t)
                elif dec.action == "return":
                    borrowed -= 1
                    pol.action_taken(t)
        return out
    raise ValueError(case)


@pytest.mark.parametrize("case", ["dwell_cooldown", "deny_order", "train_priority", "quiet_multiples", "quiet_streak",
                                  "set_policy", "return_stalled", "random_walk"])
def test_policy_matches_vitax(case):
    out = both(_policy_case, case)
    if case == "dwell_cooldown":
        assert out == [(None, "dwell", False), ("borrow", "shed_rate", False), (None, "dwell", False),
                       (None, "cooldown", True), ("borrow", "shed_rate", False)]
    if case == "random_walk":
        assert {a for a, _, _ in out} == {None, "borrow", "return"}


# --- the TrainDirector -----------------------------------------------------------------------------------


def mk_director(mod, exit_code=0, argv=("train.py",)):
    spawned, order = [], []

    def spawn(child_argv, env, tag):
        proc = FakeProc(exit_code, on_signal=lambda p: order.append(next(i for i, s in enumerate(spawned)
                                                                          if s["proc"] is p)))
        spawned.append({"argv": list(child_argv), "env": env, "tag": tag, "proc": proc})
        return proc

    director = mod.daemon.TrainDirector(list(argv), term_grace_s=2.0, env={"BASE": "1"}, spawn=spawn,
                                        sleep=lambda s: None, port_fn=lambda: 4321)
    return director, spawned, order


def test_director_start_resize_and_dirty_drain_match_vitax():
    def run(mod):
        director, spawned, order = mk_director(mod)
        director.start(2)
        out = [[s["tag"] for s in spawned], [s["argv"][-2:] for s in spawned], director.process_count,
               director.alive(), director.healthy(), director.resize(1), order[:2], director.process_count,
               director.resizes_total, spawned[2]["tag"], spawned[2]["env"]]
        spawned[2]["proc"].rc = 1                     # the relaunched rank crashed
        out += [director.alive(), director.healthy()]
        dirty, dspawned, _ = mk_director(mod, exit_code=1)
        dirty.start(2)
        out += [_raises(dirty.resize, 1), dirty.process_count, [s["tag"] for s in dspawned[2:]],
                dirty.last_start_t is not None]
        return out, [s["env"] for s in spawned[:2]], order
    (ours, our_env, our_order), (theirs, their_env, their_order) = run(PORT), run(JAX)
    assert ours == theirs
    assert ours[0] == ["g0_p0", "g0_p1"] and ours[1] == [["--resume_epoch", "-1"]] * 2
    assert ours[5] == {"from_processes": 2, "to_processes": 1, "exit_codes": [0, 0]} and ours[6] == [0, 1]
    assert ours[10] == {"BASE": "1"}                  # a one-process launch: no bring-up variables
    assert "relaunched at 2" in ours[13] and ours[14] == 2
    # the bring-up variables are torchrun's (distributed.maybe_initialize), vitax's JAX's
    for pid, env in enumerate(our_env):
        assert env == {"BASE": "1", "RANK": str(pid), "WORLD_SIZE": "2", "LOCAL_RANK": str(pid),
                       "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "4321"}
    for pid, env in enumerate(their_env):
        assert env == {"BASE": "1", "JAX_COORDINATOR_ADDRESS": "localhost:4321", "JAX_NUM_PROCESSES": "2",
                       "JAX_PROCESS_ID": str(pid)}
    # one SIGTERM a rank here; vitax's drain sends a second through terminate_child
    assert our_order == [0, 1] and their_order == [0, 1, 0, 1]


def test_terminate_children_signals_all_before_any_wait():
    """supervise.terminate_children: every process hears one SIGTERM before
    the first wait, a straggler is killed past its window, and
    terminate_child is the one-process case."""
    from vitax_torch.supervise import terminate_child, terminate_children
    order = []

    class Stubborn(FakeProc):
        def send_signal(self, sig):
            self.signals.append(sig)
            order.append("term")

        def poll(self):
            order.append("poll")
            return self.rc
    procs = [FakeProc(0), Stubborn(), FakeProc(3)]
    assert terminate_children(procs, 0.0, sleep=lambda s: None) == [0, -9, 3]
    assert [len(p.signals) for p in procs] == [1, 1, 1] and order.index("term") < order.index("poll")
    lone = FakeProc(0)
    assert terminate_child(lone, 0.0, sleep=lambda s: None) == 0 and len(lone.signals) == 1


def test_director_default_child_is_the_train_cli():
    director, spawned, _ = mk_director(PORT, argv=("--fake_data", "--device", "cpu"))
    director.start(1)
    assert spawned[0]["argv"] == [sys.executable, "-m", "vitax_torch.train", "--fake_data", "--device", "cpu",
                                  "--resume_epoch", "-1"]
    assert daemon.default_train_argv(["python", "x.py"]) == ["python", "x.py"]


@pytest.mark.parametrize("counts", [(2, 1, 2), (1, 2, 1), (3, 2, 3)], ids=["2-1-2", "1-2-1", "3-2-3"])
def test_topology_env_across_resizes(counts):
    base = {"PATH": "/bin", "WORLD_SIZE": "2", "RANK": "1", "MASTER_PORT": "9", "LOCAL_RANK": "1"}  # stale
    for n in counts:
        for pid in range(n):
            ours = supervise.topology_env(base, n, pid, 5555 if n > 1 else 0)
            theirs = jax_supervise.topology_env(base, n, pid, 5555 if n > 1 else 0)
            if n == 1:
                assert ours == {"PATH": "/bin"}       # every stale bring-up variable removed
                assert not any(k.startswith("JAX_") for k in theirs)
            else:
                assert ours == {"PATH": "/bin", "RANK": str(pid), "WORLD_SIZE": str(n), "LOCAL_RANK": str(pid),
                                "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "localhost", "MASTER_PORT": "5555"}
                assert theirs["JAX_NUM_PROCESSES"] == ours["WORLD_SIZE"]
                assert theirs["JAX_PROCESS_ID"] == ours["RANK"]
    with pytest.raises(AssertionError):
        supervise.topology_env(base, 2, 0, 0)


# --- the Arbiter (socketless) ----------------------------------------------------------------------------


def mk_arbiter(mod, hosts=("h0", "h1"), n_train=2, dwell_s=0.0, cooldown_s=0.0, quiet_dwell_s=0.0,
               clock=None, **seams):
    led = mod.ledger.HostLedger(list(hosts), clock=lambda: 1.0)
    pol = mod.policy.ArbiterPolicy("slo_bounded", min_train_hosts=1, dwell_s=dwell_s, cooldown_s=cooldown_s,
                                   quiet_dwell_s=quiet_dwell_s)
    train = FakeTrain(n_train)
    rec = DummyRecorder()
    arb = mod.daemon.Arbiter(led, pol, train=train, recorder=rec, clock=clock or (lambda: 0.0), **seams)
    return arb, train, rec


def _arbiter_case(mod, case):
    order = []
    shed = lambda: {"shed_rate_per_s": 9.0}  # noqa: E731 - live pressure
    if case == "full_sequence":
        arb, train, rec = mk_arbiter(
            mod, provision=lambda host: (order.append(("provision", host)) or "http://b:1"),
            release=lambda host, url: order.append(("release", host, url)),
            fleet_adopt=lambda url: order.append(("adopt", url)),
            fleet_release=lambda url: order.append(("fleet_release", url)), signals_fn=shed)
        out = [arb.tick(now=0.0)]
        arb._signals_fn = lambda: {}
        out += [arb.tick(now=1.0)]
    elif case == "rollback_provision":
        arb, train, rec = mk_arbiter(mod, provision=lambda host: _never(), signals_fn=shed)
        out = [arb.tick(now=0.0)]
    elif case == "rollback_release":
        arb, train, rec = mk_arbiter(mod, provision=lambda host: "http://b:1",
                                     release=lambda host, url: order.append(("release", host, url)),
                                     fleet_adopt=lambda url: (_ for _ in ()).throw(OSError("router")),
                                     signals_fn=shed)
        out = [arb.tick(now=0.0)]
    elif case == "deny_dedupe":
        attempts = []

        def provision(host):
            attempts.append(host)
            if len(attempts) == 1:
                raise RuntimeError("first attempt dies")
            return "http://b:1"
        arb, train, rec = mk_arbiter(mod, provision=provision, cooldown_s=10.0, signals_fn=shed)
        out = [arb.tick(now=t) for t in (0.0, 1.0, 2.0, 11.0)]
    elif case == "escalation":
        arb, train, rec = mk_arbiter(mod, provision=lambda host: "http://b:1")
        out = [arb.request_capacity("autoscaler_max"), arb.tick(now=0.0), arb.tick(now=1.0)]
    elif case == "return_failure":
        state = {"fail": True}

        def fleet_release(url):
            if state["fail"]:
                raise OSError("router drain wedged")
        arb, train, rec = mk_arbiter(mod, provision=lambda host: "http://b:1", fleet_release=fleet_release,
                                     signals_fn=shed)
        out = [arb.tick(now=0.0)]
        arb._signals_fn = lambda: {}
        out += [arb.tick(now=1.0), arb.metrics()["borrowed"]]
        state["fail"] = False
        out += [arb.tick(now=2.0)]
    elif case == "telemetry":
        arb, train, rec = mk_arbiter(mod, hosts=("h0", "h1", "h2"), n_train=3, clock=lambda: 100.0,
                                     provision=lambda host: "http://b:1", signals_fn=shed)
        train.is_healthy = False
        out = [arb.tick(now=0.0), arb.observe_train({"step": 7, "epoch": 0, "process_count": 3, "junk": 1}),
               arb.tick(now=110.0), arb.tick(now=200.0)]
    elif case == "generation":
        t = {"now": 100.0}
        arb, train, rec = mk_arbiter(mod, hosts=("h0", "h1", "h2"), n_train=3, clock=lambda: t["now"],
                                     provision=lambda host: "http://b:1", signals_fn=shed)
        arb.observe_train({"step": 9, "epoch": 0, "process_count": 3})
        t["now"] = 105.0
        out = [arb.tick(now=110.0), arb._gen_start_t, arb.tick(now=111.0)]
        t["now"] = 120.0
        arb.observe_train({"step": 1, "epoch": 0, "process_count": 2})
        out += [arb.tick(now=121.0)]
    elif case == "metrics_gate":
        arb, train, rec = mk_arbiter(mod)
        out = [sorted(arb.metrics()), _raises(arb.set_policy, "cryptomining"), arb.set_policy("serve_priority"),
               arb.metrics()["policy"]["policy"]]
    else:
        raise ValueError(case)
    return out, order, train.resizes, arb.ledger.snapshot(), arb.metrics(), rec.events


@pytest.mark.parametrize("case", ["full_sequence", "rollback_provision", "rollback_release", "deny_dedupe",
                                  "escalation", "return_failure", "telemetry", "generation", "metrics_gate"])
def test_arbiter_matches_vitax(case):
    out, order, resizes, snap, metrics, events = both(_arbiter_case, case)
    kinds = [p["event"] for k, p in events]
    if case == "full_sequence":
        assert out == ["borrow", "return"] and resizes == [1, 2]
        assert order == [("provision", "h1"), ("adopt", "http://b:1"), ("fleet_release", "http://b:1"),
                         ("release", "h1", "http://b:1")]
        assert snap["hosts"]["h1"]["owner"] == "train" and metrics["returns_total"] == 1
    if case in ("rollback_provision", "rollback_release"):
        assert out == [None] and resizes == [1, 2] and "borrow_failed" in kinds
        assert snap["hosts"]["h1"]["owner"] == "train"
    if case == "deny_dedupe":
        assert out == [None, None, None, "borrow"] and kinds.count("deny") == 1 and metrics["denies_total"] == 1
    if case == "return_failure":
        assert out == ["borrow", None, {"h1": "http://b:1"}, "return"] and "return_failed" in kinds
    if case == "generation":
        assert out == ["borrow", 105.0, None, "borrow"]
        deny = [p for k, p in events if p["event"] == "deny"][-1]
        assert deny["generation_lag_s"] == 5.0 and deny["telemetry_age_s"] == 11.0


# --- the train-side heartbeat ----------------------------------------------------------------------------


def _reporter_case(mod):
    posts = []
    rep = mod.control.ArbiterReporter("http://a:1/", process_count=2,
                                      http_json=lambda url, payload, timeout: posts.append((url, payload)))
    out = [rep.post_once()]
    rep.update(5, 0)
    rep.update(6, 0)
    out += [rep.post_once(), rep.post_once()]
    rep.update(7, 0)
    out += [rep.post_once(), rep.post_once(), rep.post_once(force=True), rep.posts_total]
    dead = mod.control.ArbiterReporter("http://a:1", http_json=_never)
    dead.update(1, 0)
    out += [dead.post_once(), dead.post_failures, dead.posts_total]
    flushed = []
    thr = mod.control.ArbiterReporter("http://a:1", interval_s=30.0,
                                      http_json=lambda url, payload, timeout: flushed.append(payload))
    thr.start()
    thr.update(3, 1)
    thr.stop()
    out += [flushed, any(t.name == "vitax-arbiter-report" and t.is_alive() for t in threading.enumerate())]
    return out, posts


def test_arbiter_reporter_matches_vitax():
    out, posts = both(_reporter_case)
    assert out == [False, True, False, True, False, True, 3, False, 1, 0, [{"step": 3, "epoch": 1,
                                                                           "process_count": 1}], False]
    assert posts[0] == ("http://a:1/telemetry", {"step": 6, "epoch": 0, "process_count": 2})


# --- the HTTP surface ------------------------------------------------------------------------------------


def _http(url, payload=None, timeout=10.0, raw=None, ctype="application/json"):
    data = json.dumps(payload).encode() if payload is not None else raw
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if data is not None else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _call(url, payload=None, raw=None):
    try:
        return _http(url, payload, raw=raw)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _http_case(mod):
    arb = mod.daemon.Arbiter(mod.ledger.HostLedger(["h0", "h1"], clock=lambda: 1.0),
                             mod.policy.ArbiterPolicy(dwell_s=3600.0), interval_s=3600.0, clock=lambda: 2.0)
    httpd = mod.daemon.start_arbiter(arb, 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = [_call(base + "/healthz"), _call(base + "/ledger"), _call(base + "/request", {"reason": "surge"}),
               _call(base + "/telemetry", {"step": 3, "epoch": 0, "process_count": 2}), _call(base + "/metrics"),
               _call(base + "/policy", {"policy": "serve_priority"})[0]]
        arb.allow_admin = True
        out += [_call(base + "/policy", {"policy": "serve_priority"}), _call(base + "/policy", {"policy": "bogus"})[0],
                _call(base + "/nope")[0], _call(base + "/request", raw=b"{bad")[0]]
    finally:
        mod.daemon.stop_arbiter(httpd, arb)
    return out


def test_arbiter_http_surface_matches_vitax():
    out = both(_http_case)
    assert out[0] == (200, {"status": "ok"}) and out[2] == (200, {"accepted": True, "status": "pending"})
    assert out[4][1]["requests_total"] == 1 and out[4][1]["train_telemetry"]["step"] == 3
    assert out[5:] == [403, (200, {"policy": "serve_priority"}), 400, 404, 400]


# --- the fleet's side: the router's hooks and the autoscaler's escalation --------------------------------


def _router_case(mod):
    health = {"status": "ok", "ready": True}
    mgr = mod.replica.ReplicaManager(http_get=lambda url, t: health, sleep=lambda s: None)
    mgr.adopt("http://seed", name="replica_0")
    rt = mod.router.Router(mgr)
    httpd = mod.router.start_router(rt, 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = [_call(base + "/fleet/adopt", {"url": "http://b:1"}), _call(base + "/fleet/release", {"url": "x"})]

        def adopt(url):
            return {"adopted": mgr.adopt(url, name="borrowed_0").name, "url": url}

        def release(url):
            target = next(mgr.find(n) for n, s in mgr.snapshot().items() if s["url"] == url)
            mgr.retire(target)
            mgr.discard(target)
            return {"released": target.name, "url": url}
        rt.fleet_adopt_fn, rt.fleet_release_fn = adopt, release
        out += [_call(base + "/fleet/adopt", {"url": "http://b:1"}), sorted(mgr.snapshot()),
                _call(base + "/fleet/adopt", {})[0], _call(base + "/fleet/adopt", raw=b"{bad")[0],
                _call(base + "/fleet/release", {"url": "http://b:1"}), sorted(mgr.snapshot())]
        rt.fleet_release_fn = lambda url: _never()
        out += [_call(base + "/fleet/release", {"url": "http://b:1"})]
    finally:
        mod.router.stop_router(httpd)
    return out


def test_router_fleet_hooks_match_vitax():
    out = both(_router_case)
    assert [o[0] if isinstance(o, tuple) else o for o in out[:2]] == [501, 501]
    assert out[2] == (200, {"adopted": "borrowed_0", "url": "http://b:1"}) and out[3] == ["borrowed_0", "replica_0"]
    assert out[4:6] == [400, 400] and out[7] == ["replica_0"] and out[8][0] == 500


def _autoscale_case(mod, case):
    rec = DummyRecorder()
    mgr = mod.replica.ReplicaManager(http_get=lambda url, t: {"status": "ok", "ready": True}, sleep=lambda s: None)
    mgr.adopt("http://a", name="a")
    mgr.poll_once(now=0.0)
    adm = mod.admission.AdmissionController(100.0)
    asks = []

    def request_capacity(reason):
        asks.append(reason)
        if case == "unreachable":
            raise ConnectionError("arbiter down")
        return {"accepted": True}

    def full():
        raise mod.placement.AgentFullError("agent at capacity: 1 slot(s) in use")
    sc = mod.autoscale.Autoscaler(mgr, admission=adm, min_replicas=1, max_replicas=2 if case == "agent_full" else 1,
                                  scale_out=full if case == "agent_full" else None, request_capacity=request_capacity,
                                  dwell_s=1.0, cooldown_s=2.0, recorder=rec)
    actions, t = [], 0.0
    for sheds in (3, 3, 3, 3, 3, 3, 3, 0, 0):
        for _ in range(sheds):
            adm.record_shed(reason="test")
        actions.append(sc.tick(now=t))
        t += 0.5
    return actions, asks, rec.events, sc.snapshot()


@pytest.mark.parametrize("case", ["ceiling", "agent_full", "unreachable"])
def test_autoscaler_escalation_matches_vitax(case):
    actions, asks, events, snap = both(_autoscale_case, case)
    if case == "unreachable":
        assert "escalated" not in actions and asks and snap["escalations_total"] == 0
        assert {p["event"] for _, p in events} == {"escalate_failed"}
    else:
        assert actions.count("escalated") == snap["escalations_total"] == len(asks) >= 1
        assert all(a == "shed_rate" for a in asks)


# --- tools/metrics_report.py on each package's stream ----------------------------------------------------


def _stream_case(mod, tmp):
    path = os.path.join(tmp, "port" if mod is PORT else "jax")
    rec = mod.daemon.JsonlRecorder(path)
    state = {"fail": 1}

    def provision(host):
        if state["fail"]:
            state["fail"] -= 1
            raise RuntimeError("agent down")
        return "http://b:1"
    arb = mod.daemon.Arbiter(mod.ledger.HostLedger(["h0", "h1"], clock=lambda: 1.0),
                             mod.policy.ArbiterPolicy(dwell_s=0.0, cooldown_s=1.0, quiet_dwell_s=0.0),
                             train=FakeTrain(2), provision=provision, recorder=rec, clock=lambda: 0.0)
    arb.request_capacity("autoscaler_max")
    arb._signals_fn = lambda: {"shed_rate_per_s": 9.0}
    for t in (0.0, 0.5, 0.7, 2.0, 2.5):
        arb.tick(now=t)
    arb._signals_fn = lambda: {}
    arb.tick(now=4.0)
    rec.event("control", event="elastic_resume", from_processes=2, to_processes=1)
    rec.event("autoscale", event="scale_out", outcome="escalated", reason="shed_rate", size=1)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import metrics_report
    finally:
        sys.path.pop(0)
    summary = metrics_report.summarize(os.path.join(path, "metrics.jsonl"))
    return {k: summary.get(k) for k in ("arbiter_events", "autoscale_events", "train_topology_timeline")}


def test_metrics_report_arbiter_sections_match_vitax(tmp_path):
    out = both(_stream_case, str(tmp_path))
    assert out["arbiter_events"]["borrows"] == 1 and out["arbiter_events"]["borrow_failures"] == 1
    assert out["arbiter_events"]["returns"] == 1 and out["arbiter_events"]["requests"] == 1
    assert out["autoscale_events"]["escalations"] == 1
    assert out["train_topology_timeline"] == [{"event": "elastic_resume", "from_processes": 2, "to_processes": 1}]


# --- the peer store's last pull beside a live receiver ---------------------------------------------------


@pytest.mark.parametrize("joined", [False, True], ids=["join_timed_out", "joined"])
def test_peer_stop_skips_last_pull_beside_a_live_receiver(joined, monkeypatch, tmp_path, capsys):
    from vitax_torch.checkpoint import peer
    rep = peer.PeerReplicator(peer.PeerStore(str(tmp_path)), process_index=0, process_count=2, client=None)
    release = threading.Event()
    rep._receiver = threading.Thread(target=release.wait, daemon=True)
    rep._receiver.start()
    rep._inbox = object()
    pulls = []
    monkeypatch.setattr(rep, "_pull", lambda timeout_ms: pulls.append(timeout_ms))
    monkeypatch.setattr(peer, "join_or_warn", lambda thread, timeout, what=None, rank=0: joined)
    try:
        rep.stop()
    finally:
        release.set()
    assert len(pulls) == (1 if joined else 0)
    assert ("skipping the final receive" in capsys.readouterr().err) is not joined
    assert rep._receiver is None and rep._stop.is_set()


class _RacyStore:
    """A store whose check() says a key is there that get() then waits for:
    the replica chunk its sender deleted between the two calls."""

    def check(self, keys):
        return True

    def get(self, key):
        time.sleep(60)
        raise AssertionError("get() waited on a vanished key")

    def compare_set(self, key, expected, desired):
        return expected                 # absent: the c10d stores return the expected value


def test_store_get_never_waits_on_a_vanished_key():
    from vitax_torch.train.control import StoreKV
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not set within 200 ms"):
        StoreKV(_RacyStore()).blocking_key_value_get_bytes("vitax/peer/1/g2/c227", 200)
    assert time.monotonic() - t0 < 5.0


# --- the drill, end to end on the CPU --------------------------------------------------------------------

TINY_FLAGS = ["--image_size", "16", "--patch_size", "8", "--embed_dim", "32", "--num_heads", "2", "--num_blocks",
              "2", "--num_classes", "4", "--dtype", "float32"]


def _port_below_ephemeral(rng) -> int:
    """A bindable port below the ephemeral range, so no port-0 bind (a
    TCPStore, the trainers' store) takes it between here and its use."""
    for _ in range(1000):
        p = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
                return p
            except OSError:
                continue
    raise RuntimeError("no free port below 32000")


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def test_arbiter_drill_on_the_cpu(tmp_path):
    import torch
    from vitax_torch.checkpoint.consolidate import save_npz
    from vitax_torch.checkpoint.convert import params_to_jax
    from vitax_torch.config import Config
    from vitax_torch.data.transforms import ValTransform
    from vitax_torch.models.vit import build_model
    from vitax_torch.serve.engine import InferenceEngine
    from vitax_torch.serve.server import decode_image_bytes

    torch.manual_seed(0)
    cfg = Config(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4,
                 dtype="float32").validate()
    sd = build_model(cfg, "cpu").state_dict()
    npz = str(tmp_path / "m.npz")
    save_npz(npz, params_to_jax(sd))
    m = tmp_path / "m"
    m.mkdir()
    rng = random.Random()
    A, P, B, G, GB = (_port_below_ephemeral(rng) for _ in range(5))
    arb, fleet = f"http://127.0.0.1:{A}", f"http://127.0.0.1:{P}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    serve = ["--npz", npz, "--device", "cpu", *TINY_FLAGS, "--serve_allow_chaos", "--max_batch_wait_ms", "5"]
    train = [*TINY_FLAGS, "--device", "cpu", "--fake_data", "--batch_size", "8", "--num_epochs", "1",
             "--steps_per_epoch", "100000", "--log_step_interval", "10", "--warmup_steps", "0", "--num_workers", "1",
             "--eval_max_batches", "1", "--test_epoch_interval", "99", "--ckpt_epoch_interval", "99",
             "--ckpt_dir", str(tmp_path / "ckpt"), "--replicate_steps", "2", "--peer_heartbeat_s", "1",
             "--control_sync_steps", "2", "--metrics_dir", str(m), "--arbiter_url", arb]
    cmds = {
        "agent": ["-m", "vitax_torch.serve.fleet.agent", "--agent_port", str(G), "--agent_base_port", str(GB),
                  "--agent_max_replicas", "1", "--health_interval_s", "0.2"],
        "fleet": ["-m", "vitax_torch.serve.fleet", "--replicas", "1", "--max_replicas", "1", *serve, "--serve_port",
                  str(P), "--base_port", str(B), "--slo_p99_ms", "300", "--autoscale_dwell_s", "0.5",
                  "--autoscale_cooldown_s", "3", "--health_interval_s", "0.2", "--arbiter_url", arb,
                  "--metrics_dir", str(m / "fleet")],
        "arbiter": ["-m", "vitax_torch.arbiter", "--hosts", "h0,h1", "--arbiter_port", str(A), "--fleet_url", fleet,
                    "--agent_urls", f"h1=http://127.0.0.1:{G}",
                    "--serve_argv", shlex.join(serve + ["--metrics_dir", str(m / "borrowed")]),
                    "--metrics_dir", str(m), "--arbiter_dwell_s", "0.5", "--arbiter_cooldown_s", "2",
                    "--arbiter_interval_s", "0.25", "--train_grace_s", "60", "--ledger_path",
                    str(tmp_path / "ledger.json"), "--train_log_dir", str(tmp_path / "train_logs"), "--", *train]}
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env, start_new_session=True,
                                    stdout=open(tmp_path / f"{name}.log", "w"), stderr=subprocess.STDOUT)
             for name, argv in cmds.items()}
    body = b"P6\n16 16\n255\n" + np.random.default_rng(0).integers(0, 256, 16 * 16 * 3, dtype=np.uint8).tobytes()
    # the borrowed replica must answer as the engine on the export does (the serve CLI's topk default, 5 > 4
    # classes: every class); the reference is taken before the drill, so nothing slows the ask below
    engine = InferenceEngine.from_npz(cfg, npz, "cpu")
    engine.warmup()
    want_ids, want_p = engine.predict(decode_image_bytes(body, ValTransform(16))[None])

    def metrics():
        return _http(arb + "/metrics")[1]

    try:
        _wait(lambda: _http(fleet + "/healthz")[1]["replicas"] == {"replica_0": "ready"}, 60, "the seed replica")
        _wait(lambda: metrics()["train_telemetry"] is not None, 90, "the first train heartbeat")
        seed_url = _http(fleet + "/metrics")[1]["replicas"]["replica_0"]["url"]
        _http(seed_url + "/chaos", {"site": "engine_predict", "at": 1, "times": 1000000, "action": "hang",
                                    "seconds": 0.4})
        stop, codes = threading.Event(), []

        def burst():
            while not stop.is_set():
                try:
                    codes.append(_http(fleet + "/predict", raw=body, ctype="image/x-portable-pixmap", timeout=30)[0])
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
                    time.sleep(0.02)
        threads = [threading.Thread(target=burst) for _ in range(6)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: metrics()["borrows_total"] >= 1, 60, "the borrow")
            _wait(lambda: _http(fleet + "/healthz")[1]["replicas"].get("borrowed_0") == "ready", 60,
                  "the borrowed replica")
            # asked while the burst still holds the pressure: once it clears the arbiter returns the host
            fm = _http(fleet + "/metrics")[1]
            borrowed = fm["replicas"]["borrowed_0"]["url"]
            ans = _http(borrowed + "/predict", raw=body, ctype="image/x-portable-pixmap")[1]
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert 429 in codes and set(codes) <= {200, 429}
        assert fm["autoscale"]["escalations_total"] >= 1
        assert ans["classes"] == want_ids[0].tolist()[:len(ans["classes"])] and len(ans["classes"]) == 4
        np.testing.assert_allclose(ans["probs"], want_p[0][:len(ans["probs"])], rtol=1e-5, atol=1e-6)
        _wait(lambda: metrics()["returns_total"] >= 1, 120, "the return")
        _wait(lambda: (metrics()["train_telemetry"] or {}).get("process_count") == 2 and metrics()["train_alive"] == 2,
              120, "training re-expanded to 2")
        step_back = metrics()["train_telemetry"]["step"]
        _wait(lambda: metrics()["train_telemetry"]["step"] > step_back, 60, "a step of the re-expanded pair")
        snap = metrics()
        assert snap["ledger"]["hosts"]["h1"]["owner"] == "train" and snap["borrowed"] == {}
        assert _http(f"http://127.0.0.1:{G}/healthz")[1]["slots"] == {"used": 0, "max": 1}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(timeout=90)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                rcs[name] = "killed"
    logs = {name: (tmp_path / f"{name}.log").read_text() for name in procs}
    assert rcs == {"agent": 0, "fleet": 0, "arbiter": 0}, (rcs, {k: v[-3000:] for k, v in logs.items()})
    assert "training drained, exit codes [0, 0]" in logs["arbiter"]
    events = [json.loads(ln) for ln in (m / "metrics.jsonl").read_text().splitlines() if ln.strip()]
    arb_ev = [e["event"] for e in events if e.get("kind") == "arbiter"]
    assert arb_ev.count("borrow") == 1 and arb_ev.count("return") == 1 and "borrow_failed" not in arb_ev
    restores = [e for e in events if e.get("kind") == "restore"]
    shrink = [e for e in events if e.get("event") == "elastic_resume"]
    assert [(e["from_processes"], e["to_processes"]) for e in shrink] == [(2, 1), (1, 2)]
    assert restores[0]["path"] == "peer" and restores[0]["dcp_reads"] == 0 and restores[0]["resume_step"] > 0
    steps = [e for e in events if "kind" not in e]
    assert steps and all(np.isfinite(e["loss"]) for e in steps)
    drains = [json.loads(ln) for ln in (m / "borrowed" / "serve.jsonl").read_text().splitlines()
              if '"serve_drain"' in ln]
    assert drains and all(d["clean"] for d in drains)      # the agent's drain of the borrowed replica
    report = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"),
                             str(m / "metrics.jsonl"), "--json"], capture_output=True, text=True, timeout=60)
    summary = json.loads(report.stdout)
    assert summary["arbiter_events"]["borrows"] == 1 and summary["arbiter_events"]["returns"] == 1
    assert [t["to_processes"] for t in summary["train_topology_timeline"]] == [1, 2]
