"""vitax_torch's serve chaos layer against vitax's on the same inputs.

- CircuitBreaker transitions and RetryBudget tokens, step by step.
- Both routers over one fake-replica set: a replica failing every
  dispatch contained by its breaker, a dry budget's fast 503, a hedge
  fired past its threshold and won.
- The four serve fault sites fire at vitax's indices: engine_predict
  before any work (on tiny engines from one npz), batcher_flush failing a
  batch and not the worker, replica_health in sweep order,
  router_dispatch once an attempt, single and composed.
- POST /chaos: the same statuses and bodies as vitax's server, with and
  without --serve_allow_chaos.
The CPU, stdlib fakes and tiny dims.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_fleet import JAX, PORT, TINY, FakeReplica, Recorder, export
from vitax import faults as jax_faults
from vitax.serve.batcher import DynamicBatcher as JaxBatcher
from vitax.serve.fleet import breaker as jax_breaker
from vitax_torch import faults
from vitax_torch.config import Config
from vitax_torch.serve.batcher import DynamicBatcher
from vitax_torch.serve.fleet import breaker

PORT.breaker, JAX.breaker = breaker, jax_breaker
PORT.batcher, JAX.batcher = DynamicBatcher, JaxBatcher


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()
    jax_faults.uninstall()


# --- breaker and budget ------------------------------------------------------------


def _breaker_trace(mod):
    t, events = [0.0], []
    br = mod.breaker.CircuitBreaker("r", fail_threshold=3, cooldown_s=2.0, clock=lambda: t[0],
                                    on_event=events.append)
    out = []
    script = ["f", "f", "s", "f", "f", "f", "f", "b", ("t", 1.9), "b", ("t", 2.0), "e", "b", "b", "u", "b", "f",
              "b", ("t", 4.1), "b", "s", "b", "f", "f", "f", ("t", 7.0), "b", "f", ("t", 9.5), "b", "s"]
    for op in script:
        if isinstance(op, tuple):
            t[0] = op[1]
            continue
        r = {"f": br.record_failure, "s": br.record_success, "b": br.begin, "e": br.eligible,
             "u": br.release_unused}[op]()
        out.append((op, r, br.state(), br.eligible()))
    return out, events, br.snapshot()


def test_breaker_transitions_match_vitax():
    ours, theirs = _breaker_trace(PORT), _breaker_trace(JAX)
    assert ours == theirs
    assert [e["event"] for e in ours[1]] == ["open", "half_open", "reopen", "half_open", "close", "open",
                                             "half_open", "reopen", "half_open", "close"]


def _budget_trace(mod):
    out = []
    for ratio, cap in ((0.25, 10.0), (0.1, 3.0), (0.0, 10.0)):
        b = mod.breaker.RetryBudget(ratio=ratio, cap=cap)
        seq = [b.withdraw() for _ in range(12)]
        for _ in range(9):
            b.deposit()
        seq += [b.withdraw() for _ in range(4)]
        out.append((b.enabled, seq, b.snapshot()))
    return out


def test_retry_budget_tokens_match_vitax():
    ours, theirs = _budget_trace(PORT), _budget_trace(JAX)
    assert ours == theirs
    assert ours[0][2]["exhausted_total"] > 0 and all(ours[2][1])


# --- containment through both routers -------------------------------------------------


def _containment(mod, fakes):
    for f in fakes:
        f.reset()
    rec = Recorder()
    m = mod.replica.ReplicaManager(recorder=rec)
    for f in fakes:
        m.adopt(f.url, name=f.name)
    m.poll_once()
    out = {}
    # one replica failing every dispatch: its breaker opens, the router stops connecting (the
    # cooldown outlasts the five dispatches on a loaded host, so no half-open probe falls among them)
    r = mod.router.Router(m, recorder=rec, request_timeout_s=10.0, breaker_threshold=2, breaker_cooldown_s=2.0)
    fakes[0].mode = "fail"
    out["contained"] = [r.dispatch(b"x", "image/png")[0] for _ in range(5)]
    out["posts_a"] = fakes[0].posts
    out["state_open"] = r._breaker("a").state()
    fakes[0].mode = "ok"
    time.sleep(2.1)
    for rep in m.replicas:
        rep.ewma_latency_s = None
    out["probe"] = [r.dispatch(b"x", "image/png")[0] for _ in range(2)]
    out["state_closed"] = r._breaker("a").state()
    # a dry budget: the first attempt goes out, its retry does not
    for f in fakes:
        f.mode = "fail"
    for rep in m.replicas:              # the probes' latencies would pick the first replica
        rep.ewma_latency_s = None
    r2 = mod.router.Router(m, recorder=rec, request_timeout_s=10.0, retry_budget_ratio=0.1)
    while r2.budget.withdraw():
        pass
    before = sum(f.posts for f in fakes)
    status, headers, payload = r2.dispatch(b"x", "image/png")
    out["budget"] = (status, headers, payload, sum(f.posts for f in fakes) - before,
                     r2.fleet_metrics()["retry_budget"]["exhausted_total"])
    # a hedge past its threshold: the held primary loses to the second replica
    for f in fakes:
        f.mode = "ok"
    for rep in m.replicas:
        rep.ewma_latency_s = None
    fakes[0].hold = threading.Event()
    r3 = mod.router.Router(m, recorder=rec, request_timeout_s=10.0, hedge_after_ms=100.0)
    status, _, payload = r3.dispatch(b"y", "image/png")
    fakes[0].hold.set()
    snap = r3.fleet_metrics()
    out["hedge"] = (status, json.loads(payload)["replica"], snap["hedges_total"], snap["hedge_wins_total"])
    out["events"] = [(k, {kk: v for kk, v in p.items() if kk != "detail"}) for k, p in rec.events]
    return out


def test_routers_contain_failures_alike():
    fakes = [FakeReplica("a"), FakeReplica("b")]
    try:
        ours, theirs = _containment(PORT, fakes), _containment(JAX, fakes)
    finally:
        for f in fakes:
            f.stop()
    assert ours == theirs
    assert ours["contained"] == [200] * 5 and ours["posts_a"] == 2 and ours["state_open"] == "open"
    assert ours["probe"] == [200, 200] and ours["state_closed"] == "closed"
    assert ours["budget"][0] == 503 and ours["budget"][2]["reason"] == "retry_budget_exhausted"
    assert ours["budget"][3] == 1
    assert ours["hedge"] == (200, "b", 1, 1)


# --- the four sites -----------------------------------------------------------------------


def test_engine_predict_fires_before_any_work_at_vitaxs_index(devices8, tmp_path):
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax_torch.serve import InferenceEngine
    path = export(str(tmp_path))
    engines = {"port": InferenceEngine.from_npz(Config(**TINY, dtype="float32").validate(), path, "cpu"),
               "jax": JaxEngine.from_npz(JaxConfig(**TINY, dtype="float32", serve_port=0).validate(), path)}
    x = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    traces = {}
    for name, eng in engines.items():
        eng.warmup()
        mod = faults if name == "port" else jax_faults
        fired = []
        mod.install('{"site": "engine_predict", "at": 2, "times": 2, "action": "oserror"}')
        mod.set_reporter(fired.append)
        trace = []
        for _ in range(5):
            try:
                trace.append(eng.predict(x)[0].tolist())
            except OSError as e:
                trace.append(str(e))
        traces[name] = (trace, fired)
        mod.uninstall()
    assert traces["port"] == traces["jax"]
    assert [f["index"] for f in traces["port"][1]] == [2, 3]
    from vitax_torch.serve.engine import InferenceEngine as Bare
    faults.install('{"site": "engine_predict", "at": 1, "action": "oserror"}')
    with pytest.raises(OSError, match="injected fault"):      # before the shapes are read
        Bare.predict(object.__new__(Bare), None)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_batcher_flush_fails_the_batch_not_the_worker(which):
    mod, cls = (faults, DynamicBatcher) if which == "port" else (jax_faults, JaxBatcher)
    mod.install('{"site": "batcher_flush", "at": 1, "action": "oserror"}')
    calls, stats = [], []

    def predict(images):
        calls.append(images.shape[0])
        return np.zeros((images.shape[0], 3), np.int32), np.zeros((images.shape[0], 3), np.float32)

    b = cls(predict, max_batch=2, max_wait_ms=1.0, bucket_of=lambda n: 2, on_batch=stats.append)
    try:
        with pytest.raises(OSError, match="injected fault"):
            b.submit(np.zeros((16, 16, 3), np.uint8)).result(timeout=10)
        assert calls == [] and stats == []
        assert b.submit(np.zeros((16, 16, 3), np.uint8)).result(timeout=10).batch_size == 1
        assert calls == [1] and [(s["batch_size"], s["bucket"]) for s in stats] == [(1, 2)]
        assert sorted(stats[0]) == ["batch_size", "bucket", "infer_s", "queue_wait_s_max"]
    finally:
        b.close()


def _health_trace(mod):
    mod.faults.install('{"site": "replica_health", "at": 3, "times": 3, "action": "oserror"}')
    m = mod.replica.ReplicaManager(health_jitter=0.0, http_get=lambda url, timeout: {"status": "ok", "ready": True})
    reps = [m.adopt(f"http://x:{i}", name=n) for i, n in enumerate("abc")]
    out = []
    for _ in range(3):
        m.poll_once()
        out.append([(r.state, r.health_failures) for r in reps])
    mod.faults.uninstall()
    return out


def test_replica_health_fires_in_sweep_order_as_vitax():
    ours, theirs = _health_trace(PORT), _health_trace(JAX)
    assert ours == theirs
    # index 3 is c's first probe (c is not admitted), 4 and 5 a's and b's second (one flap, below the threshold)
    assert ours[0] == [("ready", 0), ("ready", 0), ("starting", 1)]
    assert ours[1] == [("ready", 1), ("ready", 1), ("ready", 0)]


def _dispatch_trace(mod, fakes):
    for f in fakes:
        f.reset()
    fired = []
    mod.faults.set_reporter(None)
    m = mod.replica.ReplicaManager()
    for f in fakes:
        m.adopt(f.url, name=f.name)
    m.poll_once()
    out = []
    for router_kw in ({}, {}, {"batch_window_ms": 50.0, "batch_max": 2}):
        mod.faults.install('{"site": "router_dispatch", "at": 2, "action": "oserror"}')
        mod.faults.set_reporter(fired.append)
        r = mod.router.Router(m, request_timeout_s=10.0, **router_kw)
        out.append(([r.dispatch(b"z%d" % i, "image/png")[0] for i in range(3)], r.metrics.retries_total))
        r.close()
    mod.faults.uninstall()
    return out, [(p["site"], p["index"]) for p in fired]


def test_router_dispatch_fires_once_an_attempt_as_vitax():
    fakes = [FakeReplica("a"), FakeReplica("b")]
    try:
        ours, theirs = _dispatch_trace(PORT, fakes), _dispatch_trace(JAX, fakes)
    finally:
        for f in fakes:
            f.stop()
    assert ours == theirs
    assert ours[0][0] == ([200, 200, 200], 1) and ours[1] == [("router_dispatch", 2)] * 3


# --- POST /chaos ---------------------------------------------------------------------------


class FakeEngine:
    """The engine surface the server touches on start, /chaos and stop."""

    buckets, topk, compile_count, ready, device = (1, 2), 3, 2, True, "cpu"

    def predict(self, images):
        n = images.shape[0]
        return np.zeros((n, 3), np.int32), np.full((n, 3), 1 / 3, np.float32)


def _chaos_trace(server_mod, faults_mod, cfg_cls, allow):
    cfg = cfg_cls(**TINY, serve_port=0, serve_allow_chaos=allow).validate()
    httpd, ctx = server_mod.start_server(cfg, FakeEngine(), port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/chaos"
    out = []
    try:
        for body in (b'{"site": "engine_predict", "at": 5, "action": "oserror"}',
                     b'[{"site": "batcher_flush", "action": "hang", "seconds": 2, "times": 3}]',
                     b'{"site": "nope", "action": "hang"}', b'not json', b"  ", b'{"site": "step"}'):
            req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    out.append((resp.status, json.load(resp), faults_mod.active()))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read()), faults_mod.active()))
    finally:
        server_mod.stop_server(httpd, ctx)
        faults_mod.uninstall()
    return out


@pytest.mark.parametrize("allow", [False, True], ids=["refused", "armed"])
def test_chaos_statuses_and_bodies_match_vitax(allow):
    from vitax.config import Config as JaxConfig
    from vitax.serve import server as jax_server
    from vitax_torch.serve import server as port_server
    ours = _chaos_trace(port_server, faults, Config, allow)
    theirs = _chaos_trace(jax_server, jax_faults, JaxConfig, allow)
    assert ours == theirs
    codes = [c for c, _, _ in ours]
    assert codes == ([403] * 6 if not allow else [200, 200, 400, 400, 200, 400])
    if allow:
        assert ours[0][1] == {"installed": "engine_predict:oserror(at=5)"} and ours[4] == (200, {"installed": None},
                                                                                            False)
