"""vitax_torch.serve.fleet against vitax.serve.fleet on the same inputs,
and the port's fleet end to end on the CPU.

- Exact equality with vitax: strip_flags and replica_argv (modulo the
  module name), admission decisions with their Retry-After and EWMA, cache
  keys, hits and evictions, the manager's lifecycle records and its
  jitter sequence, autoscale decisions, placement, the five Config
  fields' defaults and refusals.
- Both routers over one stdlib fake-replica set: dispatch order, the
  statuses (200, 429 with Retry-After, 503, 4xx passed through), composed
  groups and the /metrics keys and values.
- serve.jsonl: the same traffic through the port's server and vitax's, each
  on a tiny engine from one npz vitax exports: the same event kinds and
  keys, and tools/metrics_report.py's same counters.
- End to end: two `python -m vitax_torch.serve --device cpu` replicas
  behind the port's router answer as vitax's engine on the npz (top-k
  equal, probs within 1e-5); replica 1 crashed through /chaos mid-burst
  costs no client error and comes back; manager.stop() drains both to exit
  0; the fleet CLI answers and exits 0 on SIGTERM, and without a card and
  without --device cpu it exits non-zero.
Tiny dims, float32, the CPU.
"""

import base64
import importlib.util
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import vitax.serve.fleet.__main__ as jax_cli
from vitax import faults as jax_faults
from vitax.serve.fleet import admission as jax_admission
from vitax.serve.fleet import autoscale as jax_autoscale
from vitax.serve.fleet import cache as jax_cache
from vitax.serve.fleet import placement as jax_placement
from vitax.serve.fleet import replica as jax_replica
from vitax.serve.fleet import router as jax_router
from vitax_torch import faults
from vitax_torch.config import Config, build_parser, config_fields_from_namespace
from vitax_torch.serve.fleet import __main__ as cli
from vitax_torch.serve.fleet import admission, autoscale, cache, placement, replica, router

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = SimpleNamespace(replica=replica, router=router, admission=admission, cache=cache, autoscale=autoscale,
                       placement=placement, faults=faults)
JAX = SimpleNamespace(replica=jax_replica, router=jax_router, admission=jax_admission, cache=jax_cache,
                      autoscale=jax_autoscale, placement=jax_placement, faults=jax_faults)
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4,
            serve_max_batch=2, serve_topk=3, max_batch_wait_ms=10.0)
TINY_FLAGS = ["--image_size", "16", "--patch_size", "8", "--embed_dim", "32", "--num_heads", "2", "--num_blocks", "2",
              "--num_classes", "4", "--serve_max_batch", "2", "--serve_topk", "3", "--dtype", "float32"]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()
    jax_faults.uninstall()


class Recorder:
    """Captures events as (kind, payload)."""

    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append((kind, payload))

    def close(self):
        pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, body=None, ctype="application/octet-stream", timeout=60.0):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if body is not None else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def ppm(seed: int, size: int = 18) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)
    return f"P6\n{size} {size}\n255\n".encode() + arr.tobytes()


def export(tmp_dir) -> str:
    """A float32 save_npz export of a vitax init whose head is scaled 50x,
    so the classes are well apart."""
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import flatten_tree, save_npz
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    cfg = JaxConfig(**TINY, dtype="float32").validate()
    params = jax_build_model(cfg).init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), True)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    flat["params/head/kernel"] = flat["params/head/kernel"] * 50.0
    path = os.path.join(tmp_dir, "export_float32.npz")
    save_npz(path, flat, dtype=None)
    return path


# --- the CLI's argv plumbing -----------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--replicas", "3", "--npz", "/m.npz", "--serve_port", "8000", "--slo_p99_ms=250", "--device", "cpu"],
    ["--base_port=9000", "--metrics_dir", "/tmp/m", "--serve_cache_max", "64", "--serve_topk", "3",
     "--serve_batch_window_ms=5", "--serve_batch_max", "4", "--hedge_after_ms", "20", "--serve_allow_chaos"],
    ["--max_replicas", "4", "--min_replicas=2", "--placement_agents", "http://a:7070", "--breaker_threshold", "5",
     "--fault_plan", '{"site": "engine_predict", "at": 2, "action": "oserror"}', "--arbiter_url", "http://x"],
], ids=["source", "router", "growth"])
def test_strip_flags_and_replica_argv_match_vitax(argv):
    assert cli._FLEET_ONLY_FLAGS == jax_cli._FLEET_ONLY_FLAGS
    assert cli.strip_flags(argv, cli._FLEET_ONLY_FLAGS) == jax_cli.strip_flags(argv, jax_cli._FLEET_ONLY_FLAGS)
    for port, mdir in ((8101, ""), (8102, "/tmp/m/replica_1")):
        ours, theirs = cli.replica_argv(argv, port, mdir), jax_cli.replica_argv(argv, port, mdir)
        assert ours[:3] == [sys.executable, "-m", "vitax_torch.serve"] and theirs[:3] == [sys.executable, "-m",
                                                                                          "vitax.serve"]
        assert ours[3:] == theirs[3:]


FIVE = ("serve_allow_chaos", "serve_cache_max", "serve_cache_ttl_s", "serve_batch_window_ms", "serve_batch_max")


def test_five_serve_fields_parse_as_vitax():
    from vitax.config import build_parser as jax_parser
    argv = ["--serve_allow_chaos", "--serve_cache_max", "64", "--serve_cache_ttl_s", "30", "--serve_batch_window_ms",
            "5", "--serve_batch_max", "4"]
    for args in ([], argv):
        ours, theirs = vars(build_parser().parse_args(args)), vars(jax_parser().parse_args(args))
        assert {k: ours[k] for k in FIVE} == {k: theirs[k] for k in FIVE}
    cfg = Config(**config_fields_from_namespace(build_parser().parse_args(argv))).validate()
    assert cfg.serve_allow_chaos and cfg.serve_cache_max == 64 and cfg.serve_batch_max == 4


@pytest.mark.parametrize("bad", [dict(serve_cache_max=-1), dict(serve_cache_ttl_s=0.0),
                                 dict(serve_batch_window_ms=-1.0), dict(serve_batch_max=-2)],
                         ids=["cache_max", "cache_ttl", "batch_window", "batch_max"])
def test_five_serve_fields_refused_as_vitax(bad):
    from vitax.config import Config as JaxConfig
    with pytest.raises(AssertionError) as theirs:
        JaxConfig(**bad).validate()
    with pytest.raises(ValueError) as ours:
        Config(**bad).validate()
    assert str(ours.value) == str(theirs.value)


# --- admission, cache -------------------------------------------------------------


def _admission_trace(mod):
    rec = Recorder()
    ac = mod.admission.AdmissionController(200.0, recorder=rec, warming_capacity_frac=0.25)
    out = [ac.check(5, 2)]                        # no observation yet: admitted
    for s in (0.05, 0.3, 0.12, 0.9, 0.02):
        ac.observe(s)
    out += [ac.check(d, r, warming_replicas=w) for d, r, w in ((0, 2, 0), (1, 2, 0), (3, 1, 0), (9, 2, 2),
                                                              (40, 1, 4), (4, 0, 0), (12, 3, 1))]
    ac.record_shed(reason="replica_queue_full", replica="b")
    off = mod.admission.AdmissionController(0.0)
    off.observe(5.0)
    out.append(off.check(1000, 1))
    return out, ac.snapshot(), rec.events, off.snapshot()


def test_admission_decisions_retry_after_and_ewma_match_vitax():
    ours, theirs = _admission_trace(PORT), _admission_trace(JAX)
    assert ours == theirs
    assert any(isinstance(r, int) for r in ours[0]) and ours[1]["shed_total"] >= 2


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cache_trace(mod):
    rec, clock = Recorder(), Clock()
    c = mod.cache.PredictionCache(3, ttl_s=10.0, recorder=rec, clock=clock)
    keys = [c.key(b"img-a", "default"), c.key(b"img-a", 1), c.key(b"", 5)]
    out = []
    for step, (op, body, topk) in enumerate([("put", b"a", "default"), ("get", b"a", "default"), ("get", b"a", 1),
                                             ("put", b"b", 1), ("put", b"c", 2), ("get", b"a", "default"),
                                             ("put", b"d", 3), ("get", b"b", 1), ("get", b"a", "default"),
                                             ("tick", None, None), ("get", b"a", "default"), ("put", b"e", 1),
                                             ("get", b"e", 1)]):
        clock.t = step * 2.0 if op != "tick" else clock.t + 9.0
        if op == "put":
            c.put(body, topk, b'{"classes": [%d]}' % step)
        elif op == "get":
            out.append(c.get(body, topk))
    off = mod.cache.PredictionCache(0)
    off.put(b"a", 1, b"x")
    return keys, out, c.snapshot(), rec.events, off.get(b"a", 1), off.snapshot()


def test_cache_keys_hits_and_evictions_match_vitax():
    ours, theirs = _cache_trace(PORT), _cache_trace(JAX)
    assert ours == theirs
    snap = ours[2]
    assert snap["hits_total"] >= 2 and snap["evictions_total"] >= 1 and snap["expirations_total"] >= 1


# --- the replica manager ---------------------------------------------------------------


class FakeProc:
    """Popen stand-in: poll() gives a settable code; SIGTERM drains to 0."""

    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.rc = 0

    def kill(self):
        self.rc = -9


def _manager_trace(mod):
    rec, procs, health = Recorder(), [], {}

    def spawn(argv):
        procs.append(FakeProc())
        return procs[-1]

    def http_get(url, timeout):
        h = health.get(url.rsplit("/", 1)[0], {"status": "ok", "ready": True})
        if h is None:
            raise OSError("refused")
        return h

    m = mod.replica.ReplicaManager(recorder=rec, spawn=spawn, http_get=http_get, sleep=lambda s: None,
                                   clock=lambda: 0.0, backoff_s=0.5, max_restarts=2, fail_threshold=2)
    r0 = m.manage(["serve", "0"], "http://r0")
    r1 = m.manage(["serve", "1"], "http://r1")
    r2 = m.adopt("http://r2/")
    trace = []
    m.poll_once(now=0.0)                                 # all admitted
    a = m.acquire()
    b = m.acquire()
    c = m.acquire(exclude=(a.name,))
    trace.append((a.name, b.name, c.name, m.total_in_flight()))
    m.release(a, latency_s=0.2)
    m.release(b, ok=False)
    m.release(c, counted=False)
    health["http://r1"] = {"status": "ok", "ready": False}
    health["http://r2"] = None
    for now in (1.0, 2.0):
        m.poll_once(now=now)                             # r1 not ready, r2 failing twice
    trace.append((r1.state, r2.state, r2.health_failures, m.ready_count(), m.warming_count()))
    procs[0].rc = 13
    for now in (3.0, 3.2, 3.6, 4.0):                     # death, backoff 0.5 s, restart, re-admission
        m.poll_once(now=now)
        trace.append((r0.state, r0.restarts, r0.exit_code))
    health["http://r2"] = {"status": "ok", "ready": True, "degraded": True, "degraded_seconds": 1.25}
    m.poll_once(now=5.0)
    trace.append((m.degraded_count(), m.degraded_seconds(), m.active_count()))
    m.retire(r1)
    trace.append(m.discard(r1))
    m.stop()
    snap = {k: {kk: vv for kk, vv in v.items() if kk != "requests_per_sec"} for k, v in m.snapshot().items()}
    return trace, rec.events, snap, [p.rc for p in procs]


def test_manager_lifecycle_records_match_vitax():
    ours, theirs = _manager_trace(PORT), _manager_trace(JAX)
    assert ours == theirs
    kinds = [k for k, _ in ours[1]]
    for kind in ("replica_spawn", "replica_admit", "replica_eject", "replica_exit", "replica_restart",
                 "replica_retire", "replica_discard"):
        assert kind in kinds


def test_health_jitter_sequence_matches_vitax():
    seqs = []
    for mod in (PORT, JAX):
        m = mod.replica.ReplicaManager(health_interval_s=1.0, health_jitter=0.2, rng=random.Random(7))
        seqs.append([m._next_interval() for _ in range(64)])
    assert seqs[0] == seqs[1] and all(0.8 <= v <= 1.2 for v in seqs[0]) and len(set(seqs[0])) > 1
    assert replica.ReplicaManager(health_jitter=0.0)._next_interval() == replica.DEFAULT_HEALTH_INTERVAL_S


# --- autoscale and placement ---------------------------------------------------------------


def _autoscale_trace(mod):
    rec, health = Recorder(), {}
    m = mod.replica.ReplicaManager(http_get=lambda url, t: health.get(url.rsplit("/", 1)[0],
                                                                      {"status": "ok", "ready": True}),
                                   sleep=lambda s: None)
    m.adopt("http://a", name="a")
    m.poll_once(now=0.0)
    adm = mod.admission.AdmissionController(100.0)
    made, released = [], []

    def scale_out():
        made.append(m.adopt(f"http://n{len(made)}", name=f"n{len(made)}"))
        return made[-1]

    sc = mod.autoscale.Autoscaler(m, admission=adm, min_replicas=1, max_replicas=3, scale_out=scale_out,
                                  release=released.append, dwell_s=1.0, cooldown_s=2.0, drain_timeout_s=5.0,
                                  recorder=rec)
    actions = []
    t = 0.0
    for sheds in (0, 3, 3, 3, 3, 3, 0, 0, 0):           # a shed burst, then calm
        for _ in range(sheds):
            adm.record_shed(reason="test")
        actions.append(sc.tick(now=t))
        m.poll_once(now=t)                               # new replicas admitted
        t += 0.5
    held = m.acquire()                                   # scale-in waits for the victim's request
    for _ in range(12):
        actions.append(sc.tick(now=t))
        if sc.snapshot()["draining"] is not None and held is not None and t > 9.0:
            m.release(held, latency_s=0.1)
            held = None
        t += 0.5
    snap = {k: v for k, v in sc.snapshot().items() if k != "escalations_total"}
    return actions, [(k, {kk: vv for kk, vv in p.items()}) for k, p in rec.events], snap, \
        [r.name for r in released], m.active_count()


def test_autoscale_decisions_match_vitax():
    ours, theirs = _autoscale_trace(PORT), _autoscale_trace(JAX)
    assert ours == theirs
    assert "scale_out" in ours[0] and "retire" in ours[0] and "scale_in" in ours[0]


def test_placement_agent_and_client_match_vitax():
    outs = []
    for mod, module in ((PORT, "vitax_torch.serve"), (JAX, "vitax.serve")):
        spawned = []
        mgr = mod.replica.ReplicaManager(spawn=lambda argv: spawned.append(argv) or FakeProc(),
                                         http_get=lambda url, t: {"status": "ok"}, sleep=lambda s: None)
        agent = mod.placement.PlacementAgent(base_port=9100, manager=mgr, max_slots=2)
        got = [agent.provision(["--npz", "m.npz"]), agent.provision(["--npz", "m.npz"], name="x", port=9555)]
        with pytest.raises(mod.placement.AgentFullError):
            agent.provision(["--npz", "m.npz"])
        with pytest.raises(ValueError):
            mod.placement.PlacementAgent(manager=mgr).provision("not a list")
        got += [agent.release("x"), agent.release("nope"), agent.slots()]
        assert all(a[:3] == [sys.executable, "-m", module] for a in spawned)
        calls = []
        client = mod.placement.PlacementClient("http://agent:7070/",
                                               http_json=lambda u, p, t: calls.append((u, p, t)) or {"ok": 1})
        client.provision(["--a"], name="n")
        client.release("n")
        client.healthz()
        outs.append((got, [a[3:] for a in spawned], calls))
    assert outs[0] == outs[1]


def test_agent_http_round_trip():
    mgr = replica.ReplicaManager(spawn=lambda argv: FakeProc(), http_get=lambda url, t: {"status": "ok"},
                                 sleep=lambda s: None)
    agent = placement.PlacementAgent(base_port=9200, manager=mgr, max_slots=1)
    httpd = placement.start_agent(agent, 0)
    client = placement.PlacementClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    try:
        out = client.provision(["--npz", "m.npz"])
        assert out == {"name": "agent_replica_0", "url": "http://127.0.0.1:9200", "port": 9200}
        with pytest.raises(placement.AgentFullError):
            client.provision(["--npz", "m.npz"])
        assert client.healthz()["slots"] == {"used": 1, "max": 1}
        assert client.release("agent_replica_0") == {"released": "agent_replica_0"}
    finally:
        placement.stop_agent(httpd, agent)


# --- both routers over one fake-replica set -----------------------------------------------------


class FakeReplica:
    """A stdlib stand-in for one serve replica: /healthz, /metrics,
    /predict and /predict_batch, with dials for the failure modes."""

    def __init__(self, name: str):
        self.name = name
        self.mode = "ok"              # ok | queue_full | bad_request | fail | dead
        self.hold = None              # an Event /predict waits on
        self.started = threading.Semaphore(0)
        self.predicts = 0
        self.posts = 0
        self.batches = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if fake.mode == "dead":
                    self._reply(500, {"error": "down"})
                elif self.path == "/healthz":
                    self._reply(200, {"status": "ok", "ready": True})
                else:
                    self._reply(200, {"requests_total": fake.predicts, "marker": fake.name,
                                      "weights_dtype": "float32", "param_bytes": 1000})

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                fake.posts += 1
                if fake.mode == "queue_full":
                    self._reply(503, {"error": "overloaded", "reason": "queue_full"}, {"Retry-After": "2"})
                elif fake.mode == "bad_request":
                    self._reply(400, {"error": "bad request: not an image"})
                elif fake.mode in ("fail", "dead"):
                    self._reply(500, {"error": "replica exploded"})
                elif self.path == "/predict_batch":
                    items = json.loads(body)["items"]
                    fake.batches.append(len(items))
                    fake.predicts += len(items)
                    self._reply(200, {"results": [{"status": 200, "body": json.dumps(
                        {"classes": [1, 0], "probs": [0.6, 0.4], "replica": fake.name})} for _ in items]})
                else:
                    fake.started.release()
                    if fake.hold is not None:
                        fake.hold.wait(timeout=30)
                    fake.predicts += 1
                    self._reply(200, {"classes": [1, 0], "probs": [0.6, 0.4], "replica": fake.name})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def reset(self):
        self.mode, self.hold, self.predicts, self.posts, self.batches = "ok", None, 0, 0, []
        self.started = threading.Semaphore(0)

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


VOLATILE = {"uptime_s", "requests_per_sec", "requests_per_sec_60s", "latency_s_p50", "latency_s_p95",
            "latency_s_p99", "ewma_latency_s", "ewma_service_s", "tokens", "batch_fill_p50", "batch_fill_p95"}


def _stable(tree):
    """The /metrics tree with its clock-dependent values replaced by their
    presence, so keys and counters compare exactly."""
    if isinstance(tree, dict):
        return {k: (v is not None) if k in VOLATILE else _stable(v) for k, v in tree.items()}
    return tree


def _router_scenario(mod, fakes):
    """One fixed sequence of traffic through `mod`'s router over `fakes`:
    what each step answered, the composed groups and the final /metrics."""
    for f in fakes:
        f.reset()
    rec = Recorder()
    m = mod.replica.ReplicaManager(recorder=rec, fail_threshold=1)
    for f in fakes:
        m.adopt(f.url, name=f.name)
    m.poll_once()
    adm = mod.admission.AdmissionController(1.0)
    r = mod.router.Router(m, admission=adm, recorder=rec, request_timeout_s=10.0)
    httpd = mod.router.start_router(r, 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {}

    def post(body=b"img", ctype="image/x-portable-pixmap"):
        try:
            with urllib.request.urlopen(urllib.request.Request(url + "/predict", data=body,
                                                               headers={"Content-Type": ctype}), timeout=30) as resp:
                return resp.status, dict(resp.headers).get("Retry-After"), json.load(resp)
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read())

    try:
        # least-loaded order: held requests pin in-flight counts
        for f in fakes:
            f.hold = threading.Event()
        answers = [None] * 3
        threads = []
        for i in range(3):
            threads.append(threading.Thread(target=lambda i=i: answers.__setitem__(i, post())))
            threads[-1].start()
            assert fakes[0 if i != 1 else 1].started.acquire(timeout=10)
        adm.observe(10.0)                                     # 3 in flight at 10 s each: the next is shed
        out["shed"] = post()
        for f in fakes:
            f.hold.set()
        for t in threads:
            t.join(timeout=30)
        out["order"] = [a[2]["replica"] for a in answers]
        adm.ewma_service_s = None
        for f, rep in zip(fakes, m.replicas):          # measured latencies would order the picks below
            f.hold, rep.ewma_latency_s = None, None
        for mode in ("queue_full", "bad_request", "fail"):
            for f in fakes:
                f.mode = mode
            out[mode] = post()
        for f in fakes:
            f.mode = "ok"
        out["after"] = post()                                 # breakers closed again after a success
        for f in fakes:
            f.mode = "dead"
        m.poll_once()
        out["no_ready"] = post()
        for f in fakes:
            f.mode = "ok"
        m.poll_once()
        out["healthz"] = http(url + "/healthz")
        out["404"] = http_code(url + "/nope")
        out["metrics"] = _stable(http(url + "/metrics"))
    finally:
        mod.router.stop_router(httpd, r)
    # composed groups: five concurrent bodies fill one group (it leaves when full, the window is slack)
    c = mod.router.Router(m, request_timeout_s=10.0, batch_window_ms=5000.0, batch_max=5)
    res = [None] * 5
    ts = [threading.Thread(target=lambda i=i: res.__setitem__(i, c.dispatch(b"img%d" % i, "image/png")))
          for i in range(5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    out["composed"] = ([s for s, _, _ in res], sorted(b for f in fakes for b in f.batches),
                       _stable(c.fleet_metrics()["continuous_batching"]))
    c.close()
    out["events"] = [(k, {kk: vv for kk, vv in p.items() if kk not in ("detail", "predicted_wait_s")})
                     for k, p in rec.events]
    return out


def http_code(url):
    try:
        urllib.request.urlopen(url, timeout=10)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_both_routers_answer_one_fake_fleet_alike():
    fakes = [FakeReplica("a"), FakeReplica("b")]
    try:
        ours, theirs = _router_scenario(PORT, fakes), _router_scenario(JAX, fakes)
    finally:
        for f in fakes:
            f.stop()
    assert ours == theirs
    assert ours["order"] == ["a", "b", "a"]
    assert ours["shed"][:2] == (429, "15") and ours["shed"][2]["reason"] == "admission"
    assert ours["queue_full"][:2] == (429, "2") and ours["queue_full"][2]["reason"] == "replica_queue_full"
    assert ours["bad_request"][:2] == (400, None) and ours["bad_request"][2] == {"error": "bad request: not an image"}
    assert ours["fail"][0] == 503 and ours["fail"][2]["reason"] == "dispatch_failed"
    assert ours["no_ready"][:2] == (503, "1") and ours["no_ready"][2]["reason"] == "no_ready_replicas"
    assert ours["composed"][0] == [200] * 5 and sum(ours["composed"][1]) == 5
    assert ours["metrics"]["errors_total"] == 3 and ours["metrics"]["shed_total"] == 2


# --- serve.jsonl: the port's server against vitax's ---------------------------------------------


def _serve_jsonl(start, stop, drain, cfg, engine, mdir):
    httpd, ctx = start(cfg, engine, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    got = [http(url + "/predict", ppm(1)), http(url + "/predict", ppm(2))]
    wire = {"items": [base64.b64encode(ppm(3)).decode(), base64.b64encode(ppm(4)).decode()]}
    got.append(http(url + "/predict_batch", json.dumps(wire).encode(), "application/json"))
    assert http_post_code(url + "/predict", b"not an image") == 400
    plan = b'{"site": "batcher_flush", "at": 1, "action": "oserror"}'
    got.append(http(url + "/chaos", plan, "application/json"))
    assert http_post_code(url + "/predict", ppm(5)) == 503              # the injected flush failure
    for depth, now in ((1000, 0.0), (1000, 3.0), (0, 4.0), (0, 7.0)):   # a brownout episode of 4 s
        ctx.brownout.observe(depth, now=now)
    drain(httpd, ctx)
    return got, os.path.join(mdir, "serve.jsonl")


def http_post_code(url, body):
    try:
        http(url, body)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def test_serve_jsonl_kinds_keys_and_report_match_vitax(devices8, tmp_path):
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax.serve import server as jax_server
    from vitax_torch.serve import InferenceEngine
    from vitax_torch.serve import server as port_server
    path = export(str(tmp_path))
    kw = dict(TINY, dtype="float32", serve_port=0, serve_allow_chaos=True, max_batch_wait_ms=200.0)
    files, answers = [], []
    for mod, cfg, engine in (
            (jax_server, JaxConfig(**kw, metrics_dir=str(tmp_path / "jax")).validate(), None),
            (port_server, Config(**kw, metrics_dir=str(tmp_path / "port")).validate(), None)):
        if mod is jax_server:
            engine = JaxEngine.from_npz(cfg, path)
        else:
            engine = InferenceEngine.from_npz(cfg, path, "cpu")
        engine.warmup()
        got, f = _serve_jsonl(mod.start_server, mod.stop_server, mod.drain, cfg, engine, cfg.metrics_dir)
        answers.append(got)
        files.append(f)
    for a, b in zip(answers[0][:2], answers[1][:2]):
        assert a["classes"] == b["classes"]
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-5)
    assert answers[0][3] == answers[1][3]                               # /chaos's body

    def kinds_keys(p):
        out = {}
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                out.setdefault(rec["kind"], set()).update(rec)
                if rec["kind"] == "brownout":
                    out.setdefault("brownout " + rec["event"], set()).update(rec)
        return out

    theirs, ours = kinds_keys(files[0]), kinds_keys(files[1])
    assert ours == theirs
    assert set(ours) >= {"serve_start", "serve_request", "serve_batch", "chaos_install", "serve_fault",
                         "brownout enter", "brownout exit", "serve_drain"}
    spec = importlib.util.spec_from_file_location("metrics_report", os.path.join(REPO, "tools", "metrics_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    s_theirs, s_ours = (report.summarize(f) for f in files)
    for s in (s_theirs, s_ours):
        s.pop("path")
    assert s_ours == s_theirs
    assert s_ours["serve_fault_events"] == 1 and s_ours["brownout_seconds"] == 4.0


# --- the port's fleet end to end on the CPU --------------------------------------------------------------


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def npz(tmp_path_factory, devices8):
    return export(str(tmp_path_factory.mktemp("fleet_npz")))


def test_fleet_end_to_end_on_cpu(npz, tmp_path):
    from vitax.config import Config as JaxConfig
    from vitax.data.transforms import val_transform
    from vitax.serve import InferenceEngine as JaxEngine
    rec = Recorder()
    manager = replica.ReplicaManager(recorder=rec, health_interval_s=0.2, backoff_s=0.2)
    argv = ["--npz", npz, "--device", "cpu", *TINY_FLAGS, "--serve_allow_chaos", "--max_batch_wait_ms", "5"]
    for i in range(2):
        port = free_port()
        manager.manage(cli.replica_argv(argv, port, str(tmp_path / f"replica_{i}")), f"http://127.0.0.1:{port}")
    httpd = None
    try:
        manager.start()
        _wait(lambda: manager.ready_count() == 2, 120, "both replicas ready")
        r = router.Router(manager, recorder=rec, request_timeout_s=60.0)
        httpd = router.start_router(r, 0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        bodies = [ppm(10 + i) for i in range(4)]
        answers = [http(url + "/predict", b) for b in bodies]
        jeng = JaxEngine.from_npz(JaxConfig(**TINY, dtype="float32", serve_port=0).validate(), npz)
        jeng.warmup()
        from PIL import Image
        import io
        tf = val_transform(16, normalize=False)
        imgs = np.stack([tf(Image.open(io.BytesIO(b)).convert("RGB")) for b in bodies])
        ids, probs = jeng.predict(imgs[:2])
        ids2, probs2 = jeng.predict(imgs[2:])
        ids, probs = np.concatenate([ids, ids2]), np.concatenate([probs, probs2])
        for ans, i, p in zip(answers, ids, probs):
            assert ans["classes"] == i.tolist()
            np.testing.assert_allclose(ans["probs"], p, atol=1e-5)
        # the router's /predict_batch: each item through dispatch, the single engine's reply form
        wire = {"items": [base64.b64encode(b).decode() for b in bodies[:2]] + [base64.b64encode(b"junk").decode()]}
        batch = http(url + "/predict_batch", json.dumps(wire).encode(), "application/json")["results"]
        assert [r["status"] for r in batch] == [200, 200, 400]
        for item, ans in zip(batch[:2], answers):
            assert json.loads(item["body"])["classes"] == ans["classes"]
        # replica 1 crashed through /chaos mid-burst: the router's retry covers it
        victim = manager.find("replica_1")
        out = http(victim.url + "/chaos", b'{"site": "engine_predict", "at": 1, "action": "crash"}',
                   "application/json")
        assert out == {"installed": "engine_predict:crash(at=1, exit_code=13)"}
        errors, done = [], []

        def client(k):
            for j in range(3):
                try:
                    done.append(http(url + "/predict", ppm(100 + 10 * k + j)))
                except Exception as e:  # noqa: BLE001 - any error fails the drill
                    errors.append(repr(e))

        for _ in range(5):
            ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            if any(k == "replica_exit" for k, _ in rec.events):
                break
        assert not errors and len(done) % 12 == 0 and done, errors
        exits = [p for k, p in rec.events if k == "replica_exit"]
        assert exits == [{"replica": "replica_1", "exit_code": 13, "restarts": 0}]
        _wait(lambda: manager.ready_count() == 2 and victim.restarts == 1, 120, "replica_1 re-admitted")
        kinds = [(k, p.get("replica")) for k, p in rec.events]
        i_exit = kinds.index(("replica_exit", "replica_1"))
        assert ("replica_restart", "replica_1") in kinds[i_exit:] and ("replica_admit", "replica_1") in kinds[i_exit:]
        assert http(url + "/predict", bodies[0])["classes"] == answers[0]["classes"]
    finally:
        if httpd is not None:
            router.stop_router(httpd)
        manager.stop()
    assert [r.exit_code for r in manager.replicas] == [0, 0]
    with open(tmp_path / "replica_1" / "serve.jsonl") as f:
        faults_seen = [json.loads(ln) for ln in f if '"serve_fault"' in ln]
    assert faults_seen and faults_seen[0]["site"] == "engine_predict" and faults_seen[0]["action"] == "crash"


def test_fleet_cli_serves_on_cpu_and_drains_on_sigterm(npz, tmp_path):
    port, base = free_port(), free_port()
    argv = [sys.executable, "-m", "vitax_torch.serve.fleet", "--replicas", "1", "--npz", npz, "--device", "cpu",
            *TINY_FLAGS, "--serve_port", str(port), "--base_port", str(base), "--health_interval_s", "0.2",
            "--metrics_dir", str(tmp_path / "m"), "--serve_cache_max", "8"]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"

        def ready():
            try:
                return http(url + "/healthz")["ready"]
            except OSError:
                return False
        _wait(ready, 120, "the fleet's first ready replica")
        a = http(url + "/predict", ppm(7))
        b = http(url + "/predict", ppm(7))
        assert a["classes"] == b["classes"] and len(a["classes"]) == 3
        metrics = http(url + "/metrics")
        assert metrics["cache_hits"] == 1 and metrics["replicas"]["replica_0"]["server"]["requests_total"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        out = proc.stdout.read()
        proc.stdout.close()
    assert "fleet: router on :" in out, out
    with open(tmp_path / "m" / "serve.jsonl") as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert {"replica_spawn", "replica_admit", "cache", "replica_exit"} <= set(kinds)
    assert os.path.exists(tmp_path / "m" / "replica_0" / "serve.jsonl")


def test_fleet_cli_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device would serve")
    port, base = free_port(), free_port()
    r = subprocess.run([sys.executable, "-m", "vitax_torch.serve.fleet", "--replicas", "1", "--npz", "absent.npz",
                        "--serve_port", str(port), "--base_port", str(base), "--health_interval_s", "0.2"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr and "before it was ever ready" in r.stderr and "--device cpu" in r.stderr


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3"])
def test_export_from_state_equals_the_writers_own(tmp_path, qdtype):
    """save_npz_from_state (the fleet phase's export of a model held on the
    card, quantized block by block) writes what save_npz of params_to_jax
    writes: every code, scale and float leaf equal, the same manifest."""
    from vitax_torch.checkpoint.consolidate import load_npz_raw, save_npz, save_npz_from_state
    from vitax_torch.checkpoint.convert import params_to_jax
    from vitax_torch.models.vit import build_model
    torch.manual_seed(0)
    sd = build_model(Config(**TINY, dtype="float32").validate(), "cpu").state_dict()
    a, b = str(tmp_path / "whole.npz"), str(tmp_path / "blocks.npz")
    save_npz(a, params_to_jax(sd), dtype=qdtype)
    save_npz_from_state(b, sd, qdtype)
    (fa, sa, ma), (fb, sb, mb) = load_npz_raw(a), load_npz_raw(b)
    assert ma == mb and sorted(fa) == sorted(fb) and sorted(sa) == sorted(sb) and len(sa) == 6
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k].view(torch.uint8) if qdtype != "int8" and k in ma
                                                          else fa[k], fb[k].view(torch.uint8)
                                                          if qdtype != "int8" and k in mb else fb[k]), k
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    with pytest.raises(ValueError, match="quantized export"):
        save_npz_from_state(b, sd, "bfloat16")


def test_mapped_npz_reads_as_np_load(tmp_path):
    """read_npz (a replica's mapped read of its export) gives np.load's
    arrays, stored and compressed members alike; load_npz_raw mapped or
    not gives the same tensors, and an engine from the mapped file owns
    its weights (the file can go)."""
    from vitax_torch.checkpoint.consolidate import load_npz_raw, read_npz
    arrs = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.asarray(5, np.int32),
            "c": np.asfortranarray(np.arange(6).reshape(2, 3)), "s": np.asarray(["x", "yy"]),
            "e": np.zeros((0, 3), np.int8), "bo": np.array([True, False])}
    for i, save in enumerate((np.savez, np.savez_compressed)):
        path = str(tmp_path / f"m{i}.npz")
        save(path, **arrs)
        got = read_npz(path)
        with np.load(path) as want:
            assert sorted(got) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    path = export(str(tmp_path))
    (fa, sa, ma), (fb, sb, mb) = load_npz_raw(path), load_npz_raw(path, mapped=True)
    assert ma == mb and sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)
    from vitax_torch.serve import InferenceEngine
    cfg = Config(**TINY, dtype="float32").validate()
    engine = InferenceEngine.from_npz(cfg, path, "cpu")
    os.remove(path)
    engine.warmup()
    x = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    ids, probs = engine.predict(x)
    assert np.isfinite(probs).all() and ids.shape == (2, 3)
