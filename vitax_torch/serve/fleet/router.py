"""Least-loaded HTTP router: one front door over N serve replicas
(vitax/serve/fleet/router.py).

Speaks the single-engine contract (POST /predict, POST /predict_batch,
GET /healthz, GET /metrics; a /predict_batch's items each go through the
same dispatch as a /predict, all at once) and adds:
- **least-loaded dispatch** to the READY replica with the fewest requests
  in flight (ties to the lower EWMA latency), through the manager's
  acquire()/release();
- **one retry** of a failed dispatch (refused, replica 5xx, timeout) on a
  different replica: /predict is idempotent, so a single replica's death
  stays hidden from clients;
- **circuit breakers** (breaker.py) a replica, over real dispatches;
- **a retry budget**: retries and hedges spend a token bucket refilled at
  `retry_budget_ratio` a request, so a dying fleet answers fast 503s
  (reason "retry_budget_exhausted");
- **hedged requests** (opt-in, `hedge_after_ms`): past max(hedge_after_ms,
  rolling p99) a second attempt goes to another replica, the first
  response wins, from the same budget;
- **admission** (admission.py): 429 + Retry-After past the deadline; a
  replica's queue_full 503 maps to the same 429, and any other 4xx passes
  through to the client;
- **the prediction cache** (cache.py), consulted first: a hit needs no
  ready replica and no dispatch;
- **cross-replica continuous batching** (`BatchComposer`, opt-in,
  `batch_window_ms`): concurrent /predict bodies wait up to the window and
  go as one /predict_batch to one replica, whose batcher runs them as one
  bucket;
- **the arbiter's hooks** (POST /fleet/adopt, POST /fleet/release, each
  {"url": ...}): the fleet CLI installs `fleet_adopt_fn` and
  `fleet_release_fn` under --arbiter_url, so the chip arbiter hands the
  router a replica it provisioned on a borrowed host and takes it back
  with a drain; a router without them answers 501, as vitax's;
- **fleet metrics**: GET /metrics folds router-side latency percentiles,
  each replica's rotation state and its own /metrics, breakers, the
  budget, admission, cache, autoscale and batching counters.

The `router_dispatch` fault site fires once a dispatch attempt, single or
composed. Telemetry kinds: dispatch_retry, retry_budget, breaker, hedge,
continuous_batching (and admission, cache and the manager's lifecycle).
"""

from __future__ import annotations

import base64
import json
import queue as queue_mod
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from vitax_torch import faults
from vitax_torch.serve.fleet.admission import AdmissionController
from vitax_torch.serve.fleet.breaker import (DEFAULT_BUDGET_RATIO, DEFAULT_COOLDOWN_S, DEFAULT_FAIL_THRESHOLD,
                                             CircuitBreaker, RetryBudget)
from vitax_torch.serve.fleet.cache import PredictionCache
from vitax_torch.serve.fleet.replica import ReplicaManager

DISPATCH_ATTEMPTS = 2  # the first pick and one retry on a different replica


def _percentile(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    pos = (len(sorted_vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


class RouterMetrics:
    """Thread-safe router-side counters behind the fleet's GET /metrics."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests_total = 0
        self.errors_total = 0
        self.shed_total = 0
        self.retries_total = 0
        self.hedges_total = 0
        self.hedge_wins_total = 0
        self.cache_hits_total = 0
        self._latency = deque(maxlen=window)
        self._times = deque(maxlen=window)

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self.requests_total += 1
            self._latency.append(latency_s)
            self._times.append(time.time())

    def _bump(self, counter: str) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)

    def error(self) -> None:
        self._bump("errors_total")

    def shed(self) -> None:
        self._bump("shed_total")

    def retry(self) -> None:
        self._bump("retries_total")

    def hedge(self) -> None:
        self._bump("hedges_total")

    def hedge_win(self) -> None:
        self._bump("hedge_wins_total")

    def cache_hit(self) -> None:
        """A /predict the cache answered: no dispatch, no latency sample."""
        self._bump("cache_hits_total")

    def p99(self) -> Optional[float]:
        """The rolling client-latency p99: the hedge trigger."""
        with self._lock:
            lat = sorted(self._latency)
        return _percentile(lat, 0.99)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latency)
            times = list(self._times)
            total, errors = self.requests_total, self.errors_total
            shed, retries = self.shed_total, self.retries_total
            hedges, hedge_wins = self.hedges_total, self.hedge_wins_total
            cache_hits = self.cache_hits_total
        now = time.time()
        recent = [t for t in times if now - t <= 60.0]
        return {"requests_total": total, "errors_total": errors, "shed_total": shed, "retries_total": retries,
                "hedges_total": hedges, "hedge_wins_total": hedge_wins, "cache_hits_total": cache_hits,
                "uptime_s": round(now - self.started, 3),
                "requests_per_sec": round(total / max(now - self.started, 1e-9), 3),
                "requests_per_sec_60s": round(len(recent) / 60.0, 3),
                "latency_s_p50": _percentile(lat, 0.50), "latency_s_p95": _percentile(lat, 0.95),
                "latency_s_p99": _percentile(lat, 0.99)}


class Router:
    """Dispatch policy and fleet observability; start_router() is its HTTP
    shell, and tests drive dispatch() directly."""

    def __init__(self, manager: ReplicaManager, admission: Optional[AdmissionController] = None, recorder=None,
                 request_timeout_s: float = 60.0, breaker_threshold: int = DEFAULT_FAIL_THRESHOLD,
                 breaker_cooldown_s: float = DEFAULT_COOLDOWN_S, retry_budget_ratio: float = DEFAULT_BUDGET_RATIO,
                 hedge_after_ms: float = 0.0, cache: Optional[PredictionCache] = None, autoscaler=None,
                 batch_window_ms: float = 0.0, batch_max: int = 8):
        if hedge_after_ms < 0 or batch_window_ms < 0:
            raise ValueError(f"hedge_after_ms {hedge_after_ms} and batch_window_ms {batch_window_ms} must be >= 0")
        self.manager = manager
        self.admission = admission
        self.recorder = recorder
        self.request_timeout_s = request_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.hedge_after_ms = hedge_after_ms
        self.cache = cache
        self.autoscaler = autoscaler  # observability only; it runs itself
        # the arbiter's hooks (POST /fleet/adopt, /fleet/release), installed by
        # the fleet CLI under --arbiter_url; None -> the routes answer 501
        self.fleet_adopt_fn = None      # (url: str) -> dict
        self.fleet_release_fn = None    # (url: str) -> dict
        self.budget = RetryBudget(ratio=retry_budget_ratio)
        self.metrics = RouterMetrics()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breaker_lock = threading.Lock()
        self._composer = BatchComposer(self, batch_window_ms, batch_max) if batch_window_ms > 0 else None

    # -- dispatch --------------------------------------------------------------

    def dispatch(self, body: bytes, content_type: str) -> Tuple[int, dict, object]:
        """Route one /predict: (status, extra headers, payload), the payload
        the replica's bytes on 200 and a dict to encode otherwise. The
        cache comes first: a hit bypasses readiness, admission and dispatch."""
        topk = self._request_topk(body, content_type)
        if self.cache is not None:
            hit = self.cache.get(body, topk)
            if hit is not None:
                self.metrics.cache_hit()
                return 200, {"X-Vitax-Cache": "hit"}, hit
        ready = self.manager.ready_count()
        if ready == 0:
            self.metrics.error()
            return 503, {"Retry-After": "1"}, {"error": "no ready replicas", "reason": "no_ready_replicas"}
        if self.admission is not None:
            retry_after = self.admission.check(self.manager.total_in_flight(), ready,
                                               warming_replicas=self.manager.warming_count())
            if retry_after is not None:
                self.metrics.shed()
                return 429, {"Retry-After": str(retry_after)}, {
                    "error": "shed: predicted wait exceeds the p99 deadline", "reason": "admission"}
        self.budget.deposit()
        if self._composer is not None:
            status, headers, payload = self._composer.submit(body, content_type)
        else:
            status, headers, payload = self._dispatch_direct(body, content_type)
        if (status == 200 and self.cache is not None and isinstance(payload, bytes)
                and self.manager.degraded_count() == 0):
            # never cache a browned-out answer (topk clamped to 1)
            self.cache.put(body, topk, payload)
        return status, headers, payload

    def dispatch_batch(self, wire: bytes) -> Tuple[int, dict, object]:
        """Route one /predict_batch ({"items": [<base64 body>, ...],
        "content_types": [...]}, the single engine's form): every item
        through dispatch() at once, so the composer can group them. The
        reply is {"results": [{"status", "body"[, "reason"]}, ...]}; only an
        unparseable envelope is a 400."""
        try:
            req = json.loads(wire.decode("utf-8"))
            bodies = [base64.b64decode(b) for b in req["items"]]
            ctypes = req.get("content_types") or [""] * len(bodies)
            if len(ctypes) != len(bodies):
                raise ValueError("content_types/items length mismatch")
        except Exception as e:  # noqa: BLE001 - the client's fault, not ours
            return 400, {}, {"error": f"bad batch request: {e}"}
        results: List[Optional[dict]] = [None] * len(bodies)

        def one(i: int) -> None:
            status, _, payload = self.dispatch(bodies[i], ctypes[i])
            item = {"status": status,
                    "body": payload.decode("utf-8") if isinstance(payload, bytes) else json.dumps(payload)}
            if isinstance(payload, dict) and "reason" in payload:
                item["reason"] = payload["reason"]
            results[i] = item

        threads = [threading.Thread(target=one, args=(i,), daemon=True, name="vitax-torch-router-batch")
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return 200, {}, {"results": results}

    @staticmethod
    def _request_topk(body: bytes, content_type: str):
        """The topk part of the cache key: a JSON body's own, else "default"."""
        if content_type and "application/json" in content_type:
            try:
                topk = json.loads(body.decode("utf-8")).get("topk")
                if topk is not None:
                    return int(topk)
            except Exception:  # vtx: ignore[VTX106] a malformed body keys as default; the replica 400s it
                pass
        return "default"

    def _dispatch_direct(self, body: bytes, content_type: str) -> Tuple[int, dict, object]:
        """One request's attempts: least-loaded pick, one retry elsewhere,
        hedging, breaker and retry-budget containment."""
        exclude: set = set()
        for attempt in range(DISPATCH_ATTEMPTS):
            replica = self._pick(exclude)
            if replica is None:
                break
            if attempt == 0 and self.hedge_after_ms > 0:
                outcome = self._attempt_hedged(replica, body, content_type, exclude)
            else:
                outcome = self._attempt(replica, body, content_type)
            if outcome["kind"] == "response":
                return self._finish(outcome)
            exclude.add(replica.name)
            self._event("dispatch_retry", replica=replica.name, attempt=attempt, detail=outcome["detail"])
            if attempt + 1 < DISPATCH_ATTEMPTS:
                if not self.budget.withdraw():
                    self._event("retry_budget", event="exhausted", replica=replica.name)
                    self.metrics.error()
                    return 503, {"Retry-After": "1"}, {"error": "retry budget exhausted",
                                                       "reason": "retry_budget_exhausted"}
                self.metrics.retry()
        self.metrics.error()
        return 503, {"Retry-After": "1"}, {"error": "dispatch failed on all replicas", "reason": "dispatch_failed"}

    def _breaker(self, name: str) -> CircuitBreaker:
        with self._breaker_lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(name, fail_threshold=self.breaker_threshold, cooldown_s=self.breaker_cooldown_s,
                                    on_event=lambda p: self._event("breaker", **p))
                self._breakers[name] = br
            return br

    def _blocked_names(self) -> set:
        """Replicas whose breaker refuses a dispatch now."""
        with self._breaker_lock:
            items = list(self._breakers.items())
        return {name for name, br in items if not br.eligible()}

    def _pick(self, exclude: set):
        """The least-loaded READY replica whose breaker admits a dispatch,
        its reservation (the half-open probe) taken."""
        skip = set(exclude)
        while True:
            replica = self.manager.acquire(exclude=skip | self._blocked_names())
            if replica is None:
                return None
            if self._breaker(replica.name).begin():
                return replica
            self.manager.release(replica, counted=False)      # lost a probe race: hand it back uncharged
            skip.add(replica.name)

    def _attempt(self, replica, body: bytes, content_type: str) -> dict:
        """One dispatch to one replica (its breaker reservation held):
        {"kind": "response", ...} for what the client should see (200,
        429, 4xx), {"kind": "failed", "detail": ...} to retry elsewhere.
        Per-attempt accounting here, per-request counters in _finish()."""
        breaker = self._breaker(replica.name)
        t0 = time.monotonic()
        try:
            faults.fire("router_dispatch")
            req = urllib.request.Request(replica.url + "/predict", data=body,
                                         headers={"Content-Type": content_type or "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=self.request_timeout_s) as resp:
                out = resp.read()
            latency = time.monotonic() - t0
            self.manager.release(replica, latency_s=latency, ok=True)
            breaker.record_success()
            if self.admission is not None:
                self.admission.observe(latency)
            return {"kind": "response", "status": 200, "headers": {}, "payload": out, "latency": latency,
                    "replica": replica.name}
        except urllib.error.HTTPError as e:
            payload = self._json_body(e)
            if e.code == 503 and payload.get("reason") == "queue_full":
                # the replica answered: its backpressure becomes the fleet's 429
                self.manager.release(replica, ok=False)
                breaker.record_success()
                retry_hdr = e.headers.get("Retry-After", "1") if e.headers else "1"
                return {"kind": "response", "status": 429, "headers": {"Retry-After": retry_hdr},
                        "payload": {"error": "shed: replica queue full", "reason": "replica_queue_full"},
                        "shed": True, "replica": replica.name}
            if 400 <= e.code < 500:
                # the client's fault: the replica's verdict, never retried
                self.manager.release(replica, ok=False)
                breaker.record_success()
                return {"kind": "response", "status": e.code, "headers": {},
                        "payload": payload or {"error": f"replica answered {e.code}"}, "client_error": True,
                        "replica": replica.name}
            detail = f"HTTP {e.code}"
        except Exception as e:  # noqa: BLE001 - refused, timeout, reset
            detail = f"{type(e).__name__}: {e}"
        self.manager.release(replica, ok=False)
        breaker.record_failure()
        return {"kind": "failed", "detail": detail, "replica": replica.name}

    def _hedge_delay_s(self) -> float:
        """The rolling p99, floored at hedge_after_ms."""
        return max(self.metrics.p99() or 0.0, self.hedge_after_ms / 1000.0)

    def _attempt_hedged(self, primary, body: bytes, content_type: str, exclude: set) -> dict:
        """The first attempt with a hedge: past the hedge delay the same
        request goes to a second replica (budget permitting); the first
        response wins and the loser's thread still does its accounting."""
        results: queue_mod.Queue = queue_mod.Queue()

        def run(replica, is_hedge: bool) -> None:
            out = self._attempt(replica, body, content_type)
            out["hedge"] = is_hedge
            results.put(out)

        threading.Thread(  # vtx: ignore[VTX205] fire-and-forget: loser self-accounts in _attempt, result abandoned
            target=run, args=(primary, False), daemon=True, name="vitax-torch-hedge-primary").start()
        launched = 1
        got: list = []
        try:
            got.append(results.get(timeout=self._hedge_delay_s()))
        except queue_mod.Empty:
            if self.budget.withdraw():
                hedge_replica = self._pick(set(exclude) | {primary.name})
                if hedge_replica is not None:
                    self.metrics.hedge()
                    self._event("hedge", event="fired", primary=primary.name, replica=hedge_replica.name)
                    threading.Thread(  # vtx: ignore[VTX205] fire-and-forget: see the primary-attempt thread above
                        target=run, args=(hedge_replica, True), daemon=True,
                        name="vitax-torch-hedge-secondary").start()
                    launched = 2
        deadline = time.monotonic() + self.request_timeout_s + 1.0
        while len(got) < launched and not any(o["kind"] == "response" for o in got):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                got.append(results.get(timeout=remaining))
            except queue_mod.Empty:
                break
        winner = next((o for o in got if o["kind"] == "response"), None)
        if winner is not None:
            if winner.get("hedge"):
                self.metrics.hedge_win()
                self._event("hedge", event="win", replica=winner["replica"])
            return winner
        for o in got:
            exclude.add(o["replica"])
        details = "; ".join(o["detail"] for o in got)
        return {"kind": "failed", "replica": primary.name, "detail": details or "hedged attempts timed out"}

    def _finish(self, outcome: dict) -> Tuple[int, dict, object]:
        """Per-request bookkeeping, once a client response."""
        status = outcome["status"]
        if status == 200:
            self.metrics.observe(outcome["latency"])
        elif outcome.get("shed"):
            self.metrics.shed()
            if self.admission is not None:
                self.admission.record_shed(reason="replica_queue_full", replica=outcome["replica"])
        else:
            self.metrics.error()
        return status, outcome["headers"], outcome["payload"]

    def _attempt_batch(self, items: List[dict]):
        """One /predict_batch carrying a composed group to one replica: a
        (status, headers, payload) a item, "unsupported" where the replica
        has no /predict_batch (404/501), or None on a failed dispatch (the
        composer re-drives the items directly either way)."""
        replica = self._pick(set())
        if replica is None:
            return None
        breaker = self._breaker(replica.name)
        wire = json.dumps({"items": [base64.b64encode(it["body"]).decode("ascii") for it in items],
                           "content_types": [it["content_type"] or "application/octet-stream"
                                             for it in items]}).encode("utf-8")
        t0 = time.monotonic()
        try:
            faults.fire("router_dispatch")
            req = urllib.request.Request(replica.url + "/predict_batch", data=wire,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.request_timeout_s) as resp:
                out = json.load(resp)
            latency = time.monotonic() - t0
            results = out.get("results")
            if not isinstance(results, list) or len(results) != len(items):
                self.manager.release(replica, ok=False)
                breaker.record_failure()
                return None
            self.manager.release(replica, latency_s=latency, ok=True)
            breaker.record_success()
            if self.admission is not None:
                self.admission.observe(latency)       # one sample a group: a group is one round trip
            outcomes = []
            for res in results:
                status = int(res.get("status", 500))
                payload = str(res.get("body", "")).encode("utf-8")
                if status == 200:
                    self.metrics.observe(latency)
                    outcomes.append((200, {}, payload))
                elif status == 503 and res.get("reason") == "queue_full":
                    self.metrics.shed()
                    if self.admission is not None:
                        self.admission.record_shed(reason="replica_queue_full", replica=replica.name)
                    outcomes.append((429, {"Retry-After": "1"}, {"error": "shed: replica queue full",
                                                                 "reason": "replica_queue_full"}))
                else:
                    self.metrics.error()
                    outcomes.append((status, {}, payload or {"error": f"replica answered {status}"}))
            return outcomes
        except urllib.error.HTTPError as e:
            if e.code in (404, 501):
                self.manager.release(replica, counted=False)
                breaker.record_success()
                return "unsupported"
            detail = f"HTTP {e.code}"
        except Exception as e:  # noqa: BLE001 - refused, timeout, reset
            detail = f"{type(e).__name__}: {e}"
        self.manager.release(replica, ok=False)
        breaker.record_failure()
        self._event("dispatch_retry", replica=replica.name, attempt="batch", detail=detail)
        return None

    @staticmethod
    def _json_body(e: urllib.error.HTTPError) -> dict:
        try:
            payload = json.loads(e.read().decode("utf-8"))
            return payload if isinstance(payload, dict) else {}
        except Exception:  # noqa: BLE001 - a non-JSON error body
            return {}

    # -- observability -----------------------------------------------------------

    def healthz(self) -> dict:
        replicas = self.manager.snapshot()
        return {"status": "ok", "ready": self.manager.ready_count() > 0,
                "replicas": {name: snap["state"] for name, snap in replicas.items()}}

    def fleet_metrics(self) -> dict:
        replicas = self.manager.snapshot()
        for r in self.manager.ready_replicas():       # best effort: a replica dying mid-scrape is skipped
            try:
                replicas[r.name]["server"] = self.manager._http_get(r.url + "/metrics",
                                                                    self.manager.health_timeout_s)
            except Exception:  # vtx: ignore[VTX106] the scrape is best effort
                pass
        snap = self.metrics.snapshot()
        snap["request_timeout_s"] = self.request_timeout_s
        snap["fleet"] = {"size": len(replicas), "ready": self.manager.ready_count(),
                         "warming": self.manager.warming_count(), "in_flight": self.manager.total_in_flight(),
                         "replica_restarts": self.manager.restart_total, "degraded": self.manager.degraded_count(),
                         "degraded_seconds": self.manager.degraded_seconds()}
        reporting = [r["server"] for r in replicas.values() if "server" in r and "param_bytes" in r["server"]]
        if reporting:
            snap["fleet"]["param_bytes"] = sum(int(s["param_bytes"]) for s in reporting)
            snap["fleet"]["weights_dtypes"] = sorted({str(s.get("weights_dtype", "")) for s in reporting})
            snap["fleet"]["act_quants"] = sorted({str(s.get("act_quant", "off")) for s in reporting})
            snap["fleet"]["fused_dequants"] = sorted({str(bool(s.get("fused_dequant", False))) for s in reporting})
        snap["replicas"] = replicas
        with self._breaker_lock:
            breakers = list(self._breakers.items())
        snap["breakers"] = {name: br.snapshot() for name, br in breakers}
        snap["breaker_opens"] = sum(br.opens_total + br.reopens_total for _, br in breakers)
        snap["retry_budget"] = self.budget.snapshot()
        if self.admission is not None:
            snap["admission"] = self.admission.snapshot()
        if self.cache is not None:
            snap["cache"] = self.cache.snapshot()
            snap["cache_hits"] = snap["cache"]["hits_total"]
            snap["cache_hit_rate"] = snap["cache"]["hit_rate"]
        if self.autoscaler is not None:
            snap["autoscale"] = self.autoscaler.snapshot()
            snap["scale_events"] = snap["autoscale"]["scale_out_total"] + snap["autoscale"]["scale_in_total"]
        if self._composer is not None:
            snap["continuous_batching"] = self._composer.snapshot()
        return snap

    def close(self) -> None:
        """Stop the batch composer (the manager and autoscaler stop themselves)."""
        if self._composer is not None:
            self._composer.close()

    def _event(self, kind: str, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event(kind, **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill dispatch
                pass


class BatchComposer:
    """Cross-replica continuous batching. Least-loaded routing spreads
    concurrent arrivals over the replicas, so each replica's batcher would
    flush them one at a time; the composer holds them up to `window_ms` at
    the router (the window opens at the first arrival, closes when full)
    and sends the group as one /predict_batch to one replica. Each item's
    answer is the body a lone /predict gives. A replica without
    /predict_batch disables composition; a failed group is re-driven item
    by item through _dispatch_direct (its retry and breakers)."""

    def __init__(self, router: Router, window_ms: float, batch_max: int):
        if window_ms <= 0 or batch_max < 1:
            raise ValueError(f"window_ms {window_ms} must be > 0 and batch_max {batch_max} >= 1")
        self.router = router
        self.window_s = window_ms / 1000.0
        self.batch_max = batch_max
        self._cond = threading.Condition()
        self._pending: List[dict] = []           # guarded by _cond, as the counters
        self._closed = False
        self._disabled = False
        self.batches_total = 0
        self.items_total = 0
        self.fallback_items_total = 0
        self._fills = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._run, daemon=True, name="vitax-torch-batch-composer")
        self._worker.start()

    def submit(self, body: bytes, content_type: str) -> Tuple[int, dict, object]:
        """Park one request for grouping and block until its group settles it."""
        item = {"body": body, "content_type": content_type, "done": threading.Event(), "result": None}
        with self._cond:
            bypass = self._disabled or self._closed
            if not bypass:
                self._pending.append(item)
                self._cond.notify()
        if bypass:
            return self.router._dispatch_direct(body, content_type)
        if not item["done"].wait(timeout=self.window_s + self.router.request_timeout_s + 5.0):
            self.router.metrics.error()
            return 503, {"Retry-After": "1"}, {"error": "batched dispatch timed out", "reason": "dispatch_failed"}
        return item["result"]

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return              # close() settles what is still parked
                deadline = time.monotonic() + self.window_s
                while len(self._pending) < self.batch_max and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                group = self._pending[:self.batch_max]
                del self._pending[:len(group)]
                self.batches_total += 1
                self.items_total += len(group)
                self._fills.append(len(group) / self.batch_max)
            self._dispatch_group(group)          # outside the lock: it blocks

    def _dispatch_group(self, group: List[dict]) -> None:
        with self._cond:
            disabled = self._disabled
        outcomes = None if disabled else self.router._attempt_batch(group)
        if outcomes == "unsupported":
            with self._cond:
                self._disabled = True
            self.router._event("continuous_batching", event="disabled", detail="replica lacks /predict_batch")
            outcomes = None
        if outcomes is None:
            self._fallback(group)
            return
        for item, outcome in zip(group, outcomes):
            item["result"] = outcome
            item["done"].set()

    def _fallback(self, group: List[dict]) -> None:
        """Settle each item of a failed group through the direct path."""
        with self._cond:
            self.fallback_items_total += len(group)

        def run(item: dict) -> None:
            item["result"] = self.router._dispatch_direct(item["body"], item["content_type"])
            item["done"].set()

        threads = [threading.Thread(target=run, args=(it,), daemon=True, name="vitax-torch-batch-fallback")
                   for it in group]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.router.request_timeout_s + 5.0)   # a straggler still settles its own item

    def snapshot(self) -> dict:
        with self._cond:
            fills = sorted(self._fills)
            return {"window_ms": round(self.window_s * 1000.0, 3), "batch_max": self.batch_max,
                    "disabled": self._disabled, "batches_total": self.batches_total,
                    "items_total": self.items_total, "fallback_items_total": self.fallback_items_total,
                    "batch_fill_p50": _percentile(fills, 0.50), "batch_fill_p95": _percentile(fills, 0.95)}

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=10.0)
        with self._cond:
            leftovers, self._pending = self._pending, []
        for item in leftovers:
            item["result"] = (503, {"Retry-After": "1"}, {"error": "router shutting down",
                                                          "reason": "dispatch_failed"})
            item["done"].set()


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - access logging off
            pass

        def _reply(self, code: int, payload, headers=None) -> None:
            body = payload if isinstance(payload, bytes) else json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path == "/healthz":
                self._reply(200, router.healthz())
            elif self.path == "/metrics":
                self._reply(200, router.fleet_metrics())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path in ("/fleet/adopt", "/fleet/release"):
                self._fleet_hook()
                return
            if self.path not in ("/predict", "/predict_batch"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path == "/predict_batch":
                code, headers, payload = router.dispatch_batch(body)
            else:
                code, headers, payload = router.dispatch(body, self.headers.get("Content-Type", ""))
            self._reply(code, payload, headers=headers)

        def _fleet_hook(self) -> None:
            """The arbiter's control plane: adopt a borrowed host's replica, or
            drain it back out, through the hooks the fleet CLI installs."""
            hook = router.fleet_adopt_fn if self.path == "/fleet/adopt" else router.fleet_release_fn
            if hook is None:
                self._reply(501, {"error": f"router has no arbiter hooks ({self.path})"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad JSON body: {e}"})
                return
            url = payload.get("url", "")
            if not url:
                self._reply(400, {"error": "missing \"url\""})
                return
            try:
                out = hook(url)
            except Exception as e:  # noqa: BLE001 - a hook's failure goes back to the arbiter
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, out if isinstance(out, dict) else {"ok": True})

    return Handler


def start_router(router: Router, port: int):
    """Bind the fleet's front door on a background thread; returns the
    httpd (server_address[1] is the bound port, 0 = ephemeral)."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(router))
    httpd.daemon_threads = True
    threading.Thread(  # vtx: ignore[VTX205] stop_router's httpd.shutdown() ends serve_forever
        target=httpd.serve_forever, daemon=True, name="vitax-torch-fleet-router").start()
    return httpd


def stop_router(httpd, router: Optional[Router] = None) -> None:
    httpd.shutdown()
    httpd.server_close()
    if router is not None:
        router.close()
