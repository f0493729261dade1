"""HTTP front end over the engine + batcher (vitax/serve/server.py).

Endpoints, with the JAX server's JSON keys:
- POST /predict: the body is raw image bytes, or JSON {"image": <base64
  image bytes>, "topk": <optional, <= --serve_topk>}; the image runs the
  eval transform (vitax_torch/data/transforms.py ValTransform), then the
  dynamic batcher; the reply is {"classes", "probs", "latency_ms"}.
  JPEG bodies take the native decoder (data/native.py) where it builds,
  binary PPM (P6, maxval 255) bodies are decoded with numpy, and every
  other format goes through PIL, imported at use.
- POST /predict_batch: {"items": [<base64 body>, ...], "content_types":
  [...]}; every item is submitted before any is awaited, so the group
  lands in one bucket. The reply is {"results": [{"status", "body"}, ...]}.
- GET /healthz: live once bound; ready after warmup and while not draining.
- GET /metrics: request counters, latency percentiles, queue and batch
  accounting, brownout state and the weight footprint.

A full batcher queue answers 503 (reason "queue_full"); sustained queue
pressure enters brownout (topk clamped to 1, shorter batcher deadline);
SIGTERM drains: stop accepting, answer what is in flight, flush, exit 0.
"""

from __future__ import annotations

import base64
import io
import json
import signal
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from vitax_torch.config import Config
from vitax_torch.data import native
from vitax_torch.data.imagefolder import DecodeCounts
from vitax_torch.data.transforms import ValTransform
from vitax_torch.serve.batcher import DynamicBatcher, QueueFull
from vitax_torch.serve.engine import InferenceEngine, next_bucket
from vitax_torch.utils.logging import master_print


class ServeMetrics:
    """Thread-safe aggregate counters behind GET /metrics."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests_total = 0
        self.errors_total = 0
        self._latency = deque(maxlen=window)
        self._wait = deque(maxlen=window)
        self._occupancy = deque(maxlen=window)  # batch_size / bucket
        self._times = deque(maxlen=window)      # completion timestamps

    def observe(self, latency_s: float, queue_wait_s: float, batch_size: int, bucket: int) -> None:
        with self._lock:
            self.requests_total += 1
            self._latency.append(latency_s)
            self._wait.append(queue_wait_s)
            self._occupancy.append(batch_size / max(bucket, 1))
            self._times.append(time.time())

    def error(self) -> None:
        with self._lock:
            self.errors_total += 1

    @staticmethod
    def _pct(sorted_vals, q: float) -> Optional[float]:
        if not sorted_vals:
            return None
        pos = (len(sorted_vals) - 1) * q
        lo = int(pos)
        hi = min(lo + 1, len(sorted_vals) - 1)
        frac = pos - lo
        return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latency)
            waits = list(self._wait)
            occ = list(self._occupancy)
            times = list(self._times)
            total, errors = self.requests_total, self.errors_total
        now = time.time()
        recent = [t for t in times if now - t <= 60.0]
        return {
            "requests_total": total,
            "errors_total": errors,
            "uptime_s": round(now - self.started, 3),
            "requests_per_sec": round(total / max(now - self.started, 1e-9), 3),
            "requests_per_sec_60s": round(len(recent) / 60.0, 3),
            "latency_s_p50": self._pct(lat, 0.50),
            "latency_s_p95": self._pct(lat, 0.95),
            "latency_s_p99": self._pct(lat, 0.99),
            "queue_wait_s_mean": round(sum(waits) / len(waits), 6) if waits else None,
            "batch_occupancy_mean": round(sum(occ) / len(occ), 4) if occ else None,
        }


class BrownoutController:
    """Hysteretic degraded mode keyed on batcher queue depth: depth at or
    above enter_depth for `dwell_s` enters DEGRADED, depth at or below
    exit_depth for the same dwell exits. Disabled when queue_max or
    enter_frac is 0. `clock` is injectable for tests."""

    def __init__(self, queue_max: int, enter_frac: float, exit_frac: float, dwell_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_enter: Optional[Callable[[], None]] = None,
                 on_exit: Optional[Callable[[float], None]] = None):
        self.enabled = queue_max > 0 and enter_frac > 0
        self.enter_depth = enter_frac * queue_max
        self.exit_depth = exit_frac * queue_max
        self.dwell_s = dwell_s
        self._clock = clock
        self._on_enter = on_enter
        self._on_exit = on_exit
        self._lock = threading.Lock()
        self.degraded = False
        self._streak_since: Optional[float] = None
        self._entered_at: Optional[float] = None
        self.enters_total = 0
        self._degraded_s = 0.0

    def observe(self, depth: int, now: Optional[float] = None) -> bool:
        """Feed one queue-depth sample; returns the degraded state."""
        if not self.enabled:
            return False
        now = self._clock() if now is None else now
        transition = None
        with self._lock:
            pressure = depth >= self.enter_depth if not self.degraded else depth <= self.exit_depth
            if not pressure:
                self._streak_since = None
            else:
                if self._streak_since is None:
                    self._streak_since = now
                if now - self._streak_since >= self.dwell_s:
                    self._streak_since = None
                    if not self.degraded:
                        self.degraded = True
                        self.enters_total += 1
                        self._entered_at = now
                        transition = ("enter", depth)
                    else:
                        self.degraded = False
                        episode_s = now - (self._entered_at or now)
                        self._degraded_s += episode_s
                        self._entered_at = None
                        transition = ("exit", episode_s)
            degraded = self.degraded
        if transition is not None:   # callbacks outside the lock: they touch the batcher
            kind, arg = transition
            if kind == "enter" and self._on_enter is not None:
                self._on_enter()
            elif kind == "exit" and self._on_exit is not None:
                self._on_exit(arg)
        return degraded

    def degraded_seconds(self, now: Optional[float] = None) -> float:
        """Total time spent degraded, including the live episode."""
        with self._lock:
            total = self._degraded_s
            if self._entered_at is not None:
                total += (self._clock() if now is None else now) - self._entered_at
            return total


def decode_ppm(raw: bytes) -> Optional[np.ndarray]:
    """A binary PPM (P6, maxval 255) body as uint8 (H, W, 3), or None for
    any other format. Header: "P6", width, height, maxval as decimal tokens
    separated by whitespace (with "#" comments), one whitespace byte, then
    the pixels row by row."""
    if not raw.startswith(b"P6"):
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(raw) and (raw[pos:pos + 1].isspace() or raw[pos:pos + 1] == b"#"):
            if raw[pos:pos + 1] == b"#":
                end = raw.find(b"\n", pos)
                pos = len(raw) if end < 0 else end + 1
            else:
                pos += 1
        start = pos
        while pos < len(raw) and raw[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("malformed PPM header")
        fields.append(int(raw[start:pos]))
    if not raw[pos:pos + 1].isspace():
        raise ValueError("malformed PPM header")
    width, height, maxval = fields
    if maxval != 255:
        return None
    need = width * height * 3
    if width < 1 or height < 1 or len(raw) - pos - 1 < need:
        raise ValueError(f"PPM body holds fewer than {width}x{height}x3 pixel bytes")
    return np.frombuffer(raw, np.uint8, need, pos + 1).reshape(height, width, 3)


def decode_image_bytes(raw: bytes, transform: ValTransform, counts: Optional[DecodeCounts] = None) -> np.ndarray:
    """One /predict image body -> transformed (S, S, 3) array. A JPEG body
    takes the native decoder with the eval transform's parameters, where
    the library builds (vitax/serve/server.py:256); binary PPM is parsed
    with numpy; anything else, or a JPEG the decoder refuses, goes through
    PIL. `counts` gets one under the path taken: native, ppm or pil."""
    path = "pil"
    img = None
    if native.is_jpeg_bytes(raw) and native.available():
        img = native.process_bytes(raw, transform.native_params(0, 0, 0), transform.image_size,
                                   transform.resize_to, normalize=transform.normalize)
        path = "native" if img is not None else path
    if img is None:
        arr = decode_ppm(raw)
        if arr is not None:
            path = "ppm"
        else:
            from PIL import Image
            with Image.open(io.BytesIO(raw)) as pil:
                arr = pil.convert("RGB")
        img = transform(arr)
    if counts is not None:
        counts.add(path, jpeg=native.is_jpeg_bytes(raw))
    return img


class ServeContext:
    """Everything a handler thread needs, wired once at startup."""

    def __init__(self, cfg: Config, engine: InferenceEngine):
        self.cfg = cfg
        self.engine = engine
        self.metrics = ServeMetrics()
        self.request_timeout_s = float(cfg.serve_request_timeout_s)
        self.draining = False
        self._inflight = 0
        self._flight_cond = threading.Condition()
        self.transform = ValTransform(cfg.image_size)
        self.decoded = DecodeCounts()
        self.batcher = DynamicBatcher(
            engine.predict, max_batch=cfg.serve_max_batch, max_wait_ms=cfg.max_batch_wait_ms,
            bucket_of=lambda n: next_bucket(n, engine.buckets), queue_max=cfg.serve_queue_max)
        self.brownout = BrownoutController(
            queue_max=cfg.serve_queue_max, enter_frac=cfg.serve_brownout_enter_frac,
            exit_frac=cfg.serve_brownout_exit_frac, dwell_s=cfg.serve_brownout_dwell_s,
            on_enter=lambda: self.batcher.set_max_wait_ms(cfg.serve_brownout_wait_ms),
            on_exit=lambda _s: self.batcher.set_max_wait_ms(cfg.max_batch_wait_ms))

    def degraded(self) -> bool:
        """Current brownout verdict, refreshed with a live depth sample."""
        return self.brownout.observe(self.batcher.queue_depth())

    def is_ready(self) -> bool:
        return not self.draining and self.engine.ready

    def enter_request(self) -> bool:
        """Admit one request into the in-flight set; False when warming or draining."""
        with self._flight_cond:
            if not self.is_ready():
                return False
            self._inflight += 1
            return True

    def exit_request(self) -> None:
        with self._flight_cond:
            self._inflight -= 1
            self._flight_cond.notify_all()

    def inflight(self) -> int:
        with self._flight_cond:
            return self._inflight

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until every in-flight request is answered; False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._flight_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._flight_cond.wait(timeout=remaining)
            return True

    def decode(self, body: bytes, content_type: str):
        """(uint8 HWC image, requested topk) from a /predict body."""
        topk = self.engine.topk
        if "application/json" in content_type:
            payload = json.loads(body.decode("utf-8"))
            raw = base64.b64decode(payload["image"])
            if "topk" in payload:
                topk = int(payload["topk"])
                if not 1 <= topk <= self.engine.topk:
                    raise ValueError(f"topk must be in [1, {self.engine.topk}] "
                                     f"(--serve_topk caps the served top-k)")
        else:
            raw = body
        return decode_image_bytes(raw, self.transform, self.decoded), topk

    def close(self) -> None:
        self.batcher.close()


def _answer(result, topk: int, t0: float) -> dict:
    return {"classes": [int(c) for c in result.classes[:topk]],
            "probs": [float(p) for p in result.probs[:topk]],
            "latency_ms": round((time.time() - t0) * 1000.0, 3)}


def _make_handler(ctx: ServeContext):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - access logging off
            pass

        def _reply(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "ready": ctx.is_ready(),
                    "draining": ctx.draining,
                    "degraded": ctx.degraded(),
                    "degraded_seconds": round(ctx.brownout.degraded_seconds(), 3),
                    "buckets": list(ctx.engine.buckets),
                    "topk": ctx.engine.topk,
                    "compile_count": ctx.engine.compile_count,
                })
            elif self.path == "/metrics":
                snap = ctx.metrics.snapshot()
                snap.update({
                    "queue_depth": ctx.batcher.queue_depth(),
                    "queue_max": ctx.batcher.queue_max,
                    "batches_flushed": ctx.batcher.batches_flushed,
                    "compile_count": ctx.engine.compile_count,
                    "request_timeout_s": ctx.request_timeout_s,
                    "ready": ctx.is_ready(),
                    "draining": ctx.draining,
                    "degraded": ctx.degraded(),
                    "degraded_seconds": round(ctx.brownout.degraded_seconds(), 3),
                    "brownout_enters": ctx.brownout.enters_total,
                    "weights_dtype": ctx.engine.weights_dtype,
                    "param_bytes": ctx.engine.param_bytes(),
                    "act_quant": ctx.engine.act_quant,
                    "fused_dequant": ctx.engine.fused_dequant,
                })
                self._reply(200, snap)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/predict", "/predict_batch"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            if not ctx.enter_request():
                reason = "draining" if ctx.draining else "warming_up"
                ctx.metrics.error()
                self._reply(503, {"error": f"not ready: {reason}", "reason": reason},
                            headers={"Retry-After": "1"})
                return
            try:
                if self.path == "/predict_batch":
                    self._predict_batch()
                else:
                    self._predict()
            finally:
                ctx.exit_request()

        def _predict(self) -> None:
            t0 = time.time()
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                image, topk = ctx.decode(body, self.headers.get("Content-Type", ""))
            except Exception as e:  # noqa: BLE001 - client error, not ours
                ctx.metrics.error()
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if ctx.degraded():
                topk = 1
            try:
                fut = ctx.batcher.submit(image)
            except QueueFull as e:
                ctx.metrics.error()
                self._reply(503, {"error": f"overloaded: {e}", "reason": "queue_full"},
                            headers={"Retry-After": "1"})
                return
            try:
                result = fut.result(timeout=ctx.request_timeout_s)
            except Exception as e:  # noqa: BLE001 - inference failure or timeout
                ctx.metrics.error()
                self._reply(503, {"error": f"inference failed: {e}"})
                return
            ctx.metrics.observe(time.time() - t0, result.queue_wait_s, result.batch_size, result.bucket)
            self._reply(200, _answer(result, topk, t0))

        def _predict_batch(self) -> None:
            t0 = time.time()
            try:
                wire = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))).decode("utf-8"))
                bodies = [base64.b64decode(s) for s in wire["items"]]
                ctypes = wire.get("content_types") or [""] * len(bodies)
                if len(ctypes) != len(bodies):
                    raise ValueError("content_types/items length mismatch")
            except Exception as e:  # noqa: BLE001 - client error, not ours
                ctx.metrics.error()
                self._reply(400, {"error": f"bad batch request: {e}"})
                return
            results = [None] * len(bodies)
            waiting = []  # (index, topk, future)
            for i, (body, ctype) in enumerate(zip(bodies, ctypes)):
                try:
                    image, topk = ctx.decode(body, ctype)
                except Exception as e:  # noqa: BLE001 - client error
                    ctx.metrics.error()
                    results[i] = {"status": 400, "body": json.dumps({"error": f"bad request: {e}"})}
                    continue
                if ctx.degraded():
                    topk = 1
                try:
                    waiting.append((i, topk, ctx.batcher.submit(image)))
                except QueueFull as e:
                    ctx.metrics.error()
                    results[i] = {"status": 503, "reason": "queue_full", "body": json.dumps(
                        {"error": f"overloaded: {e}", "reason": "queue_full"})}
            for i, topk, fut in waiting:
                try:
                    result = fut.result(timeout=ctx.request_timeout_s)
                except Exception as e:  # noqa: BLE001
                    ctx.metrics.error()
                    results[i] = {"status": 503, "body": json.dumps({"error": f"inference failed: {e}"})}
                    continue
                ctx.metrics.observe(time.time() - t0, result.queue_wait_s, result.batch_size, result.bucket)
                results[i] = {"status": 200, "body": json.dumps(_answer(result, topk, t0))}
            self._reply(200, {"results": results})

    return Handler


def start_server(cfg: Config, engine: InferenceEngine, port: Optional[int] = None):
    """Engine -> listening server on a background thread. Returns (httpd,
    ctx); httpd.server_address[1] is the bound port (port=0 for an
    ephemeral one). `stop_server(httpd, ctx)` shuts it down."""
    ctx = ServeContext(cfg, engine)
    httpd = ThreadingHTTPServer(("0.0.0.0", cfg.serve_port if port is None else port), _make_handler(ctx))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True, name="vitax-torch-http").start()
    master_print(f"serve: listening on :{httpd.server_address[1]} (buckets {list(engine.buckets)}, "
                 f"wait {cfg.max_batch_wait_ms}ms, top-{engine.topk})")
    return httpd, ctx


def stop_server(httpd, ctx: ServeContext) -> None:
    httpd.shutdown()
    httpd.server_close()
    ctx.close()


def drain(httpd, ctx: ServeContext, timeout_s: float = 30.0) -> bool:
    """Graceful shutdown: mark draining (new requests 503), stop accepting,
    wait for in-flight requests, flush the batcher. True when the in-flight
    set emptied inside `timeout_s`."""
    with ctx._flight_cond:
        ctx.draining = True
    httpd.shutdown()
    idle = ctx.wait_idle(timeout_s)
    httpd.server_close()
    ctx.close()
    if not idle:
        master_print(f"serve: drain timed out after {timeout_s:.0f}s with {ctx.inflight()} in flight")
    return idle


def serve_forever(cfg: Config, engine: InferenceEngine) -> None:
    """Blocking entry point: bind first (so /healthz answers while the
    buckets warm), warm up, serve until SIGTERM/SIGINT, then drain."""
    httpd, ctx = start_server(cfg, engine)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    if not engine.ready:
        engine.warmup()
    while not stop.wait(timeout=0.5):
        pass
    master_print("serve: draining (SIGTERM/SIGINT)")
    drain(httpd, ctx)
