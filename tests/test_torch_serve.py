"""vitax_torch serving: the port's engine against the JAX engine on one npz
export, the HTTP round trip on the CPU, image decoding and transform parity
with the JAX package's PIL path, the batcher and brownout contracts, the
quantized-export refusal, and the isolation guards (no jax / flax /
ml_dtypes / vitax import in the port, no CPU fallback from the card)."""

import ast
import base64
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from vitax_torch.checkpoint.consolidate import load_npz_raw
from vitax_torch.config import Config
from vitax_torch.data.transforms import ValTransform
from vitax_torch.serve import (BrownoutController, DynamicBatcher, InferenceEngine, QueueFull,
                               start_server, stop_server)
from vitax_torch.serve.server import decode_image_bytes, decode_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4,
            serve_max_batch=2, serve_topk=3, max_batch_wait_ms=10.0)


def export(tmp_dir, dtype: str) -> str:
    """A save_npz export of a JAX init whose head is scaled 50x, so the
    classes are well apart and top-k order is not decided by rounding."""
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import flatten_tree, save_npz
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    cfg = JaxConfig(**TINY, dtype="float32").validate()
    params = jax_build_model(cfg).init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), True)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    flat["params/head/kernel"] = flat["params/head/kernel"] * 50.0
    path = os.path.join(tmp_dir, f"export_{dtype}.npz")
    save_npz(path, flat, dtype=None if dtype == "float32" else dtype)
    return path


def ppm(arr: np.ndarray, comment: bool = False) -> bytes:
    h, w, _ = arr.shape
    head = f"P6\n{'# made by a test' + chr(10) if comment else ''}{w} {h}\n255\n"
    return head.encode() + arr.tobytes()


def png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "PNG")
    return buf.getvalue()


def uint8_images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# --- the port's engine against the JAX engine -------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_jax_engine_on_one_export(devices8, tmp_path, dtype):
    """Same npz, same uint8 batch: top-k ids equal; probs within 1e-5 at f32
    and 2e-2 at bf16 (bf16 rounds activations at other points in the two
    frameworks)."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    path = export(str(tmp_path), dtype)
    jeng = JaxEngine.from_npz(JaxConfig(**TINY, dtype=dtype, serve_port=0).validate(), path)
    jeng.warmup()
    teng = InferenceEngine.from_npz(Config(**TINY, dtype=dtype).validate(), path, "cpu")
    teng.warmup()
    assert teng.buckets == jeng.buckets == (1, 2)
    assert teng.compile_count == jeng.compile_count == 2
    assert teng.weights_dtype == jeng.weights_dtype == dtype
    assert teng.param_bytes() == jeng.param_bytes()
    x = uint8_images(3, 16, seed=7)
    for rows in (x[:1], x[1:3]):
        ids_j, p_j = jeng.predict(rows)
        ids_t, p_t = teng.predict(rows)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(p_t, p_j, atol=1e-5 if dtype == "float32" else 2e-2)
        assert ids_t.dtype == np.int32 and p_t.dtype == np.float32


def test_engine_serves_only_warmed_buckets(tmp_path):
    eng = InferenceEngine.from_npz(Config(**TINY, dtype="float32").validate(),
                                   export(str(tmp_path), "float32"), "cpu")
    with pytest.raises(RuntimeError, match="not warmed up"):
        eng.predict(uint8_images(1, 16, 0))
    eng.warmup()
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        eng.predict(uint8_images(3, 16, 0))
    one = eng.predict(uint8_images(1, 16, 1))
    two = eng.predict(np.repeat(uint8_images(1, 16, 1), 2, axis=0))
    np.testing.assert_array_equal(one[0][0], two[0][1])      # padding does not leak across rows


def test_quantized_export_loads(tmp_path):
    """The quantized file an earlier slice refused now loads: int8 codes,
    the float32 scale and the manifest."""
    from vitax.checkpoint.consolidate import save_npz
    path = str(tmp_path / "q.npz")
    save_npz(path, {"params/head/kernel": np.ones((4, 3), np.float32)}, dtype="int8")
    flat, scales, manifest = load_npz_raw(path)
    assert manifest == {"params/head/kernel": "int8"}
    assert flat["params/head/kernel"].dtype == torch.int8 and bool((flat["params/head/kernel"] == 127).all())
    np.testing.assert_array_equal(scales["params/head/kernel"].numpy(), np.full((1, 3), 1 / 127, np.float32))


QUANT_ARMS = [("int8", dict()), ("int8", dict(fused_dequant="on")), ("int8", dict(serve_act_quant="int8")),
              ("float8_e4m3", dict()), ("float8_e4m3", dict(fused_dequant="on"))]


@pytest.mark.parametrize("qdtype,arm", QUANT_ARMS)
def test_quantized_engine_matches_jax_engine(tmp_path, qdtype, arm):
    """One quantized export through both engines at bf16 compute, in the
    three arms: fused_dequant auto (dequantize at use, both sides), on (the
    JAX Pallas kernel in interpret mode against the port's plain version)
    and int8 activations. Top-k ids equal, probs within 5e-3 (bf16 rounds
    activations at other points in the two frameworks, and with int8
    activations vitax's head scales the weight before its product);
    weights_dtype, param_bytes and the /metrics quant fields equal."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    path = export(str(tmp_path), qdtype)
    kw = dict(**TINY, serve_quant_dtype=qdtype, **arm)
    jeng = JaxEngine.from_npz(JaxConfig(**kw, serve_port=0).validate(), path)
    jeng.warmup()
    cfg = Config(**kw, serve_port=0).validate()
    teng = InferenceEngine.from_npz(cfg, path, "cpu")
    teng.warmup()
    assert teng.weights_dtype == jeng.weights_dtype == qdtype
    assert teng.param_bytes() == jeng.param_bytes()
    assert (teng.act_quant, teng.fused_dequant) == (jeng.act_quant, jeng.fused_dequant)
    assert teng.fused_dequant == (arm.get("fused_dequant") == "on")
    assert len(teng.scales) == 4 * TINY["num_blocks"] + 2
    x = uint8_images(3, 16, seed=7)
    for rows in (x[:1], x[1:3]):
        ids_j, p_j = jeng.predict(rows)
        ids_t, p_t = teng.predict(rows)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(p_t, p_j, atol=5e-3)
    httpd, ctx = start_server(cfg, teng, port=0)
    try:
        metrics = http(f"http://127.0.0.1:{httpd.server_address[1]}/metrics")
    finally:
        stop_server(httpd, ctx)
    assert metrics["weights_dtype"] == qdtype and metrics["param_bytes"] == jeng.param_bytes()
    assert metrics["act_quant"] == jeng.act_quant and metrics["fused_dequant"] == jeng.fused_dequant


def test_quant_dtype_flag_asserts_the_manifest(tmp_path):
    with pytest.raises(ValueError, match="no __quant__ manifest"):
        InferenceEngine.from_npz(Config(**TINY, serve_quant_dtype="int8").validate(),
                                 export(str(tmp_path), "float32"), "cpu")
    with pytest.raises(ValueError, match="float8_e4m3"):
        InferenceEngine.from_npz(Config(**TINY, serve_quant_dtype="int8").validate(),
                                 export(str(tmp_path), "float8_e4m3"), "cpu")


def test_bf16_leaves_load_exactly(tmp_path):
    import ml_dtypes
    from vitax.checkpoint.consolidate import save_npz
    flat = {"params/a": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), "step": np.int32(7)}
    path = str(tmp_path / "b.npz")
    save_npz(path, flat, dtype="bfloat16")
    got, scales, manifest = load_npz_raw(path)
    assert not scales and not manifest
    assert got["params/a"].dtype == torch.bfloat16 and got["step"].dtype == torch.int32
    want = flat["params/a"].astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got["params/a"].float().numpy(), want)


# --- images ----------------------------------------------------------------


@pytest.mark.parametrize("comment", [False, True])
def test_ppm_decoder_equals_pil(comment):
    arr = uint8_images(1, 9, seed=3)[0][:, :7]
    body = ppm(np.ascontiguousarray(arr), comment)
    np.testing.assert_array_equal(decode_ppm(body), np.asarray(Image.open(io.BytesIO(body)).convert("RGB")))
    assert decode_ppm(png(arr)) is None
    assert decode_ppm(b"P6\n2 2\n65535\n" + bytes(24)) is None          # 16-bit samples go to PIL
    with pytest.raises(ValueError):
        decode_ppm(b"P6\n4 4\n255\n" + bytes(10))


@pytest.mark.parametrize("size,hw", [(224, (256, 256)), (64, (200, 300)), (16, (40, 18))])
def test_val_transform_equals_jax(size, hw):
    """Shorter side already at image_size*256//224 (no resample, no PIL) and
    resized cases both equal the JAX package's PIL ValTransform."""
    from vitax.data.transforms import ValTransform as JaxValTransform
    arr = np.random.default_rng(4).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = JaxValTransform(size, normalize=False)(Image.fromarray(arr, "RGB"))
    got = ValTransform(size)(arr)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_image_bytes(png(arr), ValTransform(size)), want)


# --- HTTP ------------------------------------------------------------------


def http(url, body=None, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if body else {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.load(resp)


def test_http_round_trip_on_cpu(tmp_path):
    cfg = Config(**TINY, dtype="float32", serve_port=0).validate()
    engine = InferenceEngine.from_npz(cfg, export(str(tmp_path), "float32"), "cpu")
    engine.warmup()
    httpd, ctx = start_server(cfg, engine, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        imgs = uint8_images(2, 18, seed=5)       # resize_to 18 = the shorter side: no resample
        a = http(url + "/predict", ppm(imgs[0]), "image/x-portable-pixmap")
        b = http(url + "/predict", png(imgs[1]), "image/png")
        c = http(url + "/predict", json.dumps({"image": base64.b64encode(png(imgs[1])).decode(),
                                               "topk": 1}).encode(), "application/json")
        wire = {"items": [base64.b64encode(ppm(imgs[0])).decode(), base64.b64encode(b"junk").decode()]}
        batch = http(url + "/predict_batch", json.dumps(wire).encode(), "application/json")
        health = http(url + "/healthz")
        metrics = http(url + "/metrics")
        with pytest.raises(urllib.error.HTTPError) as e:
            http(url + "/predict", b"not an image")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            http(url + "/nope")
        assert e.value.code == 404
    finally:
        stop_server(httpd, ctx)
    ids, probs = engine.predict(np.stack([ValTransform(16)(x) for x in imgs]))
    for ans, row in ((a, 0), (b, 1)):
        assert ans["classes"] == ids[row].tolist()
        np.testing.assert_allclose(ans["probs"], probs[row], rtol=1e-6)
        assert ans["latency_ms"] > 0
    assert c["classes"] == ids[1, :1].tolist()
    assert [r["status"] for r in batch["results"]] == [200, 400]
    assert json.loads(batch["results"][0]["body"])["classes"] == a["classes"]
    assert health["ready"] and health["status"] == "ok" and health["buckets"] == [1, 2]
    assert health["compile_count"] == 2 and health["topk"] == 3
    assert metrics["requests_total"] == 4 and metrics["errors_total"] == 1
    assert metrics["weights_dtype"] == "float32" and metrics["param_bytes"] == engine.param_bytes()
    for key in ("latency_s_p50", "latency_s_p95", "queue_depth", "batches_flushed", "degraded",
                "brownout_enters", "request_timeout_s", "batch_occupancy_mean"):
        assert key in metrics, key


def _serve_cli_once(path, *flags):
    """Start the serve CLI on the CPU, answer one /predict, drain on SIGTERM."""
    argv = [sys.executable, "-m", "vitax_torch.serve", "--npz", path, "--device", "cpu", "--serve_port", "0",
            "--image_size", "16", "--patch_size", "8", "--embed_dim", "32", "--num_heads", "2",
            "--num_blocks", "2", "--num_classes", "4", *flags]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "listening on :" in line:
                port = int(line.split("listening on :")[1].split()[0])
        assert port, "server never bound"
        url = f"http://127.0.0.1:{port}"
        while not http(url + "/healthz")["ready"] and time.monotonic() < deadline:
            time.sleep(0.05)
        ans = http(url + "/predict", ppm(uint8_images(1, 18, 6)[0]))
        assert len(ans["classes"]) == 4          # default --serve_topk 5, clamped to 4 classes
        metrics = http(url + "/metrics")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        return metrics
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_cli_serves_on_cpu_and_drains_on_sigterm(tmp_path):
    _serve_cli_once(export(str(tmp_path), "float32"), "--dtype", "float32")


@pytest.mark.parametrize("qdtype,flags", [("int8", ()), ("int8", ("--serve_act_quant", "int8")),
                                          ("float8_e4m3", ("--fused_dequant", "on"))])
def test_cli_serves_quantized_export_on_cpu(tmp_path, qdtype, flags):
    metrics = _serve_cli_once(export(str(tmp_path), qdtype), "--serve_quant_dtype", qdtype, *flags)
    assert metrics["weights_dtype"] == qdtype
    assert metrics["act_quant"] == ("int8" if "--serve_act_quant" in flags else "off")
    assert metrics["fused_dequant"] == ("--fused_dequant" in flags)


def test_entry_points_default_to_the_card():
    """cuda unless asked for the CPU; without a card that raises, never falls back."""
    from vitax_torch.models.vit import build_model
    from vitax_torch.platform import device_kind, resolve_device
    assert resolve_device("cpu") == torch.device("cpu") and device_kind("cpu") == "cpu"
    cfg = Config(**TINY).validate()
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        InferenceEngine(cfg, build_model(cfg, "meta"))


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device would serve")
    r = subprocess.run([sys.executable, "-m", "vitax_torch.serve", "--npz", "absent.npz"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr and "--device cpu" in r.stderr


# --- batcher and brownout --------------------------------------------------


def test_batcher_flushes_by_size_and_deadline_like_jax():
    from vitax.serve.batcher import DynamicBatcher as JaxBatcher
    calls = {"port": [], "jax": []}

    def predict(tag):
        def fn(images):
            calls[tag].append(len(images))
            return np.zeros((len(images), 1), np.int32), np.ones((len(images), 1), np.float32)
        return fn

    for tag, cls in (("port", DynamicBatcher), ("jax", JaxBatcher)):
        b = cls(predict(tag), max_batch=4, max_wait_ms=50.0)
        futs = [b.submit(np.zeros((2, 2, 3), np.uint8)) for _ in range(6)]
        results = [f.result(timeout=10) for f in futs]
        b.close()
        assert [r.batch_size for r in results] == [4] * 4 + [2] * 2
        assert b.batches_flushed == 2
    assert calls["port"] == calls["jax"] == [4, 2]
    release = threading.Event()

    def stuck(images):
        release.wait(timeout=10)
        return np.zeros((len(images), 1), np.int32), np.ones((len(images), 1), np.float32)

    full = DynamicBatcher(stuck, max_batch=1, max_wait_ms=0.0, queue_max=1)
    try:
        first = full.submit(np.zeros((2, 2, 3), np.uint8))
        deadline = time.monotonic() + 10
        while full.queue_depth() and time.monotonic() < deadline:   # the worker holds the first
            time.sleep(0.005)
        second = full.submit(np.zeros((2, 2, 3), np.uint8))
        with pytest.raises(QueueFull):
            full.submit(np.zeros((2, 2, 3), np.uint8))
    finally:
        release.set()
        full.close()
    assert first.result(timeout=10).batch_size == second.result(timeout=10).batch_size == 1


def test_brownout_matches_jax_controller():
    from vitax.serve.server import BrownoutController as JaxBrownout
    depths = [0, 8, 8, 8, 9, 5, 2, 2, 2, 2, 9, 9, 1]
    traces = []
    for cls in (BrownoutController, JaxBrownout):
        c = cls(queue_max=10, enter_frac=0.75, exit_frac=0.25, dwell_s=1.5, clock=lambda: 0.0)
        traces.append([(c.observe(d, now=float(t)), round(c.degraded_seconds(now=float(t)), 6))
                       for t, d in enumerate(depths)] + [c.enters_total])
    assert traces[0] == traces[1]
    assert any(state for state, _ in traces[0][:-1])


# --- isolation and no-fallback guards ----------------------------------------


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "vitax_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_port_imports_no_jax_flax_ml_dtypes_or_vitax():
    banned = {"jax", "jaxlib", "flax", "ml_dtypes", "optax", "orbax", "vitax"}
    found = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            found += [f"{os.path.relpath(path, REPO)}: {n}" for n in names if n.split(".")[0] in banned]
    assert len(_port_sources()) > 15
    assert not found, found


def test_importing_every_port_module_loads_no_jax_and_no_pil():
    code = (
        "import importlib, pkgutil, sys, vitax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vitax_torch.__path__, 'vitax_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in ('jax', 'flax', 'ml_dtypes', 'vitax', 'PIL', 'triton') if m in sys.modules]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 15 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.gpu
def test_cuda_dispatch_raises_instead_of_falling_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.ops.attention import flash_attention_fwd
    x = torch.zeros(1, 8, 2, 24, device="cuda")                    # Dh 24 is not built
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention_fwd(x, x, x)
    from vitax_torch.ops.attention import flash_attention_bwd
    z = torch.zeros(1, 8, 2, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention_bwd(z, z, z, z, torch.zeros(1, 2, 8, device="cuda"), z, None, 0.25)
    h = torch.zeros(1, 8, 2, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(h, h, h)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu_engine():
    """The same seeded weights served on the card (kernel attention, f32
    compute with TF32 off) and on the CPU (plain attention) give the same
    answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(**TINY, dtype="float32").validate()
    cpu_model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"))
    card_model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"), init=False)
    card_model.load_state_dict({k: v.cuda() for k, v in cpu_model.state_dict().items()}, assign=True)
    engines = [InferenceEngine(cfg, cpu_model, "cpu"), InferenceEngine(cfg, card_model, "cuda")]
    for e in engines:
        e.warmup()
    before = _build.LAUNCHES["flash_attn_fwd"]
    x = uint8_images(2, 16, seed=8)
    (ids_c, p_c), (ids_g, p_g) = (e.predict(x) for e in engines)
    assert _build.LAUNCHES["flash_attn_fwd"] == before + cfg.num_blocks
    np.testing.assert_array_equal(ids_g, ids_c)
    np.testing.assert_allclose(p_g, p_c, atol=1e-5)


def numpy_quantized_export(path: str, qdtype: str, seed: int = 0) -> None:
    """A quantized export of random TINY weights in the JAX package's npz
    format, written with numpy and the port's quantizer only (the card's
    host has no flax)."""
    from vitax_torch.checkpoint.consolidate import (QUANT_MANIFEST_KEY, QUANT_SCALE_PREFIX, quant_manifest,
                                                     quantize_flat)
    rng = np.random.default_rng(seed)
    d, h, L, c, p = 32, 128, 2, 4, 8
    shapes = {"patch_embed/proj/kernel": (p, p, 3, d), "patch_embed/proj/bias": (d,), "pos_embed": (1, 4, d),
              "blocks/attn/qkv/kernel": (L, d, 3 * d), "blocks/attn/qkv/bias": (L, 3 * d),
              "blocks/attn/proj/kernel": (L, d, d), "blocks/attn/proj/bias": (L, d),
              "blocks/mlp/fc1/kernel": (L, d, h), "blocks/mlp/fc1/bias": (L, h),
              "blocks/mlp/fc2/kernel": (L, h, d), "blocks/mlp/fc2/bias": (L, d),
              "blocks/norm1/scale": (L, d), "blocks/norm1/bias": (L, d), "blocks/norm2/scale": (L, d),
              "blocks/norm2/bias": (L, d), "norm/scale": (d,), "norm/bias": (d,),
              "head/kernel": (d, c), "head/bias": (c,)}
    flat = {f"params/{k}": (rng.standard_normal(v) * (1.0 if k.endswith("scale") else 0.02)).astype(np.float32)
            for k, v in shapes.items()}
    flat["params/head/kernel"] *= 50.0
    qflat, scales = quantize_flat(flat, qdtype)
    payload = {k: (v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn else v).numpy()
               if isinstance(v, torch.Tensor) else v for k, v in qflat.items()}
    payload[QUANT_MANIFEST_KEY] = np.asarray(quant_manifest(scales, qdtype))
    payload.update({QUANT_SCALE_PREFIX + k: v.numpy() for k, v in scales.items()})
    np.savez(path, **payload)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype,act", [("int8", "off"), ("int8", "int8"), ("float8_e4m3", "off")])
def test_quantized_engine_on_card_matches_cpu_engine(tmp_path, qdtype, act):
    """One quantized export served on the card (the dequant_matmul kernel at
    every Dense site, f32 compute, TF32 off) and on the CPU (its plain
    version, fused_dequant on): the same answers, and 4 launches per block
    plus the head per batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = str(tmp_path / f"q_{qdtype}.npz")
    numpy_quantized_export(path, qdtype)
    kw = dict(**TINY, dtype="float32", serve_quant_dtype=qdtype, serve_act_quant=act)
    cpu = InferenceEngine.from_npz(Config(**kw, fused_dequant="on").validate(), path, "cpu")
    card = InferenceEngine.from_npz(Config(**kw).validate(), path, "cuda")
    assert card.fused_dequant and card.param_bytes() == cpu.param_bytes()
    for e in (cpu, card):
        e.warmup()
    before = _build.LAUNCHES["dequant_matmul"]
    x = uint8_images(2, 16, seed=8)
    (ids_c, p_c), (ids_g, p_g) = (e.predict(x) for e in (cpu, card))
    assert _build.LAUNCHES["dequant_matmul"] == before + 4 * TINY["num_blocks"] + 1
    np.testing.assert_array_equal(ids_g, ids_c)
    np.testing.assert_allclose(p_g, p_c, atol=1e-5)
    with pytest.raises(ValueError, match="dequant_matmul kernel"):
        InferenceEngine.from_npz(Config(**kw, fused_dequant="off").validate(), path, "cuda")


@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3"])
def test_numpy_quantized_export_reads_as_jax_reads_it(tmp_path, qdtype):
    """The card test's numpy-written export is one the JAX engine serves, and
    gives the answers the port's CPU engine gives."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    path = str(tmp_path / f"q_{qdtype}.npz")
    numpy_quantized_export(path, qdtype)
    kw = dict(**TINY, dtype="float32", serve_quant_dtype=qdtype, fused_dequant="on")
    jeng = JaxEngine.from_npz(JaxConfig(**kw, serve_port=0).validate(), path)
    teng = InferenceEngine.from_npz(Config(**kw).validate(), path, "cpu")
    for e in (jeng, teng):
        e.warmup()
    x = uint8_images(2, 16, seed=8)
    (ids_j, p_j), (ids_t, p_t) = (e.predict(x) for e in (jeng, teng))
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(p_t, p_j, atol=1e-5)
    assert teng.param_bytes() == jeng.param_bytes()


def test_quant_gate_record_matches_jax(tmp_path):
    """run_quant_gate over the port's engines gives the JAX package's record
    over its own engines on the same exports, images and labels."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax.serve.quant import run_quant_gate as jax_run_quant_gate, topk_accuracy as jax_topk_accuracy
    from vitax_torch.serve.quant import run_quant_gate, topk_accuracy
    full, quant = export(str(tmp_path), "float32"), export(str(tmp_path), "int8")
    kw = dict(**TINY, dtype="float32")
    jaxs = [JaxEngine.from_npz(JaxConfig(**kw, serve_port=0).validate(), full),
            JaxEngine.from_npz(JaxConfig(**kw, serve_quant_dtype="int8", serve_port=0).validate(), quant)]
    ports = [InferenceEngine.from_npz(Config(**kw).validate(), full, "cpu"),
             InferenceEngine.from_npz(Config(**kw, serve_quant_dtype="int8").validate(), quant, "cpu")]
    for e in jaxs + ports:
        e.warmup()
    images = uint8_images(6, 16, seed=11)
    labels = np.random.default_rng(2).integers(0, 4, 6)
    assert run_quant_gate(*ports, images, labels) == jax_run_quant_gate(*jaxs, images, labels)
    ids = np.random.default_rng(3).integers(0, 4, (6, 3))
    assert topk_accuracy(ids, labels) == jax_topk_accuracy(ids, labels)
