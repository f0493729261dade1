"""vitax_torch quantized serving against the JAX package, on the same numpy
inputs: the per-channel weight quantizer, activation quantization, the
plain versions of the dequant matmul kernel (weight-only within 1e-5
relative, act mode bitwise), quantized npz loading and conversion, the
in-memory quantizer, the fused-kernel policy and the config checks; on a
card, the kernel against its plain version.

The JAX package is imported inside the tests that use it: the card's host
has no flax and no orbax, and `-m gpu` must collect there."""

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint.consolidate import (load_npz_raw, quantize_flat, quantize_leaf,
                                                 quant_manifest, parse_quant_manifest)
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import Quant, build_model
from vitax_torch.ops.dequant_matmul import (dequant_matmul, dequant_matmul_plain, fused_dequant_active,
                                            make_quant_matmul, quantize_activations)
from vitax_torch.serve.quant import dense_site_kind, dequant_spec, quantize_params_for_serve

TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4)
# tests/test_dequant_matmul.py SHAPES: block-aligned, ragged in every dim,
# sub-block tiny, and a k past one block
SHAPES = [(64, 128, 256), (5, 33, 17), (130, 257, 96), (1, 8, 4)]
QDTYPES = ["int8", "float8_e4m3"]


def codes(q) -> np.ndarray:
    """The stored bits of quantized codes, torch or numpy, as uint8 / int8."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q).numpy()
    return q.view(np.uint8) if q.dtype.itemsize == 1 and q.dtype != np.int8 else q


def port_leaves(flat: dict) -> dict:
    """A JAX flat tree as the port reads it from an export: ml_dtypes fp8
    codes become float8_e4m3fn views of their bits."""
    return {k: torch.from_numpy(codes(v).copy()).view(torch.float8_e4m3fn)
            if v.dtype.itemsize == 1 and v.dtype != np.int8 else v for k, v in flat.items()}


def jax_flat(scan_blocks: bool = True, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    cfg = JaxConfig(**TINY, dtype="float32", scan_blocks=scan_blocks).validate()
    params = jax_build_model(cfg).init(jax.random.key(seed), jnp.zeros((1, 16, 16, 3)), True)
    return {k: np.array(v) for k, v in flatten_tree(jax.device_get(params)).items()}


def quantizer_case(case: str):
    rng = np.random.default_rng(11)
    if case == "dense":
        return "params/head/kernel", rng.standard_normal((33, 17)).astype(np.float32) * 2
    if case == "scanned":
        return "params/blocks/attn/qkv/kernel", rng.standard_normal((3, 16, 24)).astype(np.float32)
    if case == "conv":
        return "params/patch_embed/proj/kernel", rng.standard_normal((4, 4, 3, 8)).astype(np.float32) * 0.02
    if case == "zero_channel":
        w = rng.standard_normal((2, 12, 6)).astype(np.float32)
        w[1, :, 3] = 0.0
        return "params/blocks/mlp/fc1/kernel", w
    # values at +-240 and +-127 of a unit scale, and halfway points
    w = rng.standard_normal((9, 5)).astype(np.float32) * 30
    w[:, 0] = [240, -240, 120, -0.5, 0.5, 1.5, 2.5, 239.9, 0]
    w[:, 1] = [127, -127, 63.5, -63.5, 0.5, -0.5, 126.5, 1e-6, 0]
    return "params/blocks_0/mlp/fc2/kernel", w


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", ["dense", "scanned", "conv", "zero_channel", "at_240"])
def test_quantize_leaf_matches_jax(dtype, case):
    """int8 codes and scales bitwise equal; fp8 stored bits equal."""
    from vitax.checkpoint.consolidate import quantize_leaf as jax_quantize_leaf
    key, w = quantizer_case(case)
    q_j, s_j = jax_quantize_leaf(key, w, dtype)
    q_t, s_t = quantize_leaf(key, w, dtype)
    assert q_t.dtype == (torch.int8 if dtype == "int8" else torch.float8_e4m3fn)
    assert tuple(q_t.shape) == w.shape and tuple(s_t.shape) == s_j.shape
    np.testing.assert_array_equal(codes(q_t), codes(q_j))
    assert s_t.dtype == torch.float32
    np.testing.assert_array_equal(s_t.numpy(), s_j)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_flat_matches_jax(dtype):
    from vitax.checkpoint.consolidate import quantize_flat as jax_quantize_flat
    flat = jax_flat()
    q_j, s_j = jax_quantize_flat(flat, dtype)
    q_t, s_t = quantize_flat(flat, dtype)
    assert set(q_t) == set(q_j) and set(s_t) == set(s_j)
    assert sorted(s_t) == ["params/blocks/attn/proj/kernel", "params/blocks/attn/qkv/kernel",
                           "params/blocks/mlp/fc1/kernel", "params/blocks/mlp/fc2/kernel",
                           "params/head/kernel", "params/patch_embed/proj/kernel"]
    for k in q_j:
        np.testing.assert_array_equal(codes(q_t[k]) if k in s_t else q_t[k], codes(q_j[k]))
    for k in s_j:
        np.testing.assert_array_equal(s_t[k].numpy(), s_j[k])


def test_fp8_cast_matches_ml_dtypes():
    """torch's float8_e4m3fn cast and ml_dtypes' float8_e4m3 give the same
    codes on 100k normal draws scaled to absmax 240 (the quantizer's range)."""
    import ml_dtypes
    w = np.random.default_rng(5).standard_normal(100_000).astype(np.float32)
    w = w / np.abs(w).max() * np.float32(240.0)
    got = torch.from_numpy(w).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, w.astype(ml_dtypes.float8_e4m3).view(np.uint8))


@pytest.mark.parametrize("case", ["normal", "bf16", "zeros", "tiny", "halfway"])
def test_quantize_activations_bitwise(case):
    import jax.numpy as jnp
    from vitax.ops.dequant_matmul import quantize_activations as jax_quantize_activations
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 19)).astype(np.float32) * 3
    if case == "zeros":
        x = np.zeros((4, 8), np.float32)
    elif case == "tiny":
        x = x * 1e-30
    elif case == "halfway":
        x = np.asarray([[127.0, 0.5, 1.5, -2.5, 63.5, -0.49999997]], np.float32)
    if case == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q_j, s_j = jax_quantize_activations(xj)
    q_t, s_t = quantize_activations(xt)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32 and s_t.dim() == 0
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if case == "zeros":
        assert float(s_t) == 1.0


def _quantized_operands(m, k, n, dtype, seed):
    """x (m, k) and a JAX-layout quantized (k, n) weight, from numpy."""
    from vitax.checkpoint.consolidate import quantize_leaf as jax_quantize_leaf
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q, scale = jax_quantize_leaf("params/head/kernel", rng.standard_normal((k, n)).astype(np.float32) * 2, dtype)
    return x, w_q, scale


def _port_weight(w_q, scale):
    """The port's (out, in) codes and (out,) scale from a JAX (in, out) pair."""
    t = torch.from_numpy(np.ascontiguousarray(codes(w_q).T))
    if w_q.dtype != np.int8:
        t = t.view(torch.float8_e4m3fn)
    return t, torch.from_numpy(scale.reshape(-1).copy())


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want)) / max(1e-6, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_weight_only_plain_matches_jax(m, k, n, dtype):
    """The plain weight-only version against the JAX Pallas kernel (interpret
    mode) and the JAX unfused path: rel err <= 1e-5 (f32 sums in other
    orders; the unfused path also scales the weight before the product)."""
    import jax.numpy as jnp
    from vitax.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
    x, w_q, scale = _quantized_operands(m, k, n, dtype, seed=1)
    fused = jax_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), act=False, fused=True,
                               interpret=True)
    unfused = jax_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), act=False, fused=False)
    w_t, s_t = _port_weight(w_q, scale)
    got = dequant_matmul_plain(torch.from_numpy(x), w_t, s_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert _rel_err(got, fused) <= 1e-5
    assert _rel_err(got, unfused) <= 1e-5
    np.testing.assert_array_equal(dequant_matmul(torch.from_numpy(x), w_t, s_t).numpy(), got.numpy())


@pytest.mark.parametrize("act", [False, True])
def test_leading_dims_match_jax(act):
    """(B, N, K) inputs keep their leading dims; act mode quantizes the whole
    tensor with one scale, as the JAX dispatcher does."""
    import jax.numpy as jnp
    from vitax.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
    _, w_q, scale = _quantized_operands(1, 24, 10, "int8", seed=4)
    x = np.random.default_rng(6).standard_normal((2, 7, 24)).astype(np.float32)
    want = jax_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), act=act, fused=True,
                              interpret=True)
    w_t, s_t = _port_weight(w_q, scale)
    got = dequant_matmul_plain(torch.from_numpy(x), w_t, s_t, act=act)
    assert tuple(got.shape) == (2, 7, 10)
    if act:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_act_plain_bitwise_matches_jax(m, k, n):
    """int8 x int8 summed exactly, then (acc * sx) * s: bitwise equal to the
    JAX kernel in interpret mode and to the JAX unfused int8 dot."""
    import jax.numpy as jnp
    from vitax.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
    x, w_q, scale = _quantized_operands(m, k, n, "int8", seed=2)
    fused = jax_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), act=True, fused=True,
                               interpret=True)
    unfused = jax_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), act=True, fused=False)
    w_t, s_t = _port_weight(w_q, scale)
    got = dequant_matmul_plain(torch.from_numpy(x), w_t, s_t, act=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fused))
    np.testing.assert_array_equal(got.numpy(), np.asarray(unfused))


def test_act_mode_refuses_fp8_and_make_quant_matmul_keeps_the_head_weight_only():
    x = torch.randn(3, 8)
    w = torch.randint(-127, 128, (5, 8), dtype=torch.int8)
    s = torch.rand(5) + 0.1
    with pytest.raises(ValueError, match="act-quant needs int8"):
        dequant_matmul(x, w.float().to(torch.float8_e4m3fn), s, act=True)
    qm = make_quant_matmul(Config(**TINY, serve_quant_dtype="int8", serve_act_quant="int8").validate())
    torch.testing.assert_close(qm(x, w, s, act=True), dequant_matmul_plain(x, w, s, act=True), rtol=0, atol=0)
    torch.testing.assert_close(qm(x, w, s, act=False), dequant_matmul_plain(x, w, s), rtol=0, atol=0)
    qm_off = make_quant_matmul(Config(**TINY, serve_quant_dtype="int8").validate())
    torch.testing.assert_close(qm_off(x, w, s, act=True), dequant_matmul_plain(x, w, s), rtol=0, atol=0)


# --- export reading, conversion, in-memory quantization ---------------------


@pytest.mark.parametrize("dtype", QDTYPES)
def test_load_npz_raw_matches_jax(tmp_path, dtype):
    from vitax.checkpoint.consolidate import load_npz_raw as jax_load_npz_raw, save_npz
    path = str(tmp_path / f"q_{dtype}.npz")
    save_npz(path, jax_flat(), dtype=dtype)
    flat_j, scales_j, manifest_j = jax_load_npz_raw(path)
    flat_t, scales_t, manifest_t = load_npz_raw(path)
    assert manifest_t == manifest_j and len(manifest_t) == 6
    assert set(flat_t) == set(flat_j) and set(scales_t) == set(scales_j) == set(manifest_t)
    for k, v in flat_j.items():
        want_dtype = (torch.float8_e4m3fn if manifest_t.get(k) == "float8_e4m3"
                      else torch.int8 if k in manifest_t else torch.float32)
        assert flat_t[k].dtype == want_dtype, k
        np.testing.assert_array_equal(codes(flat_t[k]), codes(v))
    for k, v in scales_j.items():
        assert scales_t[k].dtype == torch.float32
        np.testing.assert_array_equal(scales_t[k].numpy(), v)
    from vitax.serve.quant import dequant_spec as jax_dequant_spec
    assert dequant_spec(flat_t, manifest_t) == jax_dequant_spec(flat_j, manifest_j)


def test_quant_manifest_round_trip_and_rejections():
    doc = quant_manifest(["b", "a"], "float8_e4m3")
    assert parse_quant_manifest(doc) == {"a": "float8_e4m3", "b": "float8_e4m3"}
    with pytest.raises(ValueError, match="schema"):
        parse_quant_manifest('{"schema": 2, "dtypes": {}}')
    with pytest.raises(ValueError, match="int4"):
        parse_quant_manifest('{"schema": 1, "dtypes": {"int4": ["a"]}}')


def _unscanned(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        if k.startswith("params/blocks/"):
            for i in range(v.shape[0]):
                out[k.replace("blocks/", f"blocks_{i}/", 1)] = v[i]
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("layout", ["scanned", "unscanned"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_convert_quantized_tree(dtype, layout):
    """Codes go to (out, in) (the conv to (cout, cin, kh, kw)), scales to
    per-layer (F,); both layouts give the same state, which loads strictly
    into the quantized model."""
    from vitax.checkpoint.consolidate import quantize_flat as jax_quantize_flat
    flat = jax_flat()
    if layout == "unscanned":
        flat = _unscanned(flat)
    qflat, scales = jax_quantize_flat(flat, dtype)
    state = params_from_jax(port_leaves(qflat), scales)
    key = "params/blocks/attn/qkv/kernel" if layout == "scanned" else "params/blocks_1/attn/qkv/kernel"
    q1 = qflat[key][1] if layout == "scanned" else qflat[key]
    s1 = scales[key][1] if layout == "scanned" else scales[key]
    np.testing.assert_array_equal(codes(state["blocks.1.attn.qkv.weight"]), codes(q1).T)
    np.testing.assert_array_equal(state["blocks.1.attn.qkv.qscale"].numpy(), s1.reshape(-1))
    np.testing.assert_array_equal(codes(state["patch_embed.proj.weight"]),
                                  codes(qflat["params/patch_embed/proj/kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["patch_embed.proj.qscale"].numpy(),
                                  scales["params/patch_embed/proj/kernel"].reshape(-1))
    np.testing.assert_array_equal(codes(state["head.weight"]), codes(qflat["params/head/kernel"]).T)
    assert state["blocks.0.norm1.weight"].dtype == torch.float32
    if layout == "unscanned":
        sflat, sscales = jax_quantize_flat(jax_flat(), dtype)
        other = params_from_jax(port_leaves(sflat), sscales)
        assert set(other) == set(state)
        for k in state:
            np.testing.assert_array_equal(codes(state[k]), codes(other[k]))
    model = build_model(Config(**TINY).validate(), "cpu", init=False, quant=Quant(dtype))
    model.load_state_dict(state, strict=True, assign=True)
    assert model.blocks[1].mlp.fc2.weight.dtype == state["blocks.1.mlp.fc2.weight"].dtype
    with pytest.raises(KeyError, match="no kernel"):
        params_from_jax(port_leaves(qflat), {"params/head/bias": scales["params/head/kernel"]})


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_params_for_serve_equals_the_converted_export(dtype):
    """The in-memory quantizer on the port's float state gives exactly the
    conversion of the JAX quantized export of the same weights; float
    leaves pass through by reference, and the input dict is consumed."""
    from vitax.checkpoint.consolidate import quantize_flat as jax_quantize_flat
    flat = jax_flat()
    float_state = params_from_jax(flat)
    ln = float_state["blocks.0.norm1.weight"]
    got = quantize_params_for_serve(float_state, dtype)
    assert not float_state and got["blocks.0.norm1.weight"] is ln
    qflat, scales = jax_quantize_flat(flat, dtype)
    want = params_from_jax(port_leaves(qflat), scales)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(codes(got[k]), codes(want[k]))


@pytest.mark.parametrize("key,kind", [
    ("params/blocks/attn/qkv/kernel", "block"), ("params/blocks_3/mlp/fc2/kernel", "block"),
    ("params/head/kernel", "head"), ("params/patch_embed/proj/kernel", ""),
    ("params/blocks/attn/qkv/bias", ""), ("blocks.0.attn.proj.weight", "block"), ("head.weight", "head"),
    ("patch_embed.proj.weight", ""), ("blocks.2.norm1.weight", "")])
def test_dense_site_kind_matches_jax(key, kind):
    from vitax.serve.quant import dense_site_kind as jax_dense_site_kind
    assert dense_site_kind(key) == kind
    if "/" in key:
        assert jax_dense_site_kind(key) == kind


# --- policy and configuration -------------------------------------------------


@pytest.mark.parametrize("mode,quant,act", [("auto", "int8", "off"), ("on", "int8", "off"), ("off", "int8", "off"),
                                            ("auto", "float8_e4m3", "off"), ("on", "float8_e4m3", "off"),
                                            ("auto", "int8", "int8"), ("auto", "", "off"), ("off", "", "off")])
def test_fused_dequant_active_policy(mode, quant, act):
    """On the CPU the port's policy is the JAX package's (auto is off off a
    real-kernel backend); on a CUDA device the kernel is always active and
    off raises."""
    from vitax.config import Config as JaxConfig
    from vitax.ops.dequant_matmul import fused_dequant_active as jax_fused_dequant_active
    kw = dict(**TINY, fused_dequant=mode, serve_quant_dtype=quant, serve_act_quant=act)
    cfg = Config(**kw).validate()
    assert fused_dequant_active(cfg, "cpu") == jax_fused_dequant_active(JaxConfig(**kw).validate())
    assert fused_dequant_active(cfg, "cpu") == (mode == "on")
    if mode == "off":
        with pytest.raises(ValueError, match="dequant_matmul kernel"):
            fused_dequant_active(cfg, "cuda")
    else:
        assert fused_dequant_active(cfg, "cuda") is True


@pytest.mark.parametrize("kw", [dict(serve_act_quant="int8"),
                                dict(serve_act_quant="int8", serve_quant_dtype="float8_e4m3"),
                                dict(fused_dequant="on"), dict(serve_quant_dtype="int4"),
                                dict(serve_act_quant="fp8", serve_quant_dtype="int8"),
                                dict(fused_dequant="maybe", serve_quant_dtype="int8")])
def test_config_rejections_mirror_jax(kw):
    from vitax.config import Config as JaxConfig
    with pytest.raises(ValueError):
        Config(**TINY, **kw).validate()
    with pytest.raises(AssertionError):
        JaxConfig(**TINY, **kw).validate()


def test_quant_flags_parse_with_jax_spelling():
    from vitax_torch.config import build_parser
    ns = build_parser().parse_args(["--serve_quant_dtype", "int8", "--serve_act_quant", "int8",
                                    "--fused_dequant", "on"])
    assert (ns.serve_quant_dtype, ns.serve_act_quant, ns.fused_dequant) == ("int8", "int8", "on")
    d = build_parser().parse_args([])
    assert (d.serve_quant_dtype, d.serve_act_quant, d.fused_dequant) == ("", "off", "auto")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--fused_dequant", "maybe"])


# --- on the card ----------------------------------------------------------------


# The wgmma kernel with ragged M, F and K tails (chip_smoke.py's DEQUANT_TAIL_SHAPES)
TAIL_SHAPES = [(2056, 5120, 1000), (130, 528, 392), (200, 4112, 300), (256, 5120, 15360)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES + [(8, 5120, 1000), (200, 520, 300)] + TAIL_SHAPES)
def test_kernel_matches_plain_on_card(m, k, n):
    """Weight-only (bf16 and f32 x, int8 and fp8 w) within 1e-5 relative of
    the plain version (summation order); act mode bitwise; one launch each,
    counted under the kernel `choose_kernel` gives the shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.checkpoint.consolidate import quantize_tensor
    from vitax_torch.ops import _build
    from vitax_torch.ops.dequant_matmul import choose_kernel, dequant_matmul_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).cuda() * 0.02
    for dtype in QDTYPES:
        q, s = quantize_tensor(w, (1,), dtype)
        s = s.reshape(-1).contiguous()
        for xt in (x, x.to(torch.bfloat16)):
            key = "dequant_matmul_" + ("general" if choose_kernel(xt, q) == "general" else "wgmma")
            before = dict(_build.LAUNCHES)
            got = dequant_matmul(xt, q, s)
            assert _build.LAUNCHES["dequant_matmul"] == before["dequant_matmul"] + 1
            assert _build.LAUNCHES[key] == before[key] + 1
            want = dequant_matmul_plain(xt, q, s)
            assert _rel_err(got.cpu(), want.cpu()) <= 1e-5
        if dtype == "int8":
            torch.testing.assert_close(dequant_matmul(x, q, s, act=True), dequant_matmul_plain(x, q, s, act=True),
                                       rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        dequant_matmul_cuda(torch.zeros(m, 2 * k, device="cuda")[:, ::2], q, s)
    with pytest.raises(ValueError, match="float32"):
        dequant_matmul_cuda(x, q, s.double())
