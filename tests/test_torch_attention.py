"""vitax_torch attention: the plain versions of the Hopper flash-attention
forward and backward against the JAX package's kernels (Pallas interpret
mode on the CPU, as tests/test_ops.py runs them; the backward through
jax.vjp of flash4_with_lse), the autograd Function, the CPU dispatch, the
attention policy, and (on a card, `-m gpu`) the kernels against their
plain versions.

Inputs come from numpy seeds and cross between the packages as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitax.ops.attention import flash4_with_lse, flash_bh_with_lse
from vitax.ops.attention import reference_attention as jax_reference_attention
from vitax_torch.config import Config
from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    FWD_KERNELS,
    SUPPORTED_HEAD_DIMS,
    attention_bwd_with_lse,
    attention_fwd_with_lse,
    choose_fwd_kernel,
    flash4_with_lse as torch_flash4_with_lse,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
    make_attention_impl,
    reference_attention,
)

SHAPES = [(2, 16, 2, 16), (2, 64, 4, 64), (1, 32, 2, 160)]


def qkv_np(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_flash4(shape):
    """f32: o and lse within 1e-5 of flash4_with_lse (the A1 kernel)."""
    q, k, v = qkv_np(shape)
    scale = shape[-1] ** -0.5
    o_j, lse_j = flash4_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    o_t, lse_t = attention_fwd_with_lse(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert o_t.shape == shape and lse_t.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_flash_bh(shape):
    """The BH layout (B*H, N, Dh) of flash_bh_with_lse (the A3 kernel), as
    (B*H, N, 1, Dh) views on the port's side."""
    b, n, h, dh = shape
    q, k, v = qkv_np((b * h, n, dh), seed=1)
    scale = dh ** -0.5
    o_j, lse_j = flash_bh_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    o_t, lse_t = attention_fwd_with_lse(*(torch.from_numpy(x)[:, :, None] for x in (q, k, v)), scale)
    np.testing.assert_allclose(o_t[:, :, 0].numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse_t[:, 0].numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


def test_plain_matches_jax_flash4_bf16():
    """bf16 inputs: lse comes from f32 scores of identical inputs (1e-5);
    o agrees to one bf16 rounding of the output (2e-2 at |o| < 2)."""
    shape = (2, 64, 4, 64)
    q, k, v = qkv_np(shape, seed=2)
    scale = shape[-1] ** -0.5
    o_j, lse_j = flash4_with_lse(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale)
    o_t, lse_t = attention_fwd_with_lse(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), scale)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_reference_attention_matches_jax(dtype, atol):
    shape = (2, 16, 2, 16)
    q, k, v = qkv_np(shape, seed=3)
    got = reference_attention(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)))
    want = jax_reference_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in qkv_np((2, 16, 2, 16), seed=4))
    before = dict(_build.LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = attention_fwd_with_lse(q, k, v, 16 ** -0.5)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(flash_attention(q, k, v), o_ref)
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the kernels' own entry points take CUDA tensors only."""
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_fwd_cuda(q, q, q, 0.25)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_bwd_cuda(q, q, q, q, torch.zeros(1, 1, 4), q, None, 0.25)


def _grads_np(shape, seed):
    b, n, h, _ = shape
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal((b, h, n)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_backward_matches_jax_vjp(shape):
    """f32: dq, dk, dv of the port's flash4_with_lse (the plain backward on
    the CPU) within 1e-5 of jax.vjp of the JAX one (the A2 kernel), with a
    random dO and a nonzero dlse."""
    q, k, v = qkv_np(shape, seed=6)
    do, dlse = _grads_np(shape, seed=7)
    scale = shape[-1] ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: flash4_with_lse(a, b_, c, scale),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, lse = torch_flash4_with_lse(qt, kt, vt)
    ((o * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()).backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_plain_backward_matches_jax_bf16():
    """bf16 inputs, the same cast points: dq, dk, dv agree to a couple of
    bf16 roundings of the outputs (|d| <= 2e-2 * max|d_ref| + 1e-3)."""
    shape = (2, 64, 4, 64)
    q, k, v = qkv_np(shape, seed=8)
    do, dlse = _grads_np(shape, seed=9)
    scale = shape[-1] ** -0.5
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b_, c: flash4_with_lse(a, b_, c, scale), *args)
    want = vjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    o, lse = attention_fwd_with_lse(qt, kt, vt, scale)
    got = attention_bwd_with_lse(qt, kt, vt, o, lse, torch.from_numpy(do).bfloat16(),
                                 torch.from_numpy(dlse), scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max() + 1e-3


def test_plain_path_gradcheck_float64():
    """The Function's plain forward and backward, both outputs, in float64."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 4))).requires_grad_(True) for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b_, c: torch_flash4_with_lse(a, b_, c), (q, k, v))


def test_cpu_backward_dispatch_runs_the_plain_version_and_launches_nothing():
    shape = (2, 16, 2, 16)
    q, k, v = (torch.from_numpy(x) for x in qkv_np(shape, seed=11))
    do, dlse = (torch.from_numpy(x) for x in _grads_np(shape, seed=12))
    before = dict(_build.LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do, dlse, 16 ** -0.5)
    want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, 16 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    no_dlse = flash_attention_bwd(q, k, v, o, lse, do, None, 16 ** -0.5)
    zero_dlse = attention_bwd_with_lse(q, k, v, o, lse, do, torch.zeros_like(dlse), 16 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(no_dlse, zero_dlse))
    assert _build.LAUNCHES == before


def test_unused_lse_passes_no_cotangent():
    """Training uses o only: the Function sees dlse None (no zeros tensor)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in qkv_np((1, 8, 2, 16), seed=13))
    flash_attention(q, k, v).sum().backward()
    q2, k2, v2 = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o, lse = torch_flash4_with_lse(q2, k2, v2)
    (o.sum() + 0.0 * lse.sum()).backward()
    for a, b in zip((q.grad, k.grad, v.grad), (q2.grad, k2.grad, v2.grad)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_flash", [True, False])
def test_make_attention_impl_policy(use_flash):
    cfg = Config(embed_dim=32, num_heads=2, use_flash_attention=use_flash).validate()
    impl = make_attention_impl(cfg, "cpu")
    assert (impl is flash_attention) if use_flash else (impl is None)


def test_make_attention_impl_rejects_unbuilt_head_dim_on_cuda():
    """Checked when the model is built, before any card is touched."""
    cfg = Config(embed_dim=48, num_heads=2).validate()    # Dh 24
    assert 24 not in SUPPORTED_HEAD_DIMS
    with pytest.raises(ValueError, match="head dim 24"):
        make_attention_impl(cfg, "cuda")
    assert make_attention_impl(Config(embed_dim=48, num_heads=2, use_flash_attention=False), "cuda") is None


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    """An edited kernel source never loads the library built from the old one."""
    src = tmp_path / _build.SOURCES["flash_attn_fwd"]
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build._lib_path("flash_attn_fwd")
    src.write_text("// v2\n")
    second = _build._lib_path("flash_attn_fwd")
    assert first != second
    assert first.startswith(_build.BUILD_DIR) and second.endswith(".so")


# --- on a card (python -m pytest -m gpu tests/) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 50, 2, 16), (2, 197, 4, 64), (1, 64, 2, 160), (1, 130, 3, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    """The dispatcher's kernel, then each forward kernel that takes the
    operands (wgmma and general for bf16 at Dh 64 and 160), against the
    plain version; each launch counts under its kernel's key."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, dh = shape
    arr = np.random.default_rng(5).standard_normal((b, n, 3, h, dh)).astype(np.float32)
    qkv = torch.from_numpy(arr).to(cuda, getattr(torch, dtype))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]       # strided views, never copied
    chosen = choose_fwd_kernel(q, k, v)
    assert chosen == ("wgmma" if dtype == "bfloat16" and dh in (64, 160) else "general")
    tol_o, tol_lse = (1e-5, 1e-5) if dtype == "float32" else (1.6e-2, 1e-3)
    for kernel in [None] + [name for name in FWD_KERNELS if name == "general" or chosen == "wgmma"]:
        before = dict(_build.LAUNCHES)
        with torch.inference_mode():
            o, lse = flash_attention_fwd(q, k, v) if kernel is None else flash_attn_fwd_cuda(q, k, v, dh ** -0.5,
                                                                                              kernel=kernel)
            o_ref, lse_ref = attention_fwd_with_lse(q, k, v, dh ** -0.5)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"] + 1
        key = f"flash_attn_fwd_{kernel or chosen}"
        assert _build.LAUNCHES[key] == before[key] + 1
        assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
        assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 50, 2, 16), (2, 197, 4, 64), (1, 64, 2, 160), (1, 130, 3, 32),
                                   (2, 100, 2, 80), (1, 70, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_card(cuda, shape, dtype):
    """The backward kernel against its plain version with a nonzero dlse, on
    strided q, k, v views; two runs give bitwise-equal outputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, dh = shape
    rng = np.random.default_rng(14)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, dh)).astype(np.float32)).to(cuda, getattr(torch, dtype))
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, getattr(torch, dtype))
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).to(cuda)
    o, lse = flash_attention_fwd(q, k, v)
    before = _build.LAUNCHES["flash_attn_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, dlse, dh ** -0.5)
    again = flash_attention_bwd(q, k, v, o, lse, do, dlse, dh ** -0.5)
    want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, dh ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_bwd"] == before + 2
    tol = 2e-6 if dtype == "float32" else 6e-3          # of max |ref|, the bars of chip_smoke.py
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert (a.float() - w.float()).abs().max().item() <= tol * w.float().abs().max().item()


@pytest.mark.gpu
def test_autograd_on_card_matches_cpu():
    """The Function on the card (both kernels, f32, TF32 off) against the
    same Function on the CPU (both plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (2, 40, 2, 32)
    q, k, v = qkv_np(shape, seed=15)
    do, dlse = _grads_np(shape, seed=16)
    grads = []
    for dev in ("cpu", "cuda"):
        ts = [torch.from_numpy(x).to(dev).requires_grad_(True) for x in (q, k, v)]
        o, lse = torch_flash4_with_lse(*ts)
        ((o * torch.from_numpy(do).to(dev)).sum() + (lse * torch.from_numpy(dlse).to(dev)).sum()).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
