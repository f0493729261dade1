"""vitax_torch attention: the plain version of the Hopper flash-attention
forward against the JAX package's kernels (Pallas interpret mode on the
CPU, as tests/test_ops.py runs them), the CPU dispatch, the attention
policy, and (on a card, `-m gpu`) the kernel against its plain version.

Inputs come from numpy seeds and cross between the packages as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitax.ops.attention import flash4_with_lse, flash_bh_with_lse
from vitax.ops.attention import reference_attention as jax_reference_attention
from vitax_torch.config import Config
from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    SUPPORTED_HEAD_DIMS,
    attention_fwd_with_lse,
    flash_attention,
    flash_attention_fwd,
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
    """No silent fallback: the kernel's own entry point takes CUDA tensors only."""
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_fwd_cuda(q, q, q, 0.25)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, dh = shape
    arr = np.random.default_rng(5).standard_normal((b, n, 3, h, dh)).astype(np.float32)
    qkv = torch.from_numpy(arr).to(cuda, getattr(torch, dtype))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]       # strided views, never copied
    before = _build.LAUNCHES["flash_attn_fwd"]
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v)
        o_ref, lse_ref = attention_fwd_with_lse(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_fwd"] == before + 1
    tol_o, tol_lse = (1e-5, 1e-5) if dtype == "float32" else (1.6e-2, 1e-3)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
