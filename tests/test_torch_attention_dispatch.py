"""The attention forward's dispatch on the host: which of
vitax_torch/csrc/flash_attn_fwd.cu's kernels a launch takes
(ops/attention.py `choose_fwd_kernel`, a plain function of the types, the
head dim, the alignment, the strides and the scale's sign), what the wrapper
refuses, and that the CPU path still runs the plain version.

Every main-path attention call must take the wgmma kernel: the qkv-slice
views of the 10B serve buckets and train batch, of bench.py's presets and
of the long-context runs, and the (B*H, N, 1, Dh) views of the BH and
streaming BH entries. float32, misaligned bases, strides TMA does not take,
head dims the wgmma kernel is not built for and scales that are not finite
and positive take the general kernel.
Operand tensors are made with torch.empty on the CPU: the dispatch reads
shapes, strides, types and base addresses only (nothing is touched, so the
large shapes cost no memory)."""

import numpy as np
import pytest
import torch

import bench
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    FWD_KERNELS,
    SUPPORTED_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    attention_fwd_with_lse,
    choose_fwd_kernel,
    flash_attention_fwd,
    flash_attn_fwd_cuda,
    forced_fwd_kernel,
    resolve_fwd_kernel,
    wgmma_takes,
)
from vitax_torch.ops.flash_blocked import blocked_with_lse

SERVE_BUCKETS = (1, 2, 4, 8)
TRAIN_BATCH = 32                       # chip_smoke.py's train path
LONG_SHAPES = ((2, 4096, 16, 64), (2, 9216, 16, 64))


def qkv_views(b, n, h, dh, dtype=torch.bfloat16, offset=0):
    """q, k, v as the model makes them: slices of one (B, N, 3, H, Dh)
    tensor, its base moved by `offset` elements."""
    flat = torch.empty(b * n * 3 * h * dh + offset, dtype=dtype)
    return flat[offset:].view(b, n, 3, h, dh).unbind(2)


def bh_views(b, n, h, dh, dtype=torch.bfloat16):
    """The BH entries' operands: (B*H, N, 1, Dh) views of (B*H, N, Dh)."""
    return tuple(torch.empty(b * h, n, dh, dtype=dtype)[:, :, None] for _ in range(3))


def model_shape(cfg, batch):
    return batch, cfg.num_patches, cfg.num_heads, cfg.embed_dim // cfg.num_heads


def preset_shapes():
    out = []
    for name, kw in sorted(bench.train_presets(1).items()):
        cfg = Config(**{k: v for k, v in kw.items() if k != "moe_experts"}).validate()
        out.append(pytest.param(model_shape(cfg, cfg.batch_size), id=name))
    return out


@pytest.mark.parametrize("batch", SERVE_BUCKETS + (TRAIN_BATCH,))
def test_10b_serve_buckets_and_train_batch_take_wgmma(batch):
    cfg = Config().validate()                    # the 10B flagship: N 256, 32 heads, Dh 160
    shape = model_shape(cfg, batch)
    assert shape[1:] == (256, 32, 160)
    assert choose_fwd_kernel(*qkv_views(*shape)) == "wgmma"
    assert choose_fwd_kernel(*bh_views(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", preset_shapes())
def test_bench_presets_take_wgmma(shape):
    assert shape[3] in WGMMA_HEAD_DIMS
    assert choose_fwd_kernel(*qkv_views(*shape)) == "wgmma"
    assert choose_fwd_kernel(*bh_views(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_long_context_runs_take_wgmma(shape):
    """Phase 7L's ViT-L width at N 4096 and 9216: the streaming entries
    launch the same forward on the same views."""
    assert choose_fwd_kernel(*qkv_views(*shape)) == "wgmma"
    assert choose_fwd_kernel(*bh_views(*shape)) == "wgmma"


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
def test_the_models_own_projection_views_take_wgmma(dh):
    """q, k, v as Attention.project makes them from a bf16 activation."""
    cfg = Config(image_size=16, patch_size=8, embed_dim=2 * dh, num_heads=2, num_blocks=1,
                 num_classes=4).validate()
    model = build_model(cfg, "cpu")
    x = torch.zeros(2, cfg.num_patches, cfg.embed_dim, dtype=torch.bfloat16)
    with torch.no_grad():
        q, k, v = model.blocks[0].attn.project(x)
    assert q.shape == (2, cfg.num_patches, 2, dh) and q.stride(-1) == 1
    assert choose_fwd_kernel(q, k, v) == "wgmma"


def test_float32_takes_the_general_kernel():
    q, k, v = qkv_views(8, 256, 32, 160, torch.float32)
    assert not wgmma_takes(q, k, v)
    assert choose_fwd_kernel(q, k, v) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_fwd_kernel(q, k, v, "wgmma")


@pytest.mark.parametrize("shape", [(8, 256, 32, 160), (2, 4096, 16, 64)])
def test_misaligned_base_takes_the_general_kernel(shape):
    """A base one element (2 bytes) off 16 bytes."""
    q, k, v = qkv_views(*shape, offset=1)
    assert q.data_ptr() % 16 != 0
    assert choose_fwd_kernel(q, k, v) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_fwd_kernel(q, k, v, "wgmma")
    assert resolve_fwd_kernel(q, k, v, "general") == "general"


@pytest.mark.parametrize("axis", ["b", "n", "h"])
def test_strides_off_16_bytes_take_the_general_kernel(axis):
    """One of the batch, sequence and head strides not a multiple of 8
    elements, the head axis still contiguous."""
    b, n, h, dh = 2, 64, 4, 64
    pad = {"b": (b, n * h * dh + 4), "n": (b, n, h * dh + 4), "h": (b, n, h, dh + 4)}[axis]
    base = torch.empty(pad, dtype=torch.bfloat16)
    x = base[..., :pad[-1] - 4].view(b, n, h, dh)
    assert x.stride(-1) == 1 and x.stride({"b": 0, "n": 1, "h": 2}[axis]) % 8 != 0
    assert choose_fwd_kernel(x, x, x) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_fwd_kernel(x, x, x, "wgmma")


def test_strides_of_length_one_dims_are_not_read():
    """A dimension of size 1 is never stepped along: its stride may be
    anything (the C entry gives TMA the packed one)."""
    x = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16).as_strided((1, 64, 1, 64), (3, 64, 5, 1))
    assert choose_fwd_kernel(x, x, x) == "wgmma"


@pytest.mark.parametrize("scale", [-0.125, 0.0, float("nan"), float("inf")])
def test_scales_not_finite_and_positive_take_the_general_kernel(scale):
    """The wgmma kernel takes the max of the raw scores and puts the scale
    into the exponent, so it needs a finite scale > 0; the 4D, BH and
    streaming entries pass Dh ** -0.5 (1.0 in the mask read-back)."""
    q, k, v = qkv_views(8, 256, 32, 160)
    assert choose_fwd_kernel(q, k, v) == choose_fwd_kernel(q, k, v, 160 ** -0.5) == "wgmma"
    assert choose_fwd_kernel(q, k, v, 1.0) == "wgmma"
    assert choose_fwd_kernel(q, k, v, scale) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_fwd_kernel(q, k, v, "wgmma", scale)


@pytest.mark.parametrize("dh", [d for d in SUPPORTED_HEAD_DIMS if d not in WGMMA_HEAD_DIMS])
def test_head_dims_without_a_wgmma_build_take_the_general_kernel(dh):
    q, k, v = qkv_views(2, 128, 4, dh)
    assert choose_fwd_kernel(q, k, v) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_fwd_kernel(q, k, v, "wgmma")


def test_resolve_takes_valid_names_and_refuses_unknown_ones():
    q, k, v = qkv_views(8, 256, 32, 160)
    assert set(FWD_KERNELS) == {"wgmma", "general"}
    for name in FWD_KERNELS:
        assert resolve_fwd_kernel(q, k, v, name) == name
    assert resolve_fwd_kernel(q, k, v) == choose_fwd_kernel(q, k, v) == "wgmma"
    with pytest.raises(ValueError, match="no kernel"):
        resolve_fwd_kernel(q, k, v, "sdpa")
    with pytest.raises(ValueError, match="no kernel"):
        with forced_fwd_kernel("cudnn"):
            pass


def test_forced_kernel_applies_inside_the_block_only():
    q, k, v = qkv_views(8, 256, 32, 160)
    with forced_fwd_kernel("general"):
        assert resolve_fwd_kernel(q, k, v) == "general"
        with forced_fwd_kernel(None):
            assert resolve_fwd_kernel(q, k, v) == "wgmma"
        assert resolve_fwd_kernel(q, k, v) == "general"
    assert resolve_fwd_kernel(q, k, v) == "wgmma"
    f32 = qkv_views(2, 64, 2, 64, torch.float32)
    with forced_fwd_kernel("wgmma"):
        with pytest.raises(ValueError, match="wgmma does not take"):
            resolve_fwd_kernel(*f32)
    assert resolve_fwd_kernel(*f32) == "general"


@pytest.mark.parametrize("kernel", [None, "wgmma", "general"])
def test_wrapper_refuses_cpu_tensors_before_launching(kernel):
    q, k, v = qkv_views(1, 64, 2, 64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_fwd_cuda(q, k, v, 0.125, kernel=kernel)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("forced", [None, "wgmma", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing(forced, dtype):
    """On CPU tensors the dispatchers run the plain version whatever kernel
    is forced (forcing applies to launches), and count no launch."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3, 2, 64)).astype(np.float32)).to(dtype)
    q, k, v = qkv.unbind(2)
    before = dict(_build.LAUNCHES)
    with forced_fwd_kernel(forced):
        o, lse = flash_attention_fwd(q, k, v)
        o_s, lse_s = blocked_with_lse(q, k, v, 0.125, 64, 64)
    o_ref, lse_ref = attention_fwd_with_lse(q, k, v, 0.125)
    assert _build.LAUNCHES == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    assert (o_s.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse_s - lse_ref).abs().max().item() <= 1e-5


def test_launch_counters_have_a_key_per_forward_kernel():
    assert set(_build.FLASH_FWD_KERNELS) == {f"flash_attn_fwd_{name}" for name in FWD_KERNELS}
    assert set(_build.FLASH_FWD_KERNELS) <= set(_build.LAUNCHES)
