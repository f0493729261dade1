"""The attention backward's dispatch on the host: which of
vitax_torch/csrc/flash_attn_bwd.cu's kernel families a call takes
(ops/attention.py `choose_bwd_kernel`, a plain function of the types, the
head dim, the alignment, the strides and the scale's sign, over q, k, v, o
and dO), what the wrapper refuses, and that the CPU path still runs the
plain version.

Every main-path backward must take the wgmma kernels: the qkv-slice views
with a contiguous dO at the 10B train batch, bench.py's presets, the
long-context runs, the (B*H, N, 1, Dh) views of the BH and streaming BH
entries, and the model's own operands as autograd hands them over.
float32, a misaligned base of any operand, strides TMA does not take, head
dims the wgmma kernels are not built for and scales that are not finite
and positive take the general kernels. Operand tensors are made with
torch.empty on the CPU: the dispatch reads shapes, strides, types and base
addresses only. The `gpu` tests at the end hold both kernel families
against the plain version on a card."""

import numpy as np
import pytest
import torch

import bench
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.ops import _build
from vitax_torch.ops import attention as attn
from vitax_torch.ops.attention import (
    BWD_KERNELS,
    SUPPORTED_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    Dropout,
    attention_bwd_with_lse,
    bwd_wgmma_takes,
    choose_bwd_kernel,
    flash_attention_bwd,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
    forced_bwd_kernel,
    make_attention_impl,
    resolve_bwd_kernel,
)
from vitax_torch.ops.flash_blocked import blocked_with_lse, streaming_bwd_with_lse

TRAIN_BATCH = 32                       # chip_smoke.py's train path
LONG_SHAPES = ((2, 4096, 16, 64), (2, 9216, 16, 64))
OPERANDS = ("q", "k", "v", "o", "do")


def train_operands(b, n, h, dh, dtype=torch.bfloat16, offset=None):
    """q, k, v as the model makes them (slices of one (B, N, 3, H, Dh)
    tensor), o as the forward writes it and dO as autograd hands it over
    (contiguous (B, N, H, Dh)); `offset` = (operand, elements) moves one
    operand's base."""
    name, shift = offset or ("q", 0)
    flat = torch.empty(b * n * 3 * h * dh + 8, dtype=dtype)
    qkv = flat[shift if name in ("q", "k", "v") else 0:][:b * n * 3 * h * dh].view(b, n, 3, h, dh)
    xs = dict(zip(("q", "k", "v"), qkv.unbind(2)))
    for nm in ("o", "do"):
        buf = torch.empty(b * n * h * dh + 8, dtype=dtype)
        xs[nm] = buf[shift if nm == name else 0:][:b * n * h * dh].view(b, n, h, dh)
    return tuple(xs[nm] for nm in OPERANDS)


def bh_operands(b, n, h, dh, dtype=torch.bfloat16):
    """The BH entries' operands: (B*H, N, 1, Dh) views of (B*H, N, Dh)."""
    return tuple(torch.empty(b * h, n, dh, dtype=dtype)[:, :, None] for _ in OPERANDS)


def model_shape(cfg, batch):
    return batch, cfg.num_patches, cfg.num_heads, cfg.embed_dim // cfg.num_heads


def preset_shapes():
    out = []
    for name, kw in sorted(bench.train_presets(1).items()):
        cfg = Config(**{k: v for k, v in kw.items() if k != "moe_experts"}).validate()
        out.append(pytest.param(model_shape(cfg, cfg.batch_size), id=name))
    return out


def test_10b_train_batch_takes_wgmma():
    shape = model_shape(Config().validate(), TRAIN_BATCH)     # the 10B flagship: N 256, 32 heads, Dh 160
    assert shape == (32, 256, 32, 160)
    assert choose_bwd_kernel(*train_operands(*shape)) == "wgmma"
    assert choose_bwd_kernel(*bh_operands(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", preset_shapes())
def test_bench_presets_take_wgmma(shape):
    assert shape[3] in WGMMA_HEAD_DIMS
    assert choose_bwd_kernel(*train_operands(*shape)) == "wgmma"
    assert choose_bwd_kernel(*bh_operands(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_long_context_runs_take_wgmma(shape):
    """Phase 7L's ViT-L width at N 4096 and 9216: the streaming entries
    launch the same backward on the same views."""
    assert choose_bwd_kernel(*train_operands(*shape)) == "wgmma"
    assert choose_bwd_kernel(*bh_operands(*shape)) == "wgmma"


@pytest.mark.parametrize("dh", WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("n", [64, 2304])
def test_the_models_own_backward_operands_take_wgmma(monkeypatch, dh, n):
    """A bf16 attention block's backward on the CPU with the kernel path's
    core (whole-N at N 64, streaming at N 2304): every backward call
    receives operands the wgmma kernels take, dO as autograd hands it
    over."""
    seen = []
    real = attn.flash_attention_bwd

    def spy(q, k, v, o, lse, do, dlse, scale, dropout):
        seen.append(choose_bwd_kernel(q, k, v, o, do, scale))
        return real(q, k, v, o, lse, do, dlse, scale, dropout)

    monkeypatch.setattr(attn, "flash_attention_bwd", spy)
    cfg = Config(image_size=8 * int(n ** 0.5), patch_size=8, embed_dim=2 * dh, num_heads=2, num_blocks=1,
                 num_classes=4).validate()
    assert cfg.num_patches == n
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"))
    if n > attn.MAX_SEQ_IN_VMEM:
        from vitax_torch.ops import flash_blocked

        def stream_spy(bq, bk):
            inner = real_stream(bq, bk)

            def bwd(q, k, v, o, lse, do, dlse, scale, dropout):
                seen.append(choose_bwd_kernel(q, k, v, o, do, scale))
                return inner(q, k, v, o, lse, do, dlse, scale, dropout)
            return bwd

        real_stream = flash_blocked._streaming_bwd
        monkeypatch.setattr(flash_blocked, "_streaming_bwd", stream_spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, n, cfg.embed_dim)).astype(np.float32))
    q, k, v = model.blocks[0].attn.project(x.to(torch.bfloat16))
    out = model.blocks[0].attn.core(q, k, v)
    out.float().square().sum().backward()
    assert seen == ["wgmma"]


def test_float32_takes_the_general_kernel():
    xs = train_operands(8, 256, 32, 160, torch.float32)
    assert not bwd_wgmma_takes(*xs)
    assert choose_bwd_kernel(*xs) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_bwd_kernel(*xs, "wgmma")


@pytest.mark.parametrize("name", OPERANDS)
@pytest.mark.parametrize("shape", [(8, 256, 32, 160), (2, 4096, 16, 64)])
def test_misaligned_base_takes_the_general_kernel(name, shape):
    """One operand's base one element (2 bytes) off 16 bytes."""
    xs = train_operands(*shape, offset=(name, 1))
    assert xs[OPERANDS.index(name)].data_ptr() % 16 != 0
    assert choose_bwd_kernel(*xs) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_bwd_kernel(*xs, "wgmma")
    assert resolve_bwd_kernel(*xs, "general") == "general"


@pytest.mark.parametrize("axis", ["b", "n", "h"])
@pytest.mark.parametrize("name", ["q", "do"])
def test_strides_off_16_bytes_take_the_general_kernel(axis, name):
    """One of an operand's batch, sequence and head strides not a multiple
    of 8 elements, the head axis still contiguous: dO as a layout autograd
    could hand over, q as a view."""
    b, n, h, dh = 2, 64, 4, 64
    pad = {"b": (b, n * h * dh + 4), "n": (b, n, h * dh + 4), "h": (b, n, h, dh + 4)}[axis]
    odd = torch.empty(pad, dtype=torch.bfloat16)[..., :pad[-1] - 4].view(b, n, h, dh)
    assert odd.stride(-1) == 1 and odd.stride({"b": 0, "n": 1, "h": 2}[axis]) % 8 != 0
    xs = list(train_operands(b, n, h, dh))
    xs[OPERANDS.index(name)] = odd
    assert choose_bwd_kernel(*xs) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_bwd_kernel(*xs, "wgmma")


def test_strides_of_length_one_dims_are_not_read():
    """A dimension of size 1 is never stepped along: its stride may be
    anything (the C entry gives TMA the packed one)."""
    x = torch.empty(1, 64, 1, 64, dtype=torch.bfloat16).as_strided((1, 64, 1, 64), (3, 64, 5, 1))
    assert choose_bwd_kernel(x, x, x, x, x) == "wgmma"


@pytest.mark.parametrize("scale", [-0.125, 0.0, float("nan"), float("inf")])
def test_scales_not_finite_and_positive_take_the_general_kernel(scale):
    """The wgmma kernels put the scale into the exponent, so they need a
    finite scale > 0; the entries pass Dh ** -0.5 (1.0 in the mask
    read-back)."""
    xs = train_operands(8, 256, 32, 160)
    assert choose_bwd_kernel(*xs) == choose_bwd_kernel(*xs, 160 ** -0.5) == choose_bwd_kernel(*xs, 1.0) == "wgmma"
    assert choose_bwd_kernel(*xs, scale) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_bwd_kernel(*xs, "wgmma", scale)


@pytest.mark.parametrize("dh", [d for d in SUPPORTED_HEAD_DIMS if d not in WGMMA_HEAD_DIMS])
def test_head_dims_without_a_wgmma_build_take_the_general_kernel(dh):
    xs = train_operands(2, 128, 4, dh)
    assert choose_bwd_kernel(*xs) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        resolve_bwd_kernel(*xs, "wgmma")


def test_resolve_takes_valid_names_and_refuses_unknown_ones():
    xs = train_operands(8, 256, 32, 160)
    assert set(BWD_KERNELS) == {"wgmma", "general"}
    for name in BWD_KERNELS:
        assert resolve_bwd_kernel(*xs, name) == name
    assert resolve_bwd_kernel(*xs) == choose_bwd_kernel(*xs) == "wgmma"
    with pytest.raises(ValueError, match="no kernel"):
        resolve_bwd_kernel(*xs, "sdpa")
    with pytest.raises(ValueError, match="no kernel"):
        with forced_bwd_kernel("cudnn"):
            pass


def test_forced_kernel_applies_inside_the_block_only():
    xs = train_operands(8, 256, 32, 160)
    with forced_bwd_kernel("general"):
        assert resolve_bwd_kernel(*xs) == "general"
        with forced_bwd_kernel(None):
            assert resolve_bwd_kernel(*xs) == "wgmma"
        assert resolve_bwd_kernel(*xs) == "general"
    assert resolve_bwd_kernel(*xs) == "wgmma"
    f32 = train_operands(2, 64, 2, 64, torch.float32)
    with forced_bwd_kernel("wgmma"):
        with pytest.raises(ValueError, match="wgmma does not take"):
            resolve_bwd_kernel(*f32)
    assert resolve_bwd_kernel(*f32) == "general"


def test_forcing_the_backward_leaves_the_forward_alone():
    xs = train_operands(8, 256, 32, 160)
    with forced_bwd_kernel("general"):
        assert attn.resolve_fwd_kernel(*xs[:3]) == "wgmma"
    with attn.forced_fwd_kernel("general"):
        assert resolve_bwd_kernel(*xs) == "wgmma"


@pytest.mark.parametrize("kernel", [None, "wgmma", "general"])
def test_wrapper_refuses_cpu_tensors_before_launching(kernel):
    q, k, v, o, do = train_operands(1, 64, 2, 64)
    lse = torch.zeros(1, 2, 64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_bwd_cuda(q, k, v, o, lse, do, None, 0.125, kernel=kernel)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("forced", [None, "wgmma", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing(forced, dtype):
    """On CPU tensors the backward dispatchers run the plain version whatever
    kernel is forced (forcing applies to launches), and count no launch."""
    rng = np.random.default_rng(4)
    shape = (2, 40, 2, 64)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3, 2, 64)).astype(np.float32)).to(dtype)
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    dlse = torch.from_numpy(rng.standard_normal((2, 2, 40)).astype(np.float32))
    o, lse = attn.attention_fwd_with_lse(q, k, v, 0.125)
    before = dict(_build.LAUNCHES)
    with forced_bwd_kernel(forced):
        got = flash_attention_bwd(q, k, v, o, lse, do, dlse, 0.125)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o_s, lse_s = blocked_with_lse(*leaves, 0.125, 64, 64)
        torch.autograd.backward((o_s, lse_s), (do, dlse))
    want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, 0.125)
    assert _build.LAUNCHES == before
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    b, n, h, _ = shape
    bh = [attn._to_bh(x) for x in (q, k, v, o_s.detach(), do)]
    ref = streaming_bwd_with_lse(*bh[:4], lse_s.detach().reshape(b * h, n), bh[4], dlse.reshape(b * h, n), 0.125,
                                 64, 64)
    for leaf, w in zip(leaves, ref):
        assert torch.equal(leaf.grad, attn._from_bh(w, shape))


def test_launch_counters_have_a_key_per_backward_kernel():
    assert set(_build.FLASH_BWD_KERNELS) == {f"flash_attn_bwd_{name}" for name in BWD_KERNELS}
    assert set(_build.FLASH_BWD_KERNELS) <= set(_build.LAUNCHES)


# --- on a card (python -m pytest -m gpu tests/) ------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


GPU_SHAPES = [(1, 1, 2, 64), (2, 63, 2, 64), (1, 129, 2, 128), (2, 257, 2, 160), (1, 2049, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_both_backward_kernels_match_plain_on_card(cuda, shape, rate):
    """Each bf16 backward kernel family against attention_bwd_with_lse on
    strided q, k, v views with a nonzero dlse, at ragged N, Dh 64, 128 and
    160, under dropout with offsets past 2048; two calls bitwise equal; each
    call counts under its kernel's key."""
    b, n, h, dh = shape
    rng = np.random.default_rng(21)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, dh)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, torch.bfloat16)
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).to(cuda)
    drop = Dropout(2024, rate, 2100, 3000) if rate else None
    scale = dh ** -0.5
    with torch.inference_mode():
        o, lse = flash_attn_fwd_cuda(q, k, v, scale, drop)
        want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, drop)
        assert choose_bwd_kernel(q, k, v, o, do, scale) == "wgmma"
        for kernel in BWD_KERNELS:
            before = dict(_build.LAUNCHES)
            got = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=kernel)
            again = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=kernel)
            torch.cuda.synchronize()
            key = f"flash_attn_bwd_{kernel}"
            assert _build.LAUNCHES[key] == before[key] + 2
            for a, a2, w in zip(got, again, want):
                assert torch.equal(a, a2)
                assert (a.float() - w.float()).abs().max().item() <= 6e-3 * w.float().abs().max().item()


@pytest.mark.gpu
def test_wgmma_c_entry_refuses_operands_it_does_not_take(cuda):
    """The wgmma kernels forced on a misaligned dO raise in Python, and the
    C entry called directly returns an error: nothing is sent elsewhere."""
    import ctypes
    b, n, h, dh = 1, 64, 2, 64
    q, k, v = torch.zeros(b, n, 3, h, dh, device=cuda, dtype=torch.bfloat16).unbind(2)
    o = torch.zeros(b, n, h, dh, device=cuda, dtype=torch.bfloat16)
    do = torch.zeros(b * n * h * dh + 1, device=cuda, dtype=torch.bfloat16)[1:].view(b, n, h, dh)
    lse = torch.zeros(b, h, n, device=cuda)
    assert choose_bwd_kernel(q, k, v, o, do) == "general"
    with pytest.raises(ValueError, match="wgmma does not take"):
        flash_attn_bwd_cuda(q, k, v, o, lse, do, None, 0.125, kernel="wgmma")
    lib = _build.load(attn.BWD_KERNEL)
    outs = [torch.empty_like(o) for _ in range(3)]
    delta = torch.empty(b, h, n, device=cuda)
    strides = (ctypes.c_int64 * 15)(*(s for x in (q, k, v, o, do) for s in x.stride()[:3]))
    fn = lib.vitax_flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, *attn._DROPOUT_ARGTYPES, ctypes.c_int, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
             *(x.data_ptr() for x in outs), delta.data_ptr(), 1, b, n, h, dh, strides, 0.125,
             *attn._kernel_dropout_args(None), BWD_KERNELS["wgmma"], torch.cuda.current_stream().cuda_stream)
    assert err != 0

