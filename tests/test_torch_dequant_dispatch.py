"""Kernel C's dispatch on the host: which of vitax_torch/csrc/dequant_matmul.cu's
two kernels a launch takes (ops/dequant_matmul.py `choose_kernel`, a plain
function of the shape, the types and the alignment), what the wrapper
refuses, and that the CPU path still runs the plain version.

Every Dense site of the 10B serve model, and of the widths of bench.py's
presets, must take the wgmma kernel in all three modes (bf16 x with int8
or e4m3 codes, int8 x with int8 codes); ragged K and misaligned bases take
the general kernel. Operand tensors are made with torch.empty on the CPU:
the dispatch reads shapes, types and base addresses only."""

import numpy as np
import pytest
import torch

from vitax_torch.config import Config
from vitax_torch.models.vit import Quant, QuantLinear, build_model
from vitax_torch.ops import _build
from vitax_torch.ops.dequant_matmul import (KERNELS, MAX_ACT_K, TMA_ALIGN, choose_kernel, dequant_matmul,
                                            dequant_matmul_cuda, dequant_matmul_plain, kernel_takes,
                                            resolve_kernel, wgmma_takes, wgmma_tile)

# (x dtype, w dtype) of the three tensor-core modes, and the wgmma
# arrangement each takes: weight-only converts the codes into registers
# (rs), act mode reads both int8 tiles from shared memory (ss)
MODES = {"bf16_int8": (torch.bfloat16, torch.int8), "bf16_e4m3": (torch.bfloat16, torch.float8_e4m3fn),
         "int8_int8": (torch.int8, torch.int8)}
ROUTE = {"bf16_int8": "rs", "bf16_e4m3": "rs", "int8_int8": "ss"}
# bench.py presets' (embed_dim, mlp hidden) widths: b16, l14, 10b
PRESET_WIDTHS = [(768, 3072), (1024, 4096), (5120, 20480)]
BUCKET_IMAGES = (1, 2, 4, 8)


def serve_sites():
    """(name, K, F, is_head) of every Dense site of the 10B serve model,
    read off the quantized model built on the meta device (no storage)."""
    cfg = Config(serve_quant_dtype="int8").validate()
    model = build_model(cfg, "meta", init=False, quant=Quant("int8", lambda *a, **k: None))
    sites = [(name, mod.weight.shape[1], mod.weight.shape[0], name == "head")
             for name, mod in model.named_modules() if isinstance(mod, QuantLinear)]
    return cfg, sites


def operands(m, k, f, mode, x_offset=0, w_offset=0):
    """Uninitialised CPU operands of the mode's types, each base moved by
    an offset in elements (0 keeps the allocator's alignment)."""
    xdt, wdt = MODES[mode]
    x = torch.empty(m * k + x_offset, dtype=xdt)[x_offset:].view(m, k)
    w = torch.empty(f * k + w_offset, dtype=wdt)[w_offset:].view(f, k)
    return x, w


def test_serve_model_has_129_sites_of_four_shapes():
    cfg, sites = serve_sites()
    assert len(sites) == 4 * cfg.num_blocks + 1 == 129
    assert {(k, f) for _, k, f, head in sites if not head} == {(5120, 15360), (5120, 5120), (5120, 20480),
                                                               (20480, 5120)}
    assert [(k, f) for _, k, f, head in sites if head] == [(5120, 1000)]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("images", BUCKET_IMAGES)
def test_every_serve_site_takes_the_wgmma_kernel(mode, images):
    """Each of the 129 Dense sites of the 10B serve model, at every bucket:
    block sites at M = images x 256 tokens, the head at M = images."""
    cfg, sites = serve_sites()
    seen = {}
    for name, k, f, head in sites:
        m = images if head else images * cfg.num_patches
        key = (m, k, f)
        if key not in seen:
            x, w = operands(m, k, f, mode)
            seen[key] = choose_kernel(x, w)
        assert seen[key].startswith(f"wgmma_{ROUTE[mode]}_"), (name, key, seen[key])
    assert len(seen) == 5


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dim,hidden", PRESET_WIDTHS)
@pytest.mark.parametrize("m", [1, 8, 197, 256, 2048])
def test_preset_widths_take_the_wgmma_kernel(mode, dim, hidden, m):
    for k, f in ((dim, 3 * dim), (dim, dim), (dim, hidden), (hidden, dim), (dim, 1000)):
        x, w = operands(m, k, f, mode)
        assert choose_kernel(x, w) in (f"wgmma_{ROUTE[mode]}_n128", f"wgmma_{ROUTE[mode]}_n256"), (m, k, f)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k", [33, 257, 520, 8, 1000])
def test_ragged_k_takes_the_general_kernel(mode, k):
    x, w = operands(64, k, 96, mode)
    assert not wgmma_takes(x, w)
    assert choose_kernel(x, w) == "general"
    for name in KERNELS:
        assert kernel_takes(name, x, w) == (name == "general")
    with pytest.raises(ValueError, match="does not take"):
        resolve_kernel(x, w, f"wgmma_{ROUTE[mode]}_n256")
    assert resolve_kernel(x, w, "general") == "general"


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("which", ["x", "w"])
def test_misaligned_bases_take_the_general_kernel(mode, which):
    """A base one element off 16 bytes (2 bytes for bf16 x, 1 for int8
    codes), at a main-path shape."""
    x, w = operands(2048, 5120, 5120, mode, x_offset=int(which == "x"), w_offset=int(which == "w"))
    assert (x.data_ptr() % TMA_ALIGN != 0) == (which == "x")
    assert (w.data_ptr() % TMA_ALIGN != 0) == (which == "w")
    assert choose_kernel(x, w) == "general"
    with pytest.raises(ValueError, match="does not take"):
        resolve_kernel(x, w, f"wgmma_{ROUTE[mode]}_n128")


def test_float32_x_takes_the_general_kernel():
    x = torch.empty(2048, 5120)
    w = torch.empty(5120, 5120, dtype=torch.int8)
    assert choose_kernel(x, w) == "general"
    for name in KERNELS.keys() - {"general"}:
        with pytest.raises(ValueError, match="does not take"):
            resolve_kernel(x, w, name)


@pytest.mark.parametrize("route,m,f,tile", [
    # bucket 8's rows: every block site takes the 256 tile in both arrangements
    ("rs", 2048, 15360, 256), ("rs", 2048, 5120, 256), ("rs", 2048, 20480, 256),
    ("ss", 2048, 15360, 256), ("ss", 2048, 5120, 256), ("ss", 2048, 20480, 256),
    # bucket 1's: qkv keeps 256 (one wave of 120 tiles); proj and fc2 take 128
    # (40 tiles of 256 leave 92 SMs idle); fc1 takes 256 in rs (2 waves beat 3)
    # and 128 in ss, whose 256 tile costs more
    ("rs", 256, 15360, 256), ("rs", 256, 5120, 128), ("rs", 256, 20480, 256),
    ("ss", 256, 15360, 256), ("ss", 256, 5120, 128), ("ss", 256, 20480, 128),
    # the head at M 1-8: one wave either way, the 128 tile is cheaper
    ("rs", 1, 1000, 128), ("rs", 8, 1000, 128), ("ss", 8, 1000, 128)])
def test_tile_choice_follows_the_wave_model(route, m, f, tile):
    assert wgmma_tile(route, m, f) == f"wgmma_{route}_n{tile}"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kernels_taking_aligned_operands(mode):
    """Aligned, K % 16 == 0: the general kernel and both tiles of the
    mode's wgmma arrangement (rs for bfloat16 x, ss for int8 x)."""
    x, w = operands(256, 5120, 5120, mode)
    taking = {name for name in KERNELS if kernel_takes(name, x, w)}
    want = {"general", f"wgmma_{ROUTE[mode]}_n128", f"wgmma_{ROUTE[mode]}_n256"}
    assert taking == want
    for name in sorted(KERNELS.keys() - want):
        with pytest.raises(ValueError, match="does not take"):
            resolve_kernel(x, w, name)


def test_resolve_kernel_refuses_unknown_names_and_keeps_valid_ones():
    x, w = operands(256, 5120, 5120, "bf16_int8")
    with pytest.raises(ValueError, match="no kernel"):
        resolve_kernel(x, w, "cublas")
    for name in ("general", "wgmma_rs_n128", "wgmma_rs_n256"):
        assert resolve_kernel(x, w, name) == name
    assert resolve_kernel(x, w) == choose_kernel(x, w)


@pytest.mark.parametrize("case,match", [
    ("x_float16", "weight-only mode takes bfloat16 or float32 x"),
    ("w_float32", "int8 or float8_e4m3fn"),
    ("k_mismatch", "does not contract"),
    ("scale_float64", "scale must be float32"),
    ("non_contiguous", "contiguous"),
    ("act_fp8", "act mode takes int8 x and int8 w"),
    ("act_bf16_x", "act mode takes int8 x and int8 w"),
    ("act_sx_shape", "sx must be a float32 scalar"),
    ("act_k_too_long", "act mode needs K"),
    ("cpu", "CUDA tensors only"),
])
def test_wrapper_refuses_what_neither_kernel_takes(case, match):
    """The wrapper's own errors, before anything is built or launched."""
    m, k, f = 4, 32, 8
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w = torch.zeros(f, k, dtype=torch.int8)
    s = torch.ones(f)
    sx = None
    if case == "x_float16":
        x = x.half()
    elif case == "w_float32":
        w = w.float()
    elif case == "k_mismatch":
        w = torch.zeros(f, k + 16, dtype=torch.int8)
    elif case == "scale_float64":
        s = s.double()
    elif case == "non_contiguous":
        x = torch.zeros(m, 2 * k, dtype=torch.bfloat16)[:, ::2]
    elif case == "act_fp8":
        x, w, sx = x.to(torch.int8), w.view(torch.float8_e4m3fn), torch.tensor(1.0)
    elif case == "act_bf16_x":
        sx = torch.tensor(1.0)
    elif case == "act_sx_shape":
        x, sx = x.to(torch.int8), torch.ones(2)
    elif case == "act_k_too_long":
        k = MAX_ACT_K + 16
        x, w, sx = torch.zeros(1, k, dtype=torch.int8), torch.zeros(1, k, dtype=torch.int8), torch.tensor(1.0)
        s = torch.ones(1)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        dequant_matmul_cuda(x, w, s, sx)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("m,k,f", [(16, 64, 32), (5, 33, 17), (6, 160, 48)])
def test_cpu_path_runs_the_plain_version(m, k, f, act):
    """On CPU tensors dequant_matmul is the plain version, whichever kernel
    the card would take, and launches nothing."""
    rng = np.random.default_rng(m * k + f)
    x = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, (f, k)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-3, f).astype(np.float32))
    before = dict(_build.LAUNCHES)
    got = dequant_matmul(x, w, s, act=act)
    assert _build.LAUNCHES == before
    assert got.shape == (2, m, f) and got.dtype == torch.float32
    torch.testing.assert_close(got, dequant_matmul_plain(x, w, s, act=act), rtol=0, atol=0)


def test_ab_tool_needs_a_card():
    """vitax_torch.tools.dequant_ab times kernel C against a variant source
    on a card; without one it says so and exits 2, building nothing."""
    from vitax_torch.tools import dequant_ab
    before = dict(_build.LAUNCHES)
    assert dequant_ab.main(["variant.cu", "--m", "256"]) == 2
    assert _build.LAUNCHES == before
