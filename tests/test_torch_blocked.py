"""vitax_torch streaming attention (vitax_torch/ops/flash_blocked.py)
against the JAX package's streaming kernels A4, A5a and A5b (Pallas
interpret mode on the CPU, as tests/test_flash_blocked.py runs them): the
five entries' o, lse and vjp with a nonzero dlse at a ragged N, equal and
unequal blocks, f32 and bf16, rate 0 and 0.1 with global offsets; the
plain versions against the whole-N plain version and in float64
gradcheck; the dispatch past MAX_SEQ_IN_VMEM; the launch counters, the
block and grid checks; and (on a card, `-m gpu`) the kernels against the
plain versions at N > 2048.

JAX is imported inside the tests that use it; inputs come from numpy seeds
and cross between the packages as numpy.
"""

import numpy as np
import pytest
import torch

from vitax_torch.config import Config
from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    MAX_GRID_YZ,
    MAX_SEQ_IN_VMEM,
    Dropout,
    _from_bh,
    _select_path,
    _to_bh,
    choose_fwd_kernel,
    attention_bwd_with_lse,
    attention_fwd_with_lse,
    check_grid,
    flash_attention,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
    launch_key,
    make_attention_impl,
)
from vitax_torch.ops.flash_blocked import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    NEG_INF,
    blocked_bh_dropout,
    blocked_bh_dropout_lse,
    blocked_bh_with_lse,
    blocked_dropout_attention,
    blocked_flash_attention,
    blocked_with_lse,
    block_sizes,
    streaming_bwd_with_lse,
    streaming_fwd_with_lse,
)

N = 300                                  # ragged against every block below
RATE = 0.1
SEED = 1234
# f32: the same tile order in float32, so o, lse and the grads agree to
# about 1e-6 of max |ref| (summation order inside the products only).
F32_TOL = 1e-5
# bf16: o is cast to bf16 once after the same f32 recurrence, and the
# grads once after the same f32 sums, so a flipped rounding moves an entry
# by at most one bf16 ulp of the largest entry: 2^-8 of max |ref| is below
# that ulp (2^-8 to 2^-7 of it). Readings: at most 1e-4 (o) and 1e-3 (dq).
BF16_TOL = 2.0 ** -8


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


def _jax_entry(entry, scale, bq, bk, q0, k0, seed=SEED):
    """The JAX entry as fn(q, k, v) -> (o, lse) or o."""
    import jax.numpy as jnp
    from vitax.ops import flash_blocked as jb
    from vitax.ops.attention import _seedvec
    return {
        "bh_with_lse": lambda q, k, v: jb.blocked_bh_with_lse(q, k, v, scale, bq, bk),
        "bh_dropout_lse": lambda q, k, v: jb.blocked_bh_dropout_lse(q, k, v, _seedvec(jnp.uint32(seed), q0, k0),
                                                                   scale, RATE, bq, bk),
        "bh_dropout": lambda q, k, v: jb.blocked_bh_dropout(q, k, v, jnp.uint32(seed), scale, RATE, bq, bk),
        "4d": lambda q, k, v: jb.blocked_flash_attention(q, k, v, bq, bk),
        "4d_dropout": lambda q, k, v: jb.blocked_dropout_attention(q, k, v, jnp.uint32(seed), RATE, bq, bk),
    }[entry]


def _torch_entry(entry, scale, bq, bk, q0, k0, seed=SEED):
    return {
        "bh_with_lse": lambda q, k, v: blocked_bh_with_lse(q, k, v, scale, bq, bk),
        "bh_dropout_lse": lambda q, k, v: blocked_bh_dropout_lse(q, k, v, (seed, q0, k0), scale, RATE, bq, bk),
        "bh_dropout": lambda q, k, v: blocked_bh_dropout(q, k, v, seed, scale, RATE, bq, bk),
        "4d": lambda q, k, v: blocked_flash_attention(q, k, v, bq, bk),
        "4d_dropout": lambda q, k, v: blocked_dropout_attention(q, k, v, seed, RATE, bq, bk),
    }[entry]


# (entry, dtype, (block_q, block_k), (q0, k0)): every entry, equal and
# unequal blocks, both types, offsets near 0 and past 2048.
CASES = [
    ("bh_with_lse", "float32", (128, 128), (0, 0)),
    ("bh_with_lse", "bfloat16", (128, 256), (0, 0)),
    ("bh_dropout_lse", "float32", (128, 256), (5, 17)),
    ("bh_dropout_lse", "bfloat16", (128, 128), (2100, 3000)),
    ("bh_dropout", "float32", (128, 128), (0, 0)),
    ("4d", "float32", (128, 256), (0, 0)),
    ("4d_dropout", "bfloat16", (256, 128), (0, 0)),
]


@pytest.mark.parametrize("entry,dtype,blocks,offsets", CASES)
def test_streaming_entries_match_jax(entry, dtype, blocks, offsets):
    """o, lse (where the entry returns it) and the vjp with a random dO and
    a nonzero dlse against the JAX entry at N 300, at F32_TOL or BF16_TOL of
    max |ref|; under dropout the port at a seed off by one lands beyond the
    bar on o and on every gradient."""
    import jax
    import jax.numpy as jnp
    bq, bk = blocks
    q0, k0 = offsets
    shape = (2, N, 2, 16) if entry.startswith("4d") else (4, N, 16)
    dh = shape[-1]
    scale = dh ** -0.5
    with_lse = entry.endswith("lse")
    q, k, v, do = (_np(shape, s) for s in range(4))
    dlse = _np(shape[:2], 4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_j, vjp = jax.vjp(_jax_entry(entry, scale, bq, bk, q0, k0), *(jnp.asarray(x, jd) for x in (q, k, v)))
    g_j = vjp((jnp.asarray(do, jd), jnp.asarray(dlse)) if with_lse else jnp.asarray(do, jd))
    tol = F32_TOL if dtype == "float32" else BF16_TOL

    def run(seed):
        ts = [torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v)]
        out = _torch_entry(entry, scale, bq, bk, q0, k0, seed)(*ts)
        if with_lse:
            torch.autograd.backward(out, (torch.from_numpy(do).to(td), torch.from_numpy(dlse)))
        else:
            out.backward(torch.from_numpy(do).to(td))
        return out, [t.grad for t in ts]

    out_t, g_t = run(SEED)
    o_t, o_j = (out_t[0], out_j[0]) if with_lse else (out_t, out_j)
    assert o_t.dtype == td and tuple(o_t.shape) == shape
    assert _rel(o_t, o_j) <= tol
    if with_lse:
        assert out_t[1].dtype == torch.float32
        np.testing.assert_allclose(out_t[1].detach().numpy(), np.asarray(out_j[1]), rtol=1e-5, atol=1e-5)
    for got, want in zip(g_t, g_j):
        assert got.dtype == td and _rel(got, want) <= tol
    if "dropout" in entry:
        out_off, g_off = run(SEED + 1)
        assert _rel(out_off[0] if with_lse else out_off, o_j) > 10 * tol
        assert all(_rel(got, want) > 10 * tol for got, want in zip(g_off, g_j))


@pytest.mark.parametrize("drop", [None, Dropout(7, 0.3, 2100, 3000)])
@pytest.mark.parametrize("n,bq,bk", [(50, 16, 32), (64, 64, 64), (130, 128, 64)])
def test_plain_streaming_equals_the_whole_n_plain_version(n, bq, bk, drop):
    """f32: the streaming plain versions give what the whole-N plain version
    in the BH kernels' order computes (divide after PV), tile order aside."""
    shape = (3, n, 16)
    q, k, v, do = (torch.from_numpy(_np(shape, s)) for s in range(4))
    dlse = torch.from_numpy(_np(shape[:2], 4))
    o, lse = streaming_fwd_with_lse(q, k, v, 0.25, bq, bk, drop)
    views = [x[:, :, None] for x in (q, k, v)]
    o_ref, lse_ref = attention_fwd_with_lse(*views, 0.25, drop, normalize_first=False)
    torch.testing.assert_close(o, o_ref[:, :, 0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref[:, 0], rtol=1e-5, atol=1e-5)
    got = streaming_bwd_with_lse(q, k, v, o, lse, do, dlse, 0.25, bq, bk, drop)
    want = attention_bwd_with_lse(*views, o[:, :, None], lse[:, None], do[:, :, None], dlse[:, None], 0.25, drop)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w[:, :, 0], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("drop", [None, Dropout(11, 0.25, 2049, 5)])
def test_plain_streaming_gradcheck_float64(drop):
    """float64 gradcheck of the streaming entry in both outputs (o and
    lse) at a ragged N and unequal blocks."""
    shape = (1, 13, 2, 4)
    ts = tuple(torch.from_numpy(_np(shape, s)).double().requires_grad_(True) for s in range(3))
    assert torch.autograd.gradcheck(lambda q, k, v: blocked_with_lse(q, k, v, 0.35, 4, 8, drop), ts)


def test_padding_and_block_choice():
    """JAX's block rule (min(block, N rounded up to 128)), the defaults,
    and the padded key columns masked to NEG_INF: o of a sequence equals o
    of the same sequence with its keys padded by junk the mask hides."""
    assert (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K, NEG_INF) == (512, 1024, -1e30)
    assert block_sizes(300, 512, 1024) == (384, 384)
    assert block_sizes(2304, 512, 1024) == (512, 1024)
    assert block_sizes(100, 64, 1024) == (64, 128)
    for bad in ((0, 128), (128, -1), (128.0, 128)):
        with pytest.raises(ValueError, match="positive ints"):
            block_sizes(300, *bad)
    q = torch.from_numpy(_np((2, 40, 16), 0))
    o, lse = streaming_fwd_with_lse(q, q, q, 0.25, 32, 64)
    o_ref, lse_ref = streaming_fwd_with_lse(q, q, q, 0.25, 40, 40)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-6)


def test_select_path_and_make_attention_impl_dispatch():
    """Past MAX_SEQ_IN_VMEM (2048) tokens the core is the streaming entry,
    up to it the whole-N one, for the plain hook and the dropout hook, each
    named for the startup log; the streaming core computes what
    blocked_flash_attention does."""
    assert MAX_SEQ_IN_VMEM == 2048
    assert _select_path(2048) == "4d" and _select_path(2049) == "streaming"
    dims = dict(embed_dim=32, num_heads=2, patch_size=2)
    long_cfg = Config(image_size=96, **dims).validate()          # N 2304
    short_cfg = Config(image_size=32, **dims).validate()         # N 256
    assert (long_cfg.num_patches, short_cfg.num_patches) == (2304, 256)
    assert make_attention_impl(long_cfg, "cpu") is blocked_flash_attention
    assert make_attention_impl(short_cfg, "cpu") is flash_attention
    assert blocked_flash_attention.vitax_name == "streaming" and flash_attention.vitax_name == "whole-N"
    q, k, v = (torch.from_numpy(_np((1, 2304, 2, 16), s)) for s in range(3))
    for cfg, name in ((long_cfg, "streaming"), (short_cfg, "whole-N")):
        impl = make_attention_impl(Config(**{**vars(cfg), "att_dropout": RATE}).validate(), "cpu")
        assert impl.vitax_name == name
    impl = make_attention_impl(Config(**{**vars(long_cfg), "att_dropout": RATE}).validate(), "cpu")
    before = dict(_build.LAUNCHES)
    torch.testing.assert_close(impl(q, k, v), blocked_flash_attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(impl.vitax_dropout(q, k, v, 9), blocked_dropout_attention(q, k, v, 9, RATE),
                               rtol=0, atol=0)
    short = make_attention_impl(Config(**{**vars(short_cfg), "att_dropout": RATE}).validate(), "cpu")
    qs, ks, vs = (x[:, :256] for x in (q, k, v))
    torch.testing.assert_close(short.vitax_dropout(qs, ks, vs, 9), blocked_dropout_attention(qs, ks, vs, 9, RATE),
                               rtol=1e-5, atol=1e-6)
    assert _build.LAUNCHES == before                   # nothing launches on the CPU
    assert make_attention_impl(Config(**{**vars(long_cfg), "use_flash_attention": False}).validate(), "cpu") is None


def test_cpu_streaming_runs_the_plain_version_and_launches_nothing():
    """On CPU tensors every streaming entry runs the plain versions (the
    same numbers as calling them on the BH layout) and no counter moves;
    the counters of the streaming path exist beside the whole-N ones."""
    assert set(_build.STREAM_KERNELS) == {"flash_attn_fwd_stream", "flash_attn_bwd_stream",
                                          "flash_attn_fwd_stream_drop", "flash_attn_bwd_stream_drop"}
    assert set(_build.STREAM_KERNELS) <= set(_build.LAUNCHES)
    shape = (2, 70, 3, 16)
    q, k, v, do = (torch.from_numpy(_np(shape, s)) for s in range(4))
    drop = Dropout(3, RATE, 2100, 7)
    before = dict(_build.LAUNCHES)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = blocked_with_lse(*leaves, 0.25, 32, 64, drop)
    o.backward(do)
    bh = [_to_bh(x) for x in (q, k, v)]
    o_ref, lse_ref = streaming_fwd_with_lse(*bh, 0.25, 32, 64, drop)
    want = streaming_bwd_with_lse(*bh, o_ref, lse_ref, _to_bh(do), None, 0.25, 32, 64, drop)
    assert torch.equal(o, _from_bh(o_ref, shape)) and torch.equal(lse, lse_ref.reshape(2, 3, 70))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, _from_bh(w, shape))
    assert _build.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors_with_a_stream_counter():
    """The wrappers count a launch past MAX_SEQ_IN_VMEM tokens under the
    streaming keys (`launch_key`), and refuse CPU tensors there before
    counting anything."""
    drop = Dropout(3, RATE)
    assert [launch_key(MAX_SEQ_IN_VMEM, d, bwd) for bwd in (False, True) for d in (None, drop)] == [
        "flash_attn_fwd", "flash_attn_fwd_drop", "flash_attn_bwd", "flash_attn_bwd_drop"]
    assert [launch_key(MAX_SEQ_IN_VMEM + 1, d, bwd) for bwd in (False, True) for d in (None, drop)] == [
        "flash_attn_fwd_stream", "flash_attn_fwd_stream_drop", "flash_attn_bwd_stream", "flash_attn_bwd_stream_drop"]
    n = MAX_SEQ_IN_VMEM + 256
    q = torch.zeros(1, n, 1, 16)
    before = dict(_build.LAUNCHES)
    for d in (None, drop):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            flash_attn_fwd_cuda(q, q, q, 0.25, d)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            flash_attn_bwd_cuda(q, q, q, q, torch.zeros(1, 1, n), q, None, 0.25, d)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("b,h,ok", [(MAX_GRID_YZ, 1, True), (1, MAX_GRID_YZ, True), (MAX_GRID_YZ + 1, 1, False),
                                    (4096 * 16, 1, False), (1, 70000, False)])
def test_grid_limit_is_a_clear_error(b, h, ok):
    """The kernels' grid (ceil(N/64), H, B) takes B and H up to 65535 each;
    past that the shape check raises a ValueError that names the limit (a
    BH view of 4096 images x 16 heads has 65536 rows) instead of the
    launch failing with an opaque CUDA error."""
    if ok:
        check_grid("flash_attn_fwd", b, 4097, h)
    else:
        with pytest.raises(ValueError, match="65535, the CUDA grid's y/z limit"):
            check_grid("flash_attn_fwd", b, 4097, h)


# --- on the card (`-m gpu`) ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2304, 2, 64), (1, 4097, 2, 16), (1, 2200, 1, 160)])
def test_streaming_kernels_match_plain_on_card(cuda, shape, dtype, rate):
    """The streaming entry on strided card tensors (the kernels) against
    the plain versions at 64 x 64 tiles, with offsets past 2048 and a
    nonzero dlse, at the bars of chip_smoke.py's phase 3L; the launches
    count under the streaming keys only (and the forward's and the
    backward's kernel keys: the wgmma backward for bf16 at Dh 64 and 160,
    the general one for f32 and Dh 16)."""
    b, n, h, dh = shape
    td = getattr(torch, dtype)
    qkv = torch.from_numpy(_np((b, n, 3, h, dh), 0)).to(cuda, td)
    do = torch.from_numpy(_np(shape, 1)).to(cuda, td)
    dlse = torch.from_numpy(_np((b, h, n), 2)).to(cuda)
    drop = Dropout(5, rate, 2100, 3000) if rate else None
    leaf = qkv.clone().requires_grad_(True)
    before = dict(_build.LAUNCHES)
    o, lse = blocked_with_lse(*leaf.unbind(2), dh ** -0.5, 64, 64, drop)
    torch.autograd.backward((o, lse), (do, dlse))
    moved = {key: val - before[key] for key, val in _build.LAUNCHES.items() if val != before[key]}
    suffix = "" if drop is None else "_drop"
    kernel = choose_fwd_kernel(*qkv.unbind(2))
    bwd_kernel = "wgmma" if dtype == "bfloat16" and dh in (64, 160) else "general"
    assert moved == {f"flash_attn_fwd_stream{suffix}": 1, f"flash_attn_bwd_stream{suffix}": 1,
                     f"flash_attn_fwd_{kernel}": 1, f"flash_attn_bwd_{bwd_kernel}": 1}
    with torch.no_grad():
        bh = [_to_bh(x) for x in qkv.unbind(2)]
        o_ref, lse_ref = streaming_fwd_with_lse(*bh, dh ** -0.5, 64, 64, drop)
        want = streaming_bwd_with_lse(*bh, _to_bh(o.detach()), lse.detach().reshape(b * h, n), _to_bh(do),
                                      dlse.reshape(b * h, n), dh ** -0.5, 64, 64, drop)
    tol_o, tol_g = (1.6e-2, 2e-2) if dtype == "bfloat16" else (1e-5, 1e-5)

    def rel(a, w):
        return ((a.float() - w.float()).abs().max() / w.float().abs().max()).item()

    assert rel(o.detach(), _from_bh(o_ref, shape)) <= tol_o
    assert (lse.detach() - lse_ref.reshape(b, h, n)).abs().max().item() <= 5e-6
    for got, w in zip(leaf.grad.unbind(2), want):
        assert rel(got, _from_bh(w, shape)) <= tol_g
