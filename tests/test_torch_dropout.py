"""vitax_torch attention dropout against the JAX package: the counter-hash
keep-mask bit for bit, the plain dropout attention (4D and BH entry points,
and the dense oracle) and its gradients against the JAX kernels (Pallas
interpret mode on the CPU, as tests/test_ops.py runs them), the depth-3
model and 4 train steps with the JAX model's per-block seeds captured and
fed to the port, recompute under grad_ckpt, the statistics of the proj,
mlp and pos dropouts (torch's draws, not threefry), eval, the CLI, and (on
a card, `-m gpu`) the dropout kernels against their plain versions.

JAX is imported inside the tests that use it; inputs come from numpy seeds
and cross between the packages as numpy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint.convert import opt_state_from_jax, params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import DropoutSeeds, _dropout, _generator, build_model
from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    Dropout,
    _from_bh,
    _to_bh,
    attention_bwd_with_lse,
    attention_fwd_with_lse,
    dropout_keep_mask,
    dropout_threshold,
    flash4_dropout,
    flash4_dropout_lse,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
    flash_bh_dropout,
    flash_bh_dropout_lse,
    flash_bh_with_lse,
    keep_mask_bhqk,
    make_attention_impl,
    make_dense_dropout,
)
from vitax_torch.train.state import TrainState, build_optimizer
from vitax_torch.train.step import dropout_seeds, make_eval_step, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_classes=8, dtype="float32")
RATE = 0.35


def qkv_np(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def cot_np(shape, lse_shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal(lse_shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --- the keep-mask ----------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.35, 0.999])
@pytest.mark.parametrize("nq,nk", [(64, 64), (48, 80)])
@pytest.mark.parametrize("bh", [0, 5, 1023])
@pytest.mark.parametrize("seed", [0, 77, 0xFFFFFFFF])
def test_keep_mask_matches_jax_bitwise(seed, bh, nq, nk, rate):
    """Both layouts, with and without global offsets, equal to JAX's bits."""
    import jax.numpy as jnp
    from vitax.ops.attention import dropout_keep_mask as jax_mask
    for transposed in (False, True):
        for q0, k0 in ((0, 0), (13, 2000)):
            want = np.asarray(jax_mask(jnp.uint32(seed), jnp.uint32(bh), nq, nk, rate, transposed, q0, k0))
            got = dropout_keep_mask(seed, bh, nq, nk, rate, transposed, q0, k0)
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [0.5, 1 - 2 ** -30, 2 ** -33, 0.1])
def test_threshold_matches_jax(rate):
    """The uint32 threshold as JAX computes it in Python, and the masks at
    rates where it sits at the edges of the uint32 range."""
    import jax.numpy as jnp
    from vitax.ops.attention import dropout_keep_mask as jax_mask
    assert dropout_threshold(rate) == min(int(rate * 2 ** 32), 2 ** 32 - 1)
    assert dropout_threshold(0.5) == 2 ** 31 and dropout_threshold(1 - 2 ** -30) == 2 ** 32 - 4
    want = np.asarray(jax_mask(jnp.uint32(9), jnp.uint32(3), 64, 64, rate))
    np.testing.assert_array_equal(dropout_keep_mask(9, 3, 64, 64, rate).numpy(), want)


def test_mask_layout_of_the_4d_and_bh_blocks():
    """keep_mask_bhqk gives block (b, h) the index b*H + h, the JAX 4D
    kernel's program_id(0) * heads_total + head and the BH row."""
    drop = Dropout(seed=4242, rate=RATE, q0=3, k0=70)
    m = keep_mask_bhqk(drop, 2, 3, 20, 24, "cpu")
    for b in range(2):
        for h in range(3):
            torch.testing.assert_close(m[b, h], dropout_keep_mask(4242, b * 3 + h, 20, 24, RATE, q0=3, k0=70),
                                       rtol=0, atol=0)


# --- plain dropout attention against the JAX kernels --------------------------


SHAPES = [(2, 16, 2, 16), (2, 64, 4, 64), (1, 40, 2, 160)]


def _jax_vjp(fn, arrays, cotangents):
    import jax
    import jax.numpy as jnp
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in arrays))
    return out, vjp(tuple(jnp.asarray(c) for c in cotangents))


def _torch_vjp(fn, arrays, cotangents, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in arrays]
    o, lse = fn(*ts)
    do, dlse = cotangents
    ((o.float() * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()).backward()
    return (o, lse), [t.grad for t in ts]


@pytest.mark.parametrize("q0,k0", [(0, 0), (7, 300)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_flash4_dropout_matches_jax(shape, q0, k0):
    """f32: o, lse and the vjp (random dO, nonzero dlse) of the port's
    flash4_dropout_lse (plain forward and backward on the CPU) within 1e-5
    of the JAX one (kernels A6c/A6d, interpret mode)."""
    import jax.numpy as jnp
    from vitax.ops.attention import _seedvec, flash4_dropout_lse as jax_flash4_dropout_lse
    b, n, h, dh = shape
    q, k, v = qkv_np(shape, seed=20)
    cots = cot_np(shape, (b, h, n), seed=21)
    scale = dh ** -0.5
    (o_j, lse_j), g_j = _jax_vjp(
        lambda a, b_, c: jax_flash4_dropout_lse(a, b_, c, _seedvec(jnp.uint32(1234), q0, k0), scale, RATE),
        (q, k, v), cots)
    (o_t, lse_t), g_t = _torch_vjp(lambda a, b_, c: flash4_dropout_lse(a, b_, c, (1234, q0, k0), scale, RATE),
                                   (q, k, v), cots)
    o0, _ = attention_fwd_with_lse(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert (o_t - o0).abs().max() > 0.1                 # the mask dropped something
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _bf16_close(got, want, rel=2e-2, atol=1e-3):
    want = np.asarray(want, np.float32)
    assert np.abs(got.detach().float().numpy() - want).max() <= rel * np.abs(want).max() + atol


def test_plain_flash4_dropout_matches_jax_bf16():
    """bf16 inputs at the same cast points: o within 2e-2 (one bf16 rounding
    at |o| < 2), lse within 1e-5, grads within a couple of bf16 roundings
    (2e-2 of max |ref| + 1e-3), the bars of tests/test_torch_attention.py."""
    import jax
    import jax.numpy as jnp
    from vitax.ops.attention import _seedvec, flash4_dropout_lse as jax_flash4_dropout_lse
    shape = (2, 64, 4, 64)
    q, k, v = qkv_np(shape, seed=22)
    do, dlse = cot_np(shape, (2, 4, 64), seed=23)
    scale = 64 ** -0.5
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    (o_j, lse_j), vjp = jax.vjp(
        lambda a, b_, c: jax_flash4_dropout_lse(a, b_, c, _seedvec(jnp.uint32(5), 0, 0), scale, RATE), *args)
    g_j = vjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    drop = Dropout(5, RATE)
    o_t, lse_t = attention_fwd_with_lse(qt, kt, vt, scale, drop)
    g_t = attention_bwd_with_lse(qt, kt, vt, o_t, lse_t, torch.from_numpy(do).bfloat16(), torch.from_numpy(dlse),
                                 scale, drop)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    for g, w in zip(g_t, g_j):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_bh_dropout_matches_jax(dtype):
    """The BH entry (kernels A6a/A6b) with global offsets: f32 within 1e-5,
    bf16 at the bars above."""
    import jax
    import jax.numpy as jnp
    from vitax.ops.attention import _seedvec, flash_bh_dropout_lse as jax_flash_bh_dropout_lse
    bh, n, dh = 6, 48, 32
    q, k, v = qkv_np((bh, n, dh), seed=24)
    cots = cot_np((bh, n, dh), (bh, n), seed=25)
    scale = dh ** -0.5
    jdt = getattr(jnp, dtype)
    (o_j, lse_j), vjp = jax.vjp(
        lambda a, b_, c: jax_flash_bh_dropout_lse(a, b_, c, _seedvec(jnp.uint32(99), 11, 5), scale, RATE),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    g_j = vjp((jnp.asarray(cots[0], jdt), jnp.asarray(cots[1])))
    (o_t, lse_t), g_t = _torch_vjp(lambda a, b_, c: flash_bh_dropout_lse(a, b_, c, (99, 11, 5), scale, RATE),
                                   (q, k, v), cots, getattr(torch, dtype))
    assert o_t.shape == (bh, n, dh) and lse_t.shape == (bh, n)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
        for got, want in zip(g_t, g_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(o_t.detach().float().numpy(), np.asarray(o_j, np.float32), atol=2e-2)
        for got, want in zip(g_t, g_j):
            _bf16_close(got, want)


def test_plain_flash_bh_matches_jax():
    """The BH entry at rate 0 (kernels A3/A3b): o, lse and the vjp within
    1e-5 of flash_bh_with_lse."""
    from vitax.ops.attention import flash_bh_with_lse as jax_flash_bh_with_lse
    bh, n, dh = 4, 40, 16
    q, k, v = qkv_np((bh, n, dh), seed=26)
    cots = cot_np((bh, n, dh), (bh, n), seed=27)
    (o_j, lse_j), g_j = _jax_vjp(lambda a, b_, c: jax_flash_bh_with_lse(a, b_, c, 0.25), (q, k, v), cots)
    (o_t, lse_t), g_t = _torch_vjp(lambda a, b_, c: flash_bh_with_lse(a, b_, c, 0.25), (q, k, v), cots)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j), rtol=1e-5, atol=1e-5)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_dense_dropout_matches_jax(dtype, atol):
    import jax.numpy as jnp
    from vitax.ops.attention import make_dense_dropout as jax_make_dense_dropout
    q, k, v = qkv_np((2, 24, 2, 16), seed=28)
    want = jax_make_dense_dropout(RATE)(*(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.uint32(31))
    got = make_dense_dropout(RATE)(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)), 31)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_4d_and_bh_entries_drop_the_same_positions():
    """With q = k = 0 (uniform P) and V = I (N = Dh), o = mask / (N (1 -
    rate)): the nonzero pattern of either entry is the plain mask exactly,
    global offsets included; on random inputs the two entries agree."""
    b, h, n = 2, 3, 16
    drop = Dropout(seed=77, rate=RATE, q0=3, k0=1000)
    zero = torch.zeros(b, n, h, n)
    eye = torch.eye(n)[None, :, None, :].expand(b, n, h, n).contiguous()
    mask = keep_mask_bhqk(drop, b, h, n, n, "cpu")
    o4 = flash4_dropout(zero, zero, eye, drop.seed, 1.0, RATE, drop.q0, drop.k0)
    obh = flash_bh_dropout(_to_bh(zero), _to_bh(zero), _to_bh(eye), drop.seed, 1.0, RATE, drop.q0, drop.k0)
    assert 0 < mask.mean() < 1
    torch.testing.assert_close((o4 != 0).float().transpose(1, 2), mask, rtol=0, atol=0)
    torch.testing.assert_close((obh != 0).float(), mask.reshape(b * h, n, n), rtol=0, atol=0)
    torch.testing.assert_close(o4.transpose(1, 2), mask / (n * (1 - RATE)), rtol=1e-6, atol=0)
    q, k, v = (torch.from_numpy(x) for x in qkv_np((b, n, h, 16), seed=29))
    o4 = flash4_dropout(q, k, v, 5, 0.25, RATE, 2, 9)
    obh = _from_bh(flash_bh_dropout(_to_bh(q), _to_bh(k), _to_bh(v), 5, 0.25, RATE, 2, 9), q.shape)
    torch.testing.assert_close(o4, obh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["4d", "bh"])
def test_plain_dropout_gradcheck_float64(entry):
    """Both outputs of the Function's plain forward and backward under
    dropout, in float64 (the mask keeps some and drops some here)."""
    rng = np.random.default_rng(30)
    if entry == "4d":
        shape = (1, 6, 2, 4)
        fn = lambda a, b_, c: flash4_dropout_lse(a, b_, c, (5, 1, 2), 0.5, 0.3)  # noqa: E731
    else:
        shape = (2, 6, 4)
        fn = lambda a, b_, c: flash_bh_dropout_lse(a, b_, c, (5, 1, 2), 0.5, 0.3)  # noqa: E731
    ts = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True) for _ in range(3)]
    m = keep_mask_bhqk(Dropout(5, 0.3, 1, 2), 1, 2, 6, 6, "cpu")
    assert 0 < m.mean() < 1
    assert torch.autograd.gradcheck(fn, tuple(ts))


def test_cpu_dispatch_under_dropout_runs_the_plain_version_and_launches_nothing():
    shape = (2, 16, 2, 16)
    q, k, v = (torch.from_numpy(x) for x in qkv_np(shape, seed=31))
    do, dlse = (torch.from_numpy(x) for x in cot_np(shape, (2, 2, 16), seed=32))
    drop = Dropout(8, RATE, 4, 4)
    before = dict(_build.LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v, 0.25, drop)
    o_ref, lse_ref = attention_fwd_with_lse(q, k, v, 0.25, drop)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    got = flash_attention_bwd(q, k, v, o, lse, do, dlse, 0.25, drop)
    want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, 0.25, drop)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES == before
    assert set(_build.DROPOUT_KERNELS) <= set(_build.LAUNCHES)


def test_kernel_wrappers_refuse_cpu_tensors_under_dropout():
    q = torch.zeros(1, 4, 1, 16)
    drop = Dropout(1, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_fwd_cuda(q, q, q, 0.25, drop)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attn_bwd_cuda(q, q, q, q, torch.zeros(1, 1, 4), q, None, 0.25, drop)


@pytest.mark.parametrize("use_flash", [True, False])
def test_make_attention_impl_dropout_hook(use_flash):
    """At att_dropout > 0 the flash core carries vitax_dropout (the dropout
    kernels); at 0 it is the plain flash_attention; off, None (dense)."""
    cfg = Config(embed_dim=32, num_heads=2, att_dropout=0.1, use_flash_attention=use_flash).validate()
    impl = make_attention_impl(cfg, "cpu")
    if not use_flash:
        assert impl is None
        return
    q, k, v = (torch.from_numpy(x) for x in qkv_np((1, 8, 2, 16), seed=33))
    assert torch.equal(impl(q, k, v), flash_attention(q, k, v))
    torch.testing.assert_close(impl.vitax_dropout(q, k, v, 3), flash4_dropout(q, k, v, 3, 0.25, 0.1),
                               rtol=0, atol=0)
    assert make_attention_impl(Config(embed_dim=32, num_heads=2).validate(), "cpu") is flash_attention


# --- the model and the train step against JAX --------------------------------


def _capture(impl, seeds: list):
    """Wrap the JAX impl's vitax_dropout so each call records its uint32
    seed (jax.debug.callback fires once per block, and again on a remat
    recompute)."""
    import jax
    inner = impl.vitax_dropout

    def drop(q, k, v, seed):
        jax.debug.callback(lambda s: seeds.append(int(s)), seed)
        return inner(q, k, v, seed)

    impl.vitax_dropout = drop
    return impl


def _distinct(xs):
    out = []
    for x in xs:
        if x not in out:
            out.append(x)
    return out


def _flat(tree):
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=(n,)))


def test_model_forward_and_grads_match_jax_under_dropout():
    """Depth 3, f32, att_dropout 0.2: the JAX model (its dropout kernel
    A6c in interpret mode, scanned blocks, remat) applied with
    deterministic=False, its per-block seeds captured and handed to the
    port: logits within 1e-4 (the bar of tests/test_torch_vit.py), the
    loss within 2e-5 and every parameter's gradient within rtol 1e-4 /
    atol 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    dims = dict(TINY, num_blocks=3, att_dropout=0.2)
    jcfg = JaxConfig(**dims).validate()
    seeds = []
    jmodel = jax_build_model(jcfg, attention_impl=_capture(jax_make_attention_impl(jcfg, None, True), seeds))
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3), jnp.float32), True)
    x, labels = _images(4, seed=40)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x), False, rngs={"dropout": jax.random.key(7)})
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jax.effects_barrier()
    block_seeds = _distinct(seeds)
    assert len(block_seeds) == 3
    det = np.asarray(jmodel.apply(params, jnp.asarray(x), True))

    cfg = Config(**dims).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(_flat(params)), strict=True, assign=True)
    model.train()
    logits = model(torch.from_numpy(x), DropoutSeeds(blocks=tuple(block_seeds)))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert np.abs(np.asarray(jlogits) - det).max() > 1e-3       # dropout moved the logits
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    want = params_from_jax(_flat(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def _jax_train_setup(dims, seeds):
    """The JAX train state on a one-device mesh, its model's attention the
    dense core with make_dense_dropout as vitax_dropout (the same hash mask
    as the kernels), each call's seed captured."""
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_dense_dropout as jax_make_dense_dropout
    from vitax.ops.attention import reference_attention as jax_reference_attention
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state

    def impl(q, k, v):
        return jax_reference_attention(q, k, v)

    impl.vitax_dropout = jax_make_dense_dropout(dims["att_dropout"])
    cfg = JaxConfig(**dims).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:1])
    model = jax_build_model(cfg, attention_impl=_capture(impl, seeds))
    tx, schedule = jax_build_optimizer(cfg, max_iteration=10)
    state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
    return cfg, mesh, model, tx, schedule, state, sspecs


@pytest.mark.parametrize("arm", [dict(grad_ckpt=True), dict(grad_ckpt=True, grad_accum_steps=2)],
                         ids=["ckpt", "ckpt_accum2"])
def test_train_step_matches_jax_under_dropout(arm, monkeypatch):
    """4 steps under att_dropout 0.2 with warmup 2 from one state: the JAX
    make_train_step's per-(step, microbatch, block) seeds captured and fed
    to the port's step (in place of its dropout_seeds), losses within rtol 2e-4 / atol 2e-5 and
    every param within rtol 2e-3 / atol 2e-5 (the bars of
    tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp
    from vitax.ops.fused_optimizer import find_adam_state
    from vitax.train.step import make_train_step as jax_make_train_step
    dims = dict(TINY, num_blocks=2, att_dropout=0.2, batch_size=16, warmup_steps=2, lr=1e-3,
                weight_decay=0.1, clip_grad_norm=1.0, **arm)
    seeds = []
    jcfg, mesh, jmodel, tx, jschedule, jstate, sspecs = _jax_train_setup(dims, seeds)
    cfg = Config(**dims).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(_flat(jstate.params)), strict=True, assign=True)
    adam = find_adam_state(jstate.opt_state)
    mu, nu, count = opt_state_from_jax(_flat(adam.mu), _flat(adam.nu), adam.count)
    state = TrainState(step=0, model=model.train(), mu=mu, nu=nu, count=count)

    images, labels = _images(16, seed=41)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    step_fn = jax_make_train_step(jcfg, jmodel, tx, mesh, sspecs, schedule=jschedule)
    k_steps = cfg.grad_accum_steps
    want_losses, step_seeds = [], []
    for _ in range(4):
        seeds.clear()
        jstate, m = step_fn(jstate, jbatch, jax.random.key(1))
        want_losses.append(float(jax.device_get(m["loss"])))
        jax.effects_barrier()
        got = _distinct(seeds)
        assert len(got) == k_steps * cfg.num_blocks
        step_seeds.append(got)

    def captured_seeds(cfg_, step, k):
        mb = step_seeds[step][k * cfg.num_blocks:(k + 1) * cfg.num_blocks]
        return DropoutSeeds(blocks=tuple(mb))

    import vitax_torch.train.step as step_module
    monkeypatch.setattr(step_module, "dropout_seeds", captured_seeds)
    optimizer, _ = build_optimizer(cfg, 10)
    train_step = make_train_step(cfg, optimizer, "cpu")
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    got_losses = []
    for _ in range(4):
        state, metrics = train_step(state, batch)
        got_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-4, atol=2e-5)
    want = params_from_jax(_flat(jstate.params))
    got = state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


# --- the port's own dropout semantics --------------------------------------


ALL_DROPOUTS = dict(att_dropout=0.2, mlp_dropout=0.2, pos_dropout=0.2)


def test_grad_ckpt_replays_every_mask():
    """grad_ckpt on and off give the same gradients with all three dropouts
    on: the recompute redraws the attention, proj, mlp and pos masks."""
    images, labels = _images(8, seed=42)
    seeds = dropout_seeds(Config(**TINY, num_blocks=2), step=3, k=0)
    grads, losses = [], []
    for ckpt in (False, True):
        cfg = Config(**TINY, num_blocks=2, grad_ckpt=ckpt, **ALL_DROPOUTS).validate()
        model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu")).train()
        loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(images), seeds), torch.from_numpy(labels))
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad for p in model.parameters()])
    no_drop = build_model(Config(**TINY, num_blocks=2).validate(), "cpu")
    with torch.no_grad():
        plain_loss = torch.nn.functional.cross_entropy(no_drop(torch.from_numpy(images)), torch.from_numpy(labels))
    assert losses[0] == losses[1] and abs(losses[0] - plain_loss.item()) > 1e-4
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_generator_dropout_statistics(rate):
    """proj/mlp/pos dropout: the keep share within 5 sigma of 1 - rate, kept
    values scaled by exactly 1/(1 - rate) (as flax divides), the mask a pure
    function of the seed, other seeds other masks."""
    x = torch.rand(64, 500, dtype=torch.float32) + 1.0
    n = x.numel()
    y = _dropout(x, rate, _generator(11, "cpu"))
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    torch.testing.assert_close(y[kept], x[kept] / (1.0 - rate), rtol=0, atol=0)
    assert torch.equal(_dropout(x, rate, _generator(11, "cpu")), y)
    assert not torch.equal(_dropout(x, rate, _generator(12, "cpu")) != 0, kept)
    assert _dropout(x, rate, None) is x and _dropout(x, 0.0, _generator(11, "cpu")) is x


def test_dropout_seeds_are_a_host_function_of_seed_step_microbatch_block():
    cfg = Config(**TINY, num_blocks=4)
    s = dropout_seeds(cfg, 5, 1)
    assert s == dropout_seeds(cfg, 5, 1) and len(s.blocks) == 4
    assert all(isinstance(x, int) and 0 <= x < 2 ** 32 for x in (*s.blocks, s.pos))
    assert len(set(s.blocks)) == 4                                # blocks differ
    assert dropout_seeds(cfg, 6, 1).blocks != s.blocks            # steps differ
    assert dropout_seeds(cfg, 5, 0).blocks != s.blocks            # microbatches differ
    assert dropout_seeds(Config(**TINY, num_blocks=4, seed=1), 5, 1).blocks != s.blocks


def test_masks_differ_across_blocks_and_steps():
    """In the model: two steps' seeds give two different losses, one step's
    seeds the same loss twice; a block's attention mask follows its own
    seed (each block gets a distinct one)."""
    cfg = Config(**TINY, num_blocks=2, **ALL_DROPOUTS).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"))
    x = torch.from_numpy(_images(4, seed=43)[0])
    with torch.no_grad():
        a = model(x, dropout_seeds(cfg, 0, 0))
        b = model(x, dropout_seeds(cfg, 0, 0))
        c = model(x, dropout_seeds(cfg, 1, 0))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="3 dropout seeds for 2 blocks"):
        model(x, DropoutSeeds(blocks=(1, 2, 3)))


def test_dense_path_drops_with_the_kernels_mask():
    """--no_flash_attention under dropout: the dense path uses the same hash
    mask as the flash core, so the two models agree (f32, within 1e-5)."""
    x = torch.from_numpy(_images(3, seed=44)[0])
    seeds = DropoutSeeds(blocks=(123, 456))
    outs = []
    for flash in (True, False):
        cfg = Config(**TINY, num_blocks=2, att_dropout=0.3, use_flash_attention=flash).validate()
        with torch.no_grad():
            outs.append(build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"))(x, seeds))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_eval_under_a_dropout_config_equals_the_rate0_model():
    """No seeds, no dropout: the eval step and a forward without seeds under
    a dropout config are the rate-0 model's, bit for bit."""
    images, labels = _images(8, seed=45)
    cfg = Config(**TINY, num_blocks=2, **ALL_DROPOUTS).validate()
    cfg0 = Config(**TINY, num_blocks=2).validate()
    m, m0 = (build_model(c, "cpu", attention_impl=make_attention_impl(c, "cpu")) for c in (cfg, cfg0))
    x = torch.from_numpy(images)
    with torch.no_grad():
        assert torch.equal(m.train()(x), m0(x))
    batch = {"image": x, "label": torch.from_numpy(labels)}
    got = make_eval_step(cfg)(TrainState(step=0, model=m, mu=[], nu=[], count=None), batch)
    want = make_eval_step(cfg0)(TrainState(step=0, model=m0, mu=[], nu=[], count=None), batch)
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


def test_cli_trains_with_dropout_on_cpu():
    r = subprocess.run([sys.executable, "-m", "vitax_torch.train", "--device", "cpu", "--fake_data",
                        "--image_size", "16", "--patch_size", "8", "--embed_dim", "32", "--num_heads", "2",
                        "--num_blocks", "2", "--num_classes", "4", "--batch_size", "8", "--max_steps", "3",
                        "--log_step_interval", "1", "--warmup_steps", "1", "--test_epoch_interval", "1",
                        "--eval_max_batches", "1", "--att_dropout", "0.1", "--mlp_dropout", "0.1"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dropout: att 0.1 (in the flash core), mlp and proj 0.1" in r.stdout
    for step in (1, 2, 3):
        assert f"epoch 1 step {step}, lr: " in r.stdout
    assert "accuracy on val: " in r.stdout


# --- on a card (python -m pytest -m gpu tests/) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 197, 4, 64), (2, 50, 2, 16), (1, 130, 3, 160), (1, 64, 2, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_kernels_match_plain_on_card(cuda, shape, dtype):
    """Forward and backward dropout kernels against their plain versions on
    strided views, nonzero dlse and offsets; two backward runs bitwise equal;
    the bars of chip_smoke.py (o: 1e-5 f32 / 1.6e-2 bf16; grads 2e-6 / 6e-3
    of max |ref|)."""
    b, n, h, dh = shape
    rng = np.random.default_rng(50)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, dh)).astype(np.float32)).to(cuda, getattr(torch, dtype))
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, getattr(torch, dtype))
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).to(cuda)
    drop = Dropout(2024, 0.1, 5, 17)
    scale = dh ** -0.5
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, scale, drop)
        got = flash_attention_bwd(q, k, v, o, lse, do, dlse, scale, drop)
        again = flash_attention_bwd(q, k, v, o, lse, do, dlse, scale, drop)
        o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale, drop)
        want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, drop)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn_fwd_drop"] == before["flash_attn_fwd_drop"] + 1
    assert _build.LAUNCHES["flash_attn_bwd_drop"] == before["flash_attn_bwd_drop"] + 2
    assert _build.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"]
    tol_o, tol_g = (1e-5, 2e-6) if dtype == "float32" else (1.6e-2, 6e-3)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert (a.float() - w.float()).abs().max().item() <= tol_g * w.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_mask_recovered_bitwise_on_card(cuda, dtype):
    """q = k = 0 and V = I (N = Dh = 128): the kernel's nonzero pattern is
    the plain mask exactly, on the 4D and the BH entry, with offsets; a
    seed off by one gives another pattern."""
    b, h, n = 2, 3, 128
    drop = Dropout(77, 0.1, 3, 1000)
    zero = torch.zeros(b, n, h, n, device=cuda, dtype=getattr(torch, dtype))
    eye = torch.eye(n, device=cuda, dtype=zero.dtype)[None, :, None, :].expand(b, n, h, n).contiguous()
    with torch.no_grad():
        o4, _ = flash_attention_fwd(zero, zero, eye, 1.0, drop)
        obh = flash_bh_dropout(_to_bh(zero), _to_bh(zero), _to_bh(eye), drop.seed, 1.0, drop.rate, drop.q0, drop.k0)
    mask = keep_mask_bhqk(drop, b, h, n, n, cuda)
    assert torch.equal((o4 != 0).float().transpose(1, 2), mask)
    assert torch.equal((obh != 0).float(), mask.reshape(b * h, n, n))
    assert not torch.equal(keep_mask_bhqk(drop._replace(seed=78), b, h, n, n, cuda), mask)


@pytest.mark.gpu
def test_dropout_autograd_on_card_matches_cpu(cuda):
    """flash4_dropout_lse on the card (both dropout kernels, f32, TF32 off)
    against the same Function on the CPU (both plain versions)."""
    shape = (2, 40, 2, 32)
    q, k, v = qkv_np(shape, seed=51)
    do, dlse = cot_np(shape, (2, 2, 40), seed=52)
    grads = []
    for dev in ("cpu", "cuda"):
        ts = [torch.from_numpy(x).to(dev).requires_grad_(True) for x in (q, k, v)]
        o, lse = flash4_dropout_lse(*ts, (9, 2, 3), 32 ** -0.5, RATE)
        ((o * torch.from_numpy(do).to(dev)).sum() + (lse * torch.from_numpy(dlse).to(dev)).sum()).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
