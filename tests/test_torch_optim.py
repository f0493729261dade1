"""vitax_torch fused clip+AdamW: the plain version against the JAX package's
kernel (fused_clip_adamw in Pallas interpret mode) and against the optax
chain of build_optimizer, both clip branches over 3 steps at the
tests/test_fused_optimizer.py bar (rtol 1e-6; see _assert_close); the lr schedule,
the global norm, the dispatch policy; and (on a card, `-m gpu`) the kernel
against its plain version. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from vitax_torch.config import Config
from vitax_torch.ops import _build
from vitax_torch.ops.fused_optimizer import (clip_adamw_, fused_adamw_cuda, fused_clip_adamw,
                                             fused_optimizer_active, global_norm, step_scalars)
from vitax_torch.train.schedule import warmup_cosine_schedule
from vitax_torch.train.state import ADAMW_HPARAMS

B1, B2, EPS = ADAMW_HPARAMS["b1"], ADAMW_HPARAMS["b2"], ADAMW_HPARAMS["eps"]
SHAPES = {"a": (5, 3), "b": (7,), "c": (33, 131), "d": (1,), "e": (2, 3, 4)}
WD, LR, WARMUP, MAX_ITER = 0.1, 1e-2, 1, 10


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _jax_scal(count, g, clip):
    """[clip_scale, lr, bc1, bc2] computed as vitax fused_clip_adamw does."""
    import jax.numpy as jnp
    import optax
    from vitax.train.schedule import warmup_cosine_schedule as jax_schedule
    norm = optax.global_norm(g)
    c = jnp.int32(count) + 1
    return np.asarray([jnp.where(norm < clip, 1.0, clip / norm), jax_schedule(LR, WARMUP, MAX_ITER)(count),
                       1 - B1 ** c, 1 - B2 ** c], np.float32)


def _plain_run(params, grads, clip):
    """3 steps of clip_adamw_ on CPU tensors, each fed the JAX package's
    step scalars, so the comparison is the update's alone."""
    import jax.numpy as jnp
    p = [torch.from_numpy(v.copy()) for v in params.values()]
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    for count, g_np in enumerate(grads):
        scal = _jax_scal(count, {k: jnp.asarray(v) for k, v in g_np.items()}, clip)
        clip_adamw_(p, [torch.from_numpy(g_np[k]) for k in params], mu, nu, torch.from_numpy(scal),
                    (B1, B2, EPS, WD))
    return [dict(zip(params, [x.numpy() for x in xs])) for xs in (p, mu, nu)]


def _assert_close(got, want, rtol=1e-6):
    """rtol 1e-6, with an atol of 1e-6 of the leaf's largest magnitude: XLA
    on the CPU contracts a * b + c into one FMA where the port rounds each
    op (as its kernel does), and the moment update cancels where g and mu
    have opposite signs, so an element near zero can differ by more ulps
    than the relative term allows (measured: 1e-7 of the leaf's scale)."""
    for k in want:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=rtol,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip_triggers", "clip_idle"])
def test_plain_matches_jax_fused_kernel(clip):
    import jax
    import jax.numpy as jnp
    import optax
    from vitax.ops.fused_optimizer import find_adam_state, fused_clip_adamw as jax_fused
    from vitax.train.schedule import warmup_cosine_schedule as jax_schedule

    params, grads = _trees(0)
    sched = jax_schedule(LR, WARMUP, MAX_ITER)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = (optax.ScaleByAdamState(count=jnp.int32(0), mu=jax.tree.map(jnp.zeros_like, p),
                                    nu=jax.tree.map(jnp.zeros_like, p)),)
    for g_np in grads:
        g = {k: jnp.asarray(v) for k, v in g_np.items()}
        p, state = jax_fused(g, state, p, grad_norm=optax.global_norm(g), schedule=sched,
                             clip_norm=clip, weight_decay=WD, b1=B1, b2=B2, eps=EPS, interpret=True)
    adam = find_adam_state(state)
    got_p, got_mu, got_nu = _plain_run(params, grads, clip)
    _assert_close(got_p, p)
    _assert_close(got_mu, adam.mu)
    _assert_close(got_nu, adam.nu)


@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip_triggers", "clip_idle"])
def test_plain_matches_optax_chain(clip):
    """The JAX package's unfused path: optax's clip formula off the shared
    norm, then the chain build_optimizer returns. The clip-idle arm agrees
    to the bit-level bar; the triggered one differs by the clip's one
    rounding (optax divides, then multiplies)."""
    import jax
    import jax.numpy as jnp
    import optax
    from vitax.config import Config as JaxConfig
    from vitax.train.state import build_optimizer

    params, grads = _trees(1)
    cfg = JaxConfig(lr=LR, warmup_steps=WARMUP, weight_decay=WD, clip_grad_norm=clip)
    tx, _ = build_optimizer(cfg, MAX_ITER)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g_np in grads:
        g = {k: jnp.asarray(v) for k, v in g_np.items()}
        norm = optax.global_norm(g)
        g = jax.tree.map(lambda t: jnp.where(norm < clip, t, (t / norm) * clip), g)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    got_p, _, _ = _plain_run(params, grads, clip)
    _assert_close(got_p, p)


def test_dispatcher_matches_jax_fused_kernel():
    """The port's own step scalars (its global norm, its float64 bias
    corrections) through the CPU dispatcher: 3 steps with the clip idle,
    against the JAX kernel. The scalars differ from JAX's by float32 ulps,
    which the 1 - b2^t bias correction magnifies to ~2e-5 relative, so the
    bar is 1e-4 relative on the parameters."""
    import jax
    import jax.numpy as jnp
    import optax
    from vitax.ops.fused_optimizer import fused_clip_adamw as jax_fused
    from vitax.train.schedule import warmup_cosine_schedule as jax_schedule

    params, grads = _trees(2)
    clip = 1e6
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = (optax.ScaleByAdamState(count=jnp.int32(0), mu=jax.tree.map(jnp.zeros_like, p),
                                    nu=jax.tree.map(jnp.zeros_like, p)),)
    tp = [torch.from_numpy(v.copy()) for v in params.values()]
    mu, nu = [torch.zeros_like(x) for x in tp], [torch.zeros_like(x) for x in tp]
    count = torch.zeros((), dtype=torch.int32)
    sched = warmup_cosine_schedule(LR, WARMUP, MAX_ITER)
    for g_np in grads:
        g = {k: jnp.asarray(v) for k, v in g_np.items()}
        p, state = jax_fused(g, state, p, grad_norm=optax.global_norm(g),
                             schedule=jax_schedule(LR, WARMUP, MAX_ITER), clip_norm=clip,
                             weight_decay=WD, b1=B1, b2=B2, eps=EPS, interpret=True)
        tg = [torch.from_numpy(g_np[k]) for k in params]
        count = fused_clip_adamw(tp, tg, mu, nu, count, grad_norm=global_norm(tg), schedule=sched,
                                 clip_norm=clip, weight_decay=WD, b1=B1, b2=B2, eps=EPS)
    assert int(count) == 3 and count.dtype == torch.int32
    _assert_close(dict(zip(params, [x.numpy() for x in tp])), p, rtol=1e-4)


def test_schedule_matches_jax():
    from vitax.train.schedule import warmup_cosine_schedule as jax_schedule
    for base, warmup, max_it in ((1e-3, 4, 40), (3e-4, 0, 17), (1e-3, 10, 10)):
        ours, theirs = warmup_cosine_schedule(base, warmup, max_it), jax_schedule(base, warmup, max_it)
        got = np.array([float(ours(s)) for s in range(max_it + 1)])
        want = np.array([float(theirs(s)) for s in range(max_it + 1)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert float(ours(0)) == 0.0 or warmup == 0
        assert ours(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


def test_global_norm_and_step_scalars_match_jax():
    """The norm within float32 summation-order noise; clip scale and lr
    to 1e-6; the bias corrections within 1e-4 (see step_scalars)."""
    import jax.numpy as jnp
    _, grads = _trees(3)
    g = grads[0]
    for clip in (1.0, 1e6, 0.0):
        want = _jax_scal(2, {k: jnp.asarray(v) for k, v in g.items()}, clip if clip else np.inf)
        norm = global_norm([torch.from_numpy(v) for v in g.values()])
        scal = step_scalars(torch.tensor(2, dtype=torch.int32), norm,
                            warmup_cosine_schedule(LR, WARMUP, MAX_ITER), clip, B1, B2)
        assert scal.dtype == torch.float32 and scal.shape == (4,)
        np.testing.assert_allclose(scal.numpy()[:2], want[:2], rtol=1e-6)
        np.testing.assert_allclose(scal.numpy()[2:], want[2:], rtol=1e-4)
        np.testing.assert_allclose(scal.numpy()[2:], [1 - B1 ** 3, 1 - B2 ** 3], rtol=1e-6)


@pytest.mark.parametrize("mode,device,active", [("auto", "cpu", False), ("auto", "cuda", True),
                                                ("on", "cpu", False), ("on", "cuda", True),
                                                ("off", "cpu", False), ("off", "cuda", None)])
def test_fused_optimizer_active_policy(mode, device, active):
    """The kernel runs exactly where the tensors are on the card; the plain
    update never runs there, so `off` on a CUDA device raises."""
    cfg = Config(fused_optimizer=mode)
    if active is None:
        with pytest.raises(ValueError, match="fused_optimizer off"):
            fused_optimizer_active(cfg, device)
    else:
        assert fused_optimizer_active(cfg, device) is active


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    params, grads = _trees(4)
    sched = warmup_cosine_schedule(LR, WARMUP, MAX_ITER)
    before = dict(_build.LAUNCHES)
    runs = []
    for via_dispatcher in (True, False):
        p = [torch.from_numpy(v.copy()) for v in params.values()]
        mu, nu = [torch.zeros_like(x) for x in p], [torch.zeros_like(x) for x in p]
        for i, g_np in enumerate(grads):
            g = [torch.from_numpy(g_np[k]) for k in params]
            count = torch.tensor(i, dtype=torch.int32)
            if via_dispatcher:
                fused_clip_adamw(p, g, mu, nu, count, grad_norm=global_norm(g), schedule=sched,
                                 clip_norm=1.0, weight_decay=WD, b1=B1, b2=B2, eps=EPS)
            else:
                clip_adamw_(p, g, mu, nu, step_scalars(count, global_norm(g), sched, 1.0, B1, B2),
                            (B1, B2, EPS, WD))
        runs.append(p)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _build.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fused_adamw_cuda([x], [x], [x], [x], torch.zeros(4), (B1, B2, EPS, WD))


# --- on a card (python -m pytest -m gpu tests/) ------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip_triggers", "clip_idle"])
def test_kernel_matches_plain_on_card(cuda, clip):
    """Odd lengths, lengths not a multiple of 4, a leaf whose base is not
    16-byte aligned (scalar path); f32 within the 1e-6 relative bar."""
    rng = np.random.default_rng(4)
    shapes = [(7,), (5, 3), (4099,), (64, 160), (1,), (3, 5120)]

    def leaf(s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale).to(cuda)

    p, g = [leaf(s) for s in shapes], [leaf(s) for s in shapes]
    mu, nu = [leaf(s, 0.1) for s in shapes], [leaf(s, 0.01).abs() for s in shapes]
    base = leaf((1 + 999,))
    p.append(base[1:])                       # 4 bytes past an aligned base
    g.append(leaf((999,)))
    mu.append(leaf((999,), 0.1))
    nu.append(leaf((999,), 0.01).abs())
    ref = [[x.clone() for x in xs] for xs in (p, mu, nu)]
    norm = global_norm(g)
    sched = warmup_cosine_schedule(LR, WARMUP, MAX_ITER)
    scal = step_scalars(torch.tensor(3, dtype=torch.int32, device=cuda), norm, sched, clip, B1, B2)
    before = _build.LAUNCHES["fused_adamw"]
    fused_adamw_cuda(p, g, mu, nu, scal, (B1, B2, EPS, WD))
    clip_adamw_(ref[0], g, ref[1], ref[2], scal, (B1, B2, EPS, WD))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_adamw"] == before + 1
    for got, want in zip((p, mu, nu), ref):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
