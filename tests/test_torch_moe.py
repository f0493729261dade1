"""vitax_torch's mixture of experts (models/moe.py) held to the JAX
package's MoeMlp and its MoE training, serving and export, on the CPU.

Mirrors tests/test_moe.py's cases on the port (single expert equals the
dense Mlp, routing and capacity drop, the top-2 hand case and its
second-choice queue, a uniform router's aux of 1), then holds the port
against vitax on the same weights carried through params_from_jax:

- MoeMlp for top-1 and top-2, einsum and gather: the routing exactly
  first (each token's experts, slots and kept flags against vitax's
  router probabilities, a mismatch printed with its margin), then the
  output, frac_tokens, mean_prob and the input and param grads at atol
  and rtol 1e-5; gather equals einsum in the port;
- the whole model (D 32, 4 heads, 2 blocks, 4 experts, f32, grad_ckpt)
  trained 3 steps from vitax's init: losses, grad norms and the first
  step's grads at rtol 2e-4 (tests/test_train_smoke.py:99's bar), at
  grad_accum_steps 1 and at 2 against vitax's accum_loss_moe; the aux
  weight moves the loss;
- the npz export bitwise vitax's save_npz, float and int8; a served export
  (float and int8, the int8 one dequantized at load) answering vitax's
  engine's top-k; a finetune warm start from an MoE export;
- the config's refusals with vitax's messages; the MoE FLOP count.
"""

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint.consolidate import load_npz_raw, save_npz
from vitax_torch.checkpoint.convert import opt_state_from_jax, params_from_jax, params_to_jax
from vitax_torch.config import Config
from vitax_torch.models.moe import MoeMlp, capacity, route
from vitax_torch.models.vit import Mlp, build_model, count_params, expected_param_count
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.telemetry import flops
from vitax_torch.train.state import TrainState, build_optimizer
from vitax_torch.train.step import make_train_step

TINY = dict(image_size=32, patch_size=8, embed_dim=32, num_heads=4, num_blocks=2, num_classes=10,
            batch_size=8, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32",
            moe_experts=4)
STEPS, MAX_ITER = 3, 10
# (flags) of each model arm, each against vitax's same flags
ARMS = {"top1_einsum": {}, "top2_gather": dict(moe_top_k=2, moe_impl="gather"),
        "top1_einsum_accum2": dict(grad_accum_steps=2), "top2_einsum_accum2": dict(moe_top_k=2, grad_accum_steps=2)}


def _moe_pair(top_k, impl, d=16, h=32, e=4, cf=1.0, seed=12):
    """vitax's MoeMlp with its init, and the port's on the same weights
    carried through params_from_jax (the leaves of a block's `moe`)."""
    import jax
    import jax.numpy as jnp
    from vitax.models.moe import MoeMlp as JaxMoe
    jm = JaxMoe(num_experts=e, hidden_dim=h, out_dim=d, top_k=top_k, capacity_factor=cf, impl=impl,
                dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8, d), jnp.float32))
    flat = {f"params/blocks_0/moe/{k}": np.asarray(v) for k, v in _flat(params["params"]).items()}
    sd = {k[len("blocks.0.moe."):]: v for k, v in params_from_jax(flat).items()}
    tm = MoeMlp(d, h, e, torch.float32, capacity_factor=cf, top_k=top_k, impl=impl)
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm


def _flat(tree):
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _want_slots(experts: np.ndarray, e: int, c: int):
    """(slots, keep) per choice from the choices' experts (k, B, N), in
    vitax's GShard order: per-sample ranks, second choices behind every
    first choice of their expert."""
    out, count1 = [], None
    for i, ex in enumerate(experts):
        onehot = np.eye(e, dtype=np.int64)[ex]
        pos = np.cumsum(onehot, axis=1) * onehot
        if i:
            pos = pos + count1 * onehot
        slot = pos.sum(-1) - 1
        out.append((slot, slot < c))
        count1 = np.eye(e, dtype=np.int64)[experts[0]].sum(axis=1, keepdims=True)
    return out


@pytest.mark.parametrize("top_k,impl", [(1, "einsum"), (1, "gather"), (2, "einsum"), (2, "gather")])
def test_moe_mlp_matches_jax(top_k, impl):
    """Real capacity drops (capacity factor 1.0 over a random router): the
    routing exactly, then values and grads at 1e-5."""
    import jax
    import jax.numpy as jnp
    jm, params, tm = _moe_pair(top_k, impl)
    b, n, d, e = 3, 24, 16, 4
    x = np.random.default_rng(11).standard_normal((b, n, d)).astype(np.float32)
    c = capacity(e, n, 1.0)

    # the routing: vitax's router probabilities give the experts; the port's choices must be them
    _, inter = jm.apply(params, jnp.asarray(x), capture_intermediates=True)
    jprobs = np.asarray(jax.nn.softmax(inter["intermediates"]["router"]["__call__"][0], axis=-1))
    xt = torch.from_numpy(x).requires_grad_(True)
    probs = torch.softmax(tm.router(xt.detach().float(), torch.float32), dim=-1)
    choices = route(probs, top_k, c)
    order = np.argsort(-jprobs, axis=-1, kind="stable")
    margin = np.take_along_axis(jprobs, order[..., :top_k + 1], -1)
    for i, ch in enumerate(choices):
        diff = np.argwhere(ch.expert.numpy() != order[..., i])
        assert not len(diff), (f"choice {i}: routing differs at {diff[:4].tolist()}, margin "
                               f"{[float(margin[tuple(t)][i] - margin[tuple(t)][i + 1]) for t in diff[:4]]}")
    for (slot, keep), ch in zip(_want_slots(order[..., :top_k].transpose(2, 0, 1), e, c), choices):
        np.testing.assert_array_equal(ch.slot.numpy(), slot)
        np.testing.assert_array_equal(ch.keep.numpy(), keep)
    assert not all(ch.keep.all() for ch in choices)             # a real drop in play

    out_j, cols = jm.apply(params, jnp.asarray(x), mutable=["intermediates"])
    out_t, frac, prob = tm(xt)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(frac.numpy(), np.asarray(cols["intermediates"]["moe_frac_tokens"][0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(prob.detach().numpy(), np.asarray(cols["intermediates"]["moe_mean_prob"][0]),
                               rtol=1e-5, atol=1e-5)

    def loss(p, xx):
        o, cc = jm.apply(p, xx, mutable=["intermediates"])
        return jnp.sum(jnp.sin(o)) + jnp.sum(cc["intermediates"]["moe_mean_prob"][0] ** 2)
    gp, gx = jax.grad(loss, (0, 1))(params, jnp.asarray(x))
    (torch.sin(out_t).sum() + (prob ** 2).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    want = {k[len("blocks.0.moe."):]: v for k, v in params_from_jax(
        {f"params/blocks_0/moe/{k}": v for k, v in _flat(gp["params"]).items()}).items()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gather_equals_einsum_in_the_port(top_k):
    """The gather dispatch reproduces the einsum one: outputs, input and
    param grads (tests/test_moe.py test_gather_matches_einsum_oracle)."""
    _, _, tm_e = _moe_pair(top_k, "einsum")
    _, _, tm_g = _moe_pair(top_k, "gather")
    x = np.random.default_rng(3).standard_normal((3, 24, 16)).astype(np.float32)
    grads = []
    for tm in (tm_e, tm_g):
        xt = torch.from_numpy(x).requires_grad_(True)
        out, _, _ = tm(xt)
        torch.sin(out).sum().backward()
        grads.append((out.detach(), xt.grad, [p.grad for p in tm.parameters()]))
    (oe, xe, pe), (og, xg, pg) = grads
    assert not torch.allclose(oe, torch.zeros_like(oe))
    torch.testing.assert_close(og, oe, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xg, xe, rtol=1e-5, atol=1e-6)
    for a, b in zip(pg, pe):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _expert(tm, i, v):
    h = torch.nn.functional.gelu(v @ tm.w1[i] + tm.b1[i])
    return h @ tm.w2[i] + tm.b2[i]


def _set_router(tm, kernel, bias):
    with torch.no_grad():
        tm.router.weight.copy_(torch.as_tensor(kernel, dtype=torch.float32).T)
        tm.router.bias.copy_(torch.as_tensor(bias, dtype=torch.float32))


def _moe(e, d, h, top_k=1, cf=1.25, seed=0):
    from vitax_torch.models.vit import init_params
    tm = MoeMlp(d, h, e, torch.float32, capacity_factor=cf, top_k=top_k)
    init_params(tm, torch.Generator().manual_seed(seed))
    return tm


def test_single_expert_equals_dense_mlp():
    """E 1 at capacity >= N gates every token at 1.0: the dense Mlp on the
    expert's weights."""
    tm = _moe(1, 16, 32, cf=1.0)
    mlp = Mlp(16, 32, torch.float32)
    with torch.no_grad():
        mlp.fc1.weight.copy_(tm.w1[0].T)
        mlp.fc1.bias.copy_(tm.b1[0])
        mlp.fc2.weight.copy_(tm.w2[0].T)
        mlp.fc2.bias.copy_(tm.b2[0])
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(tm(x)[0], mlp(x), rtol=1e-5, atol=1e-5)


def test_routing_and_capacity_drop():
    """Every token routed to expert 0 at capacity 1: only the first token
    gets expert compute, the rest are dropped (zero MoE output)."""
    tm = _moe(2, 8, 8, cf=0.5)                  # C = ceil(.5 * 4 / 2) = 1
    _set_router(tm, np.zeros((8, 2)), [10.0, -10.0])
    x = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out, frac, _ = tm(x)
    assert not torch.allclose(out[0, 0], torch.zeros(8))
    torch.testing.assert_close(out[0, 1:], torch.zeros(3, 8), rtol=0, atol=1e-7)
    torch.testing.assert_close(frac, torch.tensor([1.0, 0.0]))


def test_aux_loss_uniform_router_is_one():
    """A zero router: prob = 1/E exactly, argmax ties to expert 0, so E *
    sum(frac * prob) is exactly 1."""
    from vitax_torch.train.step import aux_from_frac_prob
    tm = _moe(4, 8, 8)
    _set_router(tm, np.zeros((8, 4)), np.zeros(4))
    with torch.no_grad():
        _, frac, prob = tm(torch.randn(2, 8, 8, generator=torch.Generator().manual_seed(4)))
    torch.testing.assert_close(frac, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    cfg = Config(moe_experts=4, num_blocks=1)
    assert float(aux_from_frac_prob(frac[None], prob[None], cfg)) == pytest.approx(1.0, rel=1e-6)


def test_top2_routing_hand_case():
    """Token probs [0.75, 0.25] with no drops: 0.75 * expert 0 + 0.25 *
    expert 1."""
    tm = _moe(2, 4, 4, top_k=2, cf=2.0)
    _set_router(tm, np.zeros((4, 2)), np.log([3.0, 1.0]))
    x = torch.randn(1, 2, 4, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        out = tm(x)[0]
        want = 0.75 * _expert(tm, 0, x) + 0.25 * _expert(tm, 1, x)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_top2_second_choice_capacity_queue():
    """At capacity 1 each token's second choice loses its slot to the other
    token's first choice (the count1 offset): each keeps its first choice
    only, at gate 0.75."""
    tm = _moe(2, 4, 4, top_k=2, cf=1.0)          # C = ceil(2 / 2) = 1
    x = torch.zeros(1, 2, 4)
    x[0, 0, 0], x[0, 1, 0] = 1.0, -1.0
    s = float(np.log(3.0) / 2.0)
    k = np.zeros((4, 2))
    k[0] = (s, -s)
    _set_router(tm, k, np.zeros(2))
    with torch.no_grad():
        out = tm(x)[0]
        torch.testing.assert_close(out[0, 0], 0.75 * _expert(tm, 0, x[0, 0]), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out[0, 1], 0.75 * _expert(tm, 1, x[0, 1]), rtol=1e-5, atol=1e-6)


# --- the whole model against vitax's training ---------------------------------


def _batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _jax_run(arm: dict, images, labels, steps=STEPS):
    """vitax on one CPU device: (init params flat, opt state, losses, grad
    norms, the first step's grads flat)."""
    import jax
    import jax.numpy as jnp
    import vitax.train.step as jax_step
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.fused_optimizer import find_adam_state
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    cfg = JaxConfig(**{**TINY, **arm}, scan_blocks=False, grad_ckpt=True, fsdp_size=1).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:1])
    grads = []
    make_update = jax_step._make_update_fn

    def capturing(*a, **kw):                    # the grads the optimizer is handed
        update = make_update(*a, **kw)

        def wrapped(g, opt_state, params):
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return update(g, opt_state, params)
        return wrapped
    jax_step._make_update_fn = capturing
    try:
        model = jax_build_model(cfg)
        tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
        state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
        step_fn = jax_step.make_train_step(cfg, model, tx, mesh, sspecs, schedule=schedule)
    finally:
        jax_step._make_update_fn = make_update
    init = _flat(state.params)
    adam = find_adam_state(state.opt_state)
    opt = (_flat(adam.mu), _flat(adam.nu), np.asarray(adam.count))
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    losses, norms = [], []
    for _ in range(steps):
        state, m = step_fn(state, batch, jax.random.key(1))
        losses.append(float(jax.device_get(m["loss"])))
        norms.append(float(jax.device_get(m["grad_norm"])))
    jax.effects_barrier()
    return init, opt, losses, norms, _flat(grads[0])


def _port_run(arm: dict, init, opt, images, labels, steps=STEPS):
    cfg = Config(**{**TINY, **arm}).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(init), strict=True, assign=True)
    mu, nu, count = opt_state_from_jax(*opt)
    state = TrainState(step=0, model=model.train(), mu=mu, nu=nu, count=count)
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    train_step = make_train_step(cfg, optimizer, "cpu")
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    losses, norms, grads = [], [], None
    for _ in range(steps):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    return losses, norms, grads


@pytest.fixture(scope="module")
def runs(devices8):
    images, labels = _batch()
    out = {}
    for name, arm in ARMS.items():
        init, opt, losses, norms, grads = _jax_run(arm, images, labels)
        out[name] = {"jax": (losses, norms, params_from_jax(grads)),
                     "port": _port_run(arm, init, opt, images, labels)}
    out["noaux"] = _port_run(dict(moe_aux_weight=0.0), init, opt, images, labels, steps=1)
    out["aux"] = _port_run({}, init, opt, images, labels, steps=1)
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_trains_as_vitax(runs, arm):
    """3 steps from vitax's init and AdamW state: losses and grad norms at
    rtol 2e-4, every leaf of the first step's grads within rtol 2e-4 (atol
    1e-4 of the leaf's largest). grad_accum_steps 2 holds the aux's
    full-batch means (vitax differentiates through its microbatch scan):
    a per-microbatch product would miss the grads."""
    (jl, jn, jg), (tl, tn, tg) = runs[arm]["jax"], runs[arm]["port"]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    np.testing.assert_allclose(tn, jn, rtol=2e-4)
    assert tg.keys() == jg.keys() and any(".moe.w1" in k for k in tg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name].numpy(), g.numpy(), rtol=2e-4, atol=1e-4 * float(g.abs().max()),
                                   err_msg=name)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("policy", ["dots_saveable", "dots_attn_saveable"])
def test_remat_policies_give_the_moe_grads_of_none_saveable(policy):
    """An MoE block under every remat policy returns its load-balance
    ingredients from the recompute, not twice: the loss and every grad of
    none_saveable's, and grad_ckpt off's."""
    images, labels = _batch()
    out = []
    for kw in (dict(grad_ckpt=False), dict(remat_policy="none_saveable"), dict(remat_policy=policy)):
        cfg = Config(**{**TINY, **kw}).validate()
        model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu")).train()
        optimizer, _ = build_optimizer(cfg, MAX_ITER)
        from vitax_torch.train.state import make_train_state
        state, m = make_train_step(cfg, optimizer, "cpu")(
            make_train_state(model), {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
        out.append((float(m["loss"]), [p.grad for p in state.model.parameters()]))
    for loss, grads in out[1:]:
        assert loss == pytest.approx(out[0][0], rel=1e-6)
        for a, b in zip(grads, out[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_aux_weight_moves_the_loss(runs):
    """moe_aux_weight 0 drops the aux from the objective (tests/test_moe.py
    test_moe_train_step_ep_matches_dp's last check): the first loss moves
    by the weighted aux, which is near 1 for a near-uniform router."""
    moved = runs["aux"][0][0] - runs["noaux"][0][0]
    assert 0.005 < moved < 0.05, moved
    assert runs["aux"][0][0] == runs["top1_einsum"]["port"][0][0]


# --- export, serve, warm start -------------------------------------------------


def _jax_moe_params(**kw):
    """vitax's MoE model init (scanned blocks, its default) as a flat tree."""
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    import jax.numpy as jnp
    cfg = JaxConfig(**{**TINY, **kw}).validate()
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3), jnp.float32), True)
    return cfg, {f"params/{k}": v for k, v in _flat(params["params"]).items()}


@pytest.mark.parametrize("dtype", ["float32", "int8", "float8_e4m3"])
def test_moe_export_matches_vitax_save_npz(tmp_path, dtype):
    """vitax's MoE params through the port's state (params_from_jax, then
    params_to_jax) and its writer: the file is vitax's save_npz of the
    same tree bit for bit; int8 scales per (layer, expert, out channel),
    the router left in float."""
    from vitax.checkpoint import consolidate as jc
    _, flat = _jax_moe_params()
    sd = params_from_jax(flat)
    assert sd["blocks.1.moe.w1"].shape == (4, 32, 128) and sd["blocks.0.moe.router.weight"].shape == (4, 32)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    save_npz(ours, params_to_jax(sd), dtype=dtype)
    jc.save_npz(theirs, flat, dtype=dtype)
    a, b = dict(np.load(ours)), dict(np.load(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
    if dtype != "float32":
        _, scales, manifest = load_npz_raw(ours)
        assert "params/blocks/moe/w1" in manifest and not any("router" in k for k in manifest)
        assert tuple(scales["params/blocks/moe/w1"].shape) == (2, 4, 1, 128)


@pytest.mark.parametrize("scanned", [True, False])
def test_moe_train_state_round_trips_through_the_jax_keys(scanned):
    """An MoE train state (params, AdamW moments, counts) through
    train_state_to_jax and back: every router and expert leaf bitwise, at
    vitax's shapes (scanned: (L, E, ...))."""
    from vitax_torch.checkpoint.convert import train_state_from_jax, train_state_to_jax
    cfg = Config(**TINY).validate()
    sd = build_model(cfg, "cpu").state_dict()
    mu = {k: v + 1.0 for k, v in sd.items()}
    nu = {k: v * 2.0 for k, v in sd.items()}
    flat = train_state_to_jax(sd, mu, nu, step=3, count=3, scanned=scanned)
    key = "params/params/blocks/moe/w2" if scanned else "params/params/blocks_1/moe/w2"
    assert tuple(flat[key].shape) == ((2, 4, 128, 32) if scanned else (4, 128, 32))
    got_sd, got_mu, got_nu, step, count = train_state_from_jax(flat)
    assert step == 3 and int(count) == 3
    for want, got in ((sd, got_sd), (mu, got_mu), (nu, got_nu)):
        assert want.keys() == got.keys()
        assert all(torch.equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_served_moe_export_answers_as_vitax_engine(devices8, tmp_path, dtype):
    """One MoE export through both engines: top-k ids equal, probs within
    1e-5. The int8 export is dequantized at load into the float model (no
    QuantLinear), the numbers vitax's engine dequantizes at use."""
    from vitax.checkpoint import consolidate as jc
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax_torch.serve.engine import InferenceEngine
    from vitax_torch.models.vit import QuantLinear
    _, flat = _jax_moe_params()
    path = str(tmp_path / "moe.npz")
    jc.save_npz(path, flat, dtype=None if dtype == "float32" else dtype)
    quant = dict(serve_quant_dtype=dtype) if dtype == "int8" else {}
    jeng = JaxEngine.from_npz(JaxConfig(**TINY, serve_port=0, serve_max_batch=2, **quant).validate(), path)
    jeng.warmup()
    teng = InferenceEngine.from_npz(Config(**TINY, serve_max_batch=2, **quant).validate(), path, "cpu")
    teng.warmup()
    assert not any(isinstance(m, QuantLinear) for m in teng.model.modules())
    assert teng.weights_dtype == "float32"
    x = np.random.default_rng(7).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    for rows in (x[:1], x[1:3]):
        ids_j, p_j = jeng.predict(rows)
        ids_t, p_t = teng.predict(rows)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(p_t, p_j, atol=1e-5)


def test_moe_checkpoint_quantized_on_load_serves_as_its_int8_export(tmp_path):
    """from_checkpoint under --serve_quant_dtype int8 of an MoE checkpoint
    (quantized and dequantized on load: dequantized_for_serve) answers
    bitwise as the checkpoint's int8 export through from_npz."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.checkpoint.consolidate import consolidate
    from vitax_torch.serve.engine import InferenceEngine
    from vitax_torch.train.state import make_train_state
    cfg = Config(**TINY).validate()
    ckpt = str(tmp_path / "ckpt")
    ckpt_io.save_state(ckpt, 1, make_train_state(build_model(cfg, "cpu")), wait=True)
    ckpt_io.close()
    path = str(tmp_path / "int8.npz")
    consolidate(ckpt, 1, path, dtype="int8")
    qcfg = Config(**TINY, serve_quant_dtype="int8", serve_max_batch=2).validate()
    engines = (InferenceEngine.from_checkpoint(qcfg, ckpt, 1, "cpu"), InferenceEngine.from_npz(qcfg, path, "cpu"))
    x = np.random.default_rng(9).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    for e in engines:
        e.warmup()
    (ids_c, p_c), (ids_n, p_n) = (e.predict(x) for e in engines)
    np.testing.assert_array_equal(ids_c, ids_n)
    np.testing.assert_array_equal(p_c, p_n)


def test_moe_refuses_the_quantized_model():
    """An MoE model never builds the QuantLinear path (the card would send
    it through kernel C): asking for one raises."""
    from vitax_torch.serve.engine import model_quant
    with pytest.raises(ValueError, match="MoE model serves float weights"):
        model_quant(Config(**TINY).validate(), "int8", "cpu")


def test_finetune_warm_starts_from_an_moe_export(tmp_path):
    """--task finetune --init_npz of an MoE export: every expert and router
    leaf loaded bitwise, the head re-initialized for a new class count."""
    from vitax_torch.programs.workloads import warm_start_from_npz
    from vitax.checkpoint import consolidate as jc
    _, flat = _jax_moe_params()
    path = str(tmp_path / "moe.npz")
    jc.save_npz(path, flat)
    cfg = Config(**{**TINY, "num_classes": 6}, task="finetune", init_npz=path).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"))
    from vitax_torch.train.state import make_train_state
    state, info = warm_start_from_npz(cfg, make_train_state(model))
    want = params_from_jax(flat)
    got = state.model.state_dict()
    for name in want:
        if not name.startswith("head."):
            assert torch.equal(got[name], want[name]), name
    assert info["reinit"] == ["params/head/bias", "params/head/kernel"]


# --- config, FLOPs, param count ---------------------------------------------------


@pytest.mark.parametrize("kw", [dict(moe_experts=0, ep_size=2), dict(moe_experts=3, ep_size=2),
                                dict(moe_impl="scatter"), dict(moe_experts=1, moe_top_k=2),
                                dict(serve_quant_dtype="int8", serve_act_quant="int8"),
                                dict(serve_quant_dtype="int8", fused_dequant="on")],
                         ids=["ep_without_experts", "experts_indivisible", "unknown_impl", "top2_of_one",
                              "act_quant", "fused_dequant_on"])
def test_config_refuses_what_vitax_refuses(kw):
    """vitax/config.py:428-439 and :520-535: the same refusals, with the
    same messages."""
    from vitax.config import Config as JaxConfig
    args = {**TINY, **kw}
    with pytest.raises(AssertionError) as theirs:
        JaxConfig(**args).validate()
    with pytest.raises(ValueError) as ours:
        Config(**args).validate()
    assert str(ours.value) == str(theirs.value)


def test_config_refuses_moe_under_sp_and_takes_vitax_flags():
    """MoE under sp validates (the capacity over the whole sequence); beside
    ep > 1 it is refused, naming vitax's init failure (no green reference,
    item 11)."""
    Config(**TINY, sp_size=2).validate()
    with pytest.raises(ValueError, match=r"vitax/train/state.py:86-89.*item 11"):
        Config(**TINY, sp_size=2, ep_size=2).validate()
    from vitax_torch.config import build_parser
    ns = build_parser().parse_args(["--moe_experts", "8", "--moe_top_k", "2", "--moe_impl", "gather",
                                    "--ep_size", "2", "--moe_capacity_factor", "2.0", "--moe_aux_weight", "0"])
    assert (ns.moe_experts, ns.moe_top_k, ns.moe_impl, ns.ep_size, ns.moe_capacity_factor, ns.moe_aux_weight) == \
        (8, 2, "gather", 2, 2.0, 0.0)
    d = build_parser().parse_args([])
    assert (d.moe_experts, d.moe_top_k, d.moe_impl, d.ep_size, d.moe_capacity_factor, d.moe_aux_weight) == \
        (0, 1, "einsum", 1, 1.25, 0.01)
    for bad in (["--moe_top_k", "3"], ["--moe_impl", "scatter"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)


B16_MOE = dict(image_size=224, patch_size=16, embed_dim=768, num_heads=12, num_blocks=12, batch_size=64,
               moe_experts=8)


@pytest.mark.parametrize("kw", [TINY, dict(TINY, moe_top_k=2), B16_MOE])
def test_moe_flops_and_param_count(kw):
    """The MoE FLOP count is vitax's (top-k experts and the router); the
    closed-form param count is the model's (b16_moe: 483,324,232)."""
    from vitax.config import Config as JaxConfig
    from vitax.telemetry import flops as jax_flops
    ours, theirs = Config(**kw), JaxConfig(**kw)
    assert flops.model_flops_per_image(ours) == jax_flops.model_flops_per_image(theirs)
    assert flops.model_flops_per_step(ours) == jax_flops.model_flops_per_step(theirs)
    assert count_params(build_model(ours, "meta")) == expected_param_count(ours)
    if kw is B16_MOE:
        assert expected_param_count(ours) == 483_324_232
