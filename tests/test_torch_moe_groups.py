"""vitax_torch trains the MoE ViT under sequence and tensor parallelism (an
expert's capacity over the whole sequence across the sp ranks, the experts
replicated over tp, tp beside ep) on four CPU processes (gloo), held to
the JAX package's MoE training.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py) at capacity factor 0.5, where experts drop
tokens: the MoE model (image 32, patch 8, N 16, D 32, 4 heads, 2 blocks,
4 experts, f32, batch 16) unsharded on one device at top-2 (einsum) and
at top-1 (gather), and at (fsdp 2, sp 2) with the ring at top-2, the
evidence that vitax's own sharded run trains its unsharded one; the
first step's grads of each captured. It exports vitax's init as npz, then
spawns ONE 4-rank gloo group (torch.multiprocessing.spawn, init_method
file://) that runs every arm of the port for 3 steps on one seeded numpy
global batch, batch shard b on rows [b B/k, (b + 1) B/k). The
(tp 2, ep 2) arm saves its state after the steps. The group starts once
vitax's init is exported and trains while vitax's runs step here. The
tests read what the ranks wrote:

- the unsharded reference drops tokens (at 1.25 a wrong local capacity
  could keep every token and hide);
- every arm's losses are vitax's within rtol 2e-4 and its first step's
  grads within rtol 1e-4, atol 1e-5: a capacity or a slot order taken
  over the rank's token slice keeps other tokens than vitax's, an expert
  grad summed over tp or an expert counted tp times in the norm misses;
- the replicated leaves of the tp arms, the experts among them, stay
  bitwise equal across the tp ranks;
- the (tp 2, ep 2) checkpoint restores in one process bitwise, and its
  full-state npz export is the one process's export of that state, leaf
  for leaf.
Alone: the cross-rank slot prefix against slicing the unsharded route,
and the config's validation of these meshes.
"""

import os

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.moe import capacity, route
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.state import TrainState, build_optimizer, local, make_train_state
from vitax_torch.train.step import make_train_step, prepare_images

TINY = dict(image_size=32, patch_size=8, embed_dim=32, num_heads=4, num_blocks=2, num_classes=10,
            batch_size=16, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32",
            moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
STEPS, MAX_ITER, WORLD = 3, 10, 4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4, 1e-5
TOP1 = dict(moe_top_k=1, moe_impl="gather")
# vitax's runs: name -> (flags, devices)
JAX_RUNS = {"top2": ({}, 1), "top1": (TOP1, 1), "sp2_ring": (dict(fsdp_size=2, sp_size=2), 4)}
# the port's arms: name -> (flags, vitax run they must train)
ARMS = {"sp2_ring": (dict(fsdp_size=2, sp_size=2), "top2"),
        "sp2_ulysses": (dict(fsdp_size=2, sp_size=2, sp_impl="ulysses"), "top2"),
        "sp4_ring_top1_gather": (dict(fsdp_size=1, sp_size=4, **TOP1), "top1"),
        "tp2": (dict(fsdp_size=2, tp_size=2), "top2"),
        "tp2_ep2": (dict(fsdp_size=1, tp_size=2, ep_size=2), "top2"),
        "tp2_sp2": (dict(fsdp_size=1, tp_size=2, sp_size=2), "top2")}
TP_ARMS = [name for name, (kw, _) in ARMS.items() if kw.get("tp_size")]


def _batch():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _jax_state(arm: dict, n_devices: int):
    """vitax's (cfg, mesh, model, optimizer, schedule, initial state, its
    specs) on `n_devices` devices, as its loop builds them."""
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    from vitax.parallel.mesh import build_mesh
    from vitax.train.loop import _moe_dispatch_sharding, _token_sharding
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state as jax_make_train_state
    cfg = JaxConfig(**{**TINY, "fsdp_size": 1, **arm}, scan_blocks=False, grad_ckpt=False).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:n_devices])
    model = jax_build_model(cfg, attention_impl=jax_make_attention_impl(cfg, mesh),
                            token_sharding=_token_sharding(cfg, mesh),
                            moe_dispatch_sharding=_moe_dispatch_sharding(cfg, mesh))
    tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
    state, sspecs, _ = jax_make_train_state(cfg, model, tx, mesh, jax.random.key(0))
    return cfg, mesh, model, tx, schedule, state, sspecs


def _flat_params(state) -> dict:
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(state.params)).items()}


def _jax_run(arm: dict, n_devices: int, images, labels):
    """vitax on `n_devices` devices: (init params flat, losses, grad norms,
    the first step's grads flat)."""
    import jax
    import jax.numpy as jnp
    import vitax.train.step as jax_step
    from vitax.checkpoint.consolidate import flatten_tree
    grads = []
    make_update = jax_step._make_update_fn

    def capturing(*a, **kw):                    # the grads the optimizer is handed
        update = make_update(*a, **kw)

        def wrapped(g, opt_state, params):
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return update(g, opt_state, params)
        return wrapped
    cfg, mesh, model, tx, schedule, state, sspecs = _jax_state(arm, n_devices)
    jax_step._make_update_fn = capturing
    try:
        step_fn = jax_step.make_train_step(cfg, model, tx, mesh, sspecs, schedule=schedule)
    finally:
        jax_step._make_update_fn = make_update
    init = _flat_params(state)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step_fn(state, batch, jax.random.key(1))
        losses.append(float(jax.device_get(m["loss"])))
        norms.append(float(jax.device_get(m["grad_norm"])))
    jax.effects_barrier()
    return init, losses, norms, flatten_tree(grads[0])


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _gathered(state: TrainState) -> dict:
    """params, mu, nu whole (a collective), count and step."""
    return {"params": {n: _whole(p) for n, p in state.model.named_parameters()},
            "mu": {n: _whole(v) for n, v in state.mu.items()}, "nu": {n: _whole(v) for n, v in state.nu.items()},
            "count": int(state.count), "step": state.step}


def _sharded_state(cfg, mesh, sd) -> TrainState:
    """The model built on meta with the mesh's token, expert and tensor
    shards, apply_fsdp, the whole tensors of `sd` cut to the rank's shards."""
    from vitax_torch.parallel.mesh import expert_shard, tensor_shard, token_shard
    from vitax_torch.parallel.sharding import apply_fsdp, local_shard
    model = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu", mesh),
                        token_shard=token_shard(cfg, mesh), expert_shard=expert_shard(mesh),
                        tensor_shard=tensor_shard(mesh))
    model = apply_fsdp(model, cfg, mesh)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            local(p).copy_(local_shard(sd[name], p))
    return make_train_state(model.train())


def _run_arm(name: str, sd, images, labels, root: str) -> dict:
    """3 steps of one arm on this rank: losses, grad norms, the first
    step's grads (whole), the rank's coordinates and its replicated leaves'
    local tensors; the (tp 2, ep 2) arm saves its state and gathers it."""
    from vitax_torch.parallel.mesh import MESH_DIMS, batch_shard, build_mesh
    from vitax_torch.parallel.rules import tp_dim
    cfg = Config(**{**TINY, **ARMS[name][0]}).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    b, count = batch_shard(mesh)
    rows = slice(b * TINY["batch_size"] // count, (b + 1) * TINY["batch_size"] // count)
    state = _sharded_state(cfg, mesh, sd)
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    batch = {"image": torch.from_numpy(images[rows]), "label": torch.from_numpy(labels[rows])}
    train_step = make_train_step(cfg, optimizer, "cpu", mesh)
    losses, norms, grads = [], [], None
    for _ in range(STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:
            grads = {n: _whole(p.grad) for n, p in state.model.named_parameters()}
    out = {"losses": losses, "norms": norms, "grads": grads, "coord": dict(zip(MESH_DIMS, mesh.get_coordinate())),
           "replicated": {n: local(p).detach().clone() for n, p in state.model.named_parameters()
                          if tp_dim(n, p.dim()) is None}}
    if name == "tp2_ep2":
        ckpt_io.save_state(os.path.join(root, "ckpt_tp2_ep2"), 1, state, wait=True)
        out["state"] = _gathered(state)
    return out


def _worker(rank: int, root: str) -> None:
    """One rank of the 4-rank gloo group: every arm, results to
    root/rank<r>.pt."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=WORLD)
    data = np.load(os.path.join(root, "inputs.npz"))
    images, labels = data["images"], data["labels"]
    sd = params_from_jax({k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")})
    out = {name: _run_arm(name, sd, images, labels, root) for name in ARMS}
    ckpt_io.close()
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("moe_groups"))
    images, labels = _batch()
    # vitax's init crosses first, so the group trains while vitax's runs compile and step here
    init = _flat_params(_jax_state({}, 1)[5])
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels,
             **{f"init/{k}": v for k, v in init.items()})
    group = mp.spawn(_worker, args=(root,), nprocs=WORLD, join=False)
    try:
        jax_out = {}
        for name, (arm, n_devices) in JAX_RUNS.items():
            run_init, losses, norms, grads = _jax_run(arm, n_devices, images, labels)
            assert all(np.array_equal(run_init[k], v) for k, v in init.items()), name
            jax_out[name] = {"losses": losses, "norms": norms, "grads": params_from_jax(grads)}
    finally:
        while not group.join():
            pass
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(jax=jax_out, ranks=ranks, root=root, images=images, labels=labels, sd=params_from_jax(init))


def _first_choices_kept(model, images) -> list:
    """Each MoE block's first-choice kept flags (B, N) of one forward of
    `model` on `images`, from its router's probabilities."""
    kept, hooks = [], []
    for block in model.blocks:
        moe = block.moe

        def hook(m, args, logits, moe=moe):
            probs = torch.softmax(logits, dim=-1)
            kept.append(route(probs, moe.top_k, capacity(moe.num_experts, probs.shape[1], moe.capacity_factor))[0].keep)
        hooks.append(moe.router.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(prepare_images(torch.from_numpy(images)))
    finally:
        for h in hooks:
            h.remove()
    return kept


def test_the_unsharded_reference_drops_tokens(runs):
    """At capacity factor 0.5 (C 2 slots an expert a sample of 16 tokens
    over 4 experts) the first step's forward of vitax's init drops first
    choices in every block, so the arms below hold which tokens are kept."""
    for top_k in (2, 1):
        cfg = Config(**{**TINY, "moe_top_k": top_k}).validate()
        model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
        model.load_state_dict(runs["sd"], strict=True, assign=True)
        kept = _first_choices_kept(model, runs["images"])
        assert len(kept) == TINY["num_blocks"]
        assert all(0 < int((~k).sum()) < k.numel() for k in kept), [int((~k).sum()) for k in kept]


def test_vitax_sp_ring_trains_its_unsharded_run(runs):
    """vitax's own (fsdp 2, sp 2) ring arm at capacity factor 0.5 trains its
    one-device losses, norms and grads: the evidence that the unsharded
    run is the sharded semantics the port is held to."""
    got, want = runs["jax"]["sp2_ring"], runs["jax"]["top2"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_losses_and_grads_match_jax(runs, arm):
    """Each arm on 4 ranks against vitax's unsharded run of its routing:
    the 3 losses and grad norms within rtol 2e-4, every leaf of the first
    step's grads (the router and the experts among them) within rtol 1e-4,
    atol 1e-5. Every rank logs the same losses."""
    want = runs["jax"][ARMS[arm][1]]
    r0 = runs["ranks"][0][arm]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=LOSS_RTOL)
    assert any(".moe.w2" in k for k in want["grads"]) and any(".moe.router." in k for k in want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(r0["grads"][name].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert all(r[arm]["losses"] == r0["losses"] and r[arm]["norms"] == r0["norms"] for r in runs["ranks"])


@pytest.mark.parametrize("arm", TP_ARMS)
def test_replicated_leaves_stay_equal_across_tp_ranks(runs, arm):
    """After 3 steps every leaf outside the Megatron four, the MoE's router
    and experts among them, is bitwise the same on the tp ranks of one
    (dp, fsdp, sp, ep) coordinate: they run the whole MoE alike and take no
    tp reduction."""
    by_place = {}
    for r in runs["ranks"]:
        a = r[arm]
        by_place.setdefault(tuple(v for d, v in a["coord"].items() if d != "tp"), []).append(a["replicated"])
    assert all(len(v) == 2 for v in by_place.values())
    for group in by_place.values():
        assert any(".moe.w1" in n for n in group[0])
        assert all(torch.equal(group[0][n], group[1][n]) for n in group[0])


def test_tp_ep_checkpoint_restores_in_one_process_and_exports_its_npz(runs, tmp_path):
    """The (tp 2, ep 2) arm's checkpoint holds the expert and Megatron
    leaves at their global shapes, restores bitwise into one unwrapped
    process, and consolidate's full-state npz export of it is that one
    process's export (train_state_to_jax), leaf for leaf."""
    from vitax_torch.checkpoint.consolidate import consolidate
    from vitax_torch.checkpoint.convert import train_state_to_jax
    ckpt = os.path.join(runs["root"], "ckpt_tp2_ep2")
    meta = ckpt_io.read_state(ckpt, 1, groups=("model",))["model"]
    assert tuple(meta["blocks.0.moe.w1"].shape) == (4, 32, 128)
    assert tuple(meta["blocks.0.attn.qkv.weight"].shape) == (96, 32)
    want = runs["ranks"][0]["tp2_ep2"]["state"]
    assert all(torch.equal(r["tp2_ep2"]["state"]["params"][k], want["params"][k])
               for r in runs["ranks"] for k in want["params"])
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(ckpt, 1, make_train_state(model))
    ckpt_io.close()
    one = {"params": {n: p.detach() for n, p in state.model.named_parameters()}, "mu": state.mu, "nu": state.nu}
    assert int(state.count) == want["count"] and state.step == want["step"] == STEPS
    assert all(torch.equal(one[g][k], want[g][k]) for g in ("params", "mu", "nu") for k in want["params"])
    flat = consolidate(ckpt, 1, str(tmp_path / "tp2_ep2.npz"), params_only=False)
    ref = train_state_to_jax(one["params"], one["mu"], one["nu"], state.step, int(state.count))
    assert sorted(flat) == sorted(ref)
    assert all(torch.equal(torch.as_tensor(np.asarray(flat[k])), torch.as_tensor(ref[k])) for k in ref)


# --- the slot prefix alone, and the config -----------------------------------

@pytest.mark.parametrize("top_k,shards", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_sharded_route_is_the_slice_of_the_unsharded_route(top_k, shards):
    """route() on each token slice, with its lower slices' and the whole
    sequence's choice counts (what sequence_counts gathers over the sp
    group), equals the slice of route() on the whole sequence: gates,
    experts and kept flags, and each token's buffer slot plus the tokens
    queued before the slice over the whole sequence (the lower slices'
    choices; for a second choice, the rest of the sample's first choices
    too) is the whole route's slot. Sample 0's first slice sends
    every token to expert 1, so it takes all of that expert's C slots
    and the later slices' tokens for it drop. The rank's buffer slots of
    its kept tokens are unique and below C."""
    gen = torch.Generator().manual_seed(7)
    b, n, e = 3, 16, 4
    logits = torch.randn(b, n, e, generator=gen)
    logits[0, :n // shards, 1] += 20.0
    probs = torch.softmax(logits, dim=-1)
    c = capacity(e, n, 0.5)
    whole = route(probs, top_k, c)
    m = n // shards
    counts = torch.stack([torch.stack([ch.onehot.sum(dim=1) for ch in route(probs[:, i * m:(i + 1) * m], top_k, c)])
                          for i in range(shards)])            # (S, K, B, E)
    assert int(counts[0, 0, 0, 1]) == m > c
    for i in range(shards):
        got = route(probs[:, i * m:(i + 1) * m], top_k, c, lambda k, i=i: (counts[:i].sum(dim=0), counts.sum(dim=0)))
        before = counts[:i].sum(dim=0)
        shifts = [before[0], counts.sum(dim=0)[0] - counts[i, 0] + before[top_k - 1]]
        for w, g, shift in zip(whole, got, shifts):
            cut = slice(i * m, (i + 1) * m)
            for field in ("gate", "expert", "keep"):
                assert torch.equal(getattr(w, field)[:, cut], getattr(g, field)), (i, field)
            assert torch.equal(w.slot[:, cut], g.slot + torch.gather(shift, 1, g.expert).to(torch.int32)), i
        for row in range(b):
            slots = [(int(ch.expert[row, t]), int(ch.slot[row, t])) for ch in got for t in range(m) if ch.keep[row, t]]
            assert len(slots) == len(set(slots)) and all(0 <= s < c for _, s in slots)
        if i > 0:
            assert not got[0].keep[0][got[0].expert[0] == 1].any()


@pytest.mark.parametrize("kw", [dict(sp_size=2), dict(sp_size=2, sp_impl="ulysses"), dict(tp_size=2),
                                dict(tp_size=2, ep_size=2), dict(tp_size=2, sp_size=2)],
                         ids=["sp2_ring", "sp2_ulysses", "tp2", "tp2_ep2", "tp2_sp2"])
def test_config_validates_moe_under_sp_and_tp(kw):
    """MoE under sp, under tp and under tp beside ep validates."""
    Config(**TINY, **kw).validate()


@pytest.mark.parametrize("kw,match", [
    (dict(sp_size=2, ep_size=2), r"vitax has no green reference for MoE under sp beside ep > 1 .*"
                                 r"vitax/train/state.py:86-89.*vitax fails at init\); ROADMAP item 11"),
    (dict(pp_size=2, tp_size=2, moe_experts=0), r"no green reference \(its pp x tp cases are xfail.*ROADMAP item 11")],
    ids=["sp_ep", "pp_tp"])
def test_config_refuses_what_vitax_cannot_run(kw, match):
    """MoE under sp beside ep > 1 (vitax fails at init) and pp beside tp
    (vitax's cases are xfail; dense here, as vitax refuses MoE under pp
    beside tp first) stay refused, each naming why; so does an ep size
    that -1 resolves to beside sp."""
    with pytest.raises(ValueError, match=match):
        Config(**{**TINY, **kw}).validate()
    if "ep_size" in kw:
        from vitax_torch.parallel.mesh import mesh_sizes
        cfg = Config(**TINY, fsdp_size=1, sp_size=2, ep_size=-1).validate()
        with pytest.raises(ValueError, match=match):
            mesh_sizes(cfg, 4)
