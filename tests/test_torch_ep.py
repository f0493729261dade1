"""vitax_torch trained expert-parallel (--ep_size, the MoE experts sharded
over the mesh's "ep" dim) on four CPU processes (gloo), held to the JAX
package's MoE training on a 4-device mesh.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py): the MoE model (D 32, 4 heads, 2 blocks, 4
experts, f32, grad_ckpt) at (fsdp 2, ep 2) and at (ep 4), each with top-1
einsum and top-2 gather dispatch, and (fsdp 2, ep 2) with 2 microbatches
(one backward through both under FSDP2, as vitax differentiates through
its microbatch scan), its first step's grads captured. It
exports vitax's init as npz, then spawns ONE 4-rank gloo group
(torch.multiprocessing.spawn, init_method file://) that runs every arm of
the port for 3 steps on one seeded numpy global batch, batch shard b on
rows [b B/4, (b + 1) B/4) as vitax's devices hold them, plus train()
under (fsdp 2, ep 2) with a checkpoint. The tests read what the ranks
wrote:

- every arm's losses and grad norms equal vitax's (rtol 2e-4, the bar of
  tests/test_train_smoke.py:99), and so do the grads of the first step:
  an expert grad averaged over the ep group (ep times too small), a dense
  grad not averaged over it, or a norm that counts the experts of one rank
  only would each miss them;
- each rank holds E/ep experts, the ones vitax's device holds;
- train() under (fsdp 2, ep 2) saves a checkpoint whose expert leaves
  stand at their global (E, ...) shape, that one process restores
  bitwise, and a one-process save restores bitwise into the group.
"""

import os

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.state import TrainState, build_optimizer, local, make_train_state
from vitax_torch.train.step import make_train_step

TINY = dict(image_size=32, patch_size=8, embed_dim=32, num_heads=4, num_blocks=2, num_classes=10,
            batch_size=8, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32",
            moe_experts=4)
STEPS, MAX_ITER, WORLD = 3, 10, 4
ARMS = {"fsdp2_ep2_top1": dict(fsdp_size=2, ep_size=2),
        "ep4_top1": dict(fsdp_size=1, ep_size=4),
        "fsdp2_ep2_top2_gather": dict(fsdp_size=2, ep_size=2, moe_top_k=2, moe_impl="gather"),
        "ep4_top2_gather": dict(fsdp_size=1, ep_size=4, moe_top_k=2, moe_impl="gather"),
        "fsdp2_ep2_top1_accum2": dict(fsdp_size=2, ep_size=2, grad_accum_steps=2)}
TRAIN_RUN = dict(fake_data=True, num_epochs=1, steps_per_epoch=2, eval_max_batches=1, test_epoch_interval=1,
                 log_step_interval=1, num_workers=1, fsdp_size=2, ep_size=2)


def _batch():
    rng = np.random.default_rng(13)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _jax_run(arm: dict, images, labels):
    """vitax on 4 devices: (init params flat, losses, grad norms, the first
    step's grads flat)."""
    import jax
    import jax.numpy as jnp
    import vitax.train.step as jax_step
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import build_mesh
    from vitax.train.loop import _moe_dispatch_sharding
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    cfg = JaxConfig(**{**TINY, **arm}, scan_blocks=False, grad_ckpt=True).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:WORLD])
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
        model = jax_build_model(cfg, moe_dispatch_sharding=_moe_dispatch_sharding(cfg, mesh))
        tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
        state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
        step_fn = jax_step.make_train_step(cfg, model, tx, mesh, sspecs, schedule=schedule)
    finally:
        jax_step._make_update_fn = make_update
    init = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(state.params)).items()}
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step_fn(state, batch, jax.random.key(1))
        losses.append(float(jax.device_get(m["loss"])))
        norms.append(float(jax.device_get(m["grad_norm"])))
    jax.effects_barrier()
    return init, losses, norms, flatten_tree(grads[0])


def _sharded_state(cfg, mesh, sd) -> TrainState:
    """The model built on meta with the rank's expert shard, apply_fsdp,
    the whole tensors of `sd` cut to the rank's shards."""
    from vitax_torch.parallel.mesh import expert_shard
    from vitax_torch.parallel.sharding import apply_fsdp, local_shard
    model = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu", mesh),
                        expert_shard=expert_shard(mesh))
    model = apply_fsdp(model, cfg, mesh)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            local(p).copy_(local_shard(sd[name], p))
    return make_train_state(model.train())


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _gathered(state: TrainState) -> dict:
    """params, mu, nu whole (a collective), count and step."""
    return {"params": {n: _whole(p) for n, p in state.model.named_parameters()},
            "mu": {n: _whole(v) for n, v in state.mu.items()}, "nu": {n: _whole(v) for n, v in state.nu.items()},
            "count": int(state.count), "step": state.step}


def _run_arm(arm: dict, sd, images, labels) -> dict:
    """3 steps of one arm on this rank: losses, grad norms, the first
    step's grads (whole), the rank's batch shard and its experts' rows."""
    from vitax_torch.parallel.mesh import batch_shard, build_mesh
    cfg = Config(**{**TINY, **arm}).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    b, count = batch_shard(mesh)
    rows = slice(b * 8 // count, (b + 1) * 8 // count)
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
    w1 = state.model.blocks[0].moe.w1
    return {"losses": losses, "norms": norms, "grads": grads, "shard": (b, count),
            "experts": tuple(w1.to_local().shape), "w1_local": w1.to_local().detach().clone(),
            "w1_whole": _whole(w1)}


def _worker(rank: int, root: str) -> None:
    """One rank of the 4-rank gloo group: every arm, results to
    root/rank<r>.pt."""
    import torch.distributed as dist
    from vitax_torch.parallel.mesh import build_mesh
    from vitax_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=WORLD)
    data = np.load(os.path.join(root, "inputs.npz"))
    images, labels = data["images"], data["labels"]
    out = {}
    for name, arm in ARMS.items():
        sd = params_from_jax({k[len(f"init/{name}/"):]: data[k] for k in data.files
                              if k.startswith(f"init/{name}/")})
        out[name] = _run_arm(arm, sd, images, labels)

    # train() under (fsdp 2, ep 2): a save at its last epoch, then the reverse restore
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=os.path.join(root, "ckpt_ep")), "cpu", records=records)
    out["train"] = {"records": records, "state": _gathered(state)}
    cfg = Config(**TINY, fsdp_size=2, ep_size=2).validate()
    sd = params_from_jax({k[len("init/fsdp2_ep2_top1/"):]: data[k] for k in data.files
                          if k.startswith("init/fsdp2_ep2_top1/")})
    target = _sharded_state(cfg, build_mesh(cfg, torch.device("cpu")), sd)
    target = ckpt_io.restore_state(os.path.join(root, "ckpt1"), 1, target)
    out["reverse"] = _gathered(target)
    ckpt_io.close()
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("ep"))
    images, labels = _batch()
    jax_out, saved = {}, {}
    for name, arm in ARMS.items():
        init, losses, norms, grads = _jax_run(arm, images, labels)
        jax_out[name] = {"losses": losses, "norms": norms, "grads": params_from_jax(grads),
                         "init": params_from_jax(init)}
        saved.update({f"init/{name}/{k}": v for k, v in init.items()})
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels, **saved)

    # one process: a state a step past vitax's init, saved for the group to restore
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(jax_out["fsdp2_ep2_top1"]["init"], strict=True, assign=True)
    single = make_train_state(model.train())
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    single, _ = make_train_step(cfg, optimizer, "cpu")(
        single, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    ckpt_io.save_state(os.path.join(root, "ckpt1"), 1, single, wait=True)
    ckpt_io.close()

    mp.spawn(_worker, args=(root,), nprocs=WORLD, join=True)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(jax=jax_out, ranks=ranks, root=root, single=single)


def _whole_state(state: TrainState) -> dict:
    return {"params": {n: p.detach() for n, p in state.model.named_parameters()}, "mu": state.mu, "nu": state.nu,
            "count": int(state.count), "step": state.step}


def _equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and all(torch.equal(a[g][k], b[g][k]) for g in ("params", "mu", "nu") for k in a["params"]))


@pytest.mark.parametrize("arm", list(ARMS))
def test_losses_and_grads_match_jax_on_four_devices(runs, arm):
    """Each arm on 4 ranks against vitax's same arm on 4 devices: losses
    and grad norms at rtol 2e-4, and every leaf of the first step's grads
    within rtol 2e-4 of vitax's (atol 1e-4 of the leaf's largest grad),
    the experts and the router among them. Every rank logs the same loss."""
    want = runs["jax"][arm]
    r0 = runs["ranks"][0][arm]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=2e-4)
    assert any(".moe.w2" in k for k in want["grads"]) and any(".moe.router." in k for k in want["grads"])
    for name, g in want["grads"].items():
        ours = r0["grads"][name].numpy()
        np.testing.assert_allclose(ours, g.numpy(), rtol=2e-4, atol=1e-4 * float(g.abs().max()), err_msg=name)
    assert all(r[arm]["losses"] == r0["losses"] and r[arm]["norms"] == r0["norms"] for r in runs["ranks"])


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_rank_holds_its_experts_and_batch_shard(runs, arm):
    """Rank r reads batch shard r (dp, fsdp and ep carry the batch) and
    holds experts [j E/ep, (j + 1) E/ep), j its ep index (ep fastest), cut
    over fsdp on a dim past the experts."""
    ep, fsdp = ARMS[arm]["ep_size"], ARMS[arm]["fsdp_size"]
    for rank, r in enumerate(runs["ranks"]):
        a = r[arm]
        assert a["shard"] == (rank, WORLD)
        assert a["experts"][0] == TINY["moe_experts"] // ep
        j = rank % ep
        mine = a["w1_whole"][j * a["experts"][0]:(j + 1) * a["experts"][0]]
        assert any(torch.equal(a["w1_local"], c) for c in torch.chunk(mine, fsdp, dim=2))


def test_ep_save_restores_in_one_process(runs):
    """train() under (fsdp 2, ep 2): every rank logs the same losses, its
    checkpoint holds the expert leaves at their global (E, ...) shape, and
    restores bitwise into one unwrapped process."""
    recs = [[x["loss"] for x in r["train"]["records"] if "loss" in x] for r in runs["ranks"]]
    assert all(x == recs[0] for x in recs) and len(recs[0]) == 2 and all(np.isfinite(recs[0]))
    meta = ckpt_io.read_state(os.path.join(runs["root"], "ckpt_ep"), 1, groups=("model",))["model"]
    assert tuple(meta["blocks.0.moe.w1"].shape) == (4, 32, 128)
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(os.path.join(runs["root"], "ckpt_ep"), 1, make_train_state(model))
    assert _equal(_whole_state(state), runs["ranks"][0]["train"]["state"])


def test_one_process_save_restores_into_the_ep_group(runs):
    """A one-process checkpoint restored into the (fsdp 2, ep 2) sharded
    state: gathered, bitwise the saved state on every rank."""
    want = _whole_state(runs["single"])
    for r in runs["ranks"]:
        assert _equal(r["reverse"], want)
