"""vitax_torch trained pipeline-parallel (--pp_size, GPipe and 1F1B over the
mesh's "pp" dim, parallel/pipeline.py and pipeline_1f1b.py) on four CPU
processes (gloo), held to the JAX package's pipelines on a 4-device mesh.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py): the model (D 64, 4 heads, 4 blocks, batch 8,
f32) under vitax/parallel/pipeline.py's GPipe at (fsdp 2, pp 2), at (pp
4, M 4), at (fsdp 2, pp 2, M 4) and (pp 4, M 2) under att_dropout 0.1
(an attention core
of vitax's dense attention with its hash-mask dropout, whose seeds a
jax.debug.callback captures with the stage and the pipeline shard index
of each call, the tick and layer following from their order), at (pp 2,
sp 2) through the ring body, and as a top-1 einsum MoE of 4 experts at
(pp 2, ep 2); and under pipeline_1f1b.py at (fsdp 2, pp 2, M 4). It
exports vitax's init as npz, then spawns ONE 4-rank gloo group
(torch.multiprocessing.spawn, init_method file://) that runs every arm for
3 steps on one seeded numpy global batch, the port-only arms beside them
(Ulysses under pp, dots_attn_saveable, DP, GPipe at 1F1B's mesh), eval,
and train() at (fsdp 2, pp 2) with checkpoints, a resume and a restore at
pp 1. The tests read what the ranks wrote:

- every arm's losses, grad norms and first-step grads equal vitax's
  (rtol 2e-4), the dropout arm's attention masks vitax's (its captured
  seeds, a global block's seed per (microbatch, pipeline shard));
- the port's 1F1B and GPipe train the same bits, and so do
  dots_attn_saveable and none_saveable;
- the replicated leaves stay bitwise equal across the stages, and the
  ranks send the hops the schedule predicts;
- eval counts under pp equal one process's;
- the pp-2 checkpoint resumes bitwise, restores at pp 1 and in one
  process bitwise, and its full-state npz export is the one-process
  export bit for bit.
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
from vitax_torch.train.step import make_eval_step, make_train_step

TINY = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4, num_blocks=4, num_classes=10,
            batch_size=8, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32")
STEPS, MAX_ITER, RATE, WORLD = 3, 10, 0.1, 4
MOE = dict(moe_experts=4, moe_top_k=1, moe_impl="einsum")
ARMS = {"gpipe_fsdp2_pp2": dict(fsdp_size=2, pp_size=2),
        "gpipe_pp4_m4": dict(fsdp_size=1, pp_size=4, pp_microbatches=4),
        "gpipe_fsdp2_pp2_drop": dict(fsdp_size=2, pp_size=2, pp_microbatches=4, att_dropout=RATE),
        # microbatches of 4 rows (those above hold 1): a strided split would mask other rows
        "gpipe_pp4_m2_drop": dict(fsdp_size=1, pp_size=4, pp_microbatches=2, att_dropout=RATE),
        "gpipe_pp2_sp2_ring": dict(fsdp_size=1, pp_size=2, sp_size=2),
        "gpipe_pp2_ep2_moe": dict(fsdp_size=1, pp_size=2, ep_size=2, **MOE),
        "1f1b_fsdp2_pp2_m4": dict(fsdp_size=2, pp_size=2, pp_microbatches=4, pp_schedule="1f1b")}
# port-only arms: (the arm whose vitax numbers they must train, their flags)
PORT_ARMS = {"gpipe_pp2_sp2_ulysses": ("gpipe_pp2_sp2_ring", dict(fsdp_size=1, pp_size=2, sp_size=2,
                                                                   sp_impl="ulysses")),
             "gpipe_fsdp2_pp2_dots_attn": ("gpipe_fsdp2_pp2", dict(fsdp_size=2, pp_size=2,
                                                                  remat_policy="dots_attn_saveable")),
             "gpipe_dp2_pp2": ("gpipe_fsdp2_pp2", dict(dp_size=2, pp_size=2, run_without_fsdp=True)),
             "gpipe_fsdp2_pp2_m4": ("1f1b_fsdp2_pp2_m4", dict(fsdp_size=2, pp_size=2, pp_microbatches=4))}
# pairs that change no arithmetic: bitwise the same run
BITWISE = (("gpipe_fsdp2_pp2_dots_attn", "gpipe_fsdp2_pp2"), ("1f1b_fsdp2_pp2_m4", "gpipe_fsdp2_pp2_m4"))
TRAIN_RUN = dict(fake_data=True, num_epochs=2, steps_per_epoch=1, eval_max_batches=1, test_epoch_interval=1,
                 log_step_interval=1, num_workers=1, ckpt_epoch_interval=1, fsdp_size=2, pp_size=2)


def _batch():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _capturing_core(rate: float, captured: list):
    """vitax's dense attention (its reference_attention) with its hash-mask
    dropout (make_dense_dropout), recording each dropout call's (stage,
    pipeline shard index, seed) as vitax's pipeline body sees them."""
    import jax
    from vitax.ops.attention import make_dense_dropout, reference_attention
    inner = make_dense_dropout(rate)

    def core(q, k, v):
        return reference_attention(q, k, v)

    def drop(q, k, v, seed):
        ax = jax.lax.axis_index
        index = ((ax("dp") * jax.lax.psum(1, "fsdp") + ax("fsdp")) * jax.lax.psum(1, "ep")
                 + ax("ep")) * jax.lax.psum(1, "sp") + ax("sp")
        jax.debug.callback(lambda s, p, i: captured.append((int(p), int(i), int(s))), seed, ax("pp"), index)
        return inner(q, k, v, seed)
    core.vitax_dropout = drop
    return core


def _jax_run(arm: dict, images, labels):
    """vitax on 4 devices: (init params flat, losses, grad norms, the first
    step's grads flat, each step's captured {(stage, shard): [seed per
    (tick, layer)]})."""
    import jax
    import jax.numpy as jnp
    import vitax.train.step as jax_step
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    cfg = JaxConfig(**{**TINY, **arm}, grad_ckpt=False).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:WORLD])
    captured, grads = [], []
    impl = _capturing_core(cfg.att_dropout, captured) if cfg.att_dropout > 0 else jax_make_attention_impl(cfg, mesh)
    make_update = jax_step._make_update_fn

    def capturing(*a, **kw):                    # the grads the optimizer is handed
        update = make_update(*a, **kw)

        def wrapped(g, opt_state, params):
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return update(g, opt_state, params)
        return wrapped
    jax_step._make_update_fn = capturing
    try:
        model = jax_build_model(cfg, attention_impl=impl)
        tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
        state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
        step_fn = jax_step.make_train_step(cfg, model, tx, mesh, sspecs, schedule=schedule)
    finally:
        jax_step._make_update_fn = make_update
    init = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(state.params)).items()}
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    losses, norms, seeds = [], [], []
    for _ in range(STEPS):
        captured.clear()
        state, m = step_fn(state, batch, jax.random.key(1))
        losses.append(float(jax.device_get(m["loss"])))
        norms.append(float(jax.device_get(m["grad_norm"])))
        jax.effects_barrier()
        by_place = {}
        for stage, index, seed in captured:
            by_place.setdefault((stage, index), []).append(seed)
        seeds.append(by_place)
    return init, losses, norms, flatten_tree(grads[0]), seeds


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _gathered(state: TrainState) -> dict:
    """The stage's params, mu, nu whole (a collective), count and step."""
    return {"params": {n: _whole(p) for n, p in state.model.named_parameters()},
            "mu": {n: _whole(v) for n, v in state.mu.items()}, "nu": {n: _whole(v) for n, v in state.nu.items()},
            "count": int(state.count), "step": state.step}


def _sharded_state(cfg, mesh, sd) -> TrainState:
    """The rank's model (its stage under pp) built on meta with the mesh's
    core and shards, apply_fsdp, the whole tensors of `sd` cut to the
    rank's shards."""
    from vitax_torch.parallel.mesh import expert_shard, pipe_shard, token_shard
    from vitax_torch.parallel.sharding import apply_fsdp, local_shard
    model = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu", mesh),
                        token_shard=token_shard(cfg, mesh), expert_shard=expert_shard(mesh),
                        pipe_shard=pipe_shard(mesh))
    model = apply_fsdp(model, cfg, mesh)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            local(p).copy_(local_shard(sd[name], p))
    return make_train_state(model.train())


def _captured_seeds(cfg, seeds):
    """pp_seeds that hands the port vitax's captured seed of each global
    block: the one its stage drew at tick k + stage, layer l - stage Lps,
    for the rank's pipeline shard."""
    from vitax_torch.models.vit import DropoutSeeds
    per = cfg.num_blocks // cfg.pp_size

    def pp_seeds(cfg_, step, k, index):
        return DropoutSeeds(blocks=tuple(int(seeds[step][(l // per, index)][(k + l // per) * per + l % per])
                                         for l in range(cfg.num_blocks)))
    return pp_seeds


def _run_arm(arm: dict, sd, images, labels, seeds=None) -> dict:
    """3 steps of one arm on this rank, then an eval of the global batch:
    losses, grad norms, the first step's grads of the stage's leaves whole,
    the hops, the rank's coordinates, its replicated leaves' local tensors,
    the summed counts and the stage's params whole."""
    import vitax_torch.train.step as step_module
    from vitax_torch import distributed
    from vitax_torch.parallel import pipeline
    from vitax_torch.parallel.mesh import MESH_DIMS, batch_shard, build_mesh, data_shard
    cfg = Config(**{**TINY, **arm}).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    b, count = batch_shard(mesh)
    rows = slice(b * 8 // count, (b + 1) * 8 // count)
    state = _sharded_state(cfg, mesh, sd)
    own = step_module.pp_seeds
    if seeds is not None:                       # vitax's captured seeds in place of the port's
        step_module.pp_seeds = _captured_seeds(cfg, seeds)
    batch = {"image": torch.from_numpy(images[rows]), "label": torch.from_numpy(labels[rows])}
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    losses, norms, grads = [], [], None
    pipeline.reset_hops()
    try:
        train_step = make_train_step(cfg, optimizer, "cpu", mesh)
        for _ in range(STEPS):
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if grads is None:
                grads = {n: _whole(p.grad) for n, p in state.model.named_parameters()}
    finally:
        step_module.pp_seeds = own
    counts = make_eval_step(cfg, mesh)(state, batch)
    hops = dict(pipeline.HOPS)
    return dict(losses=losses, norms=norms, grads=grads, hops=hops, shard=(b, count), data_shard=data_shard(cfg),
                coord=dict(zip(MESH_DIMS, mesh.get_coordinate())),
                replicated={n: local(p).detach().clone() for n, p in state.model.named_parameters()
                            if not n.startswith("blocks.")},
                counts={k: int(distributed.all_reduce_sum(v.float())) for k, v in counts.items()},
                params={n: _whole(p) for n, p in state.model.named_parameters()},
                core=getattr(state.model.blocks[0].attn.attention_impl, "vitax_name", None))


def _worker(rank: int, root: str) -> None:
    """One rank of the 4-rank gloo group: every arm, results to
    root/rank<r>.pt."""
    import torch.distributed as dist
    from vitax_torch.parallel.mesh import build_mesh
    from vitax_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=WORLD)
    data = np.load(os.path.join(root, "inputs.npz"), allow_pickle=True)
    images, labels = data["images"], data["labels"]
    sd, sd_moe = (params_from_jax({k[len(p):]: data[k] for k in data.files if k.startswith(p)})
                  for p in ("init/", "init_moe/"))
    out = {}
    for name, arm in ARMS.items():
        seeds = data[f"seeds/{name}"].tolist() if arm.get("att_dropout") else None
        out[name] = _run_arm(arm, sd_moe if "moe_experts" in arm else sd, images, labels, seeds)
    for name, (_, arm) in PORT_ARMS.items():
        out[name] = _run_arm(arm, sd, images, labels)

    # train() under (fsdp 2, pp 2): two epochs saved, then a resume of the second
    ckpt = os.path.join(root, "ckpt_pp")
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=ckpt), "cpu", records=records)
    out["train"] = {"records": records, "state": _gathered(state)}
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=ckpt, resume_epoch=1), "cpu")
    out["resumed"] = _gathered(state)
    # the pp-2 checkpoint restored into a pp-1 group: (fsdp 4)
    cfg = Config(**TINY, fsdp_size=4).validate()
    target = _sharded_state(cfg, build_mesh(cfg, torch.device("cpu")), sd)
    out["at_pp1"] = _gathered(ckpt_io.restore_state(ckpt, 2, target))
    ckpt_io.close()
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("pp"))
    images, labels = _batch()
    jax_out, saved = {}, {}
    for name, arm in ARMS.items():
        init, losses, norms, grads, seeds = _jax_run(arm, images, labels)
        jax_out[name] = {"losses": losses, "norms": norms, "grads": params_from_jax(grads), "seeds": seeds}
        saved.update({f"{'init_moe' if 'moe_experts' in arm else 'init'}/{k}": v for k, v in init.items()})
        if arm.get("att_dropout"):
            saved[f"seeds/{name}"] = np.asarray(seeds, dtype=object)
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels, **saved)
    mp.spawn(_worker, args=(root,), nprocs=WORLD, join=True)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    dense = {k[len("init/"):]: v for k, v in saved.items() if k.startswith("init/")}
    return dict(jax=jax_out, ranks=ranks, root=root, images=images, labels=labels, init=params_from_jax(dense))


def _union(ranks, arm: str, key: str) -> dict:
    """The stages' whole tensors of `key` merged over the ranks."""
    out = {}
    for r in ranks:
        out.update(r[arm][key])
    return out


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_losses_and_grads_match_jax_on_four_devices(runs, arm):
    """Each arm on 4 ranks against vitax's same arm (a port-only arm: its
    base arm) on 4 devices: losses and grad norms at rtol 2e-4, and every
    leaf of the first step's grads, the stages' merged, within rtol 2e-4
    of vitax's (atol 1e-4 of the leaf's largest grad). The norm catches a
    stage's blocks counted once instead of summed over the stages, or a
    replicated leaf counted twice; the grads a replicated leaf's grad left
    on the stage that used it, or a microbatch lost; the dropout arm runs
    vitax's captured seeds, so its masks are vitax's (a wrong microbatch
    split, tick or shard index lands far off). Every rank logs the same
    loss."""
    base = PORT_ARMS[arm][0] if arm in PORT_ARMS else arm
    want = runs["jax"][base]
    r0 = runs["ranks"][0][arm]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=2e-4)
    ours = _union(runs["ranks"], arm, "grads")
    assert sorted(ours) == sorted(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(ours[name].numpy(), g.numpy(), rtol=2e-4, atol=1e-4 * float(g.abs().max()),
                                   err_msg=name)
    assert all(r[arm]["losses"] == r0["losses"] and r[arm]["norms"] == r0["norms"] for r in runs["ranks"])


@pytest.mark.parametrize("arm,base", BITWISE)
def test_schedules_and_remat_policies_train_the_same_bits(runs, arm, base):
    """1F1B and GPipe run each microbatch's backward in the same order on
    the same stage code, and dots_attn_saveable changes what a block keeps,
    not what it computes: their losses, grad norms and first-step grads
    are bitwise their base arm's."""
    for r in runs["ranks"]:
        assert r[arm]["losses"] == r[base]["losses"] and r[arm]["norms"] == r[base]["norms"]
        assert all(torch.equal(r[arm]["grads"][n], g) for n, g in r[base]["grads"].items())


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_ranks_hold_vitaxs_stages_and_send_the_scheduled_hops(runs, arm):
    """Rank r sits at vitax's device r of the (dp, fsdp, tp, sp, pp, ep)
    mesh, holds its stage's blocks only, under their global names, and
    reads its batch shard's rows (from the mesh and from the process group
    alone); a stage sends M activations a step and an eval to the next
    stage and M cotangents a step to the previous one."""
    from vitax_torch.parallel.mesh import MESH_DIMS, mesh_sizes, rank_coordinates
    cfg = Config(**{**TINY, **(PORT_ARMS[arm][1] if arm in PORT_ARMS else ARMS[arm])})
    sizes = mesh_sizes(cfg, WORLD)
    s_count, per = cfg.pp_size, cfg.num_blocks // cfg.pp_size
    m = cfg.pp_microbatches or s_count
    for rank, r in enumerate(runs["ranks"]):
        a = r[arm]
        assert tuple(a["coord"][d] for d in MESH_DIMS) == rank_coordinates(rank, sizes)
        c, stage = a["coord"], a["coord"]["pp"]
        want = (c["dp"] * sizes[1] + c["fsdp"]) * sizes[5] + c["ep"]
        assert a["shard"] == a["data_shard"] == (want, sizes[0] * sizes[1] * sizes[5])
        blocks = {int(n.split(".")[1]) for n in a["params"] if n.startswith("blocks.")}
        assert blocks == set(range(stage * per, (stage + 1) * per))
        assert a["hops"] == {"forward": m * (STEPS + 1) * (stage < s_count - 1), "backward": m * STEPS * (stage > 0)}
    core = runs["ranks"][0][arm]["core"]
    if cfg.sp_size > 1:
        assert core == ("ulysses all-to-all (sp)" if cfg.sp_impl == "ulysses" else "ring attention (sp)")


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_replicated_leaves_stay_equal_across_stages(runs, arm):
    """After 3 steps the embedding, the final norm and the head (their
    local shards) are bitwise the same on every stage of one (dp, fsdp,
    sp, ep) coordinate: their grads are summed over the stages and the
    update runs the same arithmetic on each."""
    by_place = {}
    for r in runs["ranks"]:
        a = r[arm]
        key = tuple(v for d, v in a["coord"].items() if d != "pp")
        by_place.setdefault(key, []).append(a["replicated"])
    assert all(len(v) > 1 for v in by_place.values())
    for group in by_place.values():
        for other in group[1:]:
            assert sorted(other) == sorted(group[0])
            assert all(torch.equal(group[0][n], other[n]) for n in group[0])


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_eval_counts_under_pp_equal_one_process(runs, arm):
    """make_eval_step under pp: the batch runs through the stages' forwards
    and only the last stage counts (sp index 0), so the sum over every
    process equals one process's counts on the arm's final params (the
    stages' merged) over the global batch."""
    cfg = Config(**{**TINY, **(MOE if "moe" in arm else {})}).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(_union(runs["ranks"], arm, "params"), strict=True, assign=True)
    batch = {"image": torch.from_numpy(runs["images"]), "label": torch.from_numpy(runs["labels"])}
    want = {k: int(v) for k, v in make_eval_step(cfg)(make_train_state(model.eval()), batch).items()}
    assert want["correct_top5"] > 0
    assert all(r[arm]["counts"] == want for r in runs["ranks"])


@pytest.mark.parametrize("arm", [name for name, arm in ARMS.items() if arm.get("att_dropout")])
def test_dropout_arms_ran_vitaxs_masks(runs, arm):
    """vitax's captured seeds cover every (stage, pipeline shard) at (M + S
    - 1) ticks of Lps layers a step, and differ between the shards and the
    steps, so the parity of a dropout arm rests on distinct masks; the
    dropout moved the losses and the grad norms off the rate-0 arm's."""
    cfg = Config(**{**TINY, **ARMS[arm]})
    per, s_count, m = cfg.num_blocks // cfg.pp_size, cfg.pp_size, cfg.pp_microbatches
    seeds = runs["jax"][arm]["seeds"]
    assert all(sorted(step) == [(s, i) for s in range(s_count) for i in range(WORLD // s_count)] for step in seeds)
    assert all(len(v) == (m + s_count - 1) * per for step in seeds for v in step.values())
    flat = [x for step in seeds for v in step.values() for x in v]
    assert len(set(flat)) == len(flat)
    base = runs["jax"]["gpipe_fsdp2_pp2"]
    moved = [np.abs(np.subtract(runs["jax"][arm][k], base[k])).max() for k in ("losses", "norms")]
    assert min(moved) > 2e-5, moved


def _merged_state(states) -> dict:
    """Gathered states of the stages merged (each rank's own keys)."""
    out = {"params": {}, "mu": {}, "nu": {}, "count": states[0]["count"], "step": states[0]["step"]}
    for state in states:
        for g in ("params", "mu", "nu"):
            out[g].update(state[g])
    return out


def _equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and all(sorted(a[g]) == sorted(b[g]) and all(torch.equal(a[g][k], b[g][k]) for k in a[g])
                    for g in ("params", "mu", "nu")))


def test_pp_checkpoint_resumes_and_restores_at_pp1_and_in_one_process(runs):
    """train() under (fsdp 2, pp 2), two epochs with a save each: every rank
    logs the same losses; --resume_epoch 1 trains the second epoch again
    to the same state bitwise on every stage; the epoch-2 checkpoint holds
    every stage's blocks under their global names and restores bitwise into
    a pp-1 group (fsdp 4) and into one unwrapped process."""
    ranks = runs["ranks"]
    recs = [[x["loss"] for x in r["train"]["records"] if "loss" in x] for r in ranks]
    assert all(x == recs[0] for x in recs) and len(recs[0]) == 2 and all(np.isfinite(recs[0]))
    for r in ranks:
        assert _equal(r["resumed"], r["train"]["state"])
    want = _merged_state([r["train"]["state"] for r in ranks])
    assert sorted(want["params"]) == sorted(runs["init"])
    for r in ranks:
        assert _equal(r["at_pp1"], want)
    ckpt = os.path.join(runs["root"], "ckpt_pp")
    meta = ckpt_io.read_state(ckpt, 2, groups=("model",))["model"]
    assert sorted(meta) == sorted(runs["init"])
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(ckpt, 2, make_train_state(model))
    got = {"params": {n: p.detach() for n, p in state.model.named_parameters()}, "mu": state.mu, "nu": state.nu,
           "count": int(state.count), "step": state.step}
    assert _equal(got, want)


def test_pp_checkpoint_exports_the_one_process_npz(runs, tmp_path):
    """consolidate's full-state npz export of the pp-2 checkpoint gathers
    every stage's blocks and is bit for bit train_state_to_jax of the same
    state in one process."""
    from vitax_torch.checkpoint.consolidate import consolidate
    from vitax_torch.checkpoint.convert import train_state_to_jax
    flat = consolidate(os.path.join(runs["root"], "ckpt_pp"), 2, str(tmp_path / "pp.npz"), params_only=False)
    s = _merged_state([r["train"]["state"] for r in runs["ranks"]])
    want = train_state_to_jax(s["params"], s["mu"], s["nu"], s["step"], s["count"])
    assert sorted(flat) == sorted(want)
    assert all(torch.equal(torch.as_tensor(np.asarray(flat[k])), torch.as_tensor(want[k])) for k in want)


# --- the config and the lone process ----------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(pp_size=2, tp_size=2), "item 11"), (dict(pp_size=3), "--num_blocks 4 not divisible by --pp_size 3"),
    (dict(pp_size=2, pp_schedule="zigzag"), "unknown pp_schedule"),
    (dict(pp_size=2, pp_microbatches=-1), "--pp_microbatches must be >= 0")])
def test_config_refuses_what_pp_cannot_run(kw, match):
    """pp beside tp waits for item 11 (vitax's cases are xfail); the rest
    are vitax's refusals (tests/test_torch_mesh.py holds their messages)."""
    with pytest.raises(ValueError, match=match):
        Config(**{**TINY, **kw}).validate()
    Config(**TINY, pp_size=2).validate()


def test_a_lone_process_refuses_pp():
    """--pp_size 2 without a process group: the one process would hold
    every stage, so train() refuses before building anything."""
    from vitax_torch.train.loop import train
    with pytest.raises(ValueError, match="--pp_size 2 splits the blocks over 2 processes"):
        train(Config(**TINY, pp_size=2, fake_data=True, max_steps=1), "cpu")


def test_pp_flags_parse_as_in_jax():
    """--pp_microbatches and --pp_schedule take vitax's names, defaults and
    choices."""
    from vitax.config import build_parser as jax_build_parser

    from vitax_torch.config import build_parser
    argv = ["--pp_size", "2", "--pp_microbatches", "4", "--pp_schedule", "1f1b"]
    for ns in (build_parser().parse_args(argv), jax_build_parser().parse_args(argv)):
        assert (ns.pp_size, ns.pp_microbatches, ns.pp_schedule) == (2, 4, "1f1b")
    ours, theirs = build_parser().parse_args([]), jax_build_parser().parse_args([])
    assert (ours.pp_microbatches, ours.pp_schedule) == (theirs.pp_microbatches, theirs.pp_schedule)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--pp_schedule", "zigzag"])
