"""vitax_torch trained sequence-parallel (--sp_size, ring and Ulysses
attention over the token axis) on four CPU processes (gloo), held to the
JAX package's training on a 4-device mesh.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py, vitax's dense block products as
tests/test_ring_attention.py's sp_cfg runs them): the ring and Ulysses at
(fsdp 1, sp 4), and both at (fsdp 2, sp 2) under att_dropout 0.1 with
their per-block seeds captured, the grads of each arm's first step
captured too. It exports vitax's init as
npz, then spawns ONE 4-rank gloo group (torch.multiprocessing.spawn,
init_method file://) that runs every arm of the port at depth 2, D 64, 4
heads, N 16, 3 steps on one seeded numpy global batch, batch shard b on
rows [b B/F, (b + 1) B/F) as vitax's devices hold them, plus the ring
under dropout with dots_attn_saveable (its core outside the recompute),
the ring with 2 microbatches, both under dots_saveable, Ulysses with
explicit gather prefetch, the rotation count of a ring forward, and train()
under sp with a checkpoint. The tests below read what the ranks wrote:

- every arm's losses and grad norms equal vitax's (rtol 2e-4, the bar of
  tests/test_train_smoke.py:99), and so do the grads of the first step;
- a ring forward issues exactly S - 1 rotations on every rank;
- train() under (fsdp 2, sp 2) saves a checkpoint that one process
  restores bitwise, and a one-process save restores bitwise into the
  group.
Alone, without a group: the loop-back ring (the same body over S virtual
shards) against whole attention, with and without dropout, on the
whole-N and the streaming block products; the config's refusals of pp and
tp beside MoE, and --sp_impl's choices.
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

TINY = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4, num_blocks=2, num_classes=10,
            batch_size=8, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32")
STEPS, MAX_ITER, RATE, WORLD = 3, 10, 0.1, 4
# (fsdp, sp, sp_impl) of each arm: the ring and Ulysses at sp 4, and both
# at (fsdp 2, sp 2) under att_dropout 0.1, where the seed folds the batch
# shard (the ring) or the linearized (batch, sp) index (Ulysses)
ARMS = {"ring_sp4": dict(fsdp_size=1, sp_size=4),
        "ulysses_sp4": dict(fsdp_size=1, sp_size=4, sp_impl="ulysses"),
        "ring_drop": dict(fsdp_size=2, sp_size=2, att_dropout=RATE),
        "ulysses_drop": dict(fsdp_size=2, sp_size=2, sp_impl="ulysses", att_dropout=RATE)}
# port-only arms: (base arm whose vitax losses they must train, extra flags)
PORT_ARMS = {"ring_dots_attn": ("ring_drop", dict(remat_policy="dots_attn_saveable")),
             "ring_accum2": ("ring_sp4", dict(grad_accum_steps=2)),
             "ring_dots": ("ring_sp4", dict(remat_policy="dots_saveable")),
             "ulysses_dots": ("ulysses_sp4", dict(remat_policy="dots_saveable")),
             "ulysses_overlap": ("ulysses_drop", dict(gather_overlap="on"))}
# no change of arithmetic: their base arm's losses exactly
BITWISE_ARMS = ("ring_dots_attn", "ring_dots", "ulysses_dots", "ulysses_overlap")
TRAIN_RUN = dict(fake_data=True, num_epochs=1, steps_per_epoch=2, eval_max_batches=1, test_epoch_interval=1,
                 log_step_interval=1, num_workers=1, fsdp_size=2, sp_size=2)


def _batch():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _jax_run(arm: dict, images, labels):
    """vitax on 4 devices: (init params flat, losses, grad norms, the first
    step's grads flat, the per-block dropout seeds of each step)."""
    import jax
    import jax.numpy as jnp
    import vitax.train.step as jax_step
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    from vitax.parallel.mesh import build_mesh
    from vitax.train.loop import _token_sharding
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    cfg = JaxConfig(**{**TINY, **arm}, scan_blocks=False, grad_ckpt=False).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:WORLD])
    impl = jax_make_attention_impl(cfg, mesh)
    captured, grads = [], []
    if cfg.att_dropout > 0:
        inner = impl.vitax_dropout

        def drop(q, k, v, seed):                # the global seed, before the shard_map fold
            jax.debug.callback(lambda s, _: captured.append(int(s)), seed, jnp.sum(q))
            return inner(q, k, v, seed)
        impl.vitax_dropout = drop
    make_update = jax_step._make_update_fn

    def capturing(*a, **kw):                    # the grads the optimizer is handed
        update = make_update(*a, **kw)

        def wrapped(g, opt_state, params):
            jax.debug.callback(lambda t: grads.append(jax.tree.map(np.asarray, t)), g)
            return update(g, opt_state, params)
        return wrapped
    jax_step._make_update_fn = capturing
    try:
        model = jax_build_model(cfg, attention_impl=impl, token_sharding=_token_sharding(cfg, mesh))
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
        seeds.append(list(dict.fromkeys(captured)))     # one seed a block
    return init, losses, norms, flatten_tree(grads[0]), seeds


def _sharded_state(cfg, mesh, sd) -> TrainState:
    """The model built on meta with the mesh's attention core and token
    shard, apply_fsdp, the whole tensors of `sd` cut to the rank's shards."""
    from vitax_torch.parallel.mesh import token_shard
    from vitax_torch.parallel.sharding import apply_fsdp, local_shard
    model = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu", mesh),
                        token_shard=token_shard(cfg, mesh))
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


def _run_arm(arm: dict, sd, images, labels, seeds=None) -> dict:
    """3 steps of one arm on this rank: losses, grad norms, the first
    step's grads (whole) and the model's attention core name."""
    import vitax_torch.train.step as step_module
    from vitax_torch.models.vit import DropoutSeeds
    from vitax_torch.parallel.mesh import batch_shard, build_mesh
    cfg = Config(**{**TINY, **arm}).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    b, count = batch_shard(mesh)
    rows = slice(b * 8 // count, (b + 1) * 8 // count)
    state = _sharded_state(cfg, mesh, sd)
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    own = step_module.dropout_seeds
    if seeds is not None:                       # vitax's captured per-block seeds in place of the port's
        step_module.dropout_seeds = lambda cfg_, step, k: DropoutSeeds(blocks=tuple(int(s) for s in seeds[step]))
    batch = {"image": torch.from_numpy(images[rows]), "label": torch.from_numpy(labels[rows])}
    losses, norms, grads = [], [], None
    try:
        train_step = make_train_step(cfg, optimizer, "cpu", mesh)
        for _ in range(STEPS):
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if grads is None:
                grads = {n: _whole(p.grad) for n, p in state.model.named_parameters()}
    finally:
        step_module.dropout_seeds = own
    core = state.model.blocks[0].attn.attention_impl
    return {"losses": losses, "norms": norms, "grads": grads, "core": getattr(core, "vitax_name", None),
            "shard": (b, count)}


def _rotations(sp: int) -> dict:
    """Rotations one ring forward and its backward issue on this rank,
    over the sp group of a (fsdp 4 / sp, sp) mesh."""
    from vitax_torch.parallel import ring_attention
    from vitax_torch.parallel.mesh import build_mesh
    cfg = Config(**{**TINY, "fsdp_size": WORLD // sp, "sp_size": sp}).validate()
    impl = make_attention_impl(cfg, "cpu", build_mesh(cfg, torch.device("cpu")))
    q, k, v = torch.randn(3, 2, 16 // sp, 4, 16).unbind(0)
    ring_attention.reset_rotations()
    with torch.no_grad():
        impl(q, k, v)
    counts = {"forward": ring_attention.ROTATIONS["forward"]}
    ring_attention.reset_rotations()
    k.requires_grad_(True)
    impl(q, k, v).sum().backward()
    counts["backward"] = ring_attention.ROTATIONS["backward"]
    return counts


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
    sd = params_from_jax({k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")})
    out = {}
    for name, arm in ARMS.items():
        seeds = data[f"seeds/{name}"] if arm.get("att_dropout") else None
        out[name] = _run_arm(arm, sd, images, labels, seeds)
    for name, (base, extra) in PORT_ARMS.items():
        seeds = data[f"seeds/{base}"] if ARMS[base].get("att_dropout") else None
        out[name] = _run_arm({**ARMS[base], **extra}, sd, images, labels, seeds)
    out["rotations"] = {sp: _rotations(sp) for sp in (2, 4)}

    # train() under (fsdp 2, sp 2): a save at its last epoch, then the reverse restore
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=os.path.join(root, "ckpt_sp")), "cpu", records=records)
    out["train"] = {"records": records, "state": _gathered(state)}
    cfg = Config(**TINY, fsdp_size=2, sp_size=2).validate()
    target = _sharded_state(cfg, build_mesh(cfg, torch.device("cpu")), sd)
    target = ckpt_io.restore_state(os.path.join(root, "ckpt1"), 1, target)
    out["reverse"] = _gathered(target)
    ckpt_io.close()
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("sp"))
    images, labels = _batch()
    jax_out, saved = {}, {}
    for name, arm in ARMS.items():
        init, losses, norms, grads, seeds = _jax_run(arm, images, labels)
        jax_out[name] = {"losses": losses, "norms": norms, "grads": params_from_jax(grads)}
        if arm.get("att_dropout"):
            saved[f"seeds/{name}"] = np.asarray(seeds, np.int64)
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels, **saved,
             **{f"init/{k}": v for k, v in init.items()})

    # one process: a state a step past vitax's init, saved for the group to restore
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(init), strict=True, assign=True)
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


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_losses_and_grads_match_jax_on_four_devices(runs, arm):
    """Each arm on 4 ranks against vitax's same arm on 4 devices: losses
    and grad norms at rtol 2e-4, and every leaf of the first step's grads
    within rtol 2e-4 of vitax's (atol 1e-4 of the leaf's largest grad).
    The norms and grads catch what the losses alone would pass: a pool or
    an sp reduce off by a factor of S, or the norm counting an sp replica
    twice. Every rank logs the same loss; the other remat policies and the
    explicit prefetch train their base arm's losses bitwise."""
    base = PORT_ARMS[arm][0] if arm in PORT_ARMS else arm
    want = runs["jax"][base]
    r0 = runs["ranks"][0][arm]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=2e-4)
    for name, g in want["grads"].items():
        ours = r0["grads"][name].numpy()
        np.testing.assert_allclose(ours, g.numpy(), rtol=2e-4, atol=1e-4 * float(g.abs().max()), err_msg=name)
    assert all(r[arm]["losses"] == r0["losses"] and r[arm]["norms"] == r0["norms"] for r in runs["ranks"])
    if arm in BITWISE_ARMS:
        assert r0["losses"] == runs["ranks"][0][base]["losses"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_rank_runs_its_core_on_its_batch_shard(runs, arm):
    """The sp core vitax names for the arm on every rank, and the ranks of
    one sp group on one batch shard: rank r on shard r // sp."""
    sp, impl = ARMS[arm]["sp_size"], ARMS[arm].get("sp_impl", "ring")
    name = "ring attention (sp)" if impl == "ring" else "ulysses all-to-all (sp)"
    for rank, r in enumerate(runs["ranks"]):
        assert r[arm]["core"] == name
        assert r[arm]["shard"] == (rank // sp, WORLD // sp)


def test_dropout_moves_the_losses_as_vitax_does(runs):
    """att_dropout 0.1 from vitax's captured seeds: the move off the rate-0
    losses (which do not depend on the mesh) is vitax's (rtol 0.1 of it; a
    rank with another's masks, or the ring's offsets wrong, lands far off),
    for the ring and for Ulysses."""
    r0 = runs["ranks"][0]
    for drop, base in (("ring_drop", "ring_sp4"), ("ulysses_drop", "ulysses_sp4")):
        theirs = np.subtract(runs["jax"][drop]["losses"], runs["jax"][base]["losses"])
        ours = np.subtract(r0[drop]["losses"], r0[base]["losses"])
        assert np.all(np.abs(theirs[1:]) > 2e-5)
        np.testing.assert_allclose(ours[1:], theirs[1:], rtol=0.1)


def test_ring_forward_issues_sp_minus_one_rotations(runs):
    """K and V ride one buffer and the last block computes without a
    shift: S - 1 rotations a forward on every rank, at sp 2 and 4 (vitax's
    test_ring_issues_exactly_sp_minus_one_permutes), and as many reverse
    shifts in its backward."""
    for r in runs["ranks"]:
        assert r["rotations"] == {sp: {"forward": sp - 1, "backward": sp - 1} for sp in (2, 4)}


def test_sp_save_restores_in_one_process(runs):
    """train() under (fsdp 2, sp 2): every rank logs the same losses and
    top-1, and its checkpoint (each replicated shard written once) restores
    bitwise into one unwrapped process."""
    recs = [[x["loss"] for x in r["train"]["records"] if "loss" in x] for r in runs["ranks"]]
    assert all(x == recs[0] for x in recs) and len(recs[0]) == 2 and all(np.isfinite(recs[0]))
    for r in runs["ranks"]:
        assert [x["top1"] for x in r["train"]["records"] if "top1" in x] == [1.0]
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(os.path.join(runs["root"], "ckpt_sp"), 1, make_train_state(model))
    assert _equal(_whole_state(state), runs["ranks"][0]["train"]["state"])


def test_one_process_save_restores_into_the_sp_group(runs):
    """A one-process checkpoint restored into the (fsdp 2, sp 2) sharded
    state: gathered, bitwise the saved state on every rank."""
    want = _whole_state(runs["single"])
    for r in runs["ranks"]:
        assert _equal(r["reverse"], want)


def _qkv(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True) for _ in range(3)]


@pytest.mark.parametrize("sp,block,rate", [(2, "whole-N", 0.0), (4, "whole-N", 0.0), (4, "whole-N", RATE),
                                           (4, "streaming", 0.0), (4, "streaming", RATE), (4, "dense", RATE)])
def test_loop_back_ring_equals_whole_attention(sp, block, rate):
    """The ring body over sp virtual shards in one process (LoopBack, the
    card's phase 7r) against whole attention on the same float64 inputs:
    o and dq, dk, dv within 1e-10, on the whole-N block product, on the
    streaming one at 8 x 8 tiles and on the dense one (--no_flash_attention),
    and at rate 0.1 against whole attention under the same hash mask
    (every (q, k) pair decided once, at global coordinates). Each shard
    shifts S - 1 times."""
    from vitax_torch.ops.attention import Dropout, attention_fwd_with_lse
    from vitax_torch.parallel import ring_attention as ra
    q, k, v = _qkv((2, 64, 2, 8))
    n, seed = 64 // sp, 1234
    blocks = {"whole-N": (ra.kernel_block(n), ra.kernel_block_drop(n)),
              "streaming": (ra.streaming_block(n, 8, 8), ra.streaming_block_drop(n, 8, 8)),
              "dense": (ra.dense_block, ra.dense_block_drop)}
    block = blocks[block][rate > 0]
    ra.reset_rotations()
    o, rots = ra.loop_back_ring(q, k, v, sp, block, seed=seed if rate else None, rate=rate)
    want, _ = attention_fwd_with_lse(q, k, v, 8 ** -0.5, Dropout(seed, rate) if rate else None)
    assert ra.ROTATIONS["forward"] == sp * (sp - 1) and all(r._shifts == sp - 1 for r in rots)
    do = torch.randn(o.shape, dtype=torch.float64)
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = torch.autograd.grad(want, (q, k, v), do)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-10)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kw,match", [(dict(sp_size=2, ep_size=2, moe_experts=4), "item 11"),
                                      (dict(pp_size=2, tp_size=2), "item 11"),
                                      (dict(sp_size=2, pp_size=2, pp_schedule="1f1b"), "ride the gpipe schedule"),
                                      (dict(sp_impl="zigzag"), "unknown sp_impl"),
                                      (dict(sp_size=0), "mesh sizes")])
def test_config_refuses_what_sp_cannot_run(kw, match):
    """pp beside tp, and MoE under sp beside ep > 1, have no green
    reference in vitax and stay refused (item 11, named in the message)
    while MoE under sp alone validates; sp under 1F1B is vitax's refusal
    (sp under pp rides GPipe); --sp_impl takes vitax's values and rejects
    others with vitax's message."""
    if kw.get("moe_experts"):
        Config(**TINY, sp_size=2, moe_experts=4).validate()
    with pytest.raises(ValueError, match=match) as ours:
        Config(**TINY, **kw).validate()
    if "sp_impl" in kw:
        from vitax.config import Config as JaxConfig
        with pytest.raises(AssertionError) as theirs:
            JaxConfig(**TINY, **kw).validate()
        assert str(ours.value) == str(theirs.value)


def test_sp_impl_flag_takes_vitax_choices():
    from vitax_torch.config import build_parser
    ns = build_parser().parse_args(["--sp_size", "2", "--sp_impl", "ulysses"])
    assert (ns.sp_size, ns.sp_impl) == (2, "ulysses")
    assert build_parser().parse_args([]).sp_impl == "ring"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--sp_impl", "zigzag"])
