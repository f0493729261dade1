"""vitax_torch trained tensor-parallel (--tp_size, vitax's Megatron column
and row placements under FSDP2, whole heads on each rank) on four CPU
processes (gloo), held to the JAX package's training on a 4-device mesh.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py): the model (D 64, 4 heads, 2 blocks, f32) at
(fsdp 2, tp 2) ZeRO-3, at (dp 2, tp 2) under --run_without_fsdp, and at
(tp 2, sp 2) with the ring under att_dropout 0.1 (vitax's dense block
products with the hash masks, its per-block seeds captured), the first
step's grads of each captured. It exports vitax's init as npz, runs the
port's one-process references, then spawns ONE 4-rank gloo group
(torch.multiprocessing.spawn, init_method file://) that runs every arm for
3 steps on one seeded numpy global batch, (fsdp 2, tp 2) under ZeRO-2
and under dots_attn_saveable, the port's tp 4 under
mlp/proj/pos dropout, the qkv relayout against slicing, eval counts, and
train() under (fsdp 2, tp 2) with checkpoints, a resume and a restore at
tp 1. The tests read what the ranks wrote:

- every arm's losses, grad norms and first-step grads equal vitax's
  (rtol 2e-4), the ring's attention masks vitax's (its captured seeds,
  folded over (batch, tp) as vitax's shard_map folds them);
- replicated leaves stay bitwise equal across the tp ranks;
- the tp run under mlp/proj/pos dropout trains the port's tp-1 losses;
- eval counts under tp equal one process's;
- the tp-2 checkpoint resumes bitwise, restores at tp 1 and in one
  process bitwise, and its full-state npz export is the one-process
  export bit for bit.
The ranks also run the tp Block over groups of 2 and 4 against the whole
Block (the stages the card's phase 7p runs); alone, the config's tp
refusals.
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

TINY = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4, num_blocks=2, num_classes=10,
            batch_size=8, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0, dtype="float32")
STEPS, MAX_ITER, RATE, WORLD = 3, 10, 0.1, 4
ARMS = {"fsdp2_tp2": dict(fsdp_size=2, tp_size=2),
        "dp2_tp2": dict(dp_size=2, tp_size=2, run_without_fsdp=True),
        "tp2_sp2_ring_drop": dict(fsdp_size=1, tp_size=2, sp_size=2, att_dropout=RATE)}
# port-only arms: (base arm whose vitax losses they must train, extra flags),
# each the base arm's losses bitwise (no change of arithmetic)
PORT_ARMS = {"fsdp2_tp2_zero2": ("fsdp2_tp2", dict(reshard_after_forward=False)),
             "fsdp2_tp2_dots_attn": ("fsdp2_tp2", dict(remat_policy="dots_attn_saveable"))}
# the port at tp 4 under the dropouts whose generators tp does not fold,
# against the port's one process (tp 1) at the same flags
GEN_DROP = dict(mlp_dropout=RATE, pos_dropout=RATE)
TRAIN_RUN = dict(fake_data=True, num_epochs=2, steps_per_epoch=1, eval_max_batches=1, test_epoch_interval=1,
                 log_step_interval=1, num_workers=1, ckpt_epoch_interval=1, fsdp_size=2, tp_size=2)


def _batch():
    rng = np.random.default_rng(17)
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


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _gathered(state: TrainState) -> dict:
    """params, mu, nu whole (a collective), count and step."""
    return {"params": {n: _whole(p) for n, p in state.model.named_parameters()},
            "mu": {n: _whole(v) for n, v in state.mu.items()}, "nu": {n: _whole(v) for n, v in state.nu.items()},
            "count": int(state.count), "step": state.step}


def _sharded_state(cfg, mesh, sd) -> TrainState:
    """The model built on meta with the mesh's core, token and tensor
    shards, apply_fsdp, the whole tensors of `sd` cut to the rank's shards."""
    from vitax_torch.parallel.mesh import tensor_shard, token_shard
    from vitax_torch.parallel.sharding import apply_fsdp, local_shard
    model = build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu", mesh),
                        token_shard=token_shard(cfg, mesh), tensor_shard=tensor_shard(mesh))
    model = apply_fsdp(model, cfg, mesh)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            local(p).copy_(local_shard(sd[name], p))
    return make_train_state(model.train())


def _steps(cfg, state, batch, mesh) -> dict:
    """STEPS train steps: losses, grad norms, the first step's grads whole."""
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    train_step = make_train_step(cfg, optimizer, "cpu", mesh)
    losses, norms, grads = [], [], None
    for _ in range(STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:
            grads = {n: _whole(p.grad) for n, p in state.model.named_parameters()}
    return {"losses": losses, "norms": norms, "grads": grads}


def _run_arm(arm: dict, sd, images, labels, seeds=None) -> dict:
    """3 steps of one arm on this rank, then an eval of the global batch:
    losses, grad norms, first-step grads, the rank's shards and
    coordinates, its replicated leaves' local tensors, the summed counts
    and the params whole."""
    import vitax_torch.train.step as step_module
    from vitax_torch import distributed
    from vitax_torch.models.vit import DropoutSeeds
    from vitax_torch.parallel.mesh import MESH_DIMS, batch_shard, build_mesh, data_shard
    from vitax_torch.parallel.rules import tp_dim
    cfg = Config(**{**TINY, **arm}).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    b, count = batch_shard(mesh)
    rows = slice(b * 8 // count, (b + 1) * 8 // count)
    state = _sharded_state(cfg, mesh, sd)
    own = step_module.dropout_seeds
    if seeds is not None:                       # vitax's captured per-block seeds in place of the port's
        step_module.dropout_seeds = lambda cfg_, step, k: DropoutSeeds(blocks=tuple(int(s) for s in seeds[step]))
    batch = {"image": torch.from_numpy(images[rows]), "label": torch.from_numpy(labels[rows])}
    try:
        out = _steps(cfg, state, batch, mesh)
    finally:
        step_module.dropout_seeds = own
    counts = make_eval_step(cfg, mesh)(state, batch)
    out.update(shard=(b, count), data_shard=data_shard(cfg), coord=dict(zip(MESH_DIMS, mesh.get_coordinate())),
               replicated={n: local(p).detach().clone() for n, p in state.model.named_parameters()
                           if tp_dim(n, p.dim()) is None},
               counts={k: int(distributed.all_reduce_sum(v.float())) for k, v in counts.items()},
               params={n: _whole(p) for n, p in state.model.named_parameters()},
               core=getattr(state.model.blocks[0].attn.attention_impl, "vitax_name", None))
    return out


def _relayout(group, count: int, index: int) -> dict:
    """The relayout Function over a tp group of `count` against slicing the
    whole qkv rows: the rank's head rows exactly, and its backward the
    whole grad's rows of the rank's contiguous shard exactly."""
    from vitax_torch.parallel import tensor_parallel as tpm
    g = torch.Generator().manual_seed(5)
    whole = torch.randn(3 * 64, 65, generator=g)
    heads_grad = [torch.randn(3 * 64 // count, 65, generator=g) for _ in range(count)]
    local_rows = whole.chunk(count)[index].clone().requires_grad_(True)
    rows = 3 * 64
    out = tpm._Relayout.apply(local_rows, group, tpm.relayout_plan(rows, count, index))
    full_grad = torch.empty_like(whole)
    for t in range(count):
        full_grad[tpm.head_rows(rows, count, t)] = heads_grad[t]
    out.backward(heads_grad[index])
    return {"forward": torch.equal(out, whole[tpm.head_rows(rows, count, index)]),
            "backward": torch.equal(local_rows.grad, full_grad.chunk(count)[index])}


def _tp_block(group, count: int, index: int) -> dict:
    """Block with a TensorShard over `group` (rank `index` of `count`)
    against the whole Block on the same float64 input, at rate 0 and RATE:
    the largest |d| of the output, of the input's grad and of each leaf's
    grad (a Megatron leaf's against its piece of the whole grad)."""
    from torch import nn

    from vitax_torch.models.vit import Block
    from vitax_torch.ops.attention import flash4_dropout, flash_attention, fold_shard_seed
    from vitax_torch.parallel import tensor_parallel as tpm
    from vitax_torch.parallel.mesh import TensorShard
    d, h, seed = 32, 4, 1234
    hl, scale = h // count, (d // h) ** -0.5
    out = {}
    for rate in (0.0, RATE):
        def core(q, k, v):
            return flash_attention(q, k, v)

        def whole_core(q, k, v):
            return flash_attention(q, k, v)
        core.vitax_dropout = lambda q, k, v, s, rate=rate: flash4_dropout(q, k, v, s, scale, rate)
        whole_core.vitax_dropout = lambda q, k, v, s, rate=rate: torch.cat(
            [flash4_dropout(*(x[:, :, t * hl:(t + 1) * hl] for x in (q, k, v)), fold_shard_seed(t, s), scale, rate)
             for t in range(count)], dim=2)
        torch.manual_seed(0)
        whole = Block(d, h, 4.0, torch.float64, whole_core, att_dropout=rate).double()
        for p in whole.parameters():
            torch.nn.init.normal_(p, std=0.3)
        x = torch.randn(2, 8, d, dtype=torch.float64, requires_grad=True)
        y = whole(x, seed if rate else None)
        dy = torch.randn_like(y)
        ref = dict(zip(["x", *dict(whole.named_parameters())], torch.autograd.grad(y, [x, *whole.parameters()], dy)))
        part = Block(d, h, 4.0, torch.float64, core, device="meta", att_dropout=rate,
                     tensor_shard=TensorShard(index, count, group))
        whole_params = dict(whole.named_parameters())
        for name, _ in list(part.named_parameters()):       # the rank's pieces, as shard_tp cuts them
            module, leaf = part.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
            setattr(module, leaf, nn.Parameter(tpm.tp_local(name, whole_params[name].detach(), count, index).clone()))
        x2 = x.detach().clone().requires_grad_(True)
        y2 = part(x2, fold_shard_seed(index, seed) if rate else None)
        names = [n for n, _ in part.named_parameters()]
        got = dict(zip(["x", *names], torch.autograd.grad(y2, [x2, *part.parameters()], dy)))
        errs = {"out": float((y2 - y).abs().max()), "x": float((got["x"] - ref["x"]).abs().max())}
        errs.update({n: float((got[n] - tpm.tp_local(n, ref[n], count, index)).abs().max()) for n in names})
        out[rate] = errs
    return out


def _worker(rank: int, root: str) -> None:
    """One rank of the 4-rank gloo group: every arm, results to
    root/rank<r>.pt."""
    import torch.distributed as dist
    from vitax_torch.parallel import tensor_parallel as tpm
    from vitax_torch.parallel.mesh import build_mesh, tensor_shard
    from vitax_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=WORLD)
    data = np.load(os.path.join(root, "inputs.npz"))
    images, labels = data["images"], data["labels"]
    sd = params_from_jax({k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")})
    out = {}
    for name, arm in ARMS.items():
        seeds = data[f"seeds/{name}"] if arm.get("att_dropout") else None
        tpm.reset_calls()
        out[name] = _run_arm(arm, sd, images, labels, seeds)
        out[name]["calls"] = dict(tpm.CALLS)
    for name, (base, extra) in PORT_ARMS.items():
        out[name] = _run_arm({**ARMS[base], **extra}, sd, images, labels)
    out["tp4_gen_drop"] = _run_arm(dict(fsdp_size=1, tp_size=4, **GEN_DROP), sd, images, labels)
    mesh = build_mesh(Config(**TINY, fsdp_size=2, tp_size=2).validate(), torch.device("cpu"))
    shard = tensor_shard(mesh)
    out["relayout"] = {2: _relayout(shard.group, 2, shard.index), 4: _relayout(dist.group.WORLD, 4, rank)}
    out["block"] = {2: _tp_block(shard.group, 2, shard.index), 4: _tp_block(dist.group.WORLD, 4, rank)}

    # train() under (fsdp 2, tp 2): two epochs saved, then a resume of the second
    ckpt = os.path.join(root, "ckpt_tp")
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=ckpt), "cpu", records=records)
    out["train"] = {"records": records, "state": _gathered(state)}
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=ckpt, resume_epoch=1), "cpu")
    out["resumed"] = _gathered(state)
    # the tp-2 checkpoint restored into a tp-1 group: (fsdp 4)
    cfg = Config(**TINY, fsdp_size=4).validate()
    target = _sharded_state(cfg, build_mesh(cfg, torch.device("cpu")), sd)
    out["at_tp1"] = _gathered(ckpt_io.restore_state(ckpt, 2, target))
    ckpt_io.close()
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def _one_process(cfg: Config, sd, images, labels) -> dict:
    """The port unwrapped in this process: 3 steps from `sd`."""
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(sd, strict=True, assign=True)
    state = make_train_state(model.train())
    return _steps(cfg, state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}, None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("tp"))
    images, labels = _batch()
    jax_out, saved = {}, {}
    for name, arm in ARMS.items():
        init, losses, norms, grads, seeds = _jax_run(arm, images, labels)
        jax_out[name] = {"losses": losses, "norms": norms, "grads": params_from_jax(grads)}
        if arm.get("att_dropout"):
            saved[f"seeds/{name}"] = np.asarray(seeds, np.int64)
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels, **saved,
             **{f"init/{k}": v for k, v in init.items()})
    sd = params_from_jax(init)
    single = _one_process(Config(**TINY, **GEN_DROP).validate(), sd, images, labels)
    mp.spawn(_worker, args=(root,), nprocs=WORLD, join=True)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(jax=jax_out, ranks=ranks, root=root, single=single, images=images, labels=labels)


@pytest.mark.parametrize("arm", list(ARMS) + list(PORT_ARMS))
def test_losses_and_grads_match_jax_on_four_devices(runs, arm):
    """Each arm on 4 ranks against vitax's same arm on 4 devices: losses
    and grad norms at rtol 2e-4, and every leaf of the first step's grads
    within rtol 2e-4 of vitax's (atol 1e-4 of the leaf's largest grad).
    The norm catches a tp leaf counted once instead of summed over the tp
    group, the grads a partial left unreduced or a head relaid wrongly;
    the ring arm runs vitax's captured seeds, so its attention masks are
    vitax's (a fold over another index, or the kernel seeing global head
    indices, lands far off). Every rank logs the same loss; ZeRO-2 and
    dots_attn_saveable (the core outside the recomputed regions) train
    their base arm's losses bitwise."""
    base = PORT_ARMS[arm][0] if arm in PORT_ARMS else arm
    want = runs["jax"][base]
    r0 = runs["ranks"][0][arm]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=2e-4)
    for name, g in want["grads"].items():
        ours = r0["grads"][name].numpy()
        np.testing.assert_allclose(ours, g.numpy(), rtol=2e-4, atol=1e-4 * float(g.abs().max()), err_msg=name)
    assert all(r[arm]["losses"] == r0["losses"] and r[arm]["norms"] == r0["norms"] for r in runs["ranks"])
    if arm in PORT_ARMS:
        assert r0["losses"] == runs["ranks"][0][base]["losses"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_rank_reads_its_batch_shard_and_counts_its_collectives(runs, arm):
    """Rank r sits at vitax's device r of the (dp, fsdp, tp, sp) mesh; the
    tp and sp ranks of one batch shard read the same rows, from the mesh
    and from the process group alone (data_shard); a block forward issues
    one relayout and two all-reduces, its backward one inverse relayout
    and two all-reduces. A step runs each block's forward, its recompute
    and its backward; the recompute redoes the relayout and the attention's
    all-reduce but stops before fc2's (torch's non-reentrant checkpoint
    stops once the saved tensors are rebuilt). The eval adds a forward."""
    dims = ("dp", "fsdp", "tp", "sp", "pp", "ep")
    arm_cfg = Config(**{**TINY, **ARMS[arm]})
    from vitax_torch.parallel.mesh import mesh_sizes, rank_coordinates
    sizes = mesh_sizes(arm_cfg, WORLD)
    for rank, r in enumerate(runs["ranks"]):
        a = r[arm]
        assert tuple(a["coord"][d] for d in dims) == rank_coordinates(rank, sizes)
        c = a["coord"]
        want = c["dp"] * sizes[1] + c["fsdp"]
        assert a["shard"] == a["data_shard"] == (want, sizes[0] * sizes[1])
        blocks = TINY["num_blocks"]
        assert a["calls"] == {"relayout": (2 * STEPS + 1) * blocks, "all_reduce": (3 * STEPS + 2) * blocks,
                              "relayout_bwd": STEPS * blocks, "all_reduce_bwd": 2 * STEPS * blocks}
    if "sp_size" in ARMS[arm]:
        assert runs["ranks"][0][arm]["core"] == "ring attention (sp)"


@pytest.mark.parametrize("arm", list(ARMS) + ["tp4_gen_drop"])
def test_replicated_leaves_stay_equal_across_tp_ranks(runs, arm):
    """After 3 steps every leaf outside the Megatron four (norms, biases of
    proj and fc2, the embeddings, the head) is bitwise the same on the tp
    ranks of one (dp, fsdp, sp) coordinate: they compute it alike and take
    no tp reduction."""
    by_place = {}
    for r in runs["ranks"]:
        a = r[arm]
        key = tuple(v for d, v in a["coord"].items() if d != "tp")
        by_place.setdefault(key, []).append(a["replicated"])
    assert all(len(v) > 1 for v in by_place.values())
    for group in by_place.values():
        for other in group[1:]:
            assert all(torch.equal(group[0][n], other[n]) for n in group[0])


def test_tp_under_generator_dropouts_trains_the_one_process_losses(runs):
    """mlp, proj and pos dropout at 0.1 (their generators never fold the
    tp index, and the dropout after GELU keeps the rank's slice of the
    whole-width mask): tp 4 trains the losses, norms and grads of the
    port's one process at the same flags (rtol 2e-4), and they moved off
    the rate-0 run."""
    r0 = runs["ranks"][0]["tp4_gen_drop"]
    want = runs["single"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(r0["norms"], want["norms"], rtol=2e-4)
    for name, g in want["grads"].items():
        np.testing.assert_allclose(r0["grads"][name].numpy(), g.numpy(), rtol=2e-4,
                                   atol=1e-4 * float(g.abs().max()), err_msg=name)
    assert np.all(np.abs(np.subtract(want["losses"], runs["jax"]["fsdp2_tp2"]["losses"])) > 2e-5)


@pytest.mark.parametrize("arm", list(ARMS) + ["tp4_gen_drop"])
def test_eval_counts_under_tp_equal_one_process(runs, arm):
    """make_eval_step under tp: only tp (and sp) index 0 counts, so the sum
    over every process equals one process's counts on the arm's final
    params over the global batch."""
    r0 = runs["ranks"][0][arm]
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(r0["params"], strict=True, assign=True)
    batch = {"image": torch.from_numpy(runs["images"]), "label": torch.from_numpy(runs["labels"])}
    want = {k: int(v) for k, v in make_eval_step(cfg)(make_train_state(model.eval()), batch).items()}
    assert want["correct_top5"] > 0
    assert all(r[arm]["counts"] == want for r in runs["ranks"])


@pytest.mark.parametrize("count", [2, 4])
def test_relayout_function_equals_slicing_the_whole_qkv(runs, count):
    """The uneven all-to-all of the qkv rows over a tp group of 2 and of 4:
    each rank's output is exactly the whole rows of its heads (q, k, v of
    heads [i H/T, (i + 1) H/T)), and its backward exactly the whole grad's
    rows of the rank's contiguous shard."""
    for r in runs["ranks"]:
        assert r["relayout"][count] == {"forward": True, "backward": True}


def _whole_state(state: TrainState) -> dict:
    return {"params": {n: p.detach() for n, p in state.model.named_parameters()}, "mu": state.mu, "nu": state.nu,
            "count": int(state.count), "step": state.step}


def _equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and all(torch.equal(a[g][k], b[g][k]) for g in ("params", "mu", "nu") for k in a["params"]))


def test_tp_checkpoint_resumes_and_restores_at_tp1_and_in_one_process(runs):
    """train() under (fsdp 2, tp 2), two epochs with a save each: every rank
    logs the same losses; --resume_epoch 1 trains the second epoch again
    to the same state bitwise; the epoch-2 checkpoint holds the Megatron
    leaves at their global shapes and restores bitwise into a tp-1 group
    (fsdp 4) and into one unwrapped process."""
    from vitax_torch.checkpoint.convert import train_state_to_jax
    recs = [[x["loss"] for x in r["train"]["records"] if "loss" in x] for r in runs["ranks"]]
    assert all(x == recs[0] for x in recs) and len(recs[0]) == 2 and all(np.isfinite(recs[0]))
    want = runs["ranks"][0]["train"]["state"]
    for r in runs["ranks"]:
        assert _equal(r["resumed"], want) and _equal(r["at_tp1"], want)
    ckpt = os.path.join(runs["root"], "ckpt_tp")
    meta = ckpt_io.read_state(ckpt, 2, groups=("model",))["model"]
    assert tuple(meta["blocks.0.attn.qkv.bias"].shape) == (192,)
    assert tuple(meta["blocks.0.mlp.fc2.weight"].shape) == (64, 256)
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(ckpt, 2, make_train_state(model))
    assert _equal(_whole_state(state), want)


def test_tp_checkpoint_exports_the_one_process_npz(runs, tmp_path):
    """consolidate's full-state npz export of the tp-2 checkpoint is bit for
    bit train_state_to_jax of the same state in one process."""
    from vitax_torch.checkpoint.consolidate import consolidate
    from vitax_torch.checkpoint.convert import train_state_to_jax
    flat = consolidate(os.path.join(runs["root"], "ckpt_tp"), 2, str(tmp_path / "tp.npz"), params_only=False)
    s = runs["ranks"][0]["train"]["state"]
    want = train_state_to_jax(s["params"], s["mu"], s["nu"], s["step"], s["count"])
    assert sorted(flat) == sorted(want)
    assert all(torch.equal(torch.as_tensor(np.asarray(flat[k])), torch.as_tensor(want[k])) for k in want)


# --- the tp Block over its group, and the config ----------------------------

@pytest.mark.parametrize("count,rate", [(2, 0.0), (4, 0.0), (2, RATE), (4, RATE)])
def test_tp_block_over_its_group_equals_the_whole_block(runs, count, rate):
    """models/vit.py's Block with a TensorShard over a gloo tp group of 2 and
    of 4 (the relayout, the core on the rank's heads, the row-parallel
    partials all-reduced before the replicated biases), the stages the
    card's phase 7p runs at the 10B width: on every rank the output and the
    input's and every leaf's grads are within 1e-10 of the whole Block's on
    the same float64 input (a Megatron leaf's grad against the whole grad's
    piece). Under att_dropout each rank's seed is folded over its tp index
    and the whole Block's core runs each head group's dropout core at that
    seed."""
    for r in runs["ranks"]:
        errs = r["block"][count][rate]
        assert max(errs.values()) <= 1e-10, errs


@pytest.mark.parametrize("kw,match", [
    (dict(tp_size=3), r"^TP: dim 0 of \('params', 'blocks_0', 'attn', 'proj', 'kernel'\) \(64, 64\) not divisible "
                      r"by tp=3$"),
    (dict(tp_size=8), "--num_heads 4 not divisible by --tp_size 8"),
    (dict(tp_size=2, moe_experts=4, sp_size=2, ep_size=2), "item 11"), (dict(tp_size=2, pp_size=2), "item 11")])
def test_config_refuses_what_tp_cannot_run(kw, match):
    """D or the MLP hidden indivisible by tp: vitax's assertion message (its
    rule_pspec on the proj kernel first); heads indivisible: each rank runs
    whole heads; tp beside pp, or beside MoE under sp with ep > 1, has no
    green reference in vitax (item 11). tp 2 validates, and so does tp
    beside MoE, with ep 2 too."""
    with pytest.raises(ValueError, match=match):
        Config(**{**TINY, **kw}).validate()
    Config(**TINY, tp_size=2).validate()
    Config(**TINY, tp_size=2, moe_experts=4).validate()
    Config(**TINY, tp_size=2, ep_size=2, moe_experts=4).validate()
    if kw.get("tp_size") == 3:
        import jax
        from vitax.config import Config as JaxConfig
        from vitax.models import build_model as jax_build_model
        from vitax.parallel.mesh import build_mesh as jax_build_mesh
        from vitax.parallel.sharding import param_specs
        jcfg = JaxConfig(**{**TINY, **kw}, scan_blocks=False)
        model = jax_build_model(jcfg)
        abstract = jax.eval_shape(lambda r: model.init(r, np.zeros((1, 32, 32, 3), np.float32), True),
                                  jax.random.key(0))
        with pytest.raises(AssertionError, match=match):
            param_specs(abstract, jcfg, jax_build_mesh(jcfg, devices=jax.devices()[:3]))


@pytest.mark.parametrize("world,match", [
    (8, "--num_heads 4 not divisible by --tp_size 8"),
    (3, r"^TP: dim 0 of \('params', 'blocks_0', 'attn', 'proj', 'kernel'\) \(64, 64\) not divisible by tp=3$")])
def test_tp_size_minus_one_is_held_to_the_checks_of_its_resolved_size(world, match):
    """--tp_size -1 validates (its size is the world's), and the mesh's
    sizes (parallel/mesh.py mesh_sizes) refuse the size it resolves to with
    the messages Config.validate gives a stated one; a size that divides
    resolves."""
    cfg = Config(**TINY, fsdp_size=1, tp_size=-1).validate()
    from vitax_torch.parallel.mesh import mesh_sizes
    with pytest.raises(ValueError, match=match):
        mesh_sizes(cfg, world)
    assert mesh_sizes(cfg, 4) == (1, 1, 4, 1, 1, 1)
