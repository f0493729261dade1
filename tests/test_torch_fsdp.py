"""vitax_torch trained sharded with FSDP2 on two CPU processes (gloo),
held to the JAX package's training on a 2-device mesh.

One module fixture runs the JAX side in this process (the 8-device CPU
mesh of tests/conftest.py: ZeRO-3, ZeRO-2 and DP on 2 devices, and ZeRO-3
under att_dropout 0.1 through vitax's shard_map dropout kernel in
interpret mode, its per-block seeds captured), exports vitax's init as
npz, then spawns ONE 2-rank gloo group (torch.multiprocessing.spawn,
init_method file://, so no port is contended) that runs every arm of the
port: depth 2, D 64, 4 heads, 3 steps on one seeded numpy global batch,
rank r on its rows [4r, 4r + 4) as vitax's device r holds them. The tests
below read what the ranks wrote:

- ZeRO-3, ZeRO-2 and DP losses equal vitax's (rtol 2e-4, the bar of
  tests/test_train_smoke.py:99) and each other; explicit prefetch
  (--gather_overlap on), dots_attn_saveable and grad_accum_steps 2 train
  the same losses;
- the sharded init is bitwise the unsharded one, drawn on the device or
  on the host (--shard_on_cpu), and every local shard is contiguous;
- att_dropout 0.1: losses within the same tolerance of vitax's fsdp=2
  run, and the two ranks' masks differ;
- grad_reduce_dtype bfloat16 stays within a bf16 tolerance of float32;
- the two ranks' batches interleave into the one-process global batch;
- train() under the group: a 2-rank save restores bitwise in one process,
  and a one-process save restores bitwise into two ranks; with
  --metrics_dir only rank 0 writes the JSONL, and run_start counts 2
  devices;
- the host folds any_across_processes and or_across_processes over the
  ranks' own inputs, and orderly_shutdown returns on both ranks.
At the end, FSDP2 in a one-rank group against the unwrapped model, bitwise:
on the CPU (gloo), and on the card (NCCL; it skips without one).
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
STEPS, MAX_ITER, RATE = 3, 10, 0.1
BF16_RTOL = 2e-3         # a quarter of bf16's epsilon (2^-7)
ARMS = {"zero3": {}, "zero2": dict(reshard_after_forward=False), "dp": dict(run_without_fsdp=True)}
EXTRA_ARMS = {"overlap": dict(gather_overlap="on"), "dots_attn": dict(remat_policy="dots_attn_saveable"),
              "accum2": dict(grad_accum_steps=2)}
TRAIN_RUN = dict(fake_data=True, num_epochs=1, steps_per_epoch=2, eval_max_batches=1, test_epoch_interval=1,
                 log_step_interval=1, num_workers=1)


def _batch():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((TINY["batch_size"], 32, 32, 3)).astype(np.float32),
            rng.integers(0, TINY["num_classes"], size=TINY["batch_size"]))


def _jax_run(arm: dict, images, labels, seeds=None):
    """vitax on 2 devices: (init params as a flat numpy dict, 3 losses, 3
    grad norms); `seeds` collects the per-block dropout seeds of each
    step."""
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import flatten_tree
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    from vitax.train.step import make_train_step as jax_make_train_step
    cfg = JaxConfig(**{**TINY, **arm}, scan_blocks=False).validate()
    mesh = build_mesh(cfg, devices=jax.devices()[:2])
    impl, captured = None, []
    if seeds is not None:
        impl = jax_make_attention_impl(cfg, mesh, force_tpu_kernels=True)
        inner = impl.vitax_dropout

        def drop(q, k, v, seed):                # the global seed, before the shard_map fold
            # q ties each call to its block's place in the forward: callbacks
            # are unordered, and only the data they read orders them
            jax.debug.callback(lambda s, _: captured.append(int(s)), seed, jnp.sum(q))
            return inner(q, k, v, seed)
        impl.vitax_dropout = drop
    model = jax_build_model(cfg, attention_impl=impl)
    tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
    state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
    init = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(state.params)).items()}
    step_fn = jax_make_train_step(cfg, model, tx, mesh, sspecs, schedule=schedule)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    losses, norms = [], []
    for _ in range(STEPS):
        captured.clear()
        state, m = step_fn(state, batch, jax.random.key(1))
        losses.append(float(jax.device_get(m["loss"])))
        norms.append(float(jax.device_get(m["grad_norm"])))
        jax.effects_barrier()
        if seeds is not None:
            seeds.append(list(dict.fromkeys(captured)))     # a call a device: one seed a block
    return init, losses, norms


def _sharded_state(cfg, mesh, sd=None) -> TrainState:
    """A sharded train state: the model built on meta, apply_fsdp, then
    the whole tensors of `sd` cut to this rank's shards (or the sharded
    init from cfg.seed)."""
    from vitax_torch.parallel.sharding import apply_fsdp, init_sharded, local_shard
    model = apply_fsdp(build_model(cfg, "meta", attention_impl=make_attention_impl(cfg, "cpu")), cfg, mesh)
    model.to_empty(device="cpu")
    if sd is None:
        init_sharded(model, cfg, "cpu")
    else:
        with torch.no_grad():
            for name, p in model.named_parameters():
                local(p).copy_(local_shard(sd[name], p))
    return make_train_state(model.train())


def _gathered(state: TrainState) -> dict:
    """params, mu, nu whole (a collective), and count."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()
    names = [n for n, _ in state.model.named_parameters()]
    return {"params": {n: whole(p) for n, p in state.model.named_parameters()},
            "mu": {n: whole(state.mu[n]) for n in names}, "nu": {n: whole(state.nu[n]) for n in names},
            "count": int(state.count), "step": state.step}


def _steps(cfg, mesh, sd, images, labels, rank):
    from vitax_torch.parallel.mesh import batch_shard
    index, count = batch_shard(mesh)
    assert (index, count) == (rank, 2)
    rows = slice(rank * 4, rank * 4 + 4)
    state = _sharded_state(cfg, mesh, sd)
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    train_step = make_train_step(cfg, optimizer, "cpu", mesh)
    batch = {"image": torch.from_numpy(images[rows]), "label": torch.from_numpy(labels[rows])}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _worker(rank: int, root: str) -> None:
    """One rank of the 2-rank gloo group: every arm, results to
    root/rank<r>.pt."""
    import torch.distributed as dist
    import vitax_torch.train.step as step_module
    from vitax_torch import distributed
    from vitax_torch.data.loader import ShardedSampler, build_datasets
    from vitax_torch.ops.attention import dropout_keep_mask
    from vitax_torch.parallel.mesh import build_mesh
    from vitax_torch.parallel.sharding import placement
    from vitax_torch.models.vit import DropoutSeeds
    from vitax_torch.train.loop import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=2)
    data = np.load(os.path.join(root, "inputs.npz"))
    images, labels = data["images"], data["labels"]
    sd = params_from_jax({k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")})
    out = {}

    cfg = Config(**TINY).validate()
    mesh = build_mesh(cfg, torch.device("cpu"))
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    unsharded = build_model(cfg, "cpu").state_dict()
    for on_cpu in (False, True):
        state = _sharded_state(Config(**TINY, shard_on_cpu=on_cpu), mesh)
        whole = _gathered(state)["params"]
        out[f"init_equal_shard_on_cpu={on_cpu}"] = all(torch.equal(whole[k], unsharded[k]) for k in unsharded)
    out["placements"] = {n: str(p.placements) for n, p in state.model.named_parameters()}
    out["want_placements"] = {n: str((placement(n, tuple(p.shape), 2),))
                              for n, p in state.model.named_parameters()}

    for name, arm in {**ARMS, **EXTRA_ARMS, "bf16": dict(dtype="bfloat16"),
                      "bf16_reduce": dict(dtype="bfloat16", grad_reduce_dtype="bfloat16")}.items():
        acfg = Config(**{**TINY, **arm}).validate()
        amesh = build_mesh(acfg, torch.device("cpu"))
        state, losses, norms = _steps(acfg, amesh, sd, images, labels, rank)
        out[name] = {"losses": losses, "norms": norms, "final": _gathered(state)["params"]}
        if name == "zero3":
            xs = [local(p) for p in state.model.parameters()] + state.grads()
            out["contiguous"] = all(x.is_contiguous() for x in xs)
            out["placement_dims"] = sorted({p.placements[0].dim for p in state.model.parameters()})

    # att_dropout: vitax's captured per-block seeds in place of the port's own
    seeds = data["seeds"]
    step_module.dropout_seeds = lambda cfg_, step, k: DropoutSeeds(blocks=tuple(int(s) for s in seeds[step]))
    dcfg = Config(**TINY, att_dropout=RATE).validate()
    _, losses, _ = _steps(dcfg, build_mesh(dcfg, torch.device("cpu")), sd, images, labels, rank)
    folded = step_module.shard_seeds(step_module.dropout_seeds(dcfg, 0, 0), rank).blocks[0]
    out["drop"] = {"losses": losses, "mask": dropout_keep_mask(folded, 0, 16, 16, RATE)}

    sampler = ShardedSampler(64, 8, shuffle=True, seed=3, process_index=rank, process_count=2)
    _, loader, _, val_loader = build_datasets(Config(**TINY, **TRAIN_RUN), torch.device("cpu"))
    out["loader"] = {"rows": sampler.epoch_indices(1),
                     "wired": (loader.sampler.process_index, loader.sampler.process_count,
                               val_loader.sampler.process_index, loader.sampler.local_batch)}

    # train() under the group: a save at its last epoch and telemetry, then the reverse restore
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, ckpt_dir=os.path.join(root, "ckpt2"),
                         metrics_dir=os.path.join(root, "metrics")), "cpu", records=records)
    out["train"] = {"records": records, "state": _gathered(state)}
    records = []
    state = train(Config(**TINY, **TRAIN_RUN, run_without_fsdp=True, ckpt_dir=os.path.join(root, "ckpt_dp")), "cpu",
                  records=records)
    from torch.distributed.tensor import DTensor
    out["train_dp"] = {"records": records,
                       "sharded": all(isinstance(p, DTensor) for p in state.model.parameters())}
    target = _sharded_state(cfg, mesh)
    target = ckpt_io.restore_state(os.path.join(root, "ckpt1"), 1, target)
    out["reverse"] = _gathered(target)
    ckpt_io.close()
    out["folds"] = {"any_rank1": distributed.any_across_processes(rank == 1),
                    "any_none": distributed.any_across_processes(False),
                    "or_bits": distributed.or_across_processes(1 << (2 * rank)),
                    "or_overlap": distributed.or_across_processes(6 if rank else 3)}
    distributed.orderly_shutdown()
    out["shut_down"] = not dist.is_initialized()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    import torch.multiprocessing as mp
    root = str(tmp_path_factory.mktemp("fsdp"))
    images, labels = _batch()
    jax_losses, jax_norms = {}, {}
    # fsdp_size -1: both devices on fsdp, or on dp for DP; bf16 gathers in bf16
    for name, arm in {**ARMS, "bf16": dict(dtype="bfloat16")}.items():
        init, jax_losses[name], jax_norms[name] = _jax_run(arm, images, labels)
        init0 = init if name == "zero3" else init0
    seeds = []
    # no remat on the JAX side: a block's forward calls its dropout core once, in block order
    _, jax_losses["drop"], _ = _jax_run(dict(att_dropout=RATE, grad_ckpt=False), images, labels, seeds)
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels, seeds=np.asarray(seeds, np.int64),
             **{f"init/{k}": v for k, v in init0.items()})

    # one process: a state a step past vitax's init, saved for the ranks to restore
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(init0), strict=True, assign=True)
    single = make_train_state(model.train())
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    single, _ = make_train_step(cfg, optimizer, "cpu")(
        single, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    ckpt_io.save_state(os.path.join(root, "ckpt1"), 1, single, wait=True)
    ckpt_io.close()

    mp.spawn(_worker, args=(root,), nprocs=2, join=True)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return dict(jax=jax_losses, jax_norms=jax_norms, ranks=ranks, root=root, single=single, images=images,
                labels=labels)


def _whole(state: TrainState) -> dict:
    return {"params": {n: p.detach() for n, p in state.model.named_parameters()}, "mu": state.mu, "nu": state.nu,
            "count": int(state.count), "step": state.step}


def _equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and all(torch.equal(a[g][k], b[g][k]) for g in ("params", "mu", "nu") for k in a["params"]))


@pytest.mark.parametrize("arm", list(ARMS))
def test_losses_match_jax_on_two_devices(runs, arm):
    """ZeRO-3, ZeRO-2 and DP on 2 ranks against vitax's same arm on 2
    devices, and against the port's ZeRO-3; both ranks log the global mean.
    The grad norms are held to vitax's too: AdamW after the clip does not
    see a common scale of every grad, so the losses alone would pass a
    reduce that sums where it should average, or a norm reduced over the
    wrong group."""
    r0, r1 = runs["ranks"]
    np.testing.assert_allclose(r0[arm]["losses"], runs["jax"][arm], rtol=2e-4)
    np.testing.assert_allclose(r0[arm]["norms"], runs["jax_norms"][arm], rtol=2e-4)
    np.testing.assert_allclose(r0[arm]["losses"], r0["zero3"]["losses"], rtol=2e-4)
    assert r0[arm]["losses"] == r1[arm]["losses"] and r0[arm]["norms"] == r1[arm]["norms"]
    assert runs["ranks"][0][arm]["losses"][-1] < runs["ranks"][0][arm]["losses"][0]


@pytest.mark.parametrize("arm", list(EXTRA_ARMS))
def test_other_zero3_schedules_train_the_same(runs, arm):
    """Explicit prefetch, the dots_attn_saveable remat and 2 microbatches
    under ZeRO-3 train ZeRO-3's losses (rtol 2e-4); the prefetch and the
    remat policy change no arithmetic, so theirs are bitwise."""
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0[arm]["losses"], r0["zero3"]["losses"], rtol=2e-4)
    if arm != "accum2":
        assert r0[arm]["losses"] == r0["zero3"]["losses"]


def test_sharded_init_is_the_unsharded_init(runs):
    """Each leaf drawn whole in init_params' order and cut to the rank's
    shard: bitwise build_model's init, drawn on the device or the host."""
    for r in runs["ranks"]:
        assert r["init_equal_shard_on_cpu=False"] and r["init_equal_shard_on_cpu=True"]
        assert r["mesh"] == (("dp", "fsdp"), (1, 2))


def test_placements_follow_the_rules_and_shards_are_contiguous(runs):
    """FSDP2 took the rule table's placement for every leaf (dims 0, 1 and
    2 all occur), and every local param and grad shard is contiguous, as
    the fused optimizer's leaf check requires."""
    r0 = runs["ranks"][0]
    assert r0["placements"] == r0["want_placements"]
    assert r0["placement_dims"] == [0, 1, 2] and r0["contiguous"]


def test_dropout_matches_jax_and_ranks_draw_different_masks(runs):
    """att_dropout 0.1 (mlp 0) from vitax's captured per-block seeds: each
    rank folds its batch shard index in as vitax's shard_map does, so the
    losses are vitax's fsdp=2 run's within rtol 2e-4, they move off the
    rate-0 losses as vitax's do, and the two ranks' masks differ."""
    r0, r1 = runs["ranks"]
    np.testing.assert_allclose(r0["drop"]["losses"], runs["jax"]["drop"], rtol=2e-4)
    # at this size dropout moves the loss by about 1e-4 of itself, inside
    # that bar: hold the move itself to vitax's (a rank with the other's
    # masks, or the blocks' seeds swapped, lands 50% or more off)
    ours = np.subtract(r0["drop"]["losses"], r0["zero3"]["losses"])
    theirs = np.subtract(runs["jax"]["drop"], runs["jax"]["zero3"])
    assert np.all(np.abs(theirs) > 2e-5)
    np.testing.assert_allclose(ours, theirs, rtol=0.1)
    assert not torch.equal(r0["drop"]["mask"], r1["drop"]["mask"])


def test_bf16_gathers_match_jax_bf16(runs):
    """The default path under --dtype bfloat16 (params gathered in bf16,
    the LayerNorms and the head in f32 units of their own, grads reduced
    in f32) on 2 ranks against vitax's bf16 run on a 2-device fsdp mesh:
    losses and grad norms within rtol BF16_RTOL (the two differ by at
    most 3.1e-4 of the norm here, and a grad scale fault moves the norm
    by 40% or more)."""
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0["bf16"]["losses"], runs["jax"]["bf16"], rtol=BF16_RTOL)
    np.testing.assert_allclose(r0["bf16"]["norms"], runs["jax_norms"]["bf16"], rtol=BF16_RTOL)


def test_bf16_grad_reduce_stays_near_f32(runs):
    """--grad_reduce_dtype bfloat16 (bf16 gathers, bf16 reduce-scatter)
    against float32 reduction under the same bf16 gathers: losses within
    rtol 1e-2 and every param within atol 2e-3 (about one bf16 ulp of the
    largest grads, times the step's lr, on few elements)."""
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0["bf16_reduce"]["losses"], r0["bf16"]["losses"], rtol=1e-2)
    np.testing.assert_allclose(r0["bf16"]["losses"], r0["zero3"]["losses"], rtol=1e-2)
    for k, v in r0["bf16"]["final"].items():
        np.testing.assert_allclose(r0["bf16_reduce"]["final"][k].numpy(), v.numpy(), atol=2e-3, err_msg=k)


def test_rank_batches_interleave_into_the_global_batch(runs):
    """Each rank's rows are the interleaved slice order[:, rank::2] of the
    one-process order, and build_datasets wires the rank and world size."""
    from vitax_torch.data.loader import ShardedSampler
    whole = ShardedSampler(64, 8, shuffle=True, seed=3).epoch_indices(1)
    a, b = (r["loader"]["rows"] for r in runs["ranks"])
    merged = np.empty_like(whole)
    merged[:, 0::2], merged[:, 1::2] = a, b
    np.testing.assert_array_equal(merged, whole)
    assert [r["loader"]["wired"] for r in runs["ranks"]] == [(0, 2, 0, 4), (1, 2, 1, 4)]


def test_train_under_the_group_saves_what_one_process_restores(runs):
    """train() on 2 ranks (fake data, 2 steps, an eval, a save at its last
    epoch): both ranks log the same losses and top-1, and the 2-rank
    checkpoint restores bitwise into an unwrapped one-process state."""
    r0, r1 = runs["ranks"]
    losses = [[x["loss"] for x in r["train"]["records"] if "loss" in x] for r in (r0, r1)]
    assert losses[0] == losses[1] and len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    for r in (r0, r1):                  # fake data: every label is 0
        assert [x["top1"] for x in r["train"]["records"] if "top1" in x] == [1.0]
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu", init=False).to_empty(device="cpu")
    state = ckpt_io.restore_state(os.path.join(runs["root"], "ckpt2"), 1, make_train_state(model))
    assert _equal(_whole(state), r0["train"]["state"])
    full = ckpt_io.read_state(os.path.join(runs["root"], "ckpt2"), 1)
    assert all(torch.equal(full["model"][k], v) for k, v in r0["train"]["state"]["params"].items())


def test_train_under_dp_logs_zero3s_losses_and_ends_sharded(runs):
    """train() under --run_without_fsdp (HSDP, params kept gathered through
    the step) logs ZeRO-3's losses and top-1, and its eval leaves no
    gathered param behind: the params the update and a save read are the
    shards."""
    for r in runs["ranks"]:
        losses = [[x["loss"] for x in rec if "loss" in x] for rec in (r["train"]["records"], r["train_dp"]["records"])]
        np.testing.assert_allclose(losses[1], losses[0], rtol=2e-4)
        assert [x["top1"] for x in r["train_dp"]["records"] if "top1" in x] == [1.0]
        assert r["train_dp"]["sharded"]


def test_one_process_save_restores_into_two_ranks(runs):
    """A one-process checkpoint restored into the 2-rank sharded state:
    gathered, bitwise the saved state on both ranks."""
    want = _whole(runs["single"])
    for r in runs["ranks"]:
        assert _equal(r["reverse"], want)


def test_only_rank_0_writes_telemetry(runs):
    """train() on 2 ranks with the same --metrics_dir: one JSONL, rank 0's
    alone (one run_start, every record tagged rank 0, n_devices 2), with a
    record a step and the eval."""
    import json
    from vitax_torch.telemetry import REQUIRED_STEP_KEYS
    d = os.path.join(runs["root"], "metrics")
    assert os.listdir(d) == ["metrics.jsonl"]
    records = [json.loads(ln) for ln in open(os.path.join(d, "metrics.jsonl"))]
    events = [r for r in records if "kind" in r]
    steps = [r for r in records if "kind" not in r]
    assert [e["kind"] for e in events] == ["run_start", "eval"] and {e["rank"] for e in events} == {0}
    assert events[0]["n_devices"] == 2 and events[0]["device_kind"] == "cpu"
    assert [r["step"] for r in steps] == [1, 2] and all(set(REQUIRED_STEP_KEYS) <= set(r) for r in steps)
    logged = [x["loss"] for x in runs["ranks"][0]["train"]["records"] if "loss" in x]
    assert [r["loss"] for r in steps] == logged


def test_host_folds_and_orderly_shutdown_on_two_ranks(runs):
    """any_across_processes is True on both ranks when rank 1 alone says so
    and False when none does; or_across_processes keeps every rank's bits
    (1 | 4, 3 | 6); orderly_shutdown returns on both ranks with the group
    gone (each rank wrote its results after it)."""
    for r in runs["ranks"]:
        assert r["folds"] == {"any_rank1": True, "any_none": False, "or_bits": 5, "or_overlap": 7}
        assert r["shut_down"]


def _world_size_one_against_unwrapped(device: str):
    """3 steps of the unwrapped model, then of FSDP2 in a one-rank group
    (NCCL on the card, gloo on the CPU) from the same init, bf16 gathers
    and f32 reduces: (unwrapped, sharded) (loss, grad norm) lists and
    params, and the sharded run's fused_adamw launches."""
    import tempfile
    import torch.distributed as dist
    from vitax_torch.ops import _build
    from vitax_torch.parallel.mesh import build_mesh
    from vitax_torch.parallel.sharding import apply_fsdp, init_sharded
    cfg = Config(**{**TINY, "dtype": "bfloat16", "embed_dim": 128, "num_heads": 2}).validate()
    images, labels = _batch()
    batch = {"image": torch.from_numpy(images).to(device), "label": torch.from_numpy(labels).to(device)}
    optimizer, _ = build_optimizer(cfg, MAX_ITER)

    def run(model, mesh):
        state = make_train_state(model.train())
        step = make_train_step(cfg, optimizer, device, mesh)
        out = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, {n: local(p).detach().clone() for n, p in state.model.named_parameters()}

    impl = make_attention_impl(cfg, device)
    plain = run(build_model(cfg, device, attention_impl=impl), None)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            mesh = build_mesh(cfg, torch.device(device))
            model = apply_fsdp(build_model(cfg, "meta", attention_impl=impl), cfg, mesh)
            model.to_empty(device=device)
            init_sharded(model, cfg, torch.device(device))
            _build.reset_launches()
            sharded = run(model, mesh)
            launches = _build.LAUNCHES["fused_adamw"]
        finally:
            dist.destroy_process_group()
    return plain, sharded, launches


def test_world_size_one_equals_the_unwrapped_model():
    """FSDP2 in a one-rank gloo group against the unwrapped model, 3 steps
    in bf16 from the same init: the bf16 gather is a cast that commutes
    with the copy, and the LayerNorms and the head stay f32 in units of
    their own, so losses, grad norms and params are bitwise equal."""
    (plain, plain_params), (sharded, sharded_params), _ = _world_size_one_against_unwrapped("cpu")
    assert sharded == plain and plain[-1][0] < plain[0][0]
    assert all(torch.equal(sharded_params[k], v) for k, v in plain_params.items())


@pytest.mark.gpu
def test_world_size_one_equals_the_unwrapped_model_on_card():
    """The same on the card through the kernels and NCCL, with the conv's
    wgrad deterministic: bitwise equal, one fused_adamw launch a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True       # the patch conv's wgrad: no atomics
    try:
        (plain, plain_params), (sharded, sharded_params), launches = _world_size_one_against_unwrapped("cuda")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert launches == STEPS
    assert sharded == plain
    assert all(torch.equal(sharded_params[k], v) for k, v in plain_params.items())
