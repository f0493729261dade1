"""vitax_torch's scenarios (vitax_torch/programs/) held to the JAX
package's (vitax/programs/): the registry's refusals with vitax's messages;
the warm start from vitax-written npz exports (f32 and int8), its fresh
head under a new --num_classes and its loud failures; finetune
(--backbone_lr_mult) and probe as three steps of train() in both packages
from one export; distill through both step builders; a probe checkpoint
resumed, exported and served; the JSONL events; the CLIs. Tiny dims,
float32, inputs from numpy seeds.

Tolerances: the masked updates alone, on the same params and grads, at
tests/test_torch_optim.py's per-leaf bars: the moments at rtol 1e-6 with
an atol of 1e-6 of the leaf's largest magnitude (XLA on the CPU contracts
a * b + c into FMAs where the port rounds each op), the params at its
dispatcher's rtol 1e-4 (the port's float64 bias corrections against XLA's
float32 pow, 2e-5 apart in 1 - b2^t), there with an atol of 1e-4 of the
leaf's largest magnitude: the biases start at zero, and where two steps'
updates cancel an element ends near zero with the updates' error. Through train() and the distill step the
two frameworks' forwards and backwards sum in other orders, and AdamW's
first steps turn the grads' relative noise into update noise (on fake
data the key bias's grad is rounding noise alone, which AdamW scales to
+-lr), so there losses are held within rtol 2e-4 / atol 2e-5, grad norms
within rtol 1e-5 and params within rtol 2e-3 / atol 2e-5, the bars of
tests/test_torch_train.py. Served probs within 1e-5 of vitax's engine
(tests/test_torch_serve.py's f32 bar); what the port computes twice on
the same inputs is held bitwise.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint.consolidate import consolidate, load_npz
from vitax_torch.checkpoint.convert import params_from_jax, train_state_to_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.programs import TASKS, get_scenario
from vitax_torch.programs.builder import build_engine, build_program
from vitax_torch.programs.workloads import (backbone_mask, frozen_fraction, head_mask, load_teacher,
                                            make_distill_step, warm_start_from_npz)
from vitax_torch.serve.engine import InferenceEngine
from vitax_torch.train.state import make_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4, batch_size=8,
            dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
RUN = dict(fake_data=True, num_epochs=1, steps_per_epoch=3, log_step_interval=1, eval_max_batches=1,
           test_epoch_interval=1, num_workers=1)


def _assert_leaf_close(got, want, what="", rtol=1e-6):
    """tests/test_torch_optim.py's per-leaf bar: rtol, and an atol of rtol
    times the leaf's largest magnitude."""
    for k in want:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=f"{what} {k}")


def _assert_params_close(model, jparams):
    """tests/test_torch_train.py's bar for params after train steps."""
    want = params_from_jax(_jax_flat(jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), rtol=2e-3, atol=2e-5, err_msg=k)


def _jax_flat(tree):
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _jax_state(seed=0, **kw):
    """(cfg, mesh, model, state, specs, tx, schedule) of a vitax init on one
    device (scanned blocks)."""
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import build_mesh
    from vitax.programs import get_scenario as jax_get_scenario
    from vitax.train.state import make_train_state as jax_make_train_state
    cfg = JaxConfig(**{**TINY, **kw}).validate()
    mesh = build_mesh(cfg, jax.devices()[:1])
    model = jax_build_model(cfg)
    tx, schedule = jax_get_scenario(cfg.task).make_optimizer(cfg, 10)
    state, specs, _ = jax_make_train_state(cfg, model, tx, mesh, jax.random.key(seed))
    return cfg, mesh, model, state, specs, tx, schedule


@pytest.fixture(scope="module")
def exports(tmp_path_factory, devices8):
    """vitax-written params exports (scanned, vitax's save_npz): f32 and
    int8 of a vitax init (seed 11), f32 of the port's seed-12 init (the
    distill teacher), the f32 flat tree, and the vitax finetune state the
    warm starts overwrite, by --num_classes."""
    import dataclasses
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import save_npz as jax_save_npz
    from vitax_torch.checkpoint.convert import params_to_jax
    root = tmp_path_factory.mktemp("exports")
    cfg, mesh, _, state, *_ = _jax_state(seed=11, task="finetune", init_npz="/x.npz")
    flat = _jax_flat(state.params)
    other = params_to_jax(build_model(Config(**TINY, seed=12), "cpu").state_dict())
    out = {"root": root, "flat": flat}
    for name, tree, dtype in (("f32", flat, None), ("int8", flat, "int8"),
                              ("other", {k: v.numpy() for k, v in other.items()}, None)):
        out[name] = str(root / f"{name}.npz")
        jax_save_npz(out[name], tree, dtype=dtype)
    # the warm start reads only the fresh tree's keys and shapes, and keeps its head
    params6 = {"params": {**state.params["params"],
                          "head": {"kernel": jnp.zeros((TINY["embed_dim"], 6)), "bias": jnp.zeros((6,))}}}
    out["jax"] = {4: (cfg, mesh, state),
                  6: (dataclasses.replace(cfg, num_classes=6), mesh, state.replace(params=params6))}
    return out


def _jax_warm_start(exports, path, num_classes=4, **flags):
    import dataclasses
    from vitax.programs.workloads import warm_start_from_npz as jax_warm_start
    cfg, mesh, state = exports["jax"][num_classes]
    return jax_warm_start(dataclasses.replace(cfg, init_npz=path, **flags), state, mesh)


def _port_state(task="finetune", **kw):
    cfg = Config(**{**TINY, "task": task, **kw})
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu")).train()
    optimizer, schedule = get_scenario(task).make_optimizer(cfg, 10)
    return cfg, optimizer, schedule, make_train_state(model, optimizer)


# --- the registry ------------------------------------------------------------


def test_tasks_and_masks_are_vitaxs():
    from vitax.programs import TASKS as JAX_TASKS
    assert TASKS == JAX_TASKS == ("train", "finetune", "probe", "distill")
    for task in TASKS:
        assert get_scenario(task).step_program == ("distill" if task == "distill" else "train")
    model = build_model(Config(**TINY), "meta")
    assert [n for n, m in head_mask(model).items() if m] == ["head.weight", "head.bias"]
    assert sum(backbone_mask(model).values()) == len(list(model.parameters())) - 2
    d, c = TINY["embed_dim"], TINY["num_classes"]
    n = sum(p.numel() for p in model.parameters())
    assert frozen_fraction(model) == (n - d * c - c) / n


# (task, flags): vitax's bad combinations (tests/test_programs.py:179-192 and
# one for each check of each validator in vitax/programs/registry.py)
BAD = [("train", dict(init_npz="/x.npz")), ("train", dict(teacher_npz="/t.npz")),
       ("train", dict(reinit_head=True)), ("train", dict(backbone_lr_mult=0.5)),
       ("finetune", {}), ("finetune", dict(init_npz="/x.npz", teacher_npz="/t.npz")),
       ("finetune", dict(init_npz="/x.npz", pp_size=2)), ("finetune", dict(init_npz="/x.npz", backbone_lr_mult=-1.0)),
       ("finetune", dict(init_npz="/x.npz", backbone_lr_mult=0.5, fused_optimizer="on")),
       ("probe", dict(teacher_npz="/t.npz")), ("probe", dict(pp_size=2)), ("probe", dict(fused_optimizer="on")),
       ("probe", dict(backbone_lr_mult=0.5)),
       ("distill", dict(init_npz="/x.npz")), ("distill", dict(reinit_head=True)),
       ("distill", dict(backbone_lr_mult=0.5)), ("distill", dict(pp_size=2)), ("distill", dict(moe_experts=4)),
       ("distill", dict(grad_accum_steps=2)), ("distill", dict(reshard_after_forward=False))]


@pytest.mark.parametrize("task,flags", BAD, ids=[f"{t}-{'-'.join(f) or 'bare'}" for t, f in BAD])
def test_validators_refuse_vitaxs_combinations_with_its_messages(task, flags):
    """Each scenario validator on the same flags: vitax asserts, the port
    raises ValueError, with the same message. (MoE is no port field: the
    validator reads it as vitax's does, off a config that carries it.)"""
    from vitax.config import Config as JaxConfig
    from vitax.programs import get_scenario as jax_get_scenario
    moe = flags.get("moe_experts")
    kw = {k: v for k, v in flags.items() if k != "moe_experts"}
    jcfg, cfg = JaxConfig(**TINY, task=task, **kw), Config(**TINY, task=task, **kw)
    if moe:
        jcfg.moe_experts = cfg.moe_experts = moe
    with pytest.raises(AssertionError) as want:
        jax_get_scenario(task).validate(jcfg)
    with pytest.raises(ValueError) as got:
        get_scenario(task).validate(cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [dict(task="probe", fused_optimizer="on"), dict(init_npz="/x.npz"),
                                   dict(task="distill", grad_accum_steps=2), dict(distill_alpha=1.5),
                                   dict(distill_temp=0.0), dict(task="finetune", init_npz="/x.npz",
                                                                backbone_lr_mult=-1.0)],
                         ids=["probe_fused_on", "train_init_npz", "distill_accum", "alpha", "temp", "mult"])
def test_config_validate_refuses_as_vitax(flags):
    from vitax.config import Config as JaxConfig
    with pytest.raises(AssertionError) as want:
        JaxConfig(**TINY, **flags).validate()
    with pytest.raises(ValueError) as got:
        Config(**TINY, **flags).validate()
    assert str(got.value) == str(want.value)


def test_unknown_task_and_program_kinds():
    from vitax.programs import get_scenario as jax_get_scenario
    with pytest.raises(ValueError) as want:
        jax_get_scenario("pretrain")
    with pytest.raises(ValueError) as got:
        get_scenario("pretrain")
    assert str(got.value) == str(want.value)
    cfg = Config(**TINY).validate()
    with pytest.raises(ValueError, match="does not build 'distill'"):
        build_program("distill", cfg, None, "cpu")
    with pytest.raises(ValueError, match="needs --teacher_npz"):
        build_program("distill", Config(**TINY, task="distill").validate(), None, "cpu")


def test_cli_flags_parse_as_vitax_and_the_train_cli_refuses_alike(capsys):
    from vitax.config import build_parser as jax_parser
    from vitax_torch.config import build_parser
    from vitax_torch.train.__main__ import main
    argv = ["--task", "finetune", "--init_npz", "/x.npz", "--reinit_head", "--backbone_lr_mult", "0.1",
            "--teacher_npz", "", "--distill_alpha", "0.25", "--distill_temp", "3.0"]
    names = ("task", "init_npz", "teacher_npz", "reinit_head", "backbone_lr_mult", "distill_alpha", "distill_temp")
    ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert [getattr(ours, n) for n in names] == [getattr(theirs, n) for n in names]
    defaults = build_parser().parse_args([])
    assert [getattr(defaults, n) for n in names] == [getattr(jax_parser().parse_args([]), n) for n in names]
    assert main(["--task", "probe", "--fused_optimizer", "on", "--device", "cpu"]) == 2
    assert "--fused_optimizer on is incompatible with --task probe" in capsys.readouterr().err


# --- the warm start ----------------------------------------------------------


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_warm_start_loads_vitaxs_export_bitwise(exports, name):
    """The backbone and head equal vitax's load_npz of the file bit for bit
    (int8 dequantized to f32 the same way); the payload is vitax's
    warm_start_from_npz's on the same file and config."""
    from vitax.checkpoint.consolidate import load_npz as jax_load_npz
    path = exports[name]
    cfg, _, _, state = _port_state(init_npz=path)
    state, info = warm_start_from_npz(cfg, state)
    want = params_from_jax(jax_load_npz(path))
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), want[n].float()), n
    assert info == _jax_warm_start(exports, path)[1] and info["loaded"] == 19 and info["reinit"] == []


@pytest.mark.parametrize("flags", [dict(num_classes=6), dict(reinit_head=True)], ids=["new_classes", "reinit_head"])
def test_warm_start_keeps_a_fresh_head(exports, flags):
    """--num_classes 6 over a 4-class export, or --reinit_head: the head
    keeps the seeded init, the rest loads; vitax reports the same payload."""
    cfg, _, _, state = _port_state(init_npz=exports["f32"], **flags)
    fresh = build_model(cfg, "cpu").state_dict()
    state, info = warm_start_from_npz(cfg, state)
    want = params_from_jax(exports["flat"])
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), (fresh if n.startswith("head.") else want)[n]), n
    assert info == _jax_warm_start(exports, exports["f32"], **flags)[1]
    assert info["reinit"] == ["params/head/bias", "params/head/kernel"] and info["loaded"] == 17


@pytest.mark.parametrize("edit", ["missing", "shape", "unknown"])
def test_warm_start_fails_loudly_with_vitaxs_message(exports, edit):
    from vitax.checkpoint.consolidate import save_npz as jax_save_npz
    flat = dict(exports["flat"])
    if edit == "missing":
        del flat["params/norm/scale"]
    elif edit == "shape":
        flat["params/pos_embed"] = flat["params/pos_embed"][:, :2]
    else:
        flat["params/extra/kernel"] = np.zeros((2, 2), np.float32)
    path = str(exports["root"] / f"bad_{edit}.npz")
    jax_save_npz(path, flat)
    with pytest.raises(ValueError) as want:
        _jax_warm_start(exports, path)
    cfg, _, _, state = _port_state(init_npz=path)
    with pytest.raises(ValueError) as got:
        warm_start_from_npz(cfg, state)
    assert str(got.value) == str(want.value)


# --- finetune and probe: the masked updates, then train() in both packages ---


@pytest.mark.parametrize("task,flags", [("finetune", dict(backbone_lr_mult=0.1)), ("probe", {})],
                         ids=["finetune_mult", "probe"])
def test_masked_updates_match_optax_on_the_same_grads(exports, task, flags):
    """3 updates of the same params from the same seeded grads (norm above
    the clip) through vitax's optimizer phase (its clip, then the
    scenario's optax chain) and the port's (the fused update's plain
    version with the leaf table's multipliers, or the head's leaves only):
    params and moments at the per-leaf bars, the moments for vitax's
    leaves (the probe's: the head's), the probe's backbone bitwise
    untouched."""
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import unflatten_tree
    from vitax.train.step import _make_update_fn as jax_update_fn
    from vitax_torch.train.step import _make_update_fn
    from vitax.config import Config as JaxConfig
    from vitax.programs import get_scenario as jax_get_scenario
    jcfg = JaxConfig(**TINY, task=task, init_npz=exports["f32"], **flags).validate()
    tx, schedule = jax_get_scenario(task).make_optimizer(jcfg, 10)
    params = jax.tree.map(jnp.asarray, unflatten_tree(dict(exports["flat"])))
    opt_state = tx.init(params)
    update = jax.jit(jax_update_fn(jcfg, tx, exports["jax"][4][1], None, schedule))     # optax's phase
    cfg, optimizer, _, state = _port_state(task, init_npz=exports["f32"], **flags)
    state.model.load_state_dict(params_from_jax(exports["flat"]))
    port_update = _make_update_fn(cfg, optimizer, "cpu")
    rng = np.random.default_rng(21)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in exports["flat"].items()}
        params, opt_state, norm = update(jax.tree.map(jnp.asarray, unflatten_tree(grads)), opt_state, params)
        for n, p in state.model.named_parameters():
            p.grad = params_from_jax(grads)[n]
        port_norm = port_update(state, state.grads())
        np.testing.assert_allclose(float(port_norm), float(norm), rtol=1e-6)
        assert float(norm) > cfg.clip_grad_norm
    _assert_leaf_close({k: v.detach() for k, v in state.model.state_dict().items()},
                       params_from_jax(_jax_flat(params)), "param", rtol=1e-4)
    jflat = _jax_flat(opt_state)                 # vitax's AdamW moments, wherever its chain keeps them
    for name, moments in (("mu", state.mu), ("nu", state.nu)):
        want = {k[k.index(f"0/{name}/params/") + len(f"0/{name}/"):]: v for k, v in jflat.items()
                if f"0/{name}/params/" in k}
        assert sorted(params_from_jax(want)) == sorted(moments)
        _assert_leaf_close({k: v.numpy() for k, v in moments.items()}, params_from_jax(want), name)
    if task == "probe":
        frozen = params_from_jax(exports["flat"])
        assert all(torch.equal(p.detach(), frozen[n]) for n, p in state.model.named_parameters()
                   if not n.startswith("head."))


def _both_trains(exports, tmp_path, task, **flags):
    """train() of vitax and of the port from the f32 export, 3 steps of fake
    data with a record a step: (vitax state, its JSONL, port state, its
    JSONL)."""
    from vitax.config import Config as JaxConfig
    from vitax.train.loop import train as jax_train
    from vitax_torch.train.loop import train
    runs = {}
    for name in ("jax", "port"):
        runs[name] = dict(TINY, **RUN, task=task, init_npz=exports["f32"], **flags,
                          ckpt_dir=str(tmp_path / name / "ckpt"), metrics_dir=str(tmp_path / name / "m"))
    jstate = jax_train(JaxConfig(**runs["jax"]).validate())
    state = train(Config(**runs["port"]).validate(), "cpu")
    logs = [[json.loads(ln) for ln in open(tmp_path / name / "m" / "metrics.jsonl")] for name in ("jax", "port")]
    return jstate, logs[0], state, logs[1]


def _steps_and_events(log):
    return [r for r in log if "kind" not in r], {r["kind"]: r for r in log if "kind" in r}


def _compare_runs(jlog, log):
    (jsteps, jevents), (steps, events) = _steps_and_events(jlog), _steps_and_events(log)
    assert len(steps) == len(jsteps) == 3
    np.testing.assert_allclose([s["loss"] for s in steps], [s["loss"] for s in jsteps], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose([s["grad_norm"] for s in steps], [s["grad_norm"] for s in jsteps], rtol=1e-5)
    assert set(events["finetune"]) == set(jevents["finetune"])
    for key in ("init_npz", "loaded", "reinit", "frozen_frac"):
        assert events["finetune"][key] == jevents["finetune"][key], key
    return events["finetune"]


def test_finetune_with_a_backbone_multiplier_trains_as_vitax(exports, tmp_path):
    """--backbone_lr_mult 0.5: losses, grad norms and the params after 3
    steps as vitax's; the finetune events carry vitax's keys and values."""
    jstate, jlog, state, log = _both_trains(exports, tmp_path, "finetune", backbone_lr_mult=0.5)
    event = _compare_runs(jlog, log)
    assert event["loaded"] == 19 and event["frozen_frac"] == 0.0
    _assert_params_close(state.model, jstate.params)


def test_probe_trains_the_head_only_as_vitax(exports, tmp_path):
    """The probe: losses, grad norms (over every grad: the backbone's set
    the head's clip) and the head after 3 steps as vitax's; the backbone
    bitwise the export; moments for the head only, and the full-state
    export's keys and shapes those of vitax's probe state."""
    jstate, jlog, state, log = _both_trains(exports, tmp_path, "probe")
    event = _compare_runs(jlog, log)
    assert 0.99 < event["frozen_frac"] < 1.0
    want = params_from_jax(exports["flat"])
    for n, p in state.model.named_parameters():
        if not n.startswith("head."):
            assert torch.equal(p.detach(), want[n]), n
    _assert_params_close(state.model, jstate.params)
    assert sorted(state.mu) == sorted(state.nu) == ["head.bias", "head.weight"]
    ours = train_state_to_jax(state.model.state_dict(), state.mu, state.nu, state.step, state.count)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in _jax_flat(jstate).items()}


# --- distill: both step builders -------------------------------------------


def test_distill_step_matches_vitax(exports, devices8):
    """Student from one export, teacher from another, 2 steps on a seeded
    batch through vitax's make_distill_step and the port's: loss, ce, kl,
    grad norm, both top-1s and the student's params."""
    import jax
    import jax.numpy as jnp
    from vitax.checkpoint.consolidate import load_npz as jax_load_npz
    from vitax.checkpoint.consolidate import unflatten_tree
    from vitax.parallel.sharding import shardings_of
    from vitax.programs.workloads import load_teacher_params, make_distill_step as jax_make_distill_step
    rng = np.random.default_rng(5)
    images = rng.standard_normal((TINY["batch_size"], 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], size=TINY["batch_size"])
    flags = dict(task="distill", teacher_npz=exports["other"], distill_alpha=0.3, distill_temp=2.5)

    jcfg, mesh, jmodel, jstate, sspecs, tx, schedule = _jax_state(**flags)
    student = jax.tree.map(jax.device_put, unflatten_tree(jax_load_npz(exports["f32"])),
                           shardings_of(mesh, sspecs.params))
    jstate = jstate.replace(params=student)
    step_fn = jax_make_distill_step(jcfg, jmodel, tx, mesh, sspecs, load_teacher_params(jcfg, mesh),
                                    schedule=schedule)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}
    keys = ("loss", "ce", "kl", "grad_norm", "teacher_top1", "student_top1")
    want = []
    for _ in range(2):
        jstate, m = step_fn(jstate, jbatch, jax.random.key(1))
        want.append([float(jax.device_get(m[k])) for k in keys])

    cfg = Config(**TINY, **flags).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(load_npz(exports["f32"])), strict=True, assign=True)
    optimizer, _ = get_scenario("distill").make_optimizer(cfg, 10)
    state = make_train_state(model.train(), optimizer)
    teacher = load_teacher(cfg, "cpu")
    assert not any(p.requires_grad for p in teacher.parameters()) and not teacher.training
    step = make_distill_step(cfg, optimizer, "cpu", teacher)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    got = []
    for _ in range(2):
        state, m = step(state, batch)
        got.append([float(m[k]) for k in keys])
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=2e-4, atol=2e-5)     # loss, ce, kl
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-5)                  # grad norm
    np.testing.assert_array_equal(got[:, 4:], want[:, 4:])                        # the top-1s
    assert (got[:, 2] >= 0).all() and 0 < want[0, 4] < 1
    _assert_params_close(state.model, jstate.params)


def test_teacher_of_another_shape_fails_loudly(exports):
    """A teacher export whose keys or shapes are not the student config's
    raises, naming them, before any param is filled."""
    with pytest.raises(ValueError, match=r"does not hold this model's params: \['params/head/bias', "
                                         r"'params/head/kernel'\]"):
        load_teacher(Config(**{**TINY, "num_classes": 6}, task="distill", teacher_npz=exports["f32"]), "cpu")


def test_distill_train_writes_vitaxs_distill_events(exports, tmp_path):
    """train() under --task distill in both packages (students from seed:
    the inits differ, so only the events' keys and mix are compared)."""
    from vitax.config import Config as JaxConfig
    from vitax.train.loop import train as jax_train
    from vitax_torch.train.loop import train
    run = dict(TINY, **{**RUN, "steps_per_epoch": 1}, task="distill", teacher_npz=exports["f32"])
    jax_train(JaxConfig(**run, ckpt_dir=str(tmp_path / "j"), metrics_dir=str(tmp_path / "jm")).validate())
    records = []
    train(Config(**run, ckpt_dir=str(tmp_path / "p"), metrics_dir=str(tmp_path / "pm")).validate(), "cpu",
          records=records)
    (_, jevents), (_, events) = (_steps_and_events([json.loads(ln) for ln in open(tmp_path / d / "metrics.jsonl")])
                                 for d in ("jm", "pm"))
    assert set(events["distill"]) == set(jevents["distill"])
    assert (events["distill"]["alpha"], events["distill"]["temp"]) == (0.5, 2.0)
    assert events["distill"]["kl"] >= 0 and np.isfinite(events["distill"]["ce"])
    assert records[0]["kl"] == events["distill"]["kl"]


# --- a probe checkpoint: resume, export, serve ------------------------------


@pytest.fixture(scope="module")
def probe_ckpt(exports, tmp_path_factory):
    """Probe run A (2 epochs of 2 steps, a save each) and run B resumed from
    A's epoch 1."""
    from vitax_torch.train.loop import train
    root = tmp_path_factory.mktemp("probe_ckpt")
    run = dict(TINY, **{**RUN, "num_epochs": 2, "steps_per_epoch": 2}, task="probe", init_npz=exports["f32"],
               ckpt_epoch_interval=1)
    a = train(Config(**run, ckpt_dir=str(root / "a")).validate(), "cpu")
    shutil.copytree(root / "a" / "epoch_1", root / "b" / "epoch_1")
    b = train(Config(**run, ckpt_dir=str(root / "b"), resume_epoch=1).validate(), "cpu")
    return dict(root=root, a=a, b=b, cfg=Config(**run).validate())


def test_probe_checkpoint_resumes_bitwise(probe_ckpt):
    a, b = probe_ckpt["a"], probe_ckpt["b"]
    assert a.step == b.step == 4 and int(a.count) == int(b.count) == 4
    for n, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[n]), n
    assert sorted(a.mu) == sorted(b.mu) == ["head.bias", "head.weight"]
    assert all(torch.equal(a.mu[n], b.mu[n]) and torch.equal(a.nu[n], b.nu[n]) for n in a.mu)
    st = ckpt_io.read_state(str(probe_ckpt["root"] / "a"), 2)
    assert sorted(st["mu"]) == ["head.bias", "head.weight"] and st["step"] == 4


def test_from_checkpoint_serves_the_epochs_export(probe_ckpt, devices8, tmp_path):
    """from_checkpoint (the latest epoch, through build_engine) answers as
    from_npz on that epoch's consolidate output, bitwise, and as vitax's
    engine on it within 1e-5; the probe's full-state export reads back in
    the port."""
    from vitax.config import Config as JaxConfig
    from vitax.serve import InferenceEngine as JaxEngine
    from vitax_torch.checkpoint.convert import train_state_from_jax
    ckpt = str(probe_ckpt["root"] / "a")
    cfg = Config(**TINY, ckpt_dir=ckpt).validate()
    with pytest.raises(ValueError, match="no epoch checkpoint"):
        InferenceEngine.from_checkpoint(cfg, str(tmp_path / "empty"), device="cpu")
    out = str(tmp_path / "epoch2.npz")
    consolidate(ckpt, 2, out)
    engines = [build_engine(cfg, device="cpu"), InferenceEngine.from_checkpoint(cfg, ckpt, 2, "cpu"),
               build_engine(cfg, npz=out, device="cpu")]
    jeng = JaxEngine.from_npz(JaxConfig(**TINY, serve_port=0).validate(), out)
    x = np.random.default_rng(9).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    answers = []
    for eng in engines + [jeng]:
        eng.warmup()
        answers.append(eng.predict(x))
    for ids, p in answers[1:3]:
        np.testing.assert_array_equal(ids, answers[0][0])
        np.testing.assert_array_equal(p, answers[0][1])
    np.testing.assert_array_equal(answers[0][0], answers[3][0])
    np.testing.assert_allclose(answers[0][1], answers[3][1], atol=1e-5)
    full = consolidate(ckpt, 2, str(tmp_path / "full.npz"), params_only=False)
    assert "opt_state/2/inner_state/0/mu/params/head/kernel" in full
    sd, mu, nu, step, count = train_state_from_jax(load_npz(str(tmp_path / "full.npz")))
    assert sorted(mu) == ["head.bias", "head.weight"] and step == int(count) == 4


def _http(url, body=None):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/x-portable-pixmap"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_serve_cli_serves_the_latest_checkpoint_on_cpu(probe_ckpt):
    """python -m vitax_torch.serve --ckpt_dir D (--epoch -1): one /predict,
    then exit 0 on SIGTERM."""
    argv = [sys.executable, "-m", "vitax_torch.serve", "--ckpt_dir", str(probe_ckpt["root"] / "a"), "--epoch", "-1",
            "--device", "cpu", "--serve_port", "0", "--image_size", "16", "--patch_size", "8", "--embed_dim", "32",
            "--num_heads", "2", "--num_blocks", "2", "--num_classes", "4"]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            lines.append(proc.stdout.readline())
            if "listening on :" in lines[-1]:
                port = int(lines[-1].split("listening on :")[1].split()[0])
        assert port, "".join(lines)
        assert any("params from checkpoint" in ln and "epoch 2" in ln for ln in lines), "".join(lines)
        url = f"http://127.0.0.1:{port}"
        while not _http(url + "/healthz")["ready"] and time.monotonic() < deadline:
            time.sleep(0.05)
        img = np.random.default_rng(3).integers(0, 256, (16, 16, 3), dtype=np.uint8)
        ans = _http(url + "/predict", b"P6\n16 16\n255\n" + img.tobytes())
        assert len(ans["classes"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


# --- on a card (python -m pytest -m gpu tests/) ------------------------------


@pytest.mark.gpu
def test_fused_adamw_multiplier_matches_plain_on_card():
    """Kernel B with a multiplier per leaf (0.1 and 1, alternating) against
    clip_adamw_ with the same, within the 1e-6 relative bar; the leaves at
    1 bitwise the kernel without multipliers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vitax_torch.ops.fused_optimizer import clip_adamw_, fused_adamw_cuda, global_norm, step_scalars
    from vitax_torch.train.schedule import warmup_cosine_schedule
    from vitax_torch.train.state import ADAMW_HPARAMS
    rng = np.random.default_rng(8)
    shapes = [(7,), (5, 3), (4099,), (64, 160), (1,), (3, 5120)]
    mults = [0.1 if i % 2 == 0 else 1.0 for i in range(len(shapes))]

    def leaves():
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda() for s in shapes]

    p, g, mu, nu = leaves(), leaves(), leaves(), [x.abs() for x in leaves()]
    copies = [[[x.clone() for x in xs] for xs in (p, mu, nu)] for _ in range(2)]
    hp = (ADAMW_HPARAMS["b1"], ADAMW_HPARAMS["b2"], ADAMW_HPARAMS["eps"], 0.1)
    scal = step_scalars(torch.tensor(3, dtype=torch.int32, device="cuda"), global_norm(g),
                        warmup_cosine_schedule(1e-2, 1, 10), 1.0, hp[0], hp[1])
    fused_adamw_cuda(p, g, mu, nu, scal, hp, mults)
    clip_adamw_(copies[0][0], g, copies[0][1], copies[0][2], scal, hp, mults)
    fused_adamw_cuda(copies[1][0], g, copies[1][1], copies[1][2], scal, hp)
    torch.cuda.synchronize()
    for got, want in zip((p, mu, nu), copies[0]):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    for i, m in enumerate(mults):
        if m == 1.0:
            assert torch.equal(p[i], copies[1][0][i])
        else:
            assert not torch.equal(p[i], copies[1][0][i])
