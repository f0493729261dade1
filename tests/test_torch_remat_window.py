"""--remat_window, --no_scan_blocks, the profiler window and
--compile_cache_dir in vitax_torch.

- Loss and every grad at --remat_window 2 against window 0 (per-block
  remat) and against vitax's windowed forward (make_windowed_forward) on
  the same weights carried across as vitax's npz tree, float32, within the
  bars of tests/test_torch_parity.py (rtol/atol 1e-4 for the loss, 2e-3 /
  2e-5 for the grads); under dropout and MoE the port's window 2 bitwise
  its own window 0 (a group's recompute redraws each block's masks).
- The --no_scan_blocks export (params_to_jax, consolidate's CLI): vitax's
  unscanned tree's keys and shapes, and it loads back.
- The profiler window on the CPU (--profile_dir, start 0, num 2): one trace
  holding exactly steps 1 and 2; a window the loop leaves open is closed.
- --compile_cache_dir: the kernels' build directory, and a warm one calls
  no nvcc.
Tiny dims, the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitax.checkpoint.consolidate import flatten_tree
from vitax.config import Config as JaxConfig
from vitax.models import build_model as jax_build_model
from vitax.models.vit import make_windowed_forward
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import DropoutSeeds, build_model
from vitax_torch.ops.attention import make_attention_impl

TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=4, num_classes=4, dtype="float32")


def _batch(seed=1, n=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16, 16, 3)).astype(np.float32), rng.integers(0, 4, size=(n,))


def _jax(window: int, policy: str):
    cfg = JaxConfig(**TINY, remat_window=window, grad_ckpt=True, remat_policy=policy).validate()
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3), jnp.float32), True)
    return cfg, model, params


def _port(params, window: int, policy: str, **kw):
    cfg = Config(**TINY, remat_window=window, grad_ckpt=True, remat_policy=policy, **kw).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    model.load_state_dict(params_from_jax(flat), strict=True, assign=True)
    return model.train()


def _port_loss_grads(model, images, labels, seeds=None):
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(images), seeds)
    loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _vitax_loss_grads(cfg, jmodel, params, images, labels):
    forward = make_windowed_forward(cfg, jmodel)

    def jloss(p):
        logits = forward(p, jnp.asarray(images), True)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], axis=1))

    loss, jgrads = jax.value_and_grad(jloss)(params)
    return float(loss), params_from_jax({k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jgrads)).items()})


@pytest.mark.parametrize("policy", ["none_saveable", "dots_saveable"])
def test_window2_loss_and_grads_match_window0_and_vitax(policy):
    cfg, jmodel, params = _jax(2, policy)
    images, labels = _batch()
    want_loss, want = _vitax_loss_grads(cfg, jmodel, params, images, labels)
    got_loss, got = _port_loss_grads(_port(params, 2, policy), images, labels)
    base_loss, base = _port_loss_grads(_port(params, 0, policy), images, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4, atol=1e-4)
    assert got.keys() == want.keys() == base.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=2e-3, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), base[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
    assert abs(got_loss - base_loss) <= 1e-6 * abs(base_loss)


def test_window_under_dots_attn_saveable_refused_and_per_block_matches_vitax():
    """The port refuses --remat_window 2 under dots_attn_saveable (its cores
    run between checkpointed regions of their own block: no group to
    checkpoint); its per-block remat gives vitax's windowed loss and grads."""
    cfg, jmodel, params = _jax(2, "dots_attn_saveable")
    with pytest.raises(ValueError, match="dots_attn_saveable"):
        Config(**TINY, remat_window=2, grad_ckpt=True, remat_policy="dots_attn_saveable").validate()
    images, labels = _batch()
    want_loss, want = _vitax_loss_grads(cfg, jmodel, params, images, labels)
    got_loss, got = _port_loss_grads(_port(params, 0, "dots_attn_saveable"), images, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4, atol=1e-4)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=2e-3, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("arm", [dict(att_dropout=0.1, mlp_dropout=0.1, pos_dropout=0.1),
                                 dict(moe_experts=4), dict(moe_experts=4, moe_top_k=2, att_dropout=0.1)],
                         ids=["dropout", "moe", "moe_top2_dropout"])
def test_window2_bitwise_window0_under_dropout_and_moe(arm):
    _, _, params = _jax(2, "none_saveable") if "moe_experts" not in arm else (None, None, None)
    images, labels = _batch(seed=3)
    outs = []
    for window in (0, 2):
        if params is None:              # MoE leaves: the port's own init, one seed for both arms
            torch.manual_seed(0)
            cfg = Config(**TINY, remat_window=window, grad_ckpt=True, **arm).validate()
            model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu")).train()
        else:
            model = _port(params, window, "none_saveable", **arm)
        seeds = DropoutSeeds(blocks=[101, 102, 103, 104], pos=7) if arm.get("att_dropout") else None
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(images), seeds, with_aux=bool(arm.get("moe_experts")))
        logits, aux = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
        loss = loss + sum(a.float().sum() for a in aux if torch.is_tensor(a))
        loss.backward()
        outs.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys() and len(outs[0][1]) > 0
    for name in outs[0][1]:
        assert torch.equal(outs[0][1][name], outs[1][1][name]), name


# --- --no_scan_blocks: the unscanned JAX layout ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_no_scan_blocks_export_matches_vitax_unscanned(tmp_path, dtype):
    from vitax.checkpoint.consolidate import save_npz as jax_save_npz
    from vitax_torch.checkpoint.consolidate import load_npz, load_npz_raw, save_npz
    from vitax_torch.checkpoint.convert import params_to_jax
    jcfg = JaxConfig(**TINY, scan_blocks=False, grad_ckpt=False).validate()
    jparams = jax_build_model(jcfg).init(jax.random.key(0), jnp.zeros((1, 16, 16, 3), jnp.float32), True)
    jflat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    jpath = str(tmp_path / "jax.npz")
    jax_save_npz(jpath, jflat, dtype=dtype)
    model = _port(_jax(0, "none_saveable")[2], 0, "none_saveable")
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    path = str(tmp_path / "a.npz")
    save_npz(path, params_to_jax(sd, scanned=False), dtype=dtype)
    want = load_npz_raw(jpath)
    got = load_npz_raw(path)
    assert {k: tuple(v.shape) for k, v in got[0].items()} == {k: tuple(v.shape) for k, v in want[0].items()}
    assert {k: tuple(v.shape) for k, v in got[1].items()} == {k: tuple(v.shape) for k, v in want[1].items()}
    assert got[2] == want[2] and any(k.startswith("params/blocks_3/") for k in got[0])
    back = params_from_jax(load_npz(path))
    assert back.keys() == sd.keys()
    for k in sd:                    # float round trip exact; int8 within its per-channel step
        tol = 0.0 if dtype is None else float(sd[k].abs().max()) / 127.0 + 1e-7
        assert float((back[k] - sd[k]).abs().max()) <= tol, k


def test_consolidate_cli_no_scan_blocks(tmp_path):
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.checkpoint.consolidate import load_npz_raw, main
    from vitax_torch.train.state import build_optimizer, make_train_state
    cfg = Config(**TINY).validate()
    model = build_model(cfg, "cpu")
    optimizer, _ = build_optimizer(cfg, 10)
    ckpt_io.save_state(str(tmp_path / "ck"), 1, make_train_state(model, optimizer), wait=True)
    ckpt_io.close()
    for flag, stem in (([], "params/blocks/"), (["--no_scan_blocks"], "params/blocks_0/")):
        out = str(tmp_path / f"x{len(flag)}.npz")
        assert main(["--ckpt_dir", str(tmp_path / "ck"), "--epoch", "1", "--out", out, *flag]) == 0
        flat = load_npz_raw(out)[0]
        assert any(k.startswith(stem) for k in flat) and not any(k.startswith("params/blocks_" if not flag
                                                                              else "params/blocks/") for k in flat)


# --- the profiler window and the build cache -------------------------------------------------------------

def _run(tmp_path, **kw):
    from vitax_torch.train.loop import train
    cfg = Config(**{**TINY, "num_blocks": 2}, fake_data=True, batch_size=8, num_epochs=1, steps_per_epoch=4,
                 log_step_interval=1, eval_max_batches=1, test_epoch_interval=99, ckpt_epoch_interval=99,
                 ckpt_dir=str(tmp_path / "ck"), num_workers=1, warmup_steps=0, **kw).validate()
    records = []
    train(cfg, "cpu", records=records)
    return [r["loss"] for r in records if "loss" in r]


def test_profiler_window_writes_one_trace_of_two_steps(tmp_path, capsys):
    from vitax_torch.telemetry.profiler import read_trace
    losses = _run(tmp_path, max_steps=3, profile_dir=str(tmp_path / "prof"), profile_start_step=0,
                  profile_num_steps=2)
    assert os.listdir(tmp_path / "prof") == ["rank0.pt.trace.json"]
    steps, kernels = read_trace(str(tmp_path / "prof" / "rank0.pt.trace.json"))
    assert steps == [1, 2] and kernels == []          # no device on the CPU
    assert capsys.readouterr().out.count(f"profile trace written to {tmp_path / 'prof'}") == 1
    assert losses == _run(tmp_path / "off", max_steps=3)      # the window leaves the math alone


def test_profiler_window_open_at_the_end_is_closed(tmp_path):
    from vitax_torch.telemetry.profiler import read_trace
    _run(tmp_path, max_steps=2, profile_dir=str(tmp_path / "prof"), profile_start_step=1, profile_num_steps=5)
    assert read_trace(str(tmp_path / "prof" / "rank0.pt.trace.json"))[0] == [2]


def test_read_trace_keeps_the_window_kernels_and_window_busy(tmp_path):
    """Kernels before the window's first step range (the warm-up step's, on
    the card) are not the window's; busy is the union of the intervals."""
    import json
    from vitax_torch.telemetry.profiler import read_trace, window_busy
    events = [{"cat": "kernel", "ph": "X", "name": "warm", "ts": 5.0, "dur": 1.0},
              {"cat": "user_annotation", "ph": "X", "name": "vitax_step_4", "ts": 10.0, "dur": 2.0},
              {"cat": "kernel", "ph": "X", "name": "a", "ts": 11.0, "dur": 2000.0},
              {"cat": "kernel", "ph": "X", "name": "b", "ts": 1011.0, "dur": 2000.0},
              {"cat": "user_annotation", "ph": "X", "name": "vitax_step_5", "ts": 3100.0, "dur": 2.0},
              {"cat": "kernel", "ph": "X", "name": "c", "ts": 4011.0, "dur": 1000.0},
              {"cat": "cpu_op", "ph": "X", "name": "aten::mm", "ts": 12.0, "dur": 1.0}]
    path = tmp_path / "rank0.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    steps, kernels = read_trace(str(path))
    assert steps == [4, 5] and [k["name"] for k in kernels] == ["a", "b", "c"]
    assert window_busy(kernels) == (4.0, 5.0) and window_busy([]) is None


def test_compile_cache_dir_resolves_the_build_dir_and_a_warm_one_builds_nothing(tmp_path, monkeypatch):
    from vitax_torch.ops import _build
    try:
        assert _build.set_build_dir(str(tmp_path / "cache")) == str(tmp_path / "cache")
        path = _build._lib_path("fused_adamw")
        assert os.path.dirname(path) == str(tmp_path / "cache")
        os.makedirs(os.path.dirname(path))
        open(path, "wb").close()        # a library a previous run built here

        def no_nvcc():
            raise AssertionError("nvcc called with a warm cache")
        monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
        log = _build._compile("fused_adamw")
        assert log["cached"] and log["path"] == path
        _run(tmp_path, max_steps=1, compile_cache_dir=str(tmp_path / "other"))
        assert _build.BUILD_DIR == str(tmp_path / "other")
    finally:
        _build.set_build_dir("")
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
