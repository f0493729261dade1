"""vitax_torch at long context (N > 2048): a tiny ViT at N 2304 through the
streaming entries against the JAX model through its streaming kernels
(make_attention_impl forced, Pallas interpret mode on the CPU): logits,
loss and every gradient at rate 0 and under att_dropout with the JAX
model's per-block seeds captured, and one train step; the train loop at
that N; --remat_policy (equal losses and grads across the three policies,
and the attention-forward dispatches a block: 2, 2 and 1); the
long-context ladder's CPU row; and (on a card, `-m gpu`) the tiny model on
the card against the CPU.

JAX is imported inside the tests that use it; inputs come from numpy seeds
and cross between the packages as numpy.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint.convert import opt_state_from_jax, params_from_jax
from vitax_torch.config import REMAT_POLICIES, Config, build_parser
from vitax_torch.models.vit import DropoutSeeds, build_model, remat_block
from vitax_torch.ops import _build
from vitax_torch.ops import attention as attention_module
from vitax_torch.ops import flash_blocked
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.state import TrainState, build_optimizer
from vitax_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# N = (96 / 2)^2 = 2304 > MAX_SEQ_IN_VMEM: the streaming path in both packages
LONG = dict(image_size=96, patch_size=2, embed_dim=32, num_heads=2, num_blocks=2, num_classes=8, dtype="float32")
BATCH = 2


def _flat(tree):
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _images(n, seed, side=96, classes=8):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, side, side, 3)).astype(np.float32), rng.integers(0, classes, size=(n,))


def _capture(impl, seeds: list):
    """Record each call's uint32 dropout seed of the JAX impl
    (jax.debug.callback; a remat recompute calls it again)."""
    import jax
    inner = impl.vitax_dropout

    def drop(q, k, v, seed):
        jax.debug.callback(lambda s: seeds.append(int(s)), seed)
        return inner(q, k, v, seed)

    impl.vitax_dropout = drop
    return impl


def _distinct(xs):
    out = []
    for x in xs:
        if x not in out:
            out.append(x)
    return out


@pytest.fixture(scope="module")
def jax_params():
    """The tiny N 2304 model's JAX init, once for the module (from the
    dense-core model: the same tree, no kernel in the init trace)."""
    import jax
    import jax.numpy as jnp
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    return jax_build_model(JaxConfig(**LONG).validate()).init(jax.random.key(0), jnp.zeros((1, 96, 96, 3)), True)


@pytest.mark.parametrize("att_dropout", [0.0, 0.2])
def test_long_context_model_matches_jax(jax_params, att_dropout):
    """N 2304, f32: the JAX model on its streaming kernels (A4, A5a, A5b in
    interpret mode, scanned blocks) and the port on its streaming entries
    (under per-block recompute) from the same weights: logits within 1e-4, the loss within
    2e-5 and every gradient within rtol 1e-4 / atol 1e-6 (the bars of
    tests/test_torch_dropout.py); under dropout with the JAX model's
    per-block seeds."""
    import jax
    import jax.numpy as jnp
    import optax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    dims = dict(LONG, att_dropout=att_dropout)
    jcfg = JaxConfig(**dims, grad_ckpt=False).validate()       # the port keeps its remat: same grads
    assert jcfg.num_patches == 2304
    seeds = []
    jimpl = jax_make_attention_impl(jcfg, None, True)
    assert "streaming" in jimpl.vitax_name
    if att_dropout:
        jimpl = _capture(jimpl, seeds)
    jmodel = jax_build_model(jcfg, attention_impl=jimpl)
    params = jax_params
    x, labels = _images(BATCH, seed=50)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x), not att_dropout, rngs={"dropout": jax.random.key(7)})
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jax.effects_barrier()

    cfg = Config(**dims).validate()
    impl = make_attention_impl(cfg, "cpu")
    assert impl.vitax_name == "streaming"
    model = build_model(cfg, "cpu", attention_impl=impl, init=False)
    model.load_state_dict(params_from_jax(_flat(params)), strict=True, assign=True)
    model.train()
    block_seeds = _distinct(seeds)
    assert len(block_seeds) == (cfg.num_blocks if att_dropout else 0)
    before = dict(_build.LAUNCHES)
    logits = model(torch.from_numpy(x), DropoutSeeds(blocks=tuple(block_seeds)) if att_dropout else None)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert _build.LAUNCHES == before
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    want = params_from_jax(_flat(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_long_context_train_step_matches_jax():
    """One train step at N 2304 from one state (the JAX make_train_step on
    its streaming kernels, one device): the loss within rtol 2e-4 / atol
    2e-5 and every param within rtol 2e-3 / atol 2e-5 (the bars of
    tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.ops.attention import make_attention_impl as jax_make_attention_impl
    from vitax.ops.fused_optimizer import find_adam_state
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    from vitax.train.step import make_train_step as jax_make_train_step
    dims = dict(LONG, batch_size=BATCH, warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
    jcfg = JaxConfig(**dims).validate()
    mesh = build_mesh(jcfg, devices=jax.devices()[:1])
    jmodel = jax_build_model(jcfg, attention_impl=jax_make_attention_impl(jcfg, None, True))
    tx, schedule = jax_build_optimizer(jcfg, max_iteration=10)
    jstate, sspecs, _ = make_train_state(jcfg, jmodel, tx, mesh, jax.random.key(0))

    cfg = Config(**dims).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(_flat(jstate.params)), strict=True, assign=True)
    adam = find_adam_state(jstate.opt_state)
    mu, nu, count = opt_state_from_jax(_flat(adam.mu), _flat(adam.nu), adam.count)
    state = TrainState(step=0, model=model.train(), mu=mu, nu=nu, count=count)

    images, labels = _images(BATCH, seed=51)
    step_fn = jax_make_train_step(jcfg, jmodel, tx, mesh, sspecs, schedule=schedule)
    jstate, m = step_fn(jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))},
                        jax.random.key(1))
    optimizer, _ = build_optimizer(cfg, 10)
    state, metrics = make_train_step(cfg, optimizer, "cpu")(
        state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(metrics["loss"]), float(jax.device_get(m["loss"])), rtol=2e-4, atol=2e-5)
    assert metrics["tokens"] == BATCH * 2304
    want = params_from_jax(_flat(jstate.params))
    got = state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_train_loop_at_long_context_on_cpu(capsys):
    """train() through the normal entry at N 2304 on the CPU: the startup
    log names the streaming core, the loss is finite and nothing
    launches."""
    from vitax_torch.train.loop import train
    cfg = Config(**LONG, batch_size=BATCH, fake_data=True, max_steps=1, warmup_steps=1, log_step_interval=1,
                 test_epoch_interval=10).validate()
    records = []
    before = dict(_build.LAUNCHES)
    train(cfg, "cpu", records=records)
    assert "attention core: streaming on cpu (N 2304)" in capsys.readouterr().out
    assert [r["step"] for r in records if "loss" in r] == [1] and np.isfinite(records[0]["loss"])
    assert _build.LAUNCHES == before


# --- --remat_policy -----------------------------------------------------------


def _count_calls(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("path,att_dropout", [("whole-N", 0.0), ("whole-N", 0.2), ("streaming", 0.0)])
def test_remat_policies_give_equal_grads_and_dispatch_counts(monkeypatch, path, att_dropout):
    """The three policies (and grad_ckpt off) give bitwise equal losses and
    grads; the plain attention forward, which stands for the kernel on the
    CPU, runs 2 times a block under none_saveable and dots_saveable (the
    forward and its recompute) and once under dots_attn_saveable and
    without grad_ckpt."""
    if path == "streaming":
        dims, calls = LONG, _count_calls(monkeypatch, flash_blocked, "streaming_fwd_with_lse")
    else:
        dims = dict(LONG, image_size=16, patch_size=4)
        calls = _count_calls(monkeypatch, attention_module, "attention_fwd_with_lse")
    x, labels = _images(BATCH, seed=52, side=dims["image_size"])
    seeds = DropoutSeeds(blocks=(11, 12)) if att_dropout else None
    results = {}
    for policy, ckpt in [(p, True) for p in REMAT_POLICIES] + [("none_saveable", False)]:
        cfg = Config(**dims, remat_policy=policy, grad_ckpt=ckpt, att_dropout=att_dropout,
                     mlp_dropout=att_dropout).validate()
        model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu")).train()
        calls.clear()
        loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(x), seeds), torch.from_numpy(labels))
        loss.backward()
        results[(policy, ckpt)] = (len(calls), loss.detach(), [p.grad for p in model.parameters()])
    want = {("none_saveable", True): 4, ("dots_saveable", True): 4, ("dots_attn_saveable", True): 2,
            ("none_saveable", False): 2}
    assert {key: r[0] for key, r in results.items()} == want
    _, loss0, grads0 = results[("none_saveable", True)]
    for _, loss, grads in results.values():
        assert torch.equal(loss, loss0)
        assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


def test_remat_policy_unknown_name_raises_naming_the_choices():
    with pytest.raises(ValueError, match="none_saveable, dots_saveable, dots_attn_saveable"):
        Config(remat_policy="everything_saveable").validate()
    model = build_model(Config(**LONG).validate(), "meta")
    with pytest.raises(ValueError, match="none_saveable, dots_saveable, dots_attn_saveable"):
        remat_block(model.blocks[0], torch.zeros(1, 4, 32), None, "dots")


def test_cli_parses_remat_policy_as_the_jax_package_does():
    """--remat_policy takes the JAX parser's choices, defaults to
    none_saveable, and both parsers refuse anything else."""
    from vitax.config import build_parser as jax_build_parser
    assert build_parser().parse_args([]).remat_policy == "none_saveable"
    for policy in REMAT_POLICIES:
        assert build_parser().parse_args(["--remat_policy", policy]).remat_policy == policy
        assert jax_build_parser().parse_args(["--remat_policy", policy]).remat_policy == policy
    for parser in (build_parser(), jax_build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--remat_policy", "dots"])


# --- the ladder -------------------------------------------------------------------


def test_ladder_cpu_row(tmp_path):
    """One streaming row at tiny dims on the CPU, in its own subprocess:
    a JSON row with ms_per_step and error null, the frontier's summary, and
    a file only where --out asks for one."""
    out = tmp_path / "rows.jsonl"
    r = subprocess.run([sys.executable, "-m", "vitax_torch.tools.long_context_ladder", "--device", "cpu",
                        "--embed_dim", "32", "--num_heads", "2", "--num_blocks", "1", "--patch_size", "4",
                        "--dense_n", "0", "--ns", "16", "--frontier", "--steps", "1", "--out", str(out)],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    row, summary = lines
    assert row["n"] == 16 and row["dense"] is False and row["error"] is None and row["ms_per_step"] > 0
    assert summary == {"frontier": [], "largest_n_within_limits": None, "stopped_by": None, "max_step_s": 10.0}
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == [row]


# --- on the card (`-m gpu`) -------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("att_dropout", [0.0, 0.2])
def test_long_context_model_on_card_matches_cpu(att_dropout):
    """The tiny N 2304 model in f32 on the card (the streaming kernels, one
    forward, one recompute and one backward launch a block) against the
    same weights on the CPU (the plain versions): logits and loss within
    1e-4 and every gradient within 1e-3 of its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(**LONG, att_dropout=att_dropout).validate()
    x, labels = _images(BATCH, seed=53)
    seeds = DropoutSeeds(blocks=(21, 22)) if att_dropout else None
    out = []
    for device in ("cpu", "cuda"):
        model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, device)).to(device).train()
        before = dict(_build.LAUNCHES)
        logits = model(torch.from_numpy(x).to(device), seeds)
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).to(device))
        loss.backward()
        moved = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        out.append((logits.detach().cpu(), loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                    moved))
    (l_cpu, loss_cpu, g_cpu, moved_cpu), (l_gpu, loss_gpu, g_gpu, moved_gpu) = out
    suffix = "_drop" if att_dropout else ""
    assert moved_cpu == {} and moved_gpu == {f"flash_attn_fwd_stream{suffix}": 4, f"flash_attn_bwd_stream{suffix}": 2,
                                             "flash_attn_fwd_general": 4,     # f32, Dh 16
                                             "flash_attn_bwd_general": 2}
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
    assert abs(loss_gpu - loss_cpu) <= 1e-4
    for name, g in g_cpu.items():
        assert (g_gpu[name] - g).abs().max() <= 1e-3 * g.abs().max() + 1e-7, name
