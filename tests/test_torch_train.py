"""vitax_torch training: the train step against the JAX package's
make_train_step from one state carried across (params_from_jax,
opt_state_from_jax), in the arms grad_ckpt on and off, grad_accum_steps 2
and a clip that triggers; the eval counts; the sampler order;
the FLOP counts; the config's later-slice refusals; the loader; and the
CLI. Tiny dims, float32, inputs from numpy seeds. The JAX side runs on the
8-device CPU mesh of tests/conftest.py, as tests/test_torch_parity.py does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitax_torch.checkpoint.convert import opt_state_from_jax, params_from_jax
from vitax_torch.config import Config
from vitax_torch.data.loader import LoaderWorkerError, ShardedLoader, ShardedSampler, build_datasets
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.telemetry import flops
from vitax_torch.train.state import TrainState, build_optimizer
from vitax_torch.train.step import _microbatch_split, make_eval_step, make_train_step
from vitax_torch.utils.metrics import SmoothedValue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=8,
            batch_size=16, dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1,
            clip_grad_norm=1.0)
MAX_ITER, N_STEPS = 10, 4


def _flat(tree):
    import jax
    from vitax.checkpoint.consolidate import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((TINY["batch_size"], 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], size=(TINY["batch_size"],))
    return images, labels


def _jax_setup(**arm):
    import jax
    from vitax.config import Config as JaxConfig
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.mesh import build_mesh
    from vitax.train.state import build_optimizer as jax_build_optimizer
    from vitax.train.state import make_train_state
    cfg = JaxConfig(**{**TINY, **arm}, scan_blocks=False, fsdp_size=2, dp_size=4).validate()
    mesh = build_mesh(cfg)
    model = jax_build_model(cfg)
    tx, schedule = jax_build_optimizer(cfg, max_iteration=MAX_ITER)
    state, sspecs, _ = make_train_state(cfg, model, tx, mesh, jax.random.key(0))
    return cfg, mesh, model, tx, schedule, state, sspecs


def _port_state(jax_state, **arm):
    from vitax.ops.fused_optimizer import find_adam_state
    cfg = Config(**{**TINY, **arm}).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    model.load_state_dict(params_from_jax(_flat(jax_state.params)), strict=True, assign=True)
    adam = find_adam_state(jax_state.opt_state)
    mu, nu, count = opt_state_from_jax(_flat(adam.mu), _flat(adam.nu), adam.count)
    assert all(p.requires_grad for p in model.parameters())
    return cfg, TrainState(step=0, model=model.train(), mu=mu, nu=nu, count=count)


@pytest.mark.parametrize("arm", [dict(grad_ckpt=False), dict(grad_ckpt=True),
                                 dict(grad_ckpt=True, grad_accum_steps=2),
                                 dict(grad_ckpt=True, clip_grad_norm=1e-2)],
                         ids=["no_ckpt", "ckpt", "ckpt_accum2", "ckpt_clip_triggers"])
def test_train_step_matches_jax(devices8, arm):
    """4 steps with warmup_steps=2 from one state: losses within rtol 2e-4 /
    atol 2e-5 and every param within rtol 2e-3 / atol 2e-5 (the bars of
    tests/test_torch_parity.py). The port's attention is flash4_with_lse
    (plain forward and backward on the CPU), the JAX model's the dense
    core, so the test also holds the custom backward inside the model."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from vitax.parallel.mesh import batch_pspec
    from vitax.train.step import make_train_step as jax_make_train_step

    jcfg, mesh, jmodel, tx, jschedule, jstate, sspecs = _jax_setup(**arm)
    cfg, state = _port_state(jstate, **arm)
    images, labels = _batch()
    sh = NamedSharding(mesh, batch_pspec())
    jbatch = {"image": jax.device_put(jnp.asarray(images), sh),
              "label": jax.device_put(jnp.asarray(labels.astype(np.int32)), sh)}
    step_fn = jax_make_train_step(jcfg, jmodel, tx, mesh, sspecs, schedule=jschedule)
    want_losses = []
    for _ in range(N_STEPS):
        jstate, m = step_fn(jstate, jbatch, jax.random.key(1))
        want_losses.append(float(jax.device_get(m["loss"])))

    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    train_step = make_train_step(cfg, optimizer, "cpu")
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    got_losses, norms = [], []
    for i in range(N_STEPS):
        state, metrics = train_step(state, batch)
        got_losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        assert metrics["lr_step"] == state.step == i + 1 and int(state.count) == i + 1
        assert metrics["grad_norm"].dim() == 0
    if "clip_grad_norm" in arm:
        assert min(norms) > cfg.clip_grad_norm          # the clip scales every step's grads
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-4, atol=2e-5)
    assert got_losses[-1] < got_losses[0]
    want = params_from_jax(_flat(jstate.params))
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=name)


def test_eval_step_matches_jax(devices8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from vitax.parallel.mesh import batch_pspec
    from vitax.train.step import make_eval_step as jax_make_eval_step

    jcfg, mesh, jmodel, _, _, jstate, sspecs = _jax_setup()
    cfg, state = _port_state(jstate)
    images, _ = _batch(seed=1)
    with torch.no_grad():
        logits = state.model(torch.from_numpy(images))
    # labels that hit top-1 for some samples and top-5 for others
    order = logits.argsort(dim=-1, descending=True).numpy()
    labels = np.where(np.arange(len(images)) % 3 == 0, order[:, 0],
                      np.where(np.arange(len(images)) % 3 == 1, order[:, 3], order[:, 7]))
    sh = NamedSharding(mesh, batch_pspec())
    jbatch = {"image": jax.device_put(jnp.asarray(images), sh),
              "label": jax.device_put(jnp.asarray(labels.astype(np.int32)), sh)}
    want = jax_make_eval_step(jcfg, jmodel, mesh, sspecs)(jstate, jbatch)
    got = make_eval_step(cfg)(state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert int(got["correct"]) == int(want["correct"]) == 6
    assert int(got["correct_top5"]) == int(want["correct_top5"]) == 11


def test_microbatch_split_is_strided():
    x = torch.arange(12)
    mbs = _microbatch_split({"image": x, "label": x * 10}, 3)
    assert [mb["image"].tolist() for mb in mbs] == [[0, 3, 6, 9], [1, 4, 7, 10], [2, 5, 8, 11]]
    assert mbs[1]["label"].tolist() == [10, 40, 70, 100]


def test_grad_ckpt_gives_the_same_grads():
    cfg = Config(**TINY).validate()
    images, labels = _batch(seed=2)
    grads = []
    for ckpt in (False, True):
        model = build_model(Config(**{**TINY, "grad_ckpt": ckpt}), "cpu",
                            attention_impl=make_attention_impl(cfg, "cpu"))
        loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(images)), torch.from_numpy(labels))
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("length,batch,seed,epoch,rank,count", [
    (1000, 32, 0, 1, 0, 1), (1000, 32, 3, 2, 1, 4), (97, 8, 5, 7, 3, 4), (50_000, 1024, 0, 0, 0, 1)])
def test_sampler_matches_jax(length, batch, seed, epoch, rank, count):
    from vitax.data.loader import ShardedSampler as JaxSampler
    for shuffle in (True, False):
        ours = ShardedSampler(length, batch, shuffle, seed, process_index=rank, process_count=count)
        theirs = JaxSampler(length, batch, shuffle, seed, process_index=rank, process_count=count)
        assert ours.steps_per_epoch == theirs.steps_per_epoch
        np.testing.assert_array_equal(ours.epoch_indices(epoch), theirs.epoch_indices(epoch))


def test_loader_batches_and_worker_errors():
    cfg = Config(**{**TINY, "fake_data": True}).validate()
    _, train_loader, val_ds, val_loader = build_datasets(cfg, torch.device("cpu"))
    assert len(val_ds) == 50_000 and val_loader.steps_per_epoch == 50_000 // 16
    it = train_loader.epoch(1)
    batch = next(it)
    it.close()
    assert batch["image"].shape == (16, 16, 16, 3) and batch["image"].dtype == torch.float32
    assert batch["label"].dtype == torch.int64 and not batch["label"].any()

    class Broken:
        def __getitem__(self, i):
            if i == 5:
                raise OSError("bad sample 5")
            return np.zeros((2, 2, 3), np.float32), 0

    loader = ShardedLoader(Broken(), ShardedSampler(16, 4, False, 0), torch.device("cpu"), num_workers=2)
    with pytest.raises(LoaderWorkerError, match="bad sample 5"):
        list(loader.epoch(0))
    with pytest.raises(FileNotFoundError, match="ImageFolder split directory not found: /datasets/imagenet-1k/train"):
        build_datasets(Config(**TINY), torch.device("cpu"))


@pytest.mark.parametrize("bad,match", [(dict(att_dropout=1.0), "dropout"), (dict(pos_dropout=-0.1), "dropout"),
                                       (dict(tp_size=-2), "mesh"), (dict(pp_size=2, tp_size=2), "mesh"),
                                       (dict(keep_checkpoints=-1), "checkpoint"),
                                       (dict(grad_accum_steps=3), "grad_accum"),
                                       (dict(fused_optimizer="maybe"), "fused_optimizer")])
def test_validate_rejects_what_this_slice_cannot_run(bad, match):
    with pytest.raises(ValueError, match=match):
        Config(**{**TINY, **bad}).validate()


def test_plain_update_is_refused_on_the_card():
    """--fused_optimizer off names the plain update, which never runs on the
    card: building the step for a CUDA device raises before any launch."""
    cfg = Config(**{**TINY, "fused_optimizer": "off"}).validate()
    optimizer, _ = build_optimizer(cfg, MAX_ITER)
    with pytest.raises(ValueError, match="fused_optimizer off"):
        make_train_step(cfg, optimizer, torch.device("cuda"))
    make_train_step(cfg, optimizer, "cpu")


def test_flops_match_jax():
    from vitax.config import Config as JaxConfig
    from vitax.telemetry import flops as jax_flops
    for dims in (TINY, dict(num_blocks=8, batch_size=32), {}):
        ours, theirs = Config(**dims), JaxConfig(**dims)
        assert flops.model_flops_per_image(ours) == jax_flops.model_flops_per_image(theirs)
        assert flops.model_flops_per_step(ours) == jax_flops.model_flops_per_step(theirs)
        assert flops.mfu(ours, 0.5, 1, 989.0) == jax_flops.mfu(theirs, 0.5, 1, 989.0)
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0 and flops.peak_tflops("cpu") == 1.0


def test_smoothed_value_matches_jax():
    from vitax.utils.metrics import SmoothedValue as JaxSmoothed
    ours, theirs = SmoothedValue(window_size=3), JaxSmoothed(window_size=3)
    for i, v in enumerate([3.0, 1.0, 4.0, 1.0, 5.0, 9.0]):
        ours.update(v, batch_size=i + 1)
        theirs.update(v, batch_size=i + 1)
        assert (ours.median, ours.avg, ours.global_avg, ours.get_latest(), ours.count) == \
            (theirs.median, theirs.avg, theirs.global_avg, theirs.get_latest(), theirs.count)


def _cli(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "vitax_torch.train", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_trains_on_cpu():
    r = _cli("--device", "cpu", "--fake_data", "--image_size", "16", "--patch_size", "8",
             "--embed_dim", "32", "--num_heads", "2", "--num_blocks", "2", "--num_classes", "4",
             "--batch_size", "8", "--max_steps", "3", "--log_step_interval", "1",
             "--warmup_steps", "1", "--test_epoch_interval", "1", "--eval_max_batches", "1")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for step in (1, 2, 3):
        assert f"epoch 1 step {step}, lr: " in r.stdout
    assert "sec/iter: " in r.stdout and "accuracy on val: " in r.stdout


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device would train on it")
    r = _cli("--fake_data", "--num_blocks", "1")
    assert r.returncode != 0
    assert "no CUDA card is available" in r.stderr and "--device cpu" in r.stderr
    r = _cli("--device", "cpu", "--fake_data", "--att_dropout", "1.0")
    assert r.returncode != 0 and "dropout" in r.stderr
