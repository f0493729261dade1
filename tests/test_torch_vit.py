"""vitax_torch model: logits against the JAX model on the same weights
(carried across by checkpoint/convert.py, both block layouts), the 10B
param count on the meta device, init statistics, config parity, and input
normalisation. Small sizes; inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitax.checkpoint.consolidate import flatten_tree
from vitax.config import Config as JaxConfig
from vitax.config import build_parser as jax_build_parser
from vitax.models import build_model as jax_build_model
from vitax.models.vit import expected_param_count as jax_expected_param_count
from vitax.train.step import prepare_images as jax_prepare_images
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config, build_parser
from vitax_torch.models.vit import INIT_BOUND, build_model, count_params, expected_param_count
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.step import prepare_images

TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4)


def jax_params(dtype: str, scan_blocks: bool, seed: int = 0):
    cfg = JaxConfig(**TINY, dtype=dtype, scan_blocks=scan_blocks, grad_ckpt=False).validate()
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 16, 16, 3), jnp.float32), True)
    return model, params


def port_model(params, dtype: str, use_flash: bool = True):
    cfg = Config(**TINY, dtype=dtype, use_flash_attention=use_flash).validate()
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=False)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    model.load_state_dict(params_from_jax(flat), strict=True, assign=True)
    return model


def images_np(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("scan_blocks", [True, False])
def test_logits_match_jax_f32(scan_blocks, use_flash):
    """f32 logits within rtol/atol 1e-4 (the bar of tests/test_torch_parity.py)."""
    jmodel, params = jax_params("float32", scan_blocks)
    x = images_np()
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), True))
    with torch.inference_mode():
        got = port_model(params, "float32", use_flash)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_logits_match_jax_bf16(scan_blocks):
    """bf16 compute over f32 params: the two frameworks round activations at
    the same cast points but in other orders, so logits agree to a few bf16
    ulps of the activations: max|d| <= 2e-2 * max|logits| + 1e-3."""
    jmodel, params = jax_params("bfloat16", scan_blocks)
    x = images_np(seed=2)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), True), np.float32)
    with torch.inference_mode():
        got = port_model(params, "bfloat16")(torch.from_numpy(x))
    assert got.dtype == torch.float32      # the head computes in f32
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max() + 1e-3


def test_convert_layouts():
    """Scanned and unscanned trees give the same state_dict; conv and Dense
    kernels change layout, pos_embed does not."""
    _, scanned = jax_params("float32", True)
    sd = params_from_jax({k: np.asarray(v) for k, v in flatten_tree(jax.device_get(scanned)).items()})
    p = jax.device_get(scanned)["params"]
    np.testing.assert_array_equal(sd["patch_embed.proj.weight"].numpy(),
                                  np.asarray(p["patch_embed"]["proj"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["blocks.1.mlp.fc1.weight"].numpy(),
                                  np.asarray(p["blocks"]["mlp"]["fc1"]["kernel"][1]).T)
    np.testing.assert_array_equal(sd["blocks.0.norm1.weight"].numpy(), np.asarray(p["blocks"]["norm1"]["scale"][0]))
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), np.asarray(p["pos_embed"]))
    unscanned = {"params/" + k.replace("blocks/", f"blocks_{i}/", 1): np.asarray(v)[i]
                 for k, v in flatten_tree(p).items() if k.startswith("blocks/") for i in range(2)}
    unscanned.update({"params/" + k: np.asarray(v) for k, v in flatten_tree(p).items()
                      if not k.startswith("blocks/")})
    sd2 = params_from_jax(unscanned)
    assert sd.keys() == sd2.keys()
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax({**unscanned, "params/extra/kernel": np.zeros((2, 2))})


def test_meta_param_count_is_the_10b_flagship():
    cfg = Config().validate()
    model = build_model(cfg, "meta")
    assert count_params(model) == expected_param_count(cfg) == 10_077_917_160
    assert expected_param_count(cfg) == jax_expected_param_count(JaxConfig())
    assert all(p.device.type == "meta" for p in model.parameters())


def test_init_statistics():
    """timm init: trunc-normal std 0.02 truncated at +/-2 sigma (measured std
    0.02 * 0.8796 = 0.0176), zero biases, LayerNorm ones/zeros; seeded."""
    cfg = Config(image_size=32, patch_size=8, embed_dim=256, num_heads=4, num_blocks=2,
                 num_classes=10, seed=3).validate()
    model = build_model(cfg, "cpu")
    weights = [m.weight for m in model.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    flat = torch.cat([w.detach().flatten() for w in weights] + [model.pos_embed.detach().flatten()])
    assert flat.abs().max().item() <= INIT_BOUND
    assert abs(flat.std().item() - 0.0176) <= 1e-3
    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            assert not m.bias.any()
        if isinstance(m, torch.nn.LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and not m.bias.any()
    again = build_model(cfg, "cpu")
    other = build_model(Config(**{**cfg.__dict__, "seed": 4}), "cpu")
    assert torch.equal(again.blocks[1].mlp.fc2.weight, model.blocks[1].mlp.fc2.weight)
    assert not torch.equal(other.blocks[1].mlp.fc2.weight, model.blocks[1].mlp.fc2.weight)


def test_parser_matches_jax_parser():
    argv = ["--embed_dim", "64", "--num_heads", "4", "--num_blocks", "3", "--dtype", "float32",
            "--no_flash_attention", "--serve_topk", "3", "--serve_max_batch", "16",
            "--max_batch_wait_ms", "2.5", "--serve_brownout_enter_frac", "0.5"]
    ours = vars(build_parser().parse_args(argv))
    theirs = vars(jax_build_parser().parse_args(argv))
    defaults = vars(build_parser().parse_args([]))
    jax_defaults = vars(jax_build_parser().parse_args([]))
    for name in Config.__dataclass_fields__:
        assert ours[name] == theirs[name], name
        assert defaults[name] == jax_defaults[name] == getattr(JaxConfig(), name), name


@pytest.mark.parametrize("bad", [dict(embed_dim=30), dict(serve_max_batch=6), dict(dtype="float16"),
                                 dict(serve_brownout_exit_frac=0.9), dict(image_size=20)])
def test_validate_rejects(bad):
    with pytest.raises(ValueError):
        Config(**bad).validate()


def test_prepare_images_matches_jax():
    x = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = prepare_images(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_prepare_images(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    f = torch.zeros(1, 2, 2, 3)
    assert prepare_images(f) is f
