"""vitax_torch's mesh, placement rules, shard seeds and precision flags,
held to the JAX package's functions on the same inputs:

- resolve_mesh_shape against vitax's over a table of (dp, fsdp,
  run_without_fsdp, device count), the raising cases with vitax's message;
- every leaf's fsdp dim against vitax's rule_pspec on the same
  tiny config: the port's shard of each torch leaf holds the same elements
  as vitax's shard of the flax leaf, mapped through
  vitax_torch/checkpoint/convert.py params_to_jax;
- fold_shard_seed against vitax's under shard_map, bit for bit;
- the FSDP and precision flags: parsed as vitax's parser parses them, the
  same properties, the same configs refused;
- the process-group bring-up refusing to run alone.
No process group is formed here (tests/test_torch_fsdp.py spawns them).
"""

import os
import socket

import numpy as np
import pytest
import torch

from vitax_torch import distributed
from vitax_torch.checkpoint.convert import params_to_jax
from vitax_torch.config import Config, build_parser
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import fold_shard_seed
from vitax_torch.parallel.mesh import resolve_mesh_shape
from vitax_torch.parallel.rules import rule_pspec
from vitax_torch.parallel.sharding import placement

TINY = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4, num_blocks=2, num_classes=10)


def _jax_cfg(**kw):
    from vitax.config import Config as JaxConfig
    return JaxConfig(**{**TINY, **kw})


MESH_CASES = [
    # (dp, fsdp, run_without_fsdp, devices)
    (1, -1, False, 1), (1, -1, False, 2), (1, -1, False, 8), (2, -1, False, 8), (-1, 2, False, 8),
    (1, 1, True, 4), (1, -1, True, 4), (2, 1, True, 4), (-1, 1, True, 8), (4, 2, False, 8),
    # refused
    (-1, -1, False, 8), (3, -1, False, 8), (2, 2, False, 8), (1, 2, True, 4), (1, 3, False, 8),
]


@pytest.mark.parametrize("dp,fsdp,no_fsdp,n", MESH_CASES)
def test_resolve_mesh_shape_matches_jax(dp, fsdp, no_fsdp, n):
    from vitax.parallel.mesh import resolve_mesh_shape as jax_resolve
    kw = dict(dp_size=dp, fsdp_size=fsdp, run_without_fsdp=no_fsdp)
    try:
        want = jax_resolve(_jax_cfg(**kw), n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_mesh_shape(Config(**TINY, **kw), n)
        assert str(got.value) == str(e)
        return
    assert resolve_mesh_shape(Config(**TINY, **kw), n) == want


def _jax_leaf_specs(cfg, mesh_shape):
    """{flax key: PartitionSpec} of vitax's rule_pspec over the unscanned
    tree of cfg, keyed as params_to_jax keys it."""
    import jax
    from vitax.models import build_model as jax_build_model
    from vitax.parallel.rules import _leaf_path_names
    from vitax.parallel.rules import rule_pspec as jax_rule_pspec
    model = jax_build_model(cfg)
    x = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    abstract = jax.eval_shape(lambda r: model.init(r, x, True), jax.random.key(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        names = _leaf_path_names(path)
        out["/".join(names)] = (leaf.shape, jax_rule_pspec(names, leaf.shape, cfg, mesh_shape, False))
    return out


def _shard_sets(t: torch.Tensor, dim, n: int):
    """The element values of each of the n chunks of `t` along `dim` (the
    whole tensor when it is not sharded)."""
    if dim is None:
        return [frozenset(t.reshape(-1).tolist())]
    return [frozenset(c.reshape(-1).tolist()) for c in torch.chunk(t, n, dim=dim)]


@pytest.mark.parametrize("mesh_shape,kw", [((1, 2, 1, 1, 1, 1), {}), ((2, 4, 1, 1, 1, 1), {}),
                                           ((1, 8, 1, 1, 1, 1), {}), ((2, 1, 1, 1, 1, 1), dict(run_without_fsdp=True)),
                                           ((1, 4, 1, 1, 1, 1), {})],
                         ids=["fsdp2", "dp2_fsdp4", "fsdp8", "dp", "fsdp4"])
def test_rule_pspec_shards_the_elements_vitax_shards(mesh_shape, kw):
    """For each leaf, the port's fsdp dim (torch layout) splits the leaf
    into the same sets of elements as vitax's fsdp dim splits the flax
    leaf: every leaf of a tiny config, its elements numbered in the torch
    layout and carried to the flax one by params_to_jax."""
    cfg = Config(**TINY, **kw)
    jax_specs = _jax_leaf_specs(_jax_cfg(scan_blocks=False, **kw), mesh_shape)
    model = build_model(cfg, "meta")
    numbered, offset = {}, 0
    for name, p in model.named_parameters():
        numbered[name] = torch.arange(offset, offset + p.numel(), dtype=torch.float64).reshape(p.shape)
        offset += p.numel()
    flax = params_to_jax(numbered, scanned=False)
    assert sorted(jax_specs) == sorted(flax)
    for name, t in numbered.items():
        spec = rule_pspec(name, tuple(t.shape), mesh_shape[1])
        key = next(k for k, v in flax.items() if torch.equal(v.reshape(-1).sort().values, t.reshape(-1)))
        shape, jspec = jax_specs[key]
        assert tuple(flax[key].shape) == tuple(shape)
        ours = spec.index("fsdp") if "fsdp" in spec else None
        theirs = list(jspec).index("fsdp") if "fsdp" in tuple(jspec) else None
        assert (ours is None) == (theirs is None), (name, spec, jspec)
        n = mesh_shape[1]
        assert _shard_sets(t, ours, n) == _shard_sets(flax[key], theirs, n), (name, spec, jspec)


def test_rule_dims_of_the_flagship_leaves():
    """The torch dims the rules give the 10B leaves under fsdp 4: qkv, proj,
    fc1 and the conv on dim 0, fc2 and the head on dim 1, pos_embed on 2,
    biases and LayerNorm params on 0; an indivisible leaf has none, and
    FSDP2 takes Shard(0) for it."""
    model = build_model(Config(), "meta")
    dims = {n: rule_pspec(n, tuple(p.shape), 4).index("fsdp") for n, p in model.named_parameters()
            if "blocks." not in n or n.startswith("blocks.0.")}
    assert dims == {"patch_embed.proj.weight": 0, "patch_embed.proj.bias": 0, "pos_embed": 2,
                    "blocks.0.norm1.weight": 0, "blocks.0.norm1.bias": 0, "blocks.0.attn.qkv.weight": 0,
                    "blocks.0.attn.qkv.bias": 0, "blocks.0.attn.proj.weight": 0, "blocks.0.attn.proj.bias": 0,
                    "blocks.0.norm2.weight": 0, "blocks.0.norm2.bias": 0, "blocks.0.mlp.fc1.weight": 0,
                    "blocks.0.mlp.fc1.bias": 0, "blocks.0.mlp.fc2.weight": 1, "blocks.0.mlp.fc2.bias": 0,
                    "norm.weight": 0, "norm.bias": 0, "head.weight": 1, "head.bias": 0}
    assert rule_pspec("head.bias", (7,), 4) == (None,)
    assert placement("head.bias", (7,), 4).dim == 0
    assert placement("blocks.0.mlp.fc2.weight", (64, 256), 4).dim == 1
    with pytest.raises(ValueError, match="Partition rule not found"):
        rule_pspec("blocks.0.attn.temperature", (4,), 4)


def test_fold_shard_seed_matches_jax_bitwise(devices8):
    """vitax folds the linearized shard index over the batch axes of size >
    1 into the seed inside shard_map; the port folds the rank's batch shard
    index, the same linearization. Every shard of a (dp 2, fsdp 4) and a
    (1, 8) mesh, at seeds across the uint32 range."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from vitax.ops.attention import fold_shard_seed as jax_fold
    from vitax.parallel.mesh import shard_map
    seeds = [0, 1, 12345, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 2024]
    for dp, fsdp in ((2, 4), (1, 8)):
        mesh = Mesh(np.asarray(devices8).reshape(dp, fsdp), ("dp", "fsdp"))
        axes = tuple(a for a in ("dp", "fsdp") if mesh.shape[a] > 1)
        fold = jax.jit(shard_map(lambda s: jax_fold(mesh, axes, s)[None], mesh, in_specs=P(),
                                 out_specs=P(("dp", "fsdp"))))
        want = np.asarray(fold(jnp.asarray(seeds, jnp.uint32)))          # (shards, seeds)
        for i in range(dp):
            for j in range(fsdp):
                assert [fold_shard_seed(i * fsdp + j, s) for s in seeds] == [int(x) for x in want[i * fsdp + j]]
    assert fold_shard_seed(0, 2024) == 2024


FLAG_LINES = [[], ["--no_reshard_after_forward"], ["--run_without_fsdp"], ["--shard_on_cpu", "--flatten_parameters"],
              ["--param_gather_dtype", "float32"], ["--grad_reduce_dtype", "bfloat16"],
              ["--gather_overlap", "on"], ["--dtype", "float32"], ["--dtype", "float32", "--param_gather_dtype",
                                                                   "float32"],
              ["--dp_size", "2", "--fsdp_size", "4"]]
FSDP_FIELDS = ("reshard_after_forward", "flatten_parameters", "run_without_fsdp", "shard_on_cpu",
               "param_gather_dtype", "grad_reduce_dtype", "gather_overlap", "dtype", "dp_size", "fsdp_size")


@pytest.mark.parametrize("argv", FLAG_LINES, ids=lambda a: " ".join(a) or "defaults")
def test_fsdp_flags_parse_as_in_jax(argv):
    """The FSDP and precision flags parse to vitax's values and defaults,
    with the same resolved gather dtype and comm-cast switch."""
    from vitax.config import build_parser as jax_build_parser
    ours, theirs = build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    for f in FSDP_FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    cfg = Config(**{f: getattr(ours, f) for f in FSDP_FIELDS})
    jcfg = _jax_cfg(**{f: getattr(theirs, f) for f in FSDP_FIELDS})
    assert cfg.resolved_param_gather_dtype == jcfg.resolved_param_gather_dtype
    assert cfg.comm_cast_active == jcfg.comm_cast_active


BAD = [dict(grad_reduce_dtype="bfloat16", dtype="float32"),
       dict(grad_reduce_dtype="bfloat16", param_gather_dtype="float32"),
       dict(param_gather_dtype="bfloat16", dtype="float32"),
       dict(gather_overlap="on", reshard_after_forward=False),
       dict(gather_overlap="on", run_without_fsdp=True),
       dict(gather_overlap="on", grad_ckpt=False),
       dict(gather_overlap="on", remat_policy="dots_saveable"),
       dict(gather_overlap="sometimes"), dict(grad_reduce_dtype="float16")]
GOOD = [dict(), dict(gather_overlap="on"), dict(grad_reduce_dtype="bfloat16"), dict(reshard_after_forward=False),
        dict(run_without_fsdp=True), dict(dtype="float32"), dict(param_gather_dtype="float32"),
        dict(dp_size=2, fsdp_size=4)]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_config_refuses_what_jax_refuses(kw):
    """vitax's validate asserts; the port's raises ValueError, with vitax's
    message where the reason is the same."""
    with pytest.raises(AssertionError) as theirs:
        _jax_cfg(**kw).validate()
    with pytest.raises(ValueError) as ours:
        Config(**TINY, **kw).validate()
    if kw.get("gather_overlap") == "on" and ("grad_ckpt" in kw or "remat_policy" in kw):
        assert str(ours.value) == str(theirs.value)
    else:
        assert str(ours.value).split(":")[0].split(" (")[0] == str(theirs.value).split(":")[0].split(" (")[0]


@pytest.mark.parametrize("kw", GOOD, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_config_accepts_what_jax_accepts(kw):
    _jax_cfg(**kw).validate()
    Config(**TINY, **kw).validate()


@pytest.mark.parametrize("name", ["tp_size", "sp_size", "pp_size"])
def test_other_parallelisms_are_refused_naming_item_11(name):
    with pytest.raises(ValueError, match="item 11"):
        Config(**TINY, **{name: 2}).validate()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_size_without_a_group_raises(monkeypatch):
    """WORLD_SIZE > 1 with its rendezvous variables missing raises; with
    them set but no rank 0 listening, the group does not form and the rank
    refuses to train alone. No group is left behind."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="RANK, MASTER_ADDR, MASTER_PORT are missing"):
        distributed.maybe_initialize("cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("VITAX_DIST_TIMEOUT_S", "1")
    with pytest.raises(RuntimeError, match="refusing to train alone"):
        distributed.maybe_initialize("cpu")
    assert not distributed.is_distributed()
    monkeypatch.delenv("WORLD_SIZE")
    assert distributed.maybe_initialize("cpu") == torch.device("cpu") and not distributed.is_distributed()
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    assert distributed.broadcast_from_process0(7) == 7
    assert os.environ.get("WORLD_SIZE") is None
