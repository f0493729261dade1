"""Vision Transformer in PyTorch: the forward of vitax/models/vit.py.

Same architecture and numerics contract as the Flax model (timm Block
parity): conv patchify, learned pos_embed with no CLS token, pre-norm
blocks (LN eps 1e-5, fused qkv with bias, exact GELU), final LN eps 1e-6,
mean-pool, Linear head. Cast points follow flax's: every Dense and the conv
compute in cfg.dtype over parameters of any stored type (float32 as
initialized, bfloat16 from a half-size export); LayerNorm statistics run in
float32 and its output is cast to cfg.dtype; the head computes in float32.

Blocks are a ModuleList run in a Python loop: eager PyTorch has no scan to
amortize. With grad_ckpt (the default) and grad enabled, each block runs
under torch.utils.checkpoint (non-reentrant) and the backward recomputes
it, the counterpart of the JAX model's per-block remat, with what it keeps
set by cfg.remat_policy (vitax/models/vit.py:317-339; `remat_block`):
none_saveable keeps only the block's input; dots_saveable also keeps every
matmul output (selective checkpointing over aten mm/addmm/bmm), so
the recompute redoes the rest, the attention core included, as in JAX,
where that core is a custom call and no dot; dots_attn_saveable runs the
core between two such regions, so its autograd Function keeps q, k, v, o
and lse and the forward kernel never runs again in the backward. Without
grad (eval, serve) the forward is the plain loop. Module and parameter
names mirror the Flax paths (vitax_torch/checkpoint/convert.py maps one
onto the other).

Dropout (the Flax model's deterministic=False) is on only when the caller
passes `DropoutSeeds`: one uint32 seed a block and one for pos dropout,
the counterpart of the Flax "dropout" rng split per block. Never keyed on
self.training: the eval step and the serve engine pass none and run the
rate-0 kernel. Attention dropout runs in the attention kernels, their mask
a counter hash of the block's seed. The proj, mlp and pos dropouts draw
from a torch.Generator seeded from the seed inside the block (or the
forward, for pos), so a checkpointed block's recompute redraws the same
masks: torch.utils.checkpoint restores only the default generators' states.
Those three masks are torch's draws, not the JAX package's threefry bits.

Quantized serving (build_model with a quant dtype): every Dense site (qkv,
proj, fc1, fc2 with act=True; the head with act=False) is a QuantLinear
holding the int8 or float8_e4m3fn (out, in) weight and its per-channel
float32 `qscale`, and the patchify conv keeps its quantized weight,
dequantized at use. A QuantLinear with a quant_matmul runs the JAX
QuantDense numerics (the dequant_matmul kernel on the card); without one
it runs the JAX engine's dequantize-at-use numerics: (w_q * s) in float32,
then the unchanged Dense in the site's dtype.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from vitax_torch.checkpoint.consolidate import QUANT_TORCH_DTYPES
from vitax_torch.config import REMAT_POLICIES, Config
from vitax_torch.ops.attention import make_dense_dropout, reference_attention
from vitax_torch.ops.dequant_matmul import dequantize_leaf

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# timm _init_vit_weights: trunc-normal std 0.02, truncated at +/-2 sigma
# (absolute bounds +/-0.04; torch's default a=-2, b=2 would be +/-100 sigma).
INIT_STD = 0.02
INIT_BOUND = 2 * INIT_STD


class DropoutSeeds(NamedTuple):
    """The seeds of one dropout forward: one uint32 per block (its attention
    mask's hash seed and its proj/mlp generator's seed) and one for pos
    dropout."""
    blocks: Tuple[int, ...]
    pos: int = 0


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, kept values divided
    by 1 - rate in x's type, dropped ones 0. A no-op without a generator
    or at rate 0."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Quant(NamedTuple):
    """How a quantized model's Dense sites compute: the stored weight dtype
    ("int8" or "float8_e4m3") and the quant_matmul of
    vitax_torch/ops/dequant_matmul.py make_quant_matmul, or None for the
    dequantize-at-use path."""
    dtype: str
    matmul: Optional[Callable] = None


class QuantLinear(nn.Module):
    """The quantized twin of a Dense site (vitax QuantDense): an int8 or
    float8_e4m3fn (out, in) weight and its (out,) float32 qscale, kept as
    buffers, and a float32 bias."""

    def __init__(self, in_features: int, out_features: int, quant: Quant, act: bool, device=None):
        super().__init__()
        self.act = act
        self.quant_matmul = quant.matmul
        self.register_buffer("weight", torch.empty(out_features, in_features,
                                                   dtype=QUANT_TORCH_DTYPES[quant.dtype], device=device))
        self.register_buffer("qscale", torch.empty(out_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.quant_matmul is None:
            w = dequantize_leaf(self.weight, self.qscale[:, None])
            return F.linear(x.to(dtype), w.to(dtype), self.bias.to(dtype))
        y = self.quant_matmul(x, self.weight, self.qscale, act=self.act)
        return y.to(dtype) + self.bias.to(dtype)


class QuantConv2d(nn.Module):
    """The patchify conv of a quantized model: its quantized weight (cout,
    cin, kh, kw) and (cout,) qscale as buffers, dequantized at use."""

    def __init__(self, cin: int, cout: int, patch_size: int, quant: Quant, device=None):
        super().__init__()
        self.register_buffer("weight", torch.empty(cout, cin, patch_size, patch_size,
                                                   dtype=QUANT_TORCH_DTYPES[quant.dtype], device=device))
        self.register_buffer("qscale", torch.empty(cout, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))


class Linear(nn.Linear):
    """flax nn.Dense(dtype=dtype) over stored params: all operands in dtype.
    Every Dense site and LayerNorm is called as a module, so FSDP2 gathers
    its params in the module's forward hook (parallel/sharding.py)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=dtype): f32 statistics, output in dtype."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(dtype)


def _linear(in_features: int, out_features: int, quant: Optional[Quant], act: bool, device) -> nn.Module:
    if quant is None:
        return Linear(in_features, out_features, device=device)
    return QuantLinear(in_features, out_features, quant, act, device=device)


class PatchEmbed(nn.Module):
    """Conv patchify: (B, H, W, 3) -> (B, N, D)."""

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype, quant: Optional[Quant] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.proj = (nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, device=device) if quant is None
                     else QuantConv2d(3, embed_dim, patch_size, quant, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight
        if isinstance(self.proj, QuantConv2d):
            w = dequantize_leaf(w, self.proj.qscale[:, None, None, None])
        w, b = w.to(self.dtype), self.proj.bias.to(self.dtype)
        x = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b, stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection. The core is
    `attention_impl(q, k, v)` on strided (B, N, H, Dh) views of the qkv
    output, or the dense path when it is None. Given a seed at att_dropout
    > 0 the core is the impl's `vitax_dropout` (the dropout kernels), or,
    on the dense path, dense attention with the same hash mask. The block
    calls its three steps (project, core, output) one by one, so that
    `remat_block` can keep the core out of a recomputed region."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attention_impl: Optional[Callable] = None, quant: Optional[Quant] = None, device=None,
                 att_dropout: float = 0.0, proj_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.att_dropout = att_dropout
        self.proj_dropout = proj_dropout
        self.qkv = _linear(dim, 3 * dim, quant, True, device)
        self.proj = _linear(dim, dim, quant, True, device)

    def project(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v (B, N, H, Dh): strided views of the qkv output; the
        backward stacks dq, dk, dv in one copy."""
        b, n, d = x.shape
        return self.qkv(x, self.dtype).view(b, n, 3, self.num_heads, d // self.num_heads).unbind(2)

    def core(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        if seed is None or self.att_dropout == 0.0:
            return (self.attention_impl or reference_attention)(q, k, v)
        drop = getattr(self.attention_impl, "vitax_dropout", None) or make_dense_dropout(self.att_dropout)
        return drop(q, k, v, seed)

    def output(self, out: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n = out.shape[:2]
        return _dropout(self.proj(out.reshape(b, n, -1), self.dtype), self.proj_dropout, gen)


class Mlp(nn.Module):
    """Dense(hidden) -> exact GELU -> Dense(dim)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype, quant: Optional[Quant] = None,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.fc1 = _linear(dim, hidden_dim, quant, True, device)
        self.fc2 = _linear(hidden_dim, dim, quant, True, device)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _dropout(F.gelu(self.fc1(x, self.dtype)), self.dropout, gen)
        return _dropout(self.fc2(x, self.dtype), self.dropout, gen)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype,
                 attention_impl: Optional[Callable] = None, quant: Optional[Quant] = None, device=None,
                 att_dropout: float = 0.0, mlp_dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.mlp_dropout = mlp_dropout
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = Attention(dim, num_heads, dtype, attention_impl, quant, device=device,
                              att_dropout=att_dropout, proj_dropout=mlp_dropout)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, quant, device=device, dropout=mlp_dropout)

    def attention_inputs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The block up to its attention core: norm1 and the qkv projection."""
        return self.attn.project(self.norm1(x, self.dtype))

    def finish(self, x: torch.Tensor, out: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """The block after its attention core `out`: proj, the residuals,
        norm2 and the mlp. The proj and mlp masks come from a generator
        made here from the seed, so a recompute under checkpoint draws them
        again."""
        gen = _generator(seed, x.device) if seed is not None and self.mlp_dropout > 0.0 else None
        x = x + self.attn.output(out, gen)
        return x + self.mlp(self.norm2(x, self.dtype), gen)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """seed: the block's dropout seed, or None (no dropout)."""
        return self.finish(x, self.attn.core(*self.attention_inputs(x), seed), seed)


# F.linear is CompositeImplicitAutograd: the policy sees the mm/addmm it
# decomposes to, never aten.linear itself.
_DOT_OPS = frozenset(getattr(torch.ops.aten, name).default for name in ("mm", "addmm", "bmm"))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saved():
    return create_selective_checkpoint_contexts(_save_dots)


def remat_block(block: Block, x: torch.Tensor, seed: Optional[int], policy: str) -> torch.Tensor:
    """The block under non-reentrant checkpoint, keeping what `policy`
    (one of REMAT_POLICIES) names: its input only, also its matmul
    outputs, or those and the attention core's (q, k, v, o, lse), the core
    then running outside the two recomputed regions."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (expected one of {', '.join(REMAT_POLICIES)})")
    if policy == "none_saveable":
        return checkpoint(block, x, seed, use_reentrant=False)
    if policy == "dots_saveable":
        return checkpoint(block, x, seed, use_reentrant=False, context_fn=_dots_saved)
    q, k, v = checkpoint(block.attention_inputs, x, use_reentrant=False, context_fn=_dots_saved)
    out = block.attn.core(q, k, v, seed)
    return checkpoint(block.finish, x, out, seed, use_reentrant=False, context_fn=_dots_saved)


class VisionTransformer(nn.Module):
    """images (B, H, W, 3) float -> logits (B, num_classes) float32."""

    def __init__(self, cfg: Config, attention_impl: Optional[Callable] = None, quant: Optional[Quant] = None,
                 device=None):
        super().__init__()
        self.dtype = _DTYPES[cfg.dtype]
        self.grad_ckpt = cfg.grad_ckpt
        self.remat_policy = cfg.remat_policy
        self.quant = quant
        self.pos_dropout = cfg.pos_dropout
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d, self.dtype, quant, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, d, device=device))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, self.dtype, attention_impl, quant, device=device,
                  att_dropout=cfg.att_dropout, mlp_dropout=cfg.mlp_dropout)
            for _ in range(cfg.num_blocks))
        self.norm = LayerNorm(d, eps=1e-6, device=device)
        self.head = _linear(d, cfg.num_classes, quant, False, device)

    def forward(self, images: torch.Tensor, seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """seeds: DropoutSeeds for a dropout forward (training), None for
        none (eval, serve)."""
        x = self.patch_embed(images) + self.pos_embed.to(self.dtype)
        if seeds is not None:
            if len(seeds.blocks) != len(self.blocks):
                raise ValueError(f"{len(seeds.blocks)} dropout seeds for {len(self.blocks)} blocks")
            if self.pos_dropout > 0.0:
                x = _dropout(x, self.pos_dropout, _generator(seeds.pos, x.device))
        remat = self.grad_ckpt and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            seed = None if seeds is None else seeds.blocks[i]
            x = remat_block(block, x, seed, self.remat_policy) if remat else block(x, seed)
        x = self.norm(x, self.dtype).mean(dim=1)
        return self.head(x, torch.float32)


def _trunc_normal(t: torch.Tensor, gen: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=INIT_STD, a=-INIT_BOUND, b=INIT_BOUND, generator=gen)


def _zeros(t: torch.Tensor, gen: torch.Generator) -> None:
    nn.init.zeros_(t)


def _ones(t: torch.Tensor, gen: torch.Generator) -> None:
    nn.init.ones_(t)


def init_leaves(model: nn.Module) -> Iterator[Tuple[nn.Parameter, Callable[[torch.Tensor, torch.Generator], None]]]:
    """(param, fill) for every parameter in init order, fill(tensor,
    generator) filling a tensor of the param's shape in place: timm's
    trunc-normal(0.02, +/-2 sigma) conv/Linear weights and pos_embed (the
    only draws), zero biases, LayerNorm ones/zeros. init_params and the
    sharded init (parallel/sharding.py init_sharded) both walk it."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            yield module.weight, _trunc_normal
            yield module.bias, _zeros
        elif isinstance(module, nn.LayerNorm):
            yield module.weight, _ones
            yield module.bias, _zeros
    if isinstance(model, VisionTransformer):
        yield model.pos_embed, _trunc_normal


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """timm init in place, leaf by leaf in init_leaves' order."""
    for param, fill in init_leaves(model):
        fill(param, generator)


def build_model(cfg: Config, device, attention_impl: Optional[Callable] = None,
                init: bool = True, quant: Optional[Quant] = None) -> VisionTransformer:
    """The ViT on `device`, built without a throwaway default init: the
    modules are made on the meta device, then given storage on `device`.
    init=True fills the params from cfg.seed (float32, as vitax initializes
    them); init=False leaves them to a load_state_dict(..., assign=True).
    On the meta device the params stay shapes only (param counts). With
    `quant` every Dense site is a QuantLinear and the conv a QuantConv2d,
    whose weights come from a quantized state (init must be False)."""
    device = torch.device(device)
    if quant is not None and init:
        raise ValueError("a quantized model takes its weights from a quantized state: pass init=False")
    model = VisionTransformer(cfg, attention_impl, quant, device="meta")
    if device.type == "meta" or not init:
        return model.eval()
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    init_params(model, gen)
    return model.eval()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def expected_param_count(cfg: Config) -> int:
    """Closed-form parameter count (vitax/models/vit.py expected_param_count):
    10,077,917,160 at default flags."""
    d = cfg.embed_dim
    h = cfg.mlp_hidden_dim
    per_block = d * 3 * d + 3 * d + d * d + d + d * h + h + h * d + d + 2 * (2 * d)
    patch = 3 * cfg.patch_size * cfg.patch_size * d + d
    return per_block * cfg.num_blocks + patch + cfg.num_patches * d + 2 * d + d * cfg.num_classes + cfg.num_classes
