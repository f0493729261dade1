"""Train state and optimizer construction (vitax/train/state.py).

The state is the model (its float32 parameters are the master weights),
the AdamW moments mu and nu as float32 tensors beside each parameter the
optimizer trains (every one; the head's only under --task probe, as
optax.masked keeps them), keyed by state_dict name, and two counters:
`step`, the optimizer steps taken, a host int the loop reads for free,
and `count`, the same number as an int32 tensor on the params' device,
which the update reads for its bias correction and learning rate without
a host sync. The schedule is a pure function of the step, so there is no
scheduler state.

Under FSDP2 (parallel/sharding.py) the params are DTensors, and mu and nu
DTensors with the params' placements; `leaves()` hands the fused update
the rank's local shards, which share the DTensors' storage.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from vitax_torch.config import Config
from vitax_torch.train.schedule import warmup_cosine_schedule

# torch.optim.AdamW's defaults, the reference's optimizer (vitax ADAMW_HPARAMS)
ADAMW_HPARAMS = dict(b1=0.9, b2=0.999, eps=1e-8)


def every_leaf(name: str) -> bool:
    return True


def unit_lr(name: str) -> float:
    return 1.0


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clip over every grad, then AdamW with weight decay on
    `schedule` (vitax build_optimizer's optax chain) over the parameters
    `trains(name)` selects, each update times `lr_mult(name)` (optax's
    masked scale after AdamW: p + ((-lr) * u) * m). Unselected parameters
    have no moments and are never written."""
    schedule: Callable
    clip_grad_norm: float
    weight_decay: float
    b1: float = ADAMW_HPARAMS["b1"]
    b2: float = ADAMW_HPARAMS["b2"]
    eps: float = ADAMW_HPARAMS["eps"]
    trains: Callable[[str], bool] = every_leaf
    lr_mult: Callable[[str], float] = unit_lr


@dataclasses.dataclass
class TrainState:
    step: int                        # optimizer steps taken
    model: nn.Module                 # float32 master parameters
    mu: Dict[str, torch.Tensor]      # AdamW first moments, by parameter name
    nu: Dict[str, torch.Tensor]      # AdamW second moments
    count: torch.Tensor              # int32 0-d on the params' device, == step
    # CUDA events of snapshot copies still reading the state (checkpoint/
    # snapshot.py stage()): the next in-place update waits for them
    staged: List[torch.cuda.Event] = dataclasses.field(default_factory=list)

    def leaves(self) -> Tuple[List[str], List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """(names, params, mu, nu) of the parameters with moments, in
        named_parameters order, the local shards of sharded ones."""
        named = [(n, p) for n, p in self.model.named_parameters() if n in self.mu]
        return ([n for n, _ in named], [local(p) for _, p in named], [local(self.mu[n]) for n, _ in named],
                [local(self.nu[n]) for n, _ in named])

    def grads(self) -> List[torch.Tensor]:
        """Every param's grad in named_parameters order, local shards of sharded ones."""
        return [local(p.grad) for _, p in self.model.named_parameters()]


@torch.no_grad()
def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a DTensor (its storage, not a copy); any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def build_optimizer(cfg: Config, max_iteration: int) -> Tuple[AdamW, Callable]:
    """(optimizer, schedule): AdamW (0.9, 0.999, 1e-8) with weight decay on
    all params, global-norm clip cfg.clip_grad_norm, warmup-cosine lr."""
    schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup_steps, max_iteration)
    return AdamW(schedule=schedule, clip_grad_norm=cfg.clip_grad_norm,
                 weight_decay=cfg.weight_decay), schedule


def make_train_state(model: nn.Module, optimizer: Optional[AdamW] = None) -> TrainState:
    """A fresh state: zero moments beside each parameter `optimizer` trains
    (every one without an optimizer; DTensors with its placements for a
    sharded one), count 0."""
    trains = optimizer.trains if optimizer is not None else every_leaf
    named = [(n, p) for n, p in model.named_parameters() if trains(n)]
    mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named}
    nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named}
    dev = next(model.parameters()).device
    return TrainState(step=0, model=model, mu=mu, nu=nu,
                      count=torch.zeros((), dtype=torch.int32, device=dev))
