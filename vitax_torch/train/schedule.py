"""LR schedule: linear warmup then half-cosine decay to 0
(vitax/train/schedule.py warmup_cosine_schedule, the reference's LambdaLR
multiplier):
  step < warmup:  ratio = step / warmup          (so lr == 0 at step 0)
  else:           where = (step - warmup) / (max - warmup)
                  ratio = 0.5 * (1 + cos(pi * where))

A pure step -> lr function in float32, on the step's device: the train step
evaluates it on the card from the optimizer's step count, with no host
sync; the loop evaluates it on a host int for its log line.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch


def warmup_cosine_schedule(base_lr: float, warmup_iteration: int,
                           max_iteration: int) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """Returns schedule(step) -> lr, a float32 0-d tensor. With
    warmup_iteration == 0 the warmup branch is never taken (pure cosine
    from step 0), like the reference's `step < warmup` test."""
    warmup = int(warmup_iteration)
    denom = max(max_iteration - warmup, 1)

    def schedule(step: Union[int, torch.Tensor]) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm_ratio = step / max(warmup, 1)          # divisor unused when warmup == 0
        where = (step - warmup) / denom
        cos_ratio = 0.5 * (1.0 + torch.cos(math.pi * where))
        return base_lr * torch.where(step < warmup, warm_ratio, cos_ratio)

    return schedule
