"""Rank-0 printing (vitax/utils/logging.py master_print)."""

from __future__ import annotations

import torch.distributed as dist


def is_master() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def master_print(*args, **kwargs) -> None:
    """Print on global rank 0 only (every process when not distributed)."""
    if is_master():
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)
