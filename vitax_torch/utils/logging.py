"""Rank-0 printing and device memory stats (vitax/utils/logging.py)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def is_master() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def master_print(*args, **kwargs) -> None:
    """Print on global rank 0 only (every process when not distributed)."""
    if is_master():
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)


def memory_stats_dict(device=None) -> dict:
    """The card's allocator stats for machine consumers (the telemetry
    records): {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} from
    torch.cuda.memory_stats and the card's total memory; {} on the CPU,
    which reports none. `device` None is the current card, if any."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0))}
    peak = stats.get("allocated_bytes.all.peak")
    if peak:
        out["peak_bytes_in_use"] = int(peak)
    out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    return out


def memory_summary(device=None) -> str:
    """Memory use for the step log line, rendered from memory_stats_dict:
    "mem: used=... peak=... limit=..." in GiB, "mem: n/a" on the CPU."""
    stats = memory_stats_dict(device)
    if not stats:
        return "mem: n/a"
    gib = 1024 ** 3
    parts = [f"used={stats.get('bytes_in_use', 0) / gib:.2f}GiB"]
    if "peak_bytes_in_use" in stats:
        parts.append(f"peak={stats['peak_bytes_in_use'] / gib:.2f}GiB")
    if "bytes_limit" in stats:
        parts.append(f"limit={stats['bytes_limit'] / gib:.2f}GiB")
    return "mem: " + " ".join(parts)
