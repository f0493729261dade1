"""Process group bring-up and host-level helpers (vitax/distributed.py).

One process per card, launched by torchrun:

    torchrun --nproc_per_node N -m vitax_torch.train ...

`maybe_initialize` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group: NCCL on
the card, each rank on cuda:LOCAL_RANK, and gloo with `--device cpu`.
Without WORLD_SIZE the process runs alone (the unwrapped one-card path). A
WORLD_SIZE above 1 whose group cannot form raises, as vitax does
(:44-57): a process never trains alone on the whole dataset by accident.
A group that the caller initialized itself is taken as it is.
"""

from __future__ import annotations

import datetime
import functools
import operator
import os
import sys

import torch
import torch.distributed as dist

from vitax_torch.platform import DeviceLike, resolve_device

ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# seconds a rank waits for the others to join or answer (VITAX_DIST_TIMEOUT_S)
DEFAULT_TIMEOUT_S = 1800


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def _rank_device(device: torch.device) -> torch.device:
    """cuda:LOCAL_RANK (the current card when LOCAL_RANK is unset) for a
    card without an index, made the current one; other devices as given."""
    if device.type != "cuda":
        return device
    if device.index is None:
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())
    torch.cuda.set_device(device)
    return device


def maybe_initialize(device: DeviceLike = None) -> torch.device:
    """Join torchrun's process group when its environment asks for one, and
    return this rank's device (default cuda; raises without a card). The
    backend is NCCL on a card and gloo on the CPU."""
    device = _rank_device(resolve_device(device))
    if is_distributed() or "WORLD_SIZE" not in os.environ:
        return device
    env = {k: os.environ.get(k, "").strip() for k in ENV_VARS}
    missing = [k for k, v in env.items() if not v]
    if missing or not (env["RANK"].isdigit() and env["WORLD_SIZE"].isdigit()):
        raise ValueError(
            f"WORLD_SIZE={env['WORLD_SIZE']!r} is set but {', '.join(missing) or 'RANK/WORLD_SIZE'} "
            f"{'are missing' if missing else 'are not integers'}: RANK, WORLD_SIZE, MASTER_ADDR and "
            f"MASTER_PORT are all required for a multi-process run (torchrun sets them); otherwise every "
            f"process would train alone on the whole dataset")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=float(os.environ.get("VITAX_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S)))
    backend = "nccl" if device.type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, timeout=timeout,
                                **({"device_id": device} if device.type == "cuda" else {}))
    except Exception as e:  # noqa: BLE001 - re-raised with what it means for the run
        raise RuntimeError(
            f"rank {rank} of WORLD_SIZE={world}: the {backend} process group at "
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']} did not form ({type(e).__name__}: {e}); refusing to "
            f"train alone on the whole dataset") from e
    return device


def barrier(tag: str) -> None:
    """Named barrier over every process (vitax barrier); no-op alone. The
    tag names the point in a timeout's message."""
    if process_count() > 1:
        try:
            dist.barrier()
        except Exception as e:  # noqa: BLE001 - re-raised with the barrier's name
            raise RuntimeError(f"barrier {tag!r} failed on rank {process_index()}: {e}") from e


def broadcast_from_process0(value: int) -> int:
    """Process 0's value on every process (vitax broadcast_from_process0),
    so all agree on, say, the epoch to resume; free alone."""
    if process_count() == 1:
        return value
    box = [int(value)]
    dist.broadcast_object_list(box, src=0)
    return int(box[0])


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over every process, in place (no-op alone)."""
    if process_count() > 1:
        dist.all_reduce(t)
    return t


def or_across_processes(value: int) -> int:
    """Bitwise OR of a small non-negative host int over every process
    (vitax or_across_processes): every process's raised bits survive into
    the one word all of them see. NCCL has no bitwise-OR reduce, so the
    words are gathered (on the card under NCCL) and folded on the host.
    Collective: every process calls it at the same point. Free alone."""
    if process_count() == 1:
        return int(value)
    device = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    word = torch.tensor([int(value)], dtype=torch.int64, device=device)
    words = [torch.empty_like(word) for _ in range(process_count())]
    dist.all_gather(words, word)
    return functools.reduce(operator.or_, torch.cat(words).tolist(), 0)


def any_across_processes(value: bool) -> bool:
    """True iff any process passes True (vitax any_across_processes), so a
    signal seen by some processes stops all of them at the same step.
    Collective, as or_across_processes; free alone."""
    return bool(or_across_processes(int(bool(value))))


def orderly_shutdown() -> None:
    """The coordinated exit of a finished run (vitax orderly_shutdown): a
    barrier so every process has finished its teardown, then leave the
    process group, then flush stdout and stderr. No-op without a group.

    vitax ends with os._exit(0) to skip C++ destructors that race the
    coordination service; the port returns and lets the interpreter exit,
    since destroy_process_group has been seen to tear NCCL and gloo down
    without a hang (chip_smoke.py phase 7t runs it under torchrun)."""
    if not is_distributed():
        return
    barrier("vitax_orderly_shutdown")
    try:
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - a dirty teardown must not fail a finished run
        print(f"vitax_torch.distributed: destroy_process_group after the barrier failed "
              f"({type(e).__name__}: {e}); exiting anyway", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
