"""The device mesh (vitax/parallel/mesh.py): one process per card, the
processes arranged as a `DeviceMesh` with dims ("dp", "fsdp").

- "dp":   pure data parallelism (params replicated across it);
- "fsdp": ZeRO-3: params, grads and AdamW moments sharded across it; it
          carries the batch too.

The reference's FSDP is mesh (1, n); its --run_without_fsdp DP baseline
(n, 1). `resolve_mesh_shape` keeps vitax's six sizes, so its errors are
vitax's; tp, sp and pp above 1 are refused by Config.validate (item 11).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vitax_torch import distributed

MESH_DIMS = ("dp", "fsdp")          # the port's DeviceMesh; both carry the global batch


def resolve_mesh_shape(cfg, n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """Resolve (dp, fsdp, tp, sp, pp, ep) against the device count (default:
    the process count, one card each), as vitax resolves it. One axis may
    be -1 (= all remaining devices). `--run_without_fsdp` forces everything
    onto dp (the reference's pure-DP baseline)."""
    n = n_devices if n_devices is not None else distributed.process_count()
    dp, fsdp, tp, sp = cfg.dp_size, cfg.fsdp_size, cfg.tp_size, cfg.sp_size
    pp = getattr(cfg, "pp_size", 1)
    ep = getattr(cfg, "ep_size", 1)

    if cfg.run_without_fsdp:
        if fsdp not in (-1, 1):
            raise ValueError("--run_without_fsdp is incompatible with --fsdp_size > 1")
        fsdp = 1
        if dp == 1 and tp == 1 and sp == 1 and pp == 1 and ep == 1:
            dp = -1  # default DP baseline: all devices data-parallel

    if pp > 1:
        if fsdp == 1 and dp == 1:
            dp = -1
        elif dp == -1 and fsdp == -1:
            fsdp = 1

    sizes = [dp, fsdp, tp, sp, pp, ep]
    n_auto = sum(1 for s in sizes if s == -1)
    if n_auto > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {sizes}")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_auto == 1:
        if n % fixed != 0:
            raise ValueError(f"device count {n} not divisible by fixed mesh axes {sizes}")
        sizes[sizes.index(-1)] = n // fixed
    elif fixed != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return tuple(sizes)


def build_mesh(cfg, device: torch.device):
    """The ("dp", "fsdp") DeviceMesh over every process, on `device`'s type;
    the process group must be up (distributed.maybe_initialize)."""
    from torch.distributed.device_mesh import init_device_mesh
    dp, fsdp = resolve_mesh_shape(cfg)[:2]
    return init_device_mesh(torch.device(device).type, (dp, fsdp), mesh_dim_names=MESH_DIMS)


def batch_shard(mesh) -> Tuple[int, int]:
    """(index, count): this rank's slice of the global batch, the
    counterpart of vitax's batch_pspec P(("dp", "fsdp")). The index is the
    rank's linearized coordinate over the mesh dims; a loader takes the
    batch's rows index::count, and `fold_shard_seed` folds it into the
    dropout seeds. Without a mesh: (0, 1)."""
    if mesh is None:
        return 0, 1
    index, count = 0, 1
    for i, dim in enumerate(MESH_DIMS):
        index = index * mesh.size(i) + mesh.get_local_rank(dim)
        count *= mesh.size(i)
    return index, count
