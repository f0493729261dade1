"""The elastic-resume plan (vitax/train/control.py elastic_resume_plan and
ResumePlan): where a resumed run re-enters a checkpointed epoch under the
current process count. A pure function of the sidecar and the count."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ResumePlan:
    """How to re-enter a checkpointed epoch under the current topology."""

    resume_step: int           # steps already done; 0 = epoch-boundary entry
    topology_changed: bool     # sidecar written under a different layout
    epoch_rounded: bool        # stream cursor invalidated -> boundary resume
    from_processes: int        # 0 when the sidecar has no process_count
    skipped_steps: int         # mid-epoch progress dropped by the rounding


def elastic_resume_plan(meta: Optional[dict], process_count: int) -> ResumePlan:
    """The resume step for a restart that may run another process count.

    `meta` is the mid-epoch sidecar (checkpoint/io.py load_resume_meta) or
    None for an epoch-boundary checkpoint. The index-sampled loaders
    partition rank-interleaved, so their step-granular resume survives any
    change of count; a stream cursor's shard assignment does not, so when
    the sidecar holds one and the count changed, the resume rounds down to
    the epoch boundary (re-running the partial epoch)."""
    step = int(meta.get("step_in_epoch") or 0) if meta else 0
    recorded = int(meta.get("process_count") or 0) if meta else 0
    changed = bool(recorded) and recorded != int(process_count)
    has_cursor = bool(meta) and isinstance(meta.get("stream_cursor"), dict)
    rounded = changed and has_cursor and step > 0
    return ResumePlan(resume_step=0 if rounded else step,
                      topology_changed=changed,
                      epoch_rounded=rounded,
                      from_processes=recorded,
                      skipped_steps=step if rounded else 0)
