"""The step the training loop runs for a task, and the serving engine
(vitax/programs/builder.py build_program and build_engine, without its AOT
compile cache: the port builds eager steps).

- `build_program(kind, cfg, optimizer, device, mesh)` builds one of the
  program kinds the scenario declares (registry.py): the train step, the
  eval step or the distill step, whose teacher comes from --teacher_npz.
- `build_engine(cfg, npz, epoch, device)` is the serving engine of a
  scenario that declares serving programs: from a consolidated npz export,
  or else from a checkpoint epoch under cfg.ckpt_dir (None = the latest
  committed one).
"""

from __future__ import annotations

from typing import Callable, Optional

from vitax_torch.config import Config
from vitax_torch.programs.registry import get_scenario
from vitax_torch.train.state import AdamW

# program kinds build_program builds (a scenario declares a subset, in
# vitax's names; "serve_bucket" programs are build_engine's warmed buckets)
PROGRAM_KINDS = ("train", "eval", "distill")


def build_program(kind: str, cfg: Config, optimizer: AdamW, device, mesh=None) -> Callable:
    """The `kind` program of cfg.task's scenario on `device` (under a
    `mesh`, each rank's): train_step, eval_step or distill_step."""
    scenario = get_scenario(cfg.task)
    if kind not in PROGRAM_KINDS:
        raise ValueError(f"unknown program kind {kind!r}; builder knows {PROGRAM_KINDS}")
    if kind not in scenario.programs:
        raise ValueError(f"--task {scenario.name} does not build {kind!r} programs "
                         f"(declared set: {scenario.programs}; vitax/programs/registry.py)")
    if kind == "train":
        from vitax_torch.train.step import make_train_step
        return make_train_step(cfg, optimizer, device, mesh)
    if kind == "eval":
        from vitax_torch.train.step import make_eval_step
        return make_eval_step(cfg, mesh)
    if not cfg.teacher_npz:
        raise ValueError("--task distill needs --teacher_npz to build a runnable program")
    from vitax_torch.programs.workloads import load_teacher, make_distill_step
    return make_distill_step(cfg, optimizer, device, load_teacher(cfg, device, mesh), mesh)


def build_engine(cfg: Config, npz: str = "", epoch: Optional[int] = None, device=None):
    """The serving engine, scenario-checked: InferenceEngine.from_npz of
    `npz` when given, else from_checkpoint of `epoch` (None = the latest)
    under cfg.ckpt_dir."""
    scenario = get_scenario(cfg.task)
    if "serve_bucket" not in scenario.programs:
        raise ValueError(f"--task {scenario.name} declares no serving programs (vitax/programs/registry.py)")
    from vitax_torch.serve.engine import InferenceEngine
    if npz:
        return InferenceEngine.from_npz(cfg, npz, device)
    return InferenceEngine.from_checkpoint(cfg, cfg.ckpt_dir, epoch, device)
