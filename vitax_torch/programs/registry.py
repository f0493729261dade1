"""Scenario registry: `--task` name -> step program, optimizer, validator
(vitax/programs/registry.py).

A Scenario is declarative data: which step program the training loop runs
(`step_program`), which programs the task may build (`programs`, vitax's
names), how its optimizer is assembled (`make_optimizer(cfg,
max_iteration) -> (optimizer, schedule)`), and a validator holding the
task's pairwise flag checks, which `Config.validate` dispatches to. The
validators raise ValueError with vitax's messages (vitax asserts), and keep
vitax's refusals where the port could do the work (the probe and the
finetune multiplier under `--fused_optimizer on`, distill with grad
accumulation, ZeRO-2, MoE or `--init_npz`), so one command line means one
run to both packages.

    train     the reference pretraining loop
    finetune  warm start from a consolidated npz export (--init_npz), head
              re-initialized on --reinit_head or a new --num_classes, and
              --backbone_lr_mult on the backbone's updates
    probe     linear probe: backbone frozen, AdamW moments for the head only
    distill   a frozen teacher (--teacher_npz) and the student in one step;
              loss (1-alpha)*CE + alpha*T^2*KL(teacher||student)

This module imports nothing heavy: Config.validate imports it, and the
optimizer builders import theirs when called.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registry entry: everything a workload declares about itself."""
    name: str
    description: str
    step_program: str            # the program the training loop steps with
    programs: Tuple[str, ...]    # program kinds the task may build
    make_optimizer: Callable     # (cfg, max_iteration) -> (optimizer, schedule)
    validate: Callable           # (cfg) -> None; raises ValueError on bad flag combinations


def _train_optimizer(cfg, max_iteration: int):
    from vitax_torch.train.state import build_optimizer
    return build_optimizer(cfg, max_iteration)


def _finetune_optimizer(cfg, max_iteration: int):
    from vitax_torch.programs.workloads import make_finetune_optimizer
    return make_finetune_optimizer(cfg, max_iteration)


def _probe_optimizer(cfg, max_iteration: int):
    from vitax_torch.programs.workloads import make_probe_optimizer
    return make_probe_optimizer(cfg, max_iteration)


def _check(*checks) -> None:
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)


def _validate_train(cfg) -> None:
    _check(
        (not cfg.init_npz,
         "--init_npz is a finetune/probe warm-start flag; --task train initializes from seed (use --task "
         "finetune to resume params from a consolidated export)"),
        (not cfg.teacher_npz, "--teacher_npz is a distillation flag; use --task distill"),
        (not cfg.reinit_head,
         "--reinit_head only applies to --task finetune (train initializes every leaf fresh anyway)"),
        (cfg.backbone_lr_mult == 1.0,
         f"--backbone_lr_mult {cfg.backbone_lr_mult} only applies to --task finetune; train updates every "
         f"leaf at the schedule lr"))


def _validate_finetune(cfg) -> None:
    _check(
        (bool(cfg.init_npz),
         "--task finetune resumes params from a consolidated export: pass --init_npz <file> (produce one "
         "with vitax.checkpoint.consolidate)"),
        (not cfg.teacher_npz, "--teacher_npz is a distillation flag; use --task distill"),
        (cfg.pp_size <= 1,
         "--task finetune runs the non-pipelined step; restore with --pp_size 1 (the consolidated export "
         "is topology-free)"),
        (cfg.backbone_lr_mult >= 0,
         f"--backbone_lr_mult must be >= 0, got {cfg.backbone_lr_mult} (0 freezes the backbone — consider "
         f"--task probe, which also drops the backbone optimizer moments)"),
        (cfg.backbone_lr_mult == 1.0 or cfg.fused_optimizer != "on",
         "--fused_optimizer on is incompatible with --backbone_lr_mult: the fused clip+AdamW kernel applies "
         "one lr to every leaf (vitax/ops/fused_optimizer.py); the optax path handles the masked scaling"))


def _validate_probe(cfg) -> None:
    _check(
        (not cfg.teacher_npz, "--teacher_npz is a distillation flag; use --task distill"),
        (cfg.pp_size <= 1, "--task probe runs the non-pipelined step; use --pp_size 1"),
        (cfg.fused_optimizer != "on",
         "--fused_optimizer on is incompatible with --task probe: the fused clip+AdamW kernel updates every "
         "leaf in place, but the probe freezes the backbone via optax masking (VTX-R010 pins that frozen "
         "leaves receive no optimizer moments)"),
        (cfg.backbone_lr_mult == 1.0,
         "--backbone_lr_mult has no effect under --task probe (the backbone is frozen outright); use --task "
         "finetune for a reduced backbone lr"))


def _validate_distill(cfg) -> None:
    # --teacher_npz is checked where the step is built (programs/builder.py),
    # as in vitax, whose analysis arms build against an abstract teacher
    _check(
        (not cfg.init_npz,
         "--init_npz warm starts are not wired for --task distill (the student trains from seed); distill "
         "from a finetuned teacher via --teacher_npz instead"),
        (not cfg.reinit_head, "--reinit_head only applies to --task finetune"),
        (cfg.backbone_lr_mult == 1.0, "--backbone_lr_mult only applies to --task finetune"),
        (cfg.pp_size <= 1, "--task distill runs the non-pipelined two-tower step; use --pp_size 1"),
        (getattr(cfg, "moe_experts", 0) == 0,
         "--task distill does not support MoE models yet: the teacher forward would need the aux-loss "
         "plumbing threaded through the frozen tower"),
        (cfg.grad_accum_steps <= 1,
         "--grad_accum_steps > 1 is not wired for --task distill: the two-tower step computes teacher logits "
         "once per loader batch"),
        (cfg.reshard_after_forward,
         "--no_reshard_after_forward (ZeRO-2) is not wired for --task distill: the step-top gather path "
         "covers the student tower only"))


_PROGRAMS = ("train", "eval", "opt_probe", "serve_bucket")

SCENARIOS = {
    "train": Scenario("train", "reference pretraining loop (CE over labels)", "train", _PROGRAMS,
                      _train_optimizer, _validate_train),
    "finetune": Scenario("finetune", "fine-tune from a consolidated npz export (--init_npz; head re-init, "
                                     "--backbone_lr_mult)", "train", _PROGRAMS,
                         _finetune_optimizer, _validate_finetune),
    "probe": Scenario("probe", "linear probe: frozen backbone, head-only optimizer state", "train", _PROGRAMS,
                      _probe_optimizer, _validate_probe),
    "distill": Scenario("distill", "knowledge distillation: frozen teacher (--teacher_npz) + student in one step",
                        "distill", ("distill", "eval", "opt_probe", "serve_bucket"),
                        _train_optimizer, _validate_distill),    # plain AdamW over the student
}

TASKS = tuple(SCENARIOS)


def get_scenario(task: str) -> Scenario:
    """Resolve a --task name; unknown names fail with the valid set."""
    if task not in SCENARIOS:
        raise ValueError(
            f"unknown --task {task!r}; registered scenarios: "
            f"{', '.join(sorted(SCENARIOS))} (vitax/programs/registry.py)")
    return SCENARIOS[task]
