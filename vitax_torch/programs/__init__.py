"""Scenario registry, step-program builder and transfer workloads
(vitax/programs/).

`registry` maps --task names to Scenario declarations; `builder` builds
the step the loop runs for a task and the serving engine; `workloads`
holds the finetune, linear-probe and distillation pieces.
"""

from vitax_torch.programs.registry import SCENARIOS, TASKS, Scenario, get_scenario

__all__ = ["SCENARIOS", "TASKS", "Scenario", "get_scenario"]
