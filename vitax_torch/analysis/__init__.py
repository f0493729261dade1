"""vitax_torch.analysis — the port checks itself (vitax/analysis/ on torch).

The correctness tooling for the port's performance and correctness claims.
vitax checks them on the lowered program (the partitioned HLO is the real
program under GSPMD); the port's step is eager, so the evidence is what one
run of the step or the engine does, taken while it runs. The package
imports torch, numpy and the stdlib only, and nothing of vitax/.

  ast_lint     vitax/analysis/ast_lint.py: the source lint, VTX100-VTX109,
               with VTX101-VTX104 given their torch meaning (a host sync or
               a tensor-to-number conversion in the step's modules, untimed
               CUDA work between timers, an implicitly chosen device)
  concurrency  vitax/analysis/concurrency.py: the thread lint, VTX200-VTX205,
               with VTX204 as device work reachable from a thread
  trace        vitax/analysis/hlo.py's place: the evidence reader. An op
               recorder (TorchDispatchMode) stands for the lowered
               StableHLO and the jaxpr, a storage map of the train state
               for the input_output_alias donation table, ops/_build.py's
               launch and dispatcher-call counts for pallas_call in the
               jaxpr, and a torch.profiler trace's c10d ops and FSDP2
               ranges for the partitioned HLO's collectives and its
               while-body prefetch slot; DTensor placements stand for the
               arg shardings, engine.compile_count and _build.builds() for
               the AOT executables
  rules        vitax/analysis/rules.py: the registry (VTX-R001-R010, vitax's
               ids, names, severities, kinds and config gates) with torch
               checks, vitax's arms and their program builders
  check        tools/check_invariants.py: the gate over the arms, schema-1
               JSON, the thread lint included

Entry points: `python -m vitax_torch.analysis.ast_lint` and
`python -m vitax_torch.analysis.concurrency` (source lints, default path
vitax_torch/), `python -m vitax_torch.analysis.check` (the program gate; on
the card unless --device cpu).
"""
