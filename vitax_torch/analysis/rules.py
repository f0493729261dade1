"""Declarative program-invariant rules over the port's eager step and engines.

The port's copy of vitax/analysis/rules.py. Every performance and
correctness claim of the port is a property of what one step or one
forward does: the clip+AdamW kernel in place of a tree of ops, the dequant
kernel at every quantized Dense site, bf16 gathers and f32 reduces under
ZeRO-3, no host sync in the step, params and moments updated in place, no
rebuild after serving warmup, the probe's frozen backbone. A refactor can
regress any of them (a silent fall-back to a plain twin, an f32 copy of a
quantized weight, an `.item()` in the step) with every parity test still
passing; each rule turns one such claim into a check.

A rule is declarative data, as in vitax: (id, name, severity, kinds,
applies_to(config), check(program, config) -> findings), with vitax's ids,
names, severities, kinds and config gates. The Program carries torch
evidence (analysis/trace.py) in place of XLA text:

  vitax artifact                 the port's evidence
  lowered StableHLO / HLO text   OpRecorder rows of one recorded step
  input_output_alias (donation)  storage_map before and after the step
  collectives in the HLO         c10d ops of a profiler trace (collectives)
  while-body prefetch slot       FSDP2's gather and post-forward ranges
  arg shardings                  DTensor placements of the state's leaves
  pallas_call in the jaxpr       ops/_build.py LAUNCHES and CALLS deltas
  AOT executables                engine.compile_count and _build.builds()

`build_program(arm)` builds one of vitax's arms (BASE_GEOMETRY, TRAIN_ARMS,
the serve arms) through the port's Config, on a device, under a mesh for
the fsdp arms (analysis/check.py runs those in one gloo group of two
ranks); `train_program` and `serve_program` take the evidence from a state
and step or an engine already built (chip_smoke.py phase 7v).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vitax_torch.analysis import trace
from vitax_torch.config import Config

SEVERITIES = ("ERROR", "WARN")


@dataclasses.dataclass
class Finding:
    """One rule violation in one program."""
    rule: str
    severity: str
    arm: str
    message: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Program:
    """One program plus the evidence the rules read.

    kind "train": one recorded step that is not a log step (`ops`, its
    `launches`, `sync_error` where the card's sync debug mode raised), the
    state's storages before and after it (`storage_before/after`, and
    `memory_before/after` on the card), the state's leaves as held
    (`state_leaves`), the shapes of the parameters the optimizer trains
    (`param_shapes`, global and local), under a mesh the step's
    `collectives` and FSDP2's forward gather order (`gather_order`), and
    on probe/distill arms the freeze evidence: the frozen paths, the
    optimizer's moment paths, the frozen leaves that changed, and whether
    each teacher output had a grad_fn.
    kind "serve": a warmed-up InferenceEngine; the rules run its
    forwards themselves."""
    kind: str                     # "train" | "serve"
    arm: str
    config: Config
    device: str = "cpu"
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_state_leaves: int = 0
    engine: Any = None
    frozen_paths: Tuple[str, ...] = ()
    opt_moment_paths: Tuple[str, ...] = ()
    ops: Optional[trace.OpRecorder] = None
    launches: Optional[trace.Launches] = None
    sync_error: str = ""
    storage_before: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    storage_after: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    memory_before: Optional[int] = None
    memory_after: Optional[int] = None
    state_leaves: List[Tuple[str, torch.Tensor]] = dataclasses.field(default_factory=list)
    param_shapes: Tuple[Tuple[int, ...], ...] = ()
    collectives: List[dict] = dataclasses.field(default_factory=list)
    gather_order: Dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    frozen_changed: Tuple[str, ...] = ()
    teacher_grad_fn: Tuple[bool, ...] = ()


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str                       # stable VTX-Rnnn code (CI contract)
    name: str                     # kebab-case human handle
    severity: str                 # ERROR fails CI; WARN is advisory
    kinds: Tuple[str, ...]        # program kinds the rule reads
    description: str
    applies_to: Callable[[Config], bool]
    check: Callable[[Program, Config], List[Finding]]

    def applicable(self, program: Program) -> bool:
        return (program.kind in self.kinds
                and self.applies_to(program.config))


RULES: List[Rule] = []


def rule(id: str, name: str, severity: str, kinds: Tuple[str, ...],
         description: str, applies_to: Callable[[Config], bool] = lambda cfg: True):
    """Register a check function as a Rule."""
    assert severity in SEVERITIES, severity

    def wrap(fn: Callable[[Program, Config], List[Finding]]) -> Rule:
        r = Rule(id=id, name=name, severity=severity, kinds=tuple(kinds),
                 description=description, applies_to=applies_to, check=fn)
        assert all(existing.id != id for existing in RULES), f"duplicate {id}"
        RULES.append(r)
        return r

    return wrap


def _finding(r: Rule, program: Program, message: str, **details) -> Finding:
    return Finding(rule=r.id, severity=r.severity, arm=program.arm,
                   message=message, details=details)


def large_param_threshold_bytes(cfg: Config) -> int:
    """Size above which a replicated parameter is a sharding regression: one
    f32 block matmul matrix (embed_dim^2 * 4). Everything the fsdp dim is
    meant to shard is at least this big; everything legitimately small
    (LN scales, cls token, small pos embeds, the step counter) is far
    smaller."""
    return cfg.embed_dim * cfg.embed_dim * 4


def _no_step(r: Rule, program: Program) -> List[Finding]:
    return [_finding(r, program, "train program carries no recorded step — train_program records one "
                                 "non-log step; nothing to audit")]


# --- built-in rules ---------------------------------------------------------


@rule("VTX-R001", "no-host-transfer-in-step", "ERROR", ("train",),
      "the train step must not move data to the host: no scalar read "
      "(.item(), int()/float() of a tensor), no device-to-host copy, no "
      "blocking host-to-device copy, no data-dependent size (nonzero) in "
      "one step that is not a log step — "
      "each one drains the launch queue on a host sync every step; "
      "telemetry reads the metrics at log steps only")
def check_no_host_transfer(program: Program, cfg: Config) -> List[Finding]:
    r = NO_HOST_TRANSFER
    if program.ops is None:
        return _no_step(r, program)
    out = [_finding(r, program, f"host sync in the step: {row.op} ({row.to_json()['in']} -> "
                                f"{row.to_json()['out']})", op=row.to_json())
           for row in program.ops.host_syncs()]
    if program.sync_error:
        out.append(_finding(r, program, f"the sync debug mode raised inside the step: {program.sync_error}",
                            error=program.sync_error))
    return out


@rule("VTX-R002", "donation-honored", "ERROR", ("train",),
      "the train state must be updated in place: every param, mu and nu "
      "keeps its storage (pointer and size) across a step, and the step "
      "counter its size; on the card the allocated bytes return to their "
      "value before the step within one block matrix (a copied state "
      "doubles the optimizer-state footprint silently)")
def check_donation(program: Program, cfg: Config) -> List[Finding]:
    r = DONATION_HONORED
    if program.ops is None:
        return _no_step(r, program)
    out: List[Finding] = []
    before, after = program.storage_before, program.storage_after
    if len(before) < program.n_state_leaves:
        out.append(_finding(r, program, f"only {len(before)} of {program.n_state_leaves} state storages "
                                        f"recorded before the step", recorded=len(before),
                            expected=program.n_state_leaves))
    for key, (ptr, nbytes) in sorted(before.items()):
        got = after.get(key)
        if key == "count":
            # the step counter is replaced by design (count + 1, so a snapshot's
            # in-flight copy of the old one never sees it change,
            # checkpoint/snapshot.py): only its size is held
            if got is None or got[1] != nbytes:
                out.append(_finding(r, program, f"step counter storage changed size: {nbytes} -> "
                                                f"{None if got is None else got[1]} bytes", key=key))
            continue
        if got != (ptr, nbytes):
            out.append(_finding(
                r, program, f"state storage {key} was not updated in place: (ptr {ptr:#x}, {nbytes} B) -> "
                            + ("gone" if got is None else f"(ptr {got[0]:#x}, {got[1]} B)"), key=key))
    if program.memory_before is not None and program.memory_after is not None:
        grew = program.memory_after - program.memory_before
        if abs(grew) > large_param_threshold_bytes(cfg):
            out.append(_finding(
                r, program, f"allocated bytes moved {grew:+,} B across the step (more than one block matrix, "
                            f"{large_param_threshold_bytes(cfg):,} B)",
                before=program.memory_before, after=program.memory_after))
    return out


def _reduce_dtype(cfg: Config) -> str:
    return "bf16" if cfg.grad_reduce_dtype == "bfloat16" else "f32"


@rule("VTX-R003", "collective-dtype-policy", "ERROR", ("train",),
      "under the bf16 comm-precision policy every block-sized param "
      "all-gather must move bf16, and block-sized grad reduce-scatters the "
      "--grad_reduce_dtype (f32 by default, bf16 with --grad_reduce_dtype "
      "bfloat16): an f32 gather doubles wire bytes — the bf16 gather win "
      "regressing silently",
      applies_to=lambda cfg: cfg.comm_cast_active)
def check_collective_dtype(program: Program, cfg: Config) -> List[Finding]:
    r = COLLECTIVE_DTYPE
    if program.mesh_shape.get("fsdp", 1) <= 1:
        return []  # single-rank program: no collectives to police
    out: List[Finding] = []
    block_numel = cfg.embed_dim * cfg.embed_dim  # smallest block matmul param
    rows = [c for c in program.collectives if c["numel"] >= block_numel]
    if not any(c["op"] == "all-gather" for c in rows):
        out.append(_finding(r, program, "no block-sized all-gather recorded in the step — the trace lost FSDP2's "
                                        "gathers, or the blocks are not sharded", collectives=len(rows)))
    want_rs = _reduce_dtype(cfg)
    for c in rows:
        if c["op"] == "all-gather" and c["dtype"] != "bf16":
            out.append(_finding(r, program, f"{c['dtype']} block-param all-gather of {c['numel']:,} elements "
                                            f"under the bf16 gather policy", collective=c))
        if c["op"] == "reduce-scatter" and c["dtype"] != want_rs:
            out.append(_finding(r, program, f"{c['dtype']} block-sized grad reduce-scatter of {c['numel']:,} "
                                            f"elements under --grad_reduce_dtype {cfg.grad_reduce_dtype}",
                                collective=c))
    return out


def _overlap_requested(cfg: Config) -> bool:
    """vitax's config-only gate: `on`, or `auto` with every config-side
    precondition met (the mesh-side fsdp>1 condition is re-checked in the
    rule body against program.mesh_shape)."""
    mode = getattr(cfg, "gather_overlap", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return (cfg.reshard_after_forward and not cfg.run_without_fsdp
            and cfg.scan_blocks and cfg.grad_ckpt
            and cfg.remat_policy == "none_saveable"
            and getattr(cfg, "pp_size", 1) == 1)


@rule("VTX-R004", "gather-overlap-structure", "ERROR", ("train",),
      "with the gather overlap requested, every block must gather its own "
      "params in the forward (ZeRO-3's per-block gathers, not hoisted or "
      "lost), and under --gather_overlap on each block's forward gather "
      "must be issued before the previous block's forward ends (the "
      "explicit prefetch parallel/sharding.py sets) — else the double "
      "buffering silently degraded to the serial schedule",
      applies_to=_overlap_requested)
def check_gather_overlap(program: Program, cfg: Config) -> List[Finding]:
    r = GATHER_OVERLAP
    if program.mesh_shape.get("fsdp", 1) <= 1:
        return []  # nothing to overlap on an unsharded fsdp dim
    order = program.gather_order
    missing = [k for k in range(cfg.num_blocks) if order.get(f"gather_{k}") is None]
    if missing:
        return [_finding(r, program, f"blocks {missing} issue no forward gather of their own — ZeRO-3 per-block "
                                     f"gathers were hoisted or lost", order=order)]
    if cfg.gather_overlap != "on":
        # auto leaves FSDP2's own prefetch, which overlaps on the card by the
        # host running ahead of it: the issue order has nothing more to show
        return []
    late = [k for k in range(1, cfg.num_blocks)
            if order.get(f"end_{k - 1}") is None or not order[f"gather_{k}"] < order[f"end_{k - 1}"]]
    if late:
        return [_finding(r, program, f"{len(late)} of {cfg.num_blocks - 1} forward gathers (blocks {late}) are "
                                     f"issued after the previous block's forward ended: the overlap schedule "
                                     f"regressed to serial gather-then-compute", order=order)]
    return []


@rule("VTX-R005", "no-replicated-large-params", "ERROR", ("train",),
      "under fsdp arms no state leaf above one block-matrix in size may be "
      "held whole on every rank: each must be a DTensor sharded on the fsdp "
      "dim (a replicated 10B tree is an instant OOM at flagship scale and a "
      "silent memory regression at any scale)",
      applies_to=lambda cfg: not cfg.run_without_fsdp and cfg.fsdp_size != 1)
def check_no_replicated_large_params(program: Program, cfg: Config) -> List[Finding]:
    r = NO_REPLICATED_LARGE
    if program.mesh_shape.get("fsdp", 1) <= 1:
        return []  # the resolved mesh has no sharding capacity to demand
    from torch.distributed.tensor import DTensor, Shard
    threshold = large_param_threshold_bytes(cfg)
    out: List[Finding] = []
    for name, t in program.state_leaves:
        nbytes = t.numel() * t.element_size()
        if nbytes < threshold:
            continue
        sharded = isinstance(t, DTensor) and any(
            isinstance(p, Shard) and dim == "fsdp"
            for p, dim in zip(t.placements, t.device_mesh.mesh_dim_names or ()))
        if not sharded:
            out.append(_finding(r, program, f"state leaf {name} ({tuple(t.shape)}, {nbytes:,} B) is not sharded "
                                             f"on the fsdp dim under an fsdp mesh", leaf=name,
                                threshold_bytes=threshold))
    return out


@rule("VTX-R006", "serve-no-recompile", "ERROR", ("serve",),
      "steady-state serving must never build: after warmup, compile count "
      "== bucket count, mixed-size traffic 1..max reuses the warmed buckets "
      "with no new bucket and no kernel build, and a batch past the largest "
      "bucket is refused")
def check_serve_no_recompile(program: Program, cfg: Config) -> List[Finding]:
    r = SERVE_NO_RECOMPILE
    from vitax_torch.ops import _build
    eng = program.engine
    out: List[Finding] = []
    expected = len(eng.buckets)
    if eng.compile_count != expected:
        out.append(_finding(
            r, program,
            f"compile_count {eng.compile_count} != bucket count {expected} "
            f"after warmup",
            compile_count=eng.compile_count, buckets=list(eng.buckets)))
    s = cfg.image_size
    before, builds = eng.compile_count, _build.builds()
    sizes = list(range(1, eng.buckets[-1] + 1))
    for n in sizes:
        try:
            eng.predict(np.zeros((n, s, s, 3), np.uint8))
        except (RuntimeError, ValueError) as e:
            out.append(_finding(r, program, f"a batch of {n} inside the largest bucket was refused: {e}", size=n))
    if eng.compile_count != before or _build.builds() != builds:
        out.append(_finding(
            r, program,
            f"serving traffic of sizes {sizes} warmed {eng.compile_count - before} new bucket(s) and built "
            f"{_build.builds() - builds} kernel librar(ies)",
            sizes=sizes, compiles=eng.compile_count - before, builds=_build.builds() - builds))
    too_big = eng.buckets[-1] + 1
    try:
        eng.predict(np.zeros((too_big, s, s, 3), np.uint8))
        out.append(_finding(
            r, program,
            f"a batch of {too_big} (past the largest bucket {eng.buckets[-1]}) was served — a shape no "
            f"warmup ran is not refused"))
    except ValueError:
        pass  # refused: the pass condition of this probe
    return out


# how each QUANT_DTYPES entry is resident on the card: int8, and the fp8
# codes as torch's e4m3fn (or their uint8 bit view)
QUANT_TORCH_DTYPES = {"int8": (torch.int8,), "float8_e4m3": (torch.float8_e4m3fn, torch.uint8)}


def _quant_weights(eng) -> Dict[str, torch.Tensor]:
    """{weight name: tensor} of every quantized leaf of an engine: the
    weight beside each `qscale`."""
    bufs = dict(eng.model.named_buffers())
    params = dict(eng.model.named_parameters())
    out = {}
    for name in eng.scales:
        w = name[:-len("qscale")] + "weight"
        out[w] = bufs.get(w, params.get(w))
    return out


@rule("VTX-R007", "quant-weights-resident", "ERROR", ("serve",),
      "a quantized engine must hold its matmul weights AT THE QUANT DTYPE: "
      "every manifested leaf int8 (or the fp8 codes) on the engine's device, "
      "one quantized tensor per scaled leaf, and no floating weight at or "
      "above block-matrix size beside them (a dequant hoisted to load time "
      "materializes the f32 copy the quantized export exists to avoid — 4x "
      "the memory, silently)",
      applies_to=lambda cfg: bool(getattr(cfg, "serve_quant_dtype", "")))
def check_quant_weights_resident(program: Program, cfg: Config) -> List[Finding]:
    r = QUANT_WEIGHTS_RESIDENT
    eng = program.engine
    out: List[Finding] = []
    scales = getattr(eng, "scales", {})
    if not scales:
        return [_finding(
            r, program,
            f"--serve_quant_dtype {cfg.serve_quant_dtype} but the engine "
            f"carries no quant scales — serving full-precision weights")]
    want = QUANT_TORCH_DTYPES[cfg.serve_quant_dtype]
    weights = _quant_weights(eng)
    for key, leaf in sorted(weights.items()):
        if leaf is None or leaf.dtype not in want or leaf.device.type != eng.device.type:
            out.append(_finding(
                r, program,
                f"scaled leaf {key} is resident as "
                f"{'nothing' if leaf is None else f'{leaf.dtype} on {leaf.device}'}, not "
                f"{cfg.serve_quant_dtype} on {eng.device} — dequantized outside the forward",
                key=key, dtype=None if leaf is None else str(leaf.dtype)))
    tensors = list(eng.model.named_parameters()) + list(eng.model.named_buffers())
    n_q = sum(1 for _, t in tensors if t.dtype in want)
    if n_q != len(scales):
        out.append(_finding(
            r, program,
            f"the engine holds {n_q} {cfg.serve_quant_dtype} tensors for {len(scales)} scaled leaves — "
            f"quantized weights are not resident as {cfg.serve_quant_dtype}",
            quant_tensors=n_q, scaled_leaves=len(scales)))
    threshold = large_param_threshold_bytes(cfg)
    for name, t in tensors:
        if t.dtype.is_floating_point and t.dtype not in want and t.numel() * t.element_size() >= threshold:
            out.append(_finding(
                r, program,
                f"block-sized floating tensor {name} ({t.dtype}{list(t.shape)}, "
                f"{t.numel() * t.element_size():,} B) in the quantized engine — a materialized "
                f"dequantized weight", key=name, threshold_bytes=threshold))
    return out


def _fused_active(cfg: Config) -> bool:
    """Config-side gate for VTX-R008, vitax's verdict on the port: `on`
    forces it; `auto` engages where the kernel runs, on a CUDA device
    (vitax's auto engages where Pallas lowers for real, on a TPU); `off`
    never. The port's probe steps its head through the kernel too, so
    the task is no exemption here; the probe's validator refuses `on`,
    as vitax's does."""
    mode = getattr(cfg, "fused_optimizer", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return torch.cuda.is_available()


@rule("VTX-R008", "fused-optimizer-lowered", "ERROR", ("train",),
      "with the fused optimizer active the train step must go through the "
      "clip+AdamW dispatcher exactly once and, on the card, launch kernel B "
      "exactly once, AND leave no parameter-sized sqrt / where / addcdiv / "
      "lerp outside it: those at parameter size are the torch.optim AdamW / "
      "per-leaf clip tell-tales of the one-pass update silently regressing "
      "to the tree-of-ops chain",
      applies_to=_fused_active)
def check_fused_optimizer(program: Program, cfg: Config) -> List[Finding]:
    r = FUSED_OPTIMIZER
    if program.ops is None or program.launches is None:
        return _no_step(r, program)
    out: List[Finding] = []
    calls = program.launches.calls.get("fused_adamw", 0)
    if calls != 1:
        out.append(_finding(r, program, f"the step made {calls} fused_clip_adamw calls; one is the fused update",
                            calls=calls))
    if program.device == "cuda":
        n = program.launches.launches.get("fused_adamw", 0)
        if n != 1:
            out.append(_finding(r, program, f"the step launched kernel B {n} times; the fused update is one "
                                            f"launch", launches=n))
    # On the CPU the dispatcher runs the plain version, a tree of ops by
    # design: its ops carry the kernel's region and are not counted here, so
    # the rule holds the call count and the choice, not a launch.
    min_elems = large_param_threshold_bytes(cfg) // 4  # f32 elements
    for row in program.ops.param_sized(program.param_shapes, min_elems):
        out.append(_finding(
            r, program,
            f"parameter-sized {row.op} ({row.to_json()['out']}) outside the fused update — an optimizer "
            f"temporary the one-pass update should have eliminated", op=row.to_json(), min_elems=min_elems))
    return out


def _fused_dequant_cfg(cfg: Config) -> bool:
    """Config-side gate for VTX-R009, vitax's verdict on the port: a
    quantized engine under `on`, or under `auto` on a dense model where the
    kernel runs, on a CUDA device (ops/dequant_matmul.py
    fused_dequant_active)."""
    if not getattr(cfg, "serve_quant_dtype", ""):
        return False
    mode = getattr(cfg, "fused_dequant", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return getattr(cfg, "moe_experts", 0) == 0 and torch.cuda.is_available()


def quant_dense_sites(model) -> int:
    """The quantized Dense sites of a model (models/vit.py QuantLinear):
    qkv, proj, fc1 and fc2 in each block, and the head."""
    from vitax_torch.models.vit import QuantLinear
    return sum(1 for m in model.modules() if isinstance(m, QuantLinear))


@rule("VTX-R009", "fused-dequant-lowered", "ERROR", ("serve",),
      "with the fused dequant-matmul active a forward of the quantized "
      "engine must go through the dequant_matmul dispatcher (on the card: "
      "launch kernel C) exactly once at every quantized Dense site, AND "
      "make no weight-sized float tensor from an int8/fp8 source outside "
      "it: such a tensor is a dequantized weight round-tripping through "
      "memory — the fusion silently regressing to the convert+matmul chain "
      "(the serve twin of VTX-R008)",
      applies_to=_fused_dequant_cfg)
def check_fused_dequant(program: Program, cfg: Config) -> List[Finding]:
    r = FUSED_DEQUANT
    eng = program.engine
    sites = quant_dense_sites(eng.model)
    s = cfg.image_size
    x = np.zeros((eng.buckets[-1], s, s, 3), np.uint8)
    with trace.launch_delta() as ld, trace.OpRecorder() as rec:
        eng.predict(x)
    out: List[Finding] = []
    calls = ld.calls.get("dequant_matmul", 0)
    if sites == 0 or calls != sites:
        out.append(_finding(r, program, f"a forward made {calls} dequant_matmul calls for {sites} quantized Dense "
                                        f"sites — the fused dequant-matmul did not take every site",
                            calls=calls, sites=sites))
    if eng.device.type == "cuda":
        n = ld.launches.get("dequant_matmul", 0)
        if n != sites:
            out.append(_finding(r, program, f"a forward launched kernel C {n} times for {sites} quantized Dense "
                                            f"sites", launches=n, sites=sites))
    min_elems = large_param_threshold_bytes(cfg) // 4  # f32 elements
    # the patchify conv is the one quantized leaf no Dense site consumes: it
    # dequantizes at use and is exempt by its exact shape
    p = cfg.patch_size
    exempt = ((cfg.embed_dim, 3, p, p),)
    shapes = [tuple(w.shape) for w in _quant_weights(eng).values() if w is not None]
    for row in rec.quant_casts(shapes, min_elems, exempt):
        out.append(_finding(
            r, program,
            f"weight-sized dequant outside the fused kernel: {row.op} {row.to_json()['in']} -> "
            f"{row.to_json()['out']}", op=row.to_json(), min_elems=min_elems))
    return out


def _frozen_task(cfg: Config) -> bool:
    """Config-side gate for VTX-R010: scenarios that freeze parameters."""
    return getattr(cfg, "task", "train") in ("probe", "distill")


@rule("VTX-R010", "frozen-params-not-updated", "ERROR", ("train",),
      "a scenario that freezes parameters (--task probe: the backbone; "
      "--task distill: the whole teacher tower) must not give any frozen "
      "leaf optimizer moments, must leave every frozen leaf bitwise "
      "unchanged by a step, and a distill step must run the teacher "
      "without autograd (its outputs carry no grad_fn) — else AdamW, or "
      "autograd, is touching a 'frozen' parameter",
      applies_to=_frozen_task)
def check_frozen_not_updated(program: Program, cfg: Config) -> List[Finding]:
    r = FROZEN_NOT_UPDATED
    out: List[Finding] = []
    if not program.frozen_paths:
        out.append(_finding(
            r, program,
            "frozen-scenario program carries no frozen-path evidence — "
            "train_program records the frozen leaves on probe/distill "
            "arms; nothing to audit",
            task=getattr(cfg, "task", "train")))
        return out
    frozen = program.frozen_paths
    for m in program.opt_moment_paths:
        if any(m == f or m.startswith(f + ".") for f in frozen):
            out.append(_finding(
                r, program,
                f"optimizer moment exists for frozen leaf {m!r}: the "
                f"freeze does not cover it and AdamW will step it",
                moment_path=m))
    for name in program.frozen_changed:
        out.append(_finding(r, program, f"frozen leaf {name!r} changed in a step", leaf=name))
    if getattr(cfg, "task", "train") == "distill":
        if not program.teacher_grad_fn:
            out.append(_finding(
                r, program,
                "distill step recorded no teacher forward — the teacher's "
                "autograd state cannot be audited"))
        elif any(program.teacher_grad_fn):
            out.append(_finding(
                r, program,
                "the distill step's teacher outputs carry a grad_fn — the "
                "teacher tower is not severed from autograd and teacher "
                "gradients may be computed"))
    return out


NO_HOST_TRANSFER = RULES[0]
DONATION_HONORED = RULES[1]
COLLECTIVE_DTYPE = RULES[2]
GATHER_OVERLAP = RULES[3]
NO_REPLICATED_LARGE = RULES[4]
SERVE_NO_RECOMPILE = RULES[5]
QUANT_WEIGHTS_RESIDENT = RULES[6]
FUSED_OPTIMIZER = RULES[7]
FUSED_DEQUANT = RULES[8]
FROZEN_NOT_UPDATED = RULES[9]


def rules_for(program: Program) -> List[Rule]:
    return [r for r in RULES if r.applicable(program)]


def run_rules(program: Program) -> Tuple[List[str], List[Finding]]:
    """Run every applicable rule over one program.

    Returns (rule ids run, findings). An empty findings list from a rule
    means the invariant holds in this program."""
    ran, findings = [], []
    for r in rules_for(program):
        ran.append(r.id)
        findings.extend(r.check(program, program.config))
    return ran, findings


# --- programs (the arms analysis/check.py runs) ------------------------------

# vitax's geometry (vitax/analysis/rules.py BASE_GEOMETRY): small enough for
# the CPU; batch_size 64 is split over the ranks of the fsdp arms.
BASE_GEOMETRY = dict(
    image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2,
    num_classes=4, batch_size=64, warmup_steps=2,
)

# arm name -> Config overrides on top of BASE_GEOMETRY, vitax's. dtype
# defaults to bfloat16, so the bf16 comm-cast policy (and with it VTX-R003)
# is active on every fsdp arm; "dp" pins float32 as the no-policy baseline
# and runs in one process, unsharded (its replicas' all-reduce is not one of
# the rules' evidence).
TRAIN_ARMS: Dict[str, dict] = {
    "dp": dict(run_without_fsdp=True, dtype="float32"),
    "zero2": dict(reshard_after_forward=False),
    "zero3": dict(gather_overlap="off"),
    "zero3_overlap": dict(gather_overlap="on"),
    "accum": dict(batch_size=128, grad_accum_steps=2),
    "moe": dict(moe_experts=4, gather_overlap="off"),
    # forced fused optimizer: the arm that activates VTX-R008 on the CPU (the
    # dispatcher runs the plain version there)
    "fused": dict(gather_overlap="off", fused_optimizer="on"),
    # scenario arms (programs/registry.py): the probe's frozen backbone and
    # the distill two-tower step — the arms that activate VTX-R010
    "probe": dict(task="probe", gather_overlap="off"),
    "distill": dict(task="distill", gather_overlap="off"),
}

SERVE_ARM = "serve"
# quantized serving: the same geometry with the params int8-quantized in
# memory (serve/quant.py quantize_params_for_serve); runs R006 plus R007
SERVE_QUANT_ARM = "serve_quant"
# the fp8 weight arm: the same machinery with float8_e4m3 leaves
SERVE_FP8_ARM = "serve_fp8"
# int8 weights + dynamic activation quant + forced fused dequant-matmul (the
# plain version on the CPU) — the serve twin of the "fused" train arm;
# activates VTX-R009
SERVE_ACTQUANT_ARM = "serve_actquant"
SERVE_ARMS = (SERVE_ARM, SERVE_QUANT_ARM, SERVE_FP8_ARM, SERVE_ACTQUANT_ARM)
ALL_ARMS = tuple(TRAIN_ARMS) + SERVE_ARMS
# vitax's pre-push subset: the overlap arm (every train rule but R008 and
# R010), the fused arm for R008, the scenario arms for R010, and the serve
# arms for R006/R007 (both quant dtypes) and R009 (forced fused)
FAST_ARMS = ("zero3_overlap", "fused", "probe", "distill") + SERVE_ARMS
# the arms that shard (fsdp > 1 under two ranks): everything but dp and
# the serve arms
SHARDED_ARMS = tuple(a for a in TRAIN_ARMS if not TRAIN_ARMS[a].get("run_without_fsdp"))
MAX_ITERATION = 100


def arm_config(arm: str, **overrides) -> Config:
    kw = dict(BASE_GEOMETRY)
    if arm == SERVE_ARM:
        kw.update(serve_max_batch=4)
    elif arm == SERVE_QUANT_ARM:
        kw.update(serve_max_batch=4, serve_quant_dtype="int8")
    elif arm == SERVE_FP8_ARM:
        kw.update(serve_max_batch=4, serve_quant_dtype="float8_e4m3")
    elif arm == SERVE_ACTQUANT_ARM:
        kw.update(serve_max_batch=4, serve_quant_dtype="int8",
                  serve_act_quant="int8", fused_dequant="on")
    else:
        kw.update(TRAIN_ARMS[arm])
    kw.update(overrides)
    return Config(**kw).validate()


def _build_tower(cfg: Config, device: torch.device, mesh):
    """A model of cfg from its seed, sharded under `mesh` as the train
    loop shards it."""
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops.attention import make_attention_impl
    impl = make_attention_impl(cfg, device, mesh)
    if mesh is None:
        return build_model(cfg, device, attention_impl=impl)
    from vitax_torch.parallel.sharding import apply_fsdp, init_sharded
    model = apply_fsdp(build_model(cfg, "meta", attention_impl=impl), cfg, mesh)
    model.to_empty(device=device)
    init_sharded(model, cfg, device)
    return model


def seeded_batch(cfg: Config, rows: int, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """uint8 images and labels from numpy's generator at `seed`, on `device`."""
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    return {"image": torch.from_numpy(rng.integers(0, 256, (rows, s, s, 3), dtype=np.uint8)).to(device),
            "label": torch.from_numpy(rng.integers(0, cfg.num_classes, rows)).to(device)}


def _local_shapes(model, trains) -> Tuple[Tuple[int, ...], ...]:
    from vitax_torch.train.state import local
    shapes = set()
    for n, p in model.named_parameters():
        if trains(n):
            shapes.add(tuple(p.shape))
            shapes.add(tuple(local(p).shape))
    return tuple(sorted(shapes))


def train_program(cfg: Config, state, step: Callable, batch: Dict[str, torch.Tensor], *, arm: str = "custom",
                  device="cpu", mesh=None, optimizer=None, teacher=None) -> Program:
    """Take the evidence of one more step of `step` on `state` (not a log
    step: no metric is read back) and return the Program. The state must
    have stepped before (grads and gathers settled). On the card the step
    runs under torch.cuda.set_sync_debug_mode("error"), except in a gloo
    group (gloo stages CUDA tensors through the host by design: there the
    recorder alone holds R001); under a mesh with fsdp > 1 under
    torch.profiler (record_shapes) for the collectives."""
    from vitax_torch.parallel.mesh import dim_size
    from vitax_torch.telemetry.profiler import STEP_PREFIX
    device = torch.device(device)
    trains = optimizer.trains if optimizer is not None else (lambda n: n in state.mu)
    frozen: Dict[str, torch.Tensor] = {}
    frozen_paths: Tuple[str, ...] = ()
    moment_paths: Tuple[str, ...] = ()
    if cfg.task == "probe":
        frozen = {n: p for n, p in state.model.named_parameters() if n not in state.mu}
        frozen_paths, moment_paths = tuple(sorted(frozen)), tuple(sorted(state.mu))
    elif cfg.task == "distill" and teacher is not None:
        frozen = {f"teacher.{n}": p for n, p in teacher.named_parameters()}
        frozen_paths = tuple(sorted(frozen))
        moment_paths = tuple(sorted(f"student.{n}" for n in state.mu))
    frozen_before = {n: trace.local_copy(p) for n, p in frozen.items()}
    grad_fns: List[bool] = []
    hook = (teacher.register_forward_hook(lambda m, i, o: grad_fns.append(o.grad_fn is not None))
            if teacher is not None else None)
    cuda = device.type == "cuda"
    prof = path = None
    if mesh is not None and dim_size(mesh, "fsdp") > 1:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                       record_shapes=True)
    debug_syncs = cuda and (mesh is None or torch.distributed.get_backend() == "nccl")
    if cuda:
        torch.cuda.synchronize(device)
    before, mem0 = trace.storage_map(state), (torch.cuda.memory_allocated(device) if cuda else None)
    sync_error = ""
    try:
        if prof is not None:
            prof.start()
        with trace.launch_delta() as ld, trace.OpRecorder() as rec:
            mode = torch.cuda.get_sync_debug_mode() if debug_syncs else None
            if debug_syncs:
                torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.profiler.record_function(f"{STEP_PREFIX}{state.step + 1}"):
                    step(state, batch)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                sync_error = str(e).splitlines()[0]
            finally:
                if debug_syncs:
                    torch.cuda.set_sync_debug_mode(mode)
    finally:
        if prof is not None:
            prof.stop()
            fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
            os.close(fd)
            prof.export_chrome_trace(path)
        if hook is not None:
            hook.remove()
    if cuda:
        torch.cuda.synchronize(device)
    try:
        colls = trace.collectives(path) if path else []
        order = trace.forward_gather_order(trace.fsdp_ranges(path), cfg.num_blocks) if path else {}
    finally:
        if path:
            os.remove(path)
    changed = tuple(n for n, p in frozen.items() if not torch.equal(trace.local_copy(p), frozen_before[n]))
    leaves = trace.state_leaves(state)
    return Program(
        kind="train", arm=arm, config=cfg, device=device.type,
        mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {},
        n_state_leaves=len(leaves) + 1, frozen_paths=frozen_paths, opt_moment_paths=moment_paths,
        ops=rec, launches=ld, sync_error=sync_error, storage_before=before, storage_after=trace.storage_map(state),
        memory_before=mem0, memory_after=torch.cuda.memory_allocated(device) if cuda else None,
        state_leaves=leaves, param_shapes=_local_shapes(state.model, trains), collectives=colls,
        gather_order=order, frozen_changed=changed, teacher_grad_fn=tuple(grad_fns))


def build_train_program(cfg: Config, arm: str = "custom", device="cpu", mesh=None,
                        wrap_step: Optional[Callable] = None) -> Program:
    """Build the scenario's state and step for `cfg` on `device` (under
    `mesh`, this rank's), step once, then take one more step's evidence.
    The distill teacher is a seeded tower (seed + 1) of the same config,
    frozen as programs/workloads.py load_teacher freezes one. `wrap_step`
    wraps the step (the check's seeded violations)."""
    from vitax_torch.parallel.mesh import batch_shard
    from vitax_torch.programs.builder import build_program as build_step
    from vitax_torch.programs.registry import get_scenario
    from vitax_torch.train.state import make_train_state
    device = torch.device(device)
    optimizer, _ = get_scenario(cfg.task).make_optimizer(cfg, MAX_ITERATION)
    state = make_train_state(_build_tower(cfg, device, mesh).train(), optimizer)
    teacher = None
    if cfg.task == "distill":
        from vitax_torch.programs.workloads import make_distill_step
        teacher = _build_tower(dataclasses.replace(cfg, seed=cfg.seed + 1), device, mesh)
        teacher = teacher.requires_grad_(False).eval()
        step = make_distill_step(cfg, optimizer, device, teacher, mesh)
    else:
        step = build_step("train", cfg, optimizer, device, mesh)
    index, ranks = batch_shard(mesh)
    batch = seeded_batch(cfg, cfg.batch_size // ranks, device, seed=index)
    step(state, batch)
    if wrap_step is not None:
        step = wrap_step(step)
    return train_program(cfg, state, step, batch, arm=arm, device=device, mesh=mesh, optimizer=optimizer,
                         teacher=teacher)


def serve_program(engine, cfg: Config, arm: str = SERVE_ARM) -> Program:
    """The Program of a warmed engine."""
    return Program(kind="serve", arm=arm, config=cfg, device=engine.device.type, engine=engine)


def build_serve_program(cfg: Config, arm: str = SERVE_ARM, device="cpu") -> Program:
    """Build and warm an InferenceEngine over a seeded model (quantized in
    memory for the quant arms); the bucket and residency invariants do not
    depend on the weights."""
    from vitax_torch.serve.engine import InferenceEngine
    from vitax_torch.serve.quant import quantize_params_for_serve
    device = torch.device(device)
    model = _build_tower(cfg, device, None)
    quant = cfg.serve_quant_dtype
    if quant:
        state = quantize_params_for_serve(dict(model.state_dict()), quant)
        engine = InferenceEngine.from_state(cfg, state, device, quant)
    else:
        engine = InferenceEngine(cfg, model, device)
    engine.warmup()
    return serve_program(engine, cfg, arm)


def build_program(arm: str, device="cpu", mesh=None, wrap_step: Optional[Callable] = None,
                  **overrides) -> Program:
    cfg = arm_config(arm, **overrides)
    if arm in SERVE_ARMS:
        return build_serve_program(cfg, arm=arm, device=device)
    return build_train_program(cfg, arm=arm, device=device, mesh=mesh, wrap_step=wrap_step)
