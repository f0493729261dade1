"""Training orchestration (vitax/train/loop.py train, _run_epochs,
_run_logging, eval_on_val), on one device, or one card per process under
torchrun with FSDP2 (ZeRO-3, ZeRO-2 or the DP baseline,
parallel/sharding.py).

Under a process group train() builds the ("dp", "fsdp", "tp", "sp", "ep")
mesh, the model on the meta device, shards it (apply_fsdp), then inits
each rank's shards (bitwise the unsharded init) or restores them; each
rank reads its batch shard's slice of every global batch; eval counts are
summed over the ranks (sp and tp index 0 of each batch shard, on the last
pipeline stage), so top-1
is over the whole val split; only rank 0 prints. Under sp (vitax's _token_sharding and
_select_attention) the model runs on the rank's token slice through the
ring or Ulysses core that make_attention_impl builds on the mesh, and the
log names it as vitax does ("attention core: ring attention (sp)").
Under --moe_experts every block's MLP is the routed MoeMlp (models/moe.py)
and, at --ep_size > 1, its experts are sharded over the ep group; under
sp its capacity is the whole sequence's, under tp it runs whole on every
tp rank.
At --tp_size > 1 each block runs H/tp whole heads and 1/tp of the MLP
features over the tp group (parallel/tensor_parallel.py); telemetry's MFU
stays the global FLOPs over the world size, as vitax's. At --pp_size > 1
each rank builds its pipeline stage only (its blocks under their global
names, models/vit.py) and the step runs --pp_schedule over
--pp_microbatches (parallel/pipeline.py); eval counts come from the last
stage.
Without one (no WORLD_SIZE
in the environment, no group made by the caller) it trains unwrapped on
one device, as before.

The loop dispatches one train step per batch and reads nothing back from
the device except at a log step: there it fetches the loss once (which
also waits for the step, so the step time it logs is the device's, not the
enqueue's). Eval counts stay on the device until the end of the pass.
Dropout seeds are the JAX loop's data_rng (key(seed + 1), :550) ported as
a host function of (seed, step, microbatch): train/step.py dropout_seeds.
Each log record carries data_wait_s, the seconds a step waited on the
loader (:654), and each epoch ends with a line saying which decode path
(native or PIL) fed it.

Checkpoints follow the JAX loop: a save every ckpt_epoch_interval epochs
and at the last one (which waits for the commit; the others write in the
background while the next epoch trains), through checkpoint/io.py.
--resume_epoch N restores epoch N and fails if it cannot; -1 resumes the
latest committed epoch, falls back loudly to an earlier one if it fails
to restore, and starts fresh on an empty dir. On resume the model is
built without an init and the checkpoint loaded into it; the restored
`step` and `count` give the schedule's lr and the dropout seeds. A
mid-epoch checkpoint (its sidecar's step_in_epoch) re-enters its epoch at
the next step, and a stream loader's cursor is checked against it.

Failures (vitax's reaction layer): --fault_plan (faults.py) arms the
drill sites, the `step` site after each dispatch with the run's step
count. A SIGTERM (train/preempt.py), the watchdog's escalation
(telemetry/watchdog.py, --hang_timeout_s, started once the first step's
loss is back, so the kernels' first-use build is outside its window), a
fault and a lost peer fold into the control plane's word
(train/control.py, agreed every --control_sync_steps steps and at each
epoch boundary): a preemption commits a mid-epoch save and returns (exit
0); the others commit an emergency save and exit 42 for the supervisor
(supervise.py). Under --peer_heartbeat_s the survivors of a lost rank
exit 42 within the grace window, and an error a dead peer raised in a
collective is classified so. --zero_stall_ckpt routes every save through
the snapshot pipeline (checkpoint/snapshot.py); --replicate_steps mirrors
the staged state to the ring buddy every N steps and at each save
(checkpoint/peer.py), and an auto-resume restores from the peer stores
when their newest complete version is at least as fresh as the DCP
frontier (the restore event says which path won, its seconds and its
checkpoint-directory reads).

The task's scenario (programs/registry.py) builds the optimizer and names
the step: --task finetune and probe warm-start from --init_npz when not
resuming (a checkpoint wins), the probe training the head only; --task
distill steps a frozen teacher from --teacher_npz beside the student. The
FLOP count stays the student's under every task, so MFU leaves the
teacher's forward out, as vitax's does.

The profiler window (telemetry/profiler.py, vitax's :553-615): with
--profile_dir the loop opens a torch.profiler window after
--profile_start_step completed steps, and after --profile_num_steps more
synchronizes the card and writes <profile_dir>/rank<r>.pt.trace.json,
each step in it under a `vitax_step_<n>` range; a window still open at
the loop's end is closed there. --compile_cache_dir builds and reuses the
kernels' libraries there (ops/_build.py set_build_dir). With
--arbiter_url rank 0 posts its step to the chip arbiter every step
(train/control.py ArbiterReporter; a thread, the step unchanged) and
flushes the last one at the end.

Telemetry (telemetry/, vitax's): with --metrics_dir, rank 0 writes
<metrics_dir>/metrics.jsonl: a run_start event, a finetune event after a
warm start, a restore event on a resume, a control/elastic_resume event
when the process count changed, a schema-1 step record at every log step
from the host values the loop fetched there (and under --task distill a
distill event beside it), an eval event a pass, and the failure layer's
fault, hang, hang_escalation, hang_hard_exit, control and peer_replication
events; ckpt_stall_s is the pipeline's staging stall (0.0 without it). The update's own
seconds (opt_update_s) are timed at those log steps only, by CUDA events
on the card that launch nothing, so the step launches the same kernels in
the same order with telemetry on or off. Every process meets the others at
vitax's four named barriers: loaded dataset, loaded model, loaded
optimizer, training begins. --debug_nans turns on autograd's anomaly
mode with NaN checks and fetches the loss and grad norm every step.
"""

from __future__ import annotations

import dataclasses
import math
import pprint
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from vitax_torch import distributed, faults
from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint import peer
from vitax_torch.checkpoint.snapshot import SnapshotPipeline
from vitax_torch.config import Config
from vitax_torch.data.loader import build_datasets
from vitax_torch.models.moe import capacity
from vitax_torch.models.vit import build_model, count_params
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.ops.fused_optimizer import fused_optimizer_active
from vitax_torch.parallel.mesh import batch_shard, build_mesh, expert_shard, pipe_shard, tensor_shard, token_shard
from vitax_torch.parallel.sharding import apply_fsdp, init_sharded, reshard
from vitax_torch.platform import DeviceLike, device_kind
from vitax_torch.programs.builder import build_program
from vitax_torch.programs.registry import get_scenario
from vitax_torch.programs.workloads import DISTILL_METRICS, frozen_fraction, warm_start_from_npz
from vitax_torch.telemetry import build_recorder, install_thread_excepthook, restore_thread_excepthook
from vitax_torch.telemetry.watchdog import EXIT_HANG, Watchdog
from vitax_torch.train import preempt
from vitax_torch.telemetry.profiler import ProfilerWindow
from vitax_torch.train.control import ArbiterReporter, ControlPlane, elastic_resume_plan, store_client
from vitax_torch.train.state import ADAMW_HPARAMS, TrainState, make_train_state
from vitax_torch.train.step import _needs_dropout
from vitax_torch.utils.logging import master_print, memory_summary
from vitax_torch.utils.metrics import SmoothedValue


def set_float32_precision() -> None:
    """Full float32 matmuls and convolutions (TF32 off for both), so a
    float32 run on the card computes what the CPU reference computes; the
    bf16 default is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def train(cfg: Config, device: DeviceLike = None,
          records: Optional[List[Dict[str, float]]] = None, data: Optional[tuple] = None) -> TrainState:
    """Train per cfg on `device` (default cuda; raises without a card) and
    return the final state. If `records` is a list, each log step appends
    {"epoch", "step", "loss", "lr", "sec_per_iter", "step_seconds",
    "grad_norm", "data_wait_s"} to it (under --task distill also "kl",
    "ce", "teacher_top1" and "student_top1"), each eval {"epoch", "top1",
    "top5"}, and each checkpoint save {"epoch", "ckpt_path",
    "ckpt_stall_s"} (the seconds save_state held the loop). `data` is
    build_datasets' (train_ds, train_loader, val_ds, val_loader), default
    build_datasets(cfg, device)."""
    cfg.validate()
    device = distributed.maybe_initialize(device)  # joins torchrun's process group; this rank's device
    rank = distributed.process_index()
    hook = install_thread_excepthook(None, rank)    # background-thread crashes: rank-tagged on stderr
    fused = fused_optimizer_active(cfg, device)     # raises for --fused_optimizer off on the card
    set_float32_precision()
    if cfg.compile_cache_dir:                       # the kernels' libraries: a warm directory builds nothing
        from vitax_torch.ops import _build
        master_print(f"kernel build cache: {_build.set_build_dir(cfg.compile_cache_dir)}")
    mesh = build_mesh(cfg, device) if distributed.is_distributed() else None
    if mesh is None and cfg.sp_size > 1:   # a lone process would run the whole sequence
        raise ValueError(f"--sp_size {cfg.sp_size} shards the tokens over {cfg.sp_size} processes: launch them "
                         f"with torchrun (--nproc_per_node a multiple of {cfg.sp_size})")
    if mesh is None and cfg.tp_size > 1:   # a lone process holds every head
        raise ValueError(f"--tp_size {cfg.tp_size} shards the blocks over {cfg.tp_size} processes: launch them "
                         f"with torchrun (--nproc_per_node a multiple of {cfg.tp_size})")
    if mesh is None and cfg.pp_size > 1:   # a lone process holds every stage
        raise ValueError(f"--pp_size {cfg.pp_size} splits the blocks over {cfg.pp_size} processes: launch them "
                         f"with torchrun (--nproc_per_node a multiple of {cfg.pp_size})")
    if mesh is None and cfg.ep_size > 1:   # a lone process holds every expert
        raise ValueError(f"--ep_size {cfg.ep_size} shards the experts over {cfg.ep_size} processes: launch them "
                         f"with torchrun (--nproc_per_node a multiple of {cfg.ep_size})")
    _, ranks = batch_shard(mesh)
    if cfg.batch_size % ranks or (cfg.batch_size // ranks) % cfg.grad_accum_steps:
        raise ValueError(f"--batch_size {cfg.batch_size} must split into {ranks} equal rank batches, each a "
                         f"multiple of --grad_accum_steps {cfg.grad_accum_steps}")
    pipe = pipe_shard(mesh)
    if pipe is not None:
        from vitax_torch.parallel.pipeline import Hop, check_batch
        microbatches = check_batch(cfg, mesh, pipe)
    fault_plan = faults.install_from_config(cfg, rank)   # armed before any hook can fire, on every restart
    auto_resume = cfg.resume_epoch < 0
    dcp_found = 0
    if auto_resume:                     # the latest committed checkpoint, if any, as rank 0 sees it
        found = distributed.broadcast_from_process0(ckpt_io.latest_epoch(cfg.ckpt_dir) or 0)
        cfg = dataclasses.replace(cfg, resume_epoch=found)
        master_print(f"auto-resume: {'epoch ' + str(found) if found else 'no checkpoint found, fresh start'}")
        dcp_found = found
    master_print(f"\n=== cfg ===\n{pprint.pformat(cfg)}\n")
    master_print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                        if device.type == "cuda" else ""))
    if fault_plan is not None:
        master_print(f"fault injection ARMED (drill): {fault_plan.describe()}")
    # the zero-stall pipeline and the peer replicator, built before the
    # resume so the peer stores can be its source
    snap_pipe = replicator = peer_plan = None
    deferred_events: list = []          # (kind, payload) raised before the recorder exists
    if cfg.zero_stall_ckpt or cfg.replicate_steps > 0:
        snap_pipe = SnapshotPipeline(device=device)
        master_print("zero-stall checkpointing: the device-to-host copy queued on a side stream, the DCP write "
                     "on a background worker")
    if cfg.replicate_steps > 0:
        replicator = peer.PeerReplicator(peer.PeerStore(peer.resolve_peer_dir(cfg, rank)), process_index=rank,
                                         process_count=distributed.process_count(), client=store_client())
        replicator.start_receiver()
        master_print(f"peer replication: every {cfg.replicate_steps} steps -> buddy rank {replicator.buddy} (local "
                     f"store {replicator.store.root}, guarding rank {replicator.guard})")
        if auto_resume:                 # the newest complete peer version at least as fresh as the DCP frontier
            frontier = ((0, 0) if not dcp_found else
                        peer.progress_key(dcp_found, ckpt_io.load_resume_step(cfg.ckpt_dir, dcp_found) or 0))
            peer_plan = peer.negotiate_restore(
                replicator.store, process_index=rank, process_count=distributed.process_count(),
                client=store_client(), stores=replicator.store_of, dcp_frontier=frontier,
                on_event=lambda kind, payload: deferred_events.append((kind, payload)))
            if peer_plan is not None:
                cfg = dataclasses.replace(cfg, resume_epoch=peer_plan.epoch)
                master_print(f"peer restore agreed: version {list(peer_plan.version)} is at least as fresh as the "
                             f"DCP frontier {list(frontier)} — restoring from peer shards, not the checkpoint "
                             f"directory")
    if mesh is not None:
        kind = ("DP (HSDP, shard group 1)" if cfg.run_without_fsdp else
                "ZeRO-3" if cfg.reshard_after_forward else "ZeRO-2")
        master_print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {mesh.size()} process(es), one "
                     f"{device.type} device each, {ranks} batch shard(s); {kind}, params gathered in "
                     f"{'bfloat16' if cfg.comm_cast_active else 'float32'}, grads reduced in "
                     f"{cfg.grad_reduce_dtype}")

    train_ds, train_loader, _, val_loader = data if data is not None else build_datasets(cfg, device)
    distributed.barrier("loaded dataset")
    master_print(f"\n=== dataset ===\n{train_ds!r}\n")

    # a mid-epoch checkpoint re-enters its epoch at the recorded step (a
    # peer version's meta is sidecar-shaped: the same planner reads it)
    if peer_plan is not None:
        plan = elastic_resume_plan(peer_plan.meta, distributed.process_count())
        resume_step, resume_rounded = plan.resume_step, plan.epoch_rounded
        topology_change = (plan.from_processes, distributed.process_count()) if plan.topology_changed else None
    else:
        resume_step, topology_change, resume_rounded = (_elastic_resume(cfg, cfg.resume_epoch)
                                                        if cfg.resume_epoch > 0 else (0, None, False))
    attention_impl = make_attention_impl(cfg, device, mesh)
    tokens = token_shard(cfg, mesh)
    master_print(f"attention core: {getattr(attention_impl, 'vitax_name', 'dense')} on {device.type} "
                 f"(N {cfg.num_patches}" + (f", {cfg.num_patches // tokens.count} a rank over sp {tokens.count}"
                                           if tokens else "")
                 + f"); grad_ckpt {cfg.grad_ckpt}, remat_policy {cfg.remat_policy}"
                 + (f", one checkpoint a group of {cfg.remat_window} blocks" if cfg.remat_window > 1 else ""))
    heads = tensor_shard(mesh)
    if heads is not None:
        master_print(f"tensor parallel: tp {heads.count}, {cfg.num_heads // heads.count} heads and "
                     f"{cfg.mlp_hidden_dim // heads.count} MLP features a rank (qkv rows relaid to whole heads "
                     f"by one all-to-all a block)")
    if pipe is not None:
        per = cfg.num_blocks // pipe.count
        master_print(f"pipeline: pp {pipe.count}, {cfg.pp_schedule} schedule, {per} blocks a stage (stages hold "
                     + ", ".join(f"[{s * per}, {(s + 1) * per})" for s in range(pipe.count))
                     + f"), {microbatches} microbatches of {cfg.batch_size // ranks // microbatches} rows a rank a "
                     f"step; stage hops over {Hop(pipe, device).route}")
    experts = expert_shard(mesh)
    if cfg.moe_experts > 0:
        master_print(f"moe: {cfg.moe_experts} experts, top-{cfg.moe_top_k}, capacity factor "
                     f"{cfg.moe_capacity_factor}, {cfg.moe_impl} dispatch, aux weight {cfg.moe_aux_weight}"
                     + (f"; {cfg.moe_experts // experts.count} experts a rank over ep {experts.count}"
                        if experts else "")
                     + (f"; capacity {capacity(cfg.moe_experts, cfg.num_patches, cfg.moe_capacity_factor)} slots "
                        f"over the whole sequence across sp {tokens.count}" if tokens else "")
                     + (f"; the whole MoE on every tp rank (experts replicated over tp {heads.count})"
                        if heads else ""))
    if _needs_dropout(cfg):
        where = "in the flash core" if attention_impl else "dense"
        master_print(f"dropout: att {cfg.att_dropout} ({where}), mlp and proj {cfg.mlp_dropout}, "
                     f"pos {cfg.pos_dropout}; seeds per (step, microbatch, block) from seed {cfg.seed}")
    if mesh is not None:                # built on meta, sharded, then each rank's shards filled
        model = apply_fsdp(build_model(cfg, "meta", attention_impl=attention_impl, token_shard=tokens,
                                       expert_shard=experts, tensor_shard=heads, pipe_shard=pipe), cfg, mesh)
        model.to_empty(device=device)
        if cfg.resume_epoch == 0:
            init_sharded(model, cfg, device)
    elif cfg.resume_epoch > 0:          # storage without an init: the checkpoint supplies every value
        model = build_model(cfg, device, attention_impl=attention_impl, init=False).to_empty(device=device)
    else:
        model = build_model(cfg, device, attention_impl=attention_impl)
    model.train()
    steps_per_epoch = cfg.steps_per_epoch or train_loader.steps_per_epoch
    max_iteration = steps_per_epoch * cfg.num_epochs
    # the scenario builds the optimizer: train and distill AdamW over every
    # leaf, finetune with the backbone's lr multiplier, probe the head only
    scenario = get_scenario(cfg.task)
    optimizer, schedule = scenario.make_optimizer(cfg, max_iteration)
    state = make_train_state(model, optimizer)
    restore_info = None                 # {"path": "peer" | "dcp", "epoch": N}: the restore event
    reads_before, t_restore = ckpt_io.restore_read_count(), time.perf_counter()
    if cfg.resume_epoch > 0:
        if peer_plan is not None:       # peer shards first; a failure falls back loudly to the DCP epoch
            state, restore_info = peer.restore_state_preferring_peers(
                replicator.store, peer_plan, cfg.ckpt_dir, dcp_found, state,
                on_event=lambda kind, payload: deferred_events.append((kind, payload)))
            if restore_info["path"] == "dcp":
                cfg = dataclasses.replace(cfg, resume_epoch=restore_info["epoch"])
                resume_step, topology_change, resume_rounded = _elastic_resume(cfg, cfg.resume_epoch)
        elif auto_resume:               # survive one bad checkpoint: fall back to an earlier one
            state, restored = ckpt_io.restore_state_with_fallback(cfg.ckpt_dir, cfg.resume_epoch, state)
            if restored != cfg.resume_epoch:
                cfg = dataclasses.replace(cfg, resume_epoch=restored)
                resume_step, topology_change, resume_rounded = _elastic_resume(cfg, restored)
        else:                           # an explicit --resume_epoch N means N: fail hard
            state = ckpt_io.restore_state(cfg.ckpt_dir, cfg.resume_epoch, state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_info = restore_info or {"path": "dcp", "epoch": cfg.resume_epoch}
        restore_info.update(seconds=time.perf_counter() - t_restore,
                            dcp_reads=ckpt_io.restore_read_count() - reads_before)
        master_print(f"restored epoch {cfg.resume_epoch}: step {state.step} (from {restore_info['path']} in "
                     f"{restore_info['seconds']:.2f} s, {restore_info['dcp_reads']} checkpoint-directory read(s))")
    finetune_info = None
    if cfg.init_npz and cfg.resume_epoch <= 0:
        # the finetune/probe warm start; a checkpoint wins over it on resume
        state, finetune_info = warm_start_from_npz(cfg, state)
    distributed.barrier("loaded model")
    master_print(f"global parameter num: {count_params(model)}")
    master_print(
        f"\n=== optimizer ===\nAdamW(lr=warmup_cosine(base={cfg.lr}, warmup={cfg.warmup_steps}, "
        f"max_iteration={max_iteration}), betas=({ADAMW_HPARAMS['b1']}, {ADAMW_HPARAMS['b2']}), "
        f"eps={ADAMW_HPARAMS['eps']}, weight_decay={cfg.weight_decay}, "
        f"clip_grad_norm={cfg.clip_grad_norm}, fused={fused})\ntask: {cfg.task} ({scenario.description})"
        + (f"; backbone frozen ({frozen_fraction(model):.4f} of the params), moments for the head only"
           if cfg.task == "probe" else "")
        + (f"; backbone updates x {cfg.backbone_lr_mult}" if cfg.backbone_lr_mult != 1.0 else "") + "\n")
    distributed.barrier("loaded optimizer")
    if cfg.grad_accum_steps > 1:
        master_print(f"grad accumulation: {cfg.grad_accum_steps} microbatches of "
                     f"{cfg.batch_size // cfg.grad_accum_steps} (one optimizer step per loader batch)")

    train_step = build_program(scenario.step_program, cfg, optimizer, device, mesh)
    eval_step = build_program("eval", cfg, optimizer, device, mesh)

    # rank 0's telemetry; host work only, the step's launches are the same without it
    recorder = build_recorder(cfg, distributed.process_count(), device_kind(device), rank=rank, device=device)
    install_thread_excepthook(recorder, rank)       # ... and now thread_crash events too

    def sink(kind: str):
        """A writer of `kind` events for a callback, or None without telemetry."""
        return (lambda payload: recorder.event(kind, **payload)) if recorder is not None else None

    if recorder is not None:
        master_print(f"telemetry: JSONL step records -> {cfg.metrics_dir} (MFU vs {recorder.peak_tflops:.0f} "
                     f"TF/s/card peak" + (", tensorboard mirror on" if cfg.tensorboard else "") + ")")
        recorder.event("run_start", device_kind=recorder.device_kind, n_devices=recorder.n_devices,
                       peak_tflops=recorder.peak_tflops, flops_per_step=recorder.flops_per_step,
                       batch_size=cfg.batch_size)
        if fault_plan is not None:  # fired faults become kind "fault" events
            faults.set_reporter(sink("fault"))
        for kind, payload in deferred_events:
            recorder.event(kind, **payload)
        if finetune_info is not None:
            recorder.event("finetune", **finetune_info)
        if restore_info is not None:    # which path won, its seconds and its checkpoint-directory reads
            recorder.event("restore", path=restore_info["path"], epoch=int(restore_info["epoch"]),
                           resume_step=int(resume_step), dcp_reads=int(restore_info["dcp_reads"]),
                           seconds=restore_info["seconds"])
        if topology_change is not None:
            recorder.event("control", event="elastic_resume", from_processes=topology_change[0],
                           to_processes=topology_change[1], epoch=cfg.resume_epoch, resume_step=resume_step,
                           epoch_rounded=resume_rounded)
    if replicator is not None and recorder is not None:
        replicator.on_event = lambda kind, payload: recorder.event(kind, **payload)
    preempt.install()                   # SIGTERM -> a committed save -> exit 0
    watchdog = None
    if cfg.hang_timeout_s > 0:
        # built here, started when the first step's loss is back: the kernels'
        # first-use build and the first step are not a hang
        watchdog = Watchdog(cfg.hang_timeout_s, on_fire=sink("hang"), rank=rank, action=cfg.hang_action,
                            on_escalate=sink("hang_escalation"), device=device)
        master_print(f"watchdog: stack+memory dump after {cfg.hang_timeout_s:.0f}s without a completed step (armed "
                     f"after the first step)" + (f", then emergency checkpoint + exit {EXIT_HANG}"
                                                 if cfg.hang_action == "checkpoint_exit" else ""))
    # the control plane: preemption, escalation, fault and peer loss folded
    # into one word the processes agree on, so all act at the same step
    control = ControlPlane(sync_steps=cfg.control_sync_steps, watchdog=watchdog,
                           on_event=sink("control"))
    if watchdog is not None:
        def last_words(payload):        # a flushed event and the cause published, before the hard exit
            if recorder is not None:
                recorder.event("hang_hard_exit", **payload)
            control.publish_fault("hang_hard_exit")
        watchdog.on_hard_exit = last_words
    if cfg.peer_heartbeat_s > 0:
        grace_s = cfg.peer_grace_s or 10.0 * cfg.peer_heartbeat_s
        if control.start_liveness(cfg.peer_heartbeat_s, grace_s):
            master_print(f"peer liveness: heartbeats every {cfg.peer_heartbeat_s:g}s through the c10d store; a peer "
                         f"silent for {grace_s:g}s is declared lost and survivors exit {EXIT_HANG} within the "
                         f"deadline instead of blocking in collectives")
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        master_print("debug_nans: autograd anomaly mode with NaN checks; the loss and grad norm are fetched "
                     "every step")
    reporter = None
    if cfg.arbiter_url and rank == 0:   # the chip arbiter's heartbeat: a thread, the step unchanged
        reporter = ArbiterReporter(cfg.arbiter_url, process_count=distributed.process_count())
        reporter.start()
        master_print(f"arbiter telemetry: posting step heartbeats to {cfg.arbiter_url}")
    window = ProfilerWindow(cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps, device, rank,
                            say=master_print)
    control.warmup()                    # the agreement's first collective outside any hang deadline
    distributed.barrier("training begins")
    master_print("training begins")
    lost = None
    try:
        return _run_epochs(cfg, state, train_step, train_loader, val_loader, eval_step, schedule, control,
                           records, train_ds, resume_step=resume_step, resume_rounded=resume_rounded,
                           recorder=recorder, watchdog=watchdog, snap_pipe=snap_pipe, replicator=replicator,
                           window=window, reporter=reporter)
    except Exception as e:  # noqa: BLE001 - classified: a lost peer exits 42, anything else is re-raised
        # gloo raises where NCCL blocks on a dead peer, and a lost rank 0
        # takes the store with it: ask the liveness monitor which this is
        lost = control.peer_loss_suspected()
        if lost is None:
            raise
        print(f"vitax_torch.control: runtime error after losing peer {lost} ({type(e).__name__}: {e}); exiting "
              f"{EXIT_HANG} for the supervisor to restart from the last committed checkpoint",
              file=sys.stderr, flush=True)
        raise SystemExit(EXIT_HANG) from e
    finally:
        # vitax's teardown order; after a lost peer the plane's exit timer
        # stays armed through it (a drain over the dead peer must not hang)
        torch.autograd.set_detect_anomaly(*anomaly)
        window.close()                  # a window the loop left open
        if lost is None:
            control.stop()
        if reporter is not None:
            reporter.stop()             # flushes the last step
        if watchdog is not None:
            watchdog.stop()
        try:
            if replicator is not None:
                replicator.stop()       # the receiver, and one last pull of the guard's shard
            if snap_pipe is not None:
                snap_pipe.close()       # the queued persist and replicate jobs
            ckpt_io.wait_until_finished()   # no exit with a save in flight
        finally:
            restore_thread_excepthook(hook)
            if recorder is not None:
                recorder.close()
            faults.uninstall()          # a plan is the run's, as the recorder
            preempt.uninstall()
            control.stop()


def _elastic_resume(cfg: Config, epoch: int):
    """(resume_step, (from, to) process counts when they differ else None,
    epoch_rounded) for re-entering `epoch` under this run's process count,
    from the epoch's sidecar (vitax/train/loop.py _elastic_resume).
    epoch_rounded: the mid-epoch progress was dropped, so the loop
    re-enters `epoch` from step 0 rather than skipping its rest."""
    count = distributed.process_count()
    plan = elastic_resume_plan(ckpt_io.load_resume_meta(cfg.ckpt_dir, epoch), count)
    if plan.topology_changed:
        master_print(
            f"elastic resume: checkpoint epoch {epoch} was written by {plan.from_processes} process(es), "
            f"this run has {count}"
            + (f" — stream cursor invalidated by the topology change; epoch-rounding the resume "
               f"(re-running {plan.skipped_steps} mid-epoch steps)" if plan.epoch_rounded else
               " — rank-interleaved sampling keeps the step-granular resume exact"))
    return plan.resume_step, (plan.from_processes, count) if plan.topology_changed else None, plan.epoch_rounded


def _verify_stream_resume(cfg: Config, train_loader, resume_step: int) -> None:
    """Mid-epoch stream resume: hold the sidecar's cursor against the
    position this run derives from (seed, epoch, step); the loader raises
    when the shard set, seed or topology changed under the checkpoint."""
    if not resume_step or not hasattr(train_loader, "check_cursor") or distributed.process_index() != 0:
        return
    cursor = ckpt_io.load_stream_cursor(cfg.ckpt_dir, cfg.resume_epoch)
    if cursor is not None:
        train_loader.check_cursor(cursor, resume_step)
        master_print(f"stream resume cursor verified: epoch {cursor.get('epoch')}, shard_cursor "
                     f"{cursor.get('shard_cursor')} ({cursor.get('shard')}), record_offset "
                     f"{cursor.get('record_offset')}")


def _decode_line(dataset) -> Optional[str]:
    """Which decode path fed the dataset so far, from its counts."""
    if not hasattr(dataset, "decoded"):
        return None
    c = dataset.decoded.snapshot()
    return (f"decoded so far: {c['native']} items native, {c['pil']} through PIL ({c['pil_jpeg']} of them "
            f"JPEG); decode path {'native' if dataset.use_native else 'PIL'}")


def _stream_cursor(loader, epoch: int, next_step: int):
    """The stream loader's resume cursor after `next_step` batches, or None
    for loaders without one; it rides a mid-epoch save's sidecar."""
    fn = getattr(loader, "cursor_for_step", None)
    return fn(epoch, next_step) if fn is not None else None


def _save_ckpt(cfg: Config, state: TrainState, epoch: int, *, wait: bool, step_in_epoch: Optional[int] = None,
               stream_cursor: Optional[dict] = None, snap_pipe=None, replicator=None) -> Tuple[str, float, float]:
    """Save through the zero-stall pipeline when it runs (every save must:
    two writers would interleave the checkpoint group's collectives), else
    save_state. Under --replicate_steps the sidecar records the window and
    the save refreshes the peer store too. Returns (path, the seconds the
    copy held the loop, the seconds a waited save then held it for the
    commit), and logs both."""
    extra = {"replicate_steps": cfg.replicate_steps} if cfg.replicate_steps > 0 else None
    t0 = time.perf_counter()
    if snap_pipe is not None:
        snap_pipe.submit(state, epoch=epoch, step_in_epoch=step_in_epoch or 0, stream_cursor=stream_cursor,
                         persist_to=cfg.ckpt_dir, keep=cfg.keep_checkpoints, extra_meta=extra, replicator=replicator,
                         wait=wait)
        stall, pinned = snap_pipe.last_stall_s, snap_pipe.last_alloc_s
    else:
        ckpt_io.save_state(cfg.ckpt_dir, epoch, state, wait=wait, step_in_epoch=step_in_epoch,
                           stream_cursor=stream_cursor, keep=cfg.keep_checkpoints, extra_meta=extra)
        stall = ckpt_io.last_snapshot_seconds()
    held = time.perf_counter() - t0 - stall
    master_print(f"checkpoint save of epoch {epoch}" + (f" (step {step_in_epoch})" if step_in_epoch else "")
                 + f": the loop held {stall:.4f} s for the copy and {held:.3f} s more"
                 + (f" (zero-stall pipeline; {pinned:.4f} s of the copy's pinning a new buffer set)"
                    if snap_pipe is not None else ""))
    return ckpt_io.epoch_ckpt_path(cfg.ckpt_dir, epoch), stall, held


def _run_epochs(  # vtx: ignore[VTX103] the log step's float(loss) fences; between them the launch queue's backpressure
        cfg: Config, state: TrainState, train_step: Callable, train_loader, val_loader,
        eval_step: Callable, schedule: Callable, control: ControlPlane,
        records: Optional[List[Dict[str, float]]] = None, train_ds=None,
        resume_step: int = 0, resume_rounded: bool = False, recorder=None, watchdog=None,
        snap_pipe=None, replicator=None, window: Optional[ProfilerWindow] = None,
        reporter: Optional[ArbiterReporter] = None) -> TrainState:
    smoothed_loss = SmoothedValue(window_size=5)
    smoothed_time = SmoothedValue(window_size=5)
    total_steps = 0
    steps_since_record = 0
    # resume_step > 0: a mid-epoch checkpoint; re-enter its epoch at that
    # step (the sampler order is a function of (seed, epoch)).
    # resume_rounded: re-run the same epoch from step 0.
    reenter = bool(resume_step) or resume_rounded
    start_epoch = cfg.resume_epoch + (0 if reenter else 1)
    if resume_step:
        master_print(f"step-granular resume: re-entering epoch {start_epoch} at step {resume_step + 1}")
        _verify_stream_resume(cfg, train_loader, resume_step)
    elif resume_rounded:
        master_print(f"epoch-rounded resume: re-running epoch {start_epoch} from step 1 (mid-epoch stream "
                     f"cursor invalidated by the topology change)")

    def coordinated_exit(epoch: int, step_in_epoch: Optional[int], sig) -> None:
        """The agreed reaction at a boundary: a jointly committed save (mid-
        epoch with its step, or the epoch's), then, bounded by a deadline,
        the exit barrier; exit 42 for an emergency, return for a preemption."""
        what = "emergency" if sig.emergency else "preemption"
        if sig.emergency and watchdog is not None:
            watchdog.acknowledge_escalation()   # the save runs under the hard deadline too
        where = f"at epoch {epoch} (step {step_in_epoch})" if step_in_epoch else f"after epoch {epoch}"
        master_print(f"{'watchdog escalation' if sig.emergency else 'SIGTERM received'}: saving {what} checkpoint "
                     f"{where} and exiting" + (f" with code {EXIT_HANG}" if sig.emergency else "")
                     + f" (agreed signals: {sig.describe()})")
        _save_ckpt(cfg, state, epoch, wait=True, step_in_epoch=step_in_epoch,
                   stream_cursor=_stream_cursor(train_loader, epoch, step_in_epoch) if step_in_epoch else None,
                   snap_pipe=snap_pipe, replicator=replicator)
        control.arm_exit_deadline()     # a peer dead mid-drain must not wedge the barrier
        distributed.barrier(f"coordinated {what} exit")
        if sig.emergency:
            raise SystemExit(EXIT_HANG)

    for epoch in range(max(start_epoch, 1), cfg.num_epochs + 1):
        master_print(f"starting epoch {epoch}")
        time_epoch_b = time_step_b = time.time()
        metrics = None
        start_step = resume_step if epoch == start_epoch else 0
        for step, batch in enumerate(train_loader.epoch(epoch, start_step=start_step), start=start_step):
            if cfg.steps_per_epoch and step >= cfg.steps_per_epoch:
                break
            will_log = total_steps == 0 or (step + 1) % cfg.log_step_interval == 0
            if window is not None:
                window.before_step(total_steps)
            state, metrics = _checked(cfg, train_step, state, batch, total_steps + 1,
                                      time_update=will_log and recorder is not None)
            total_steps += 1
            if window is not None:
                window.after_step(total_steps)
            # drill point, before the pet: an injected hang starves the
            # watchdog as a wedged step does; the index counts this run's steps
            faults.fire("step", index=total_steps)
            steps_since_record += 1
            if watchdog is not None:
                if watchdog.running:
                    watchdog.pet()
                else:                   # started once the first step is done: its build and warm-up are no hang
                    float(metrics["loss"])
                    watchdog.start()
            host_loss = float(metrics["loss"]) if will_log else None    # the log step's one fetch
            t_new = time.time()
            step_seconds = t_new - time_step_b
            smoothed_time.update(step_seconds, batch_size=1)
            time_step_b = t_new
            if will_log:
                lr = float(schedule(metrics["lr_step"]))
                _run_logging(cfg, epoch, step, host_loss, lr, smoothed_loss, smoothed_time,
                             memory_summary(state.count.device) if cfg.log_memory else None)
                data_wait_s = train_loader.consume_wait_s() / steps_since_record
                ckpt_stall_s = snap_pipe.consume_stall_s() / steps_since_record if snap_pipe is not None else 0.0
                steps_since_record = 0
                distill = {}
                if records is not None or recorder is not None:
                    grad_norm = float(metrics["grad_norm"])
                    # the distill step's metrics ride the same log-step fetch
                    distill = {k: float(metrics[k]) for k in DISTILL_METRICS if k in metrics}
                if recorder is not None:
                    recorder.record_step(step=total_steps, epoch=epoch, step_in_epoch=step + 1, loss=host_loss,
                                         lr=lr, sec_per_iter=smoothed_time.avg, data_wait_s=data_wait_s,
                                         ckpt_stall_s=ckpt_stall_s, opt_update_s=metrics["opt_update"].seconds(),
                                         grad_norm=grad_norm)
                    if distill:
                        recorder.event("distill", step=total_steps, epoch=epoch, **distill,
                                       alpha=cfg.distill_alpha, temp=cfg.distill_temp)
                if records is not None:
                    records.append({"epoch": epoch, "step": total_steps, "loss": host_loss, "lr": lr,
                                    "sec_per_iter": smoothed_time.avg, "step_seconds": step_seconds,
                                    "grad_norm": grad_norm, "data_wait_s": data_wait_s, **distill})
            if reporter is not None:    # a lock and three assignments; the thread posts
                reporter.update(total_steps, epoch)
            if replicator is not None and snap_pipe is not None and (step + 1) % cfg.replicate_steps == 0:
                # a replication window: the staging is the loop's part (its
                # ckpt_stall_s), the bytes go to the buddy from the worker
                snap_pipe.submit(state, epoch=epoch, step_in_epoch=step + 1,
                                 stream_cursor=_stream_cursor(train_loader, epoch, step + 1), replicator=replicator)
            # the step-boundary poll: the agreed word of the SIGTERM flag, the
            # watchdog's escalation, fault and peer-loss bits
            sig = control.poll(step_in_epoch=step, epoch=epoch)
            if sig.any:
                float(metrics["loss"])          # the step is done before its state is saved
                coordinated_exit(epoch, step + 1, sig)
                return state
            if cfg.max_steps and total_steps >= cfg.max_steps:
                break
        if metrics is not None:
            float(metrics["loss"])             # wait for the last step: honest epoch time
        master_print(f"epoch {epoch} done ({time.time() - time_epoch_b:.2f} sec)")
        decode = _decode_line(train_ds)
        if decode:
            master_print(f"epoch {epoch} {decode}")
        # the epoch boundary always agrees, whatever the cadence
        sig = control.poll(step_in_epoch=None, epoch=epoch)
        if sig.any:
            coordinated_exit(epoch, None, sig)
            return state
        if epoch % cfg.ckpt_epoch_interval == 0 or epoch == cfg.num_epochs:
            # the copy is taken before the save returns (or queued on a side
            # stream under the pipeline); the write commits in the background
            # while the next epoch trains, and the last epoch's save waits
            path, stall, _ = _save_ckpt(cfg, state, epoch, wait=epoch == cfg.num_epochs, snap_pipe=snap_pipe,
                                        replicator=replicator)
            if records is not None:
                records.append({"epoch": epoch, "ckpt_path": path, "ckpt_stall_s": stall})
        if epoch % cfg.test_epoch_interval == 0 or epoch == cfg.num_epochs:
            top1, top5, _, _ = eval_on_val(cfg, val_loader, eval_step, state, recorder=recorder, epoch=epoch)
            master_print(f"accuracy on val: {top1:.4f} (top-5 {top5:.4f})")
            if records is not None:
                records.append({"epoch": epoch, "top1": top1, "top5": top5})
        if cfg.max_steps and total_steps >= cfg.max_steps:
            break
    return state


def _checked(cfg: Config, train_step: Callable, state: TrainState, batch, step: int, time_update: bool):
    """train_step, and under --debug_nans a FloatingPointError naming the
    global `step` at the first non-finite loss or grad norm (fetched every
    step) or NaN that anomaly mode finds in the backward."""
    if not cfg.debug_nans:
        return train_step(state, batch, time_update=time_update)
    try:
        state, metrics = train_step(state, batch, time_update=time_update)
    except RuntimeError as e:
        if "returned nan values" not in str(e):         # autograd anomaly mode's NaN check
            raise
        raise FloatingPointError(f"--debug_nans: NaN in the backward of step {step}: {e}") from e
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(grad_norm)):
        raise FloatingPointError(f"--debug_nans: non-finite loss {loss} or grad norm {grad_norm} at step {step}")
    return state, metrics


def _run_logging(cfg: Config, epoch: int, step: int, loss: float, lr: float,
                 smoothed_loss: SmoothedValue, smoothed_time: SmoothedValue, mem: Optional[str] = None) -> None:
    """The reference's throttled step log line, with `mem` (--log_memory)
    appended; the caller already fetched the loss and resolved the lr."""
    smoothed_loss.update(loss, batch_size=1)
    master_print(f"epoch {epoch} step {step + 1}, lr: {lr:.4f}, "
                 f"loss: {smoothed_loss.avg:.4f}, sec/iter: {smoothed_time.avg:.4f}" + (f", {mem}" if mem else ""))


def eval_on_val(cfg: Config, val_loader, eval_step: Callable, state: TrainState, recorder=None, epoch: int = 0):
    """Top-1 and top-5 accuracy over the val split with drop_last (the
    remainder of the split is ignored, as in the reference), capped at
    cfg.eval_max_batches; each rank counts its slice of every batch and
    the counts are summed over the ranks. With a Recorder, one kind "eval"
    event (epoch, top1, top5, n). Returns (top1, top5, n_correct, total)."""
    correct = None
    total = 0
    for step, batch in enumerate(val_loader.epoch(0)):
        if cfg.eval_max_batches and step >= cfg.eval_max_batches:
            break
        c = eval_step(state, batch)
        correct = c if correct is None else {k: correct[k] + c[k] for k in c}
        total += cfg.batch_size
    reshard(state.model)                # the params the update and a save read are the shards
    n_correct = n_top5 = 0
    if correct is not None:
        n_correct, n_top5 = distributed.all_reduce_sum(
            torch.stack([correct["correct"], correct["correct_top5"]])).tolist()
    top1 = n_correct / total if total else 0.0
    top5 = n_top5 / total if total else 0.0
    if recorder is not None:
        recorder.event("eval", epoch=int(epoch), top1=top1, top5=top5, n=total)
    return top1, top5, n_correct, total
