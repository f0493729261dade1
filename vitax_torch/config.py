"""Configuration of the port's serve and train paths: every field of
vitax/config.py's Config, with its names, defaults and CLI flags
(build_parser, validate), so one command line means the same run to both
packages. Settings whose path is a later slice of the port are rejected by
validate() with a message that names the slice. The failure-reaction flags
are vitax's (checkpoint: zero_stall_ckpt, replicate_steps, peer_dir;
failures: hang_timeout_s, hang_action, fault_plan, control_sync_steps,
peer_heartbeat_s, peer_grace_s), with its defaults and refusals;
arbiter_url makes rank 0 post step heartbeats to the chip arbiter
(python -m vitax_torch.arbiter). Of vitax's step-program fields:
--no_scan_blocks writes the JAX layout unscanned (params/blocks_<i>/...)
wherever the port writes it; --scan_unroll is accepted at 1 only (the
eager step has no scan to unroll); --remat_window W wraps each group of W
blocks in one activation checkpoint; --compile_cache_dir is where the
kernels' libraries are built and reused (ops/_build.py); --profile_dir
with --profile_start_step and --profile_num_steps is the loop's
torch.profiler window. The mesh takes
dp, fsdp, tp, sp, pp and ep (FSDP2 over the processes torchrun starts, one
card each; tp shards the blocks' heads and MLP features; sp shards the
token axis, --sp_impl ring or ulysses; pp splits the blocks into stages,
--pp_schedule gpipe or 1f1b over --pp_microbatches; ep shards the experts
of --moe_experts, models/moe.py). MoE runs under sp (an expert's capacity
over the whole sequence), under tp (the experts replicated over it) and
under tp beside ep. Two meshes have no green reference in vitax and stay
refused (ROADMAP item 11): pp beside tp (vitax's cases are xfail) and MoE
under sp beside ep > 1 (vitax fails at init); vitax's pp refusals are
raised with its messages. --task and its flags
end validate() in the task's registry validator (programs/registry.py),
as vitax's do."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from vitax_torch.programs.registry import TASKS, get_scenario

QUANT_DTYPE_CHOICES = ("", "int8", "float8_e4m3")     # --serve_quant_dtype: the __quant__ schema's dtypes
REMAT_POLICIES = ("none_saveable", "dots_saveable", "dots_attn_saveable")    # --remat_policy (vitax/config.py:748)
DATA_FORMATS = ("imagefolder", "stream")                                    # --data_format (vitax/config.py:29)


@dataclasses.dataclass
class Config:
    # --- data ---
    data_dir: str = "/datasets/imagenet-1k"
    fake_data: bool = False
    num_workers: int = 4                # decode threads: the PIL pool, or the native call's own
    prefetch_batches: int = 2           # host batches ShardedLoader queues ahead of the step (>= 1)
    data_format: str = "imagefolder"    # imagefolder (a tree at --data_dir) | stream (.vtxshard
    #   containers at --data_dir, packed by python -m vitax_torch.tools.make_shards)
    stream_prefetch: int = 2            # host batches the streaming loader queues ahead (>= 1)
    device_normalize: bool = True       # uint8 batches, normalized on the device (--host_normalize clears)
    ckpt_dir: str = "/tmp/vit_fsdp"
    resume_epoch: int = 0               # N = resume from epoch N; -1 = auto-resume latest checkpoint
    ckpt_epoch_interval: int = 10
    zero_stall_ckpt: bool = False       # saves through the zero-stall snapshot pipeline (checkpoint/snapshot.py):
    #   the device-to-host copy queued on a side stream, the DCP write on a background worker
    replicate_steps: int = 0            # >0: every N steps, mirror this process's staged state shard to its ring
    #   buddy through the c10d store and a local peer store (checkpoint/peer.py); 0 = off
    peer_dir: str = ""                  # local peer-store root (default <ckpt_dir>/peerstore; VITAX_PEER_DIR
    #   overrides): per-host scratch, not shared storage
    keep_checkpoints: int = 0           # >0: checkpoint GC, prune committed epoch dirs beyond the
    #   newest K after each save (torn dirs never touched); 0 = keep all
    test_epoch_interval: int = 10
    log_step_interval: int = 20

    # --- model shape (defaults = the 10.078B ViT) ---
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 5120
    num_heads: int = 32
    num_blocks: int = 32
    mlp_ratio: float = 4.0
    num_classes: int = 1000

    # --- numerics and init ---
    seed: int = 0
    dtype: str = "bfloat16"             # compute dtype; initialized params are float32
    # Communication precision (vitax/config.py:94-105): param_gather_dtype is
    #   what the FSDP all-gathers move (None follows --dtype: a bf16 run gathers
    #   bf16; the cast commutes with the gather); grad_reduce_dtype is what the
    #   grad reduce-scatter / all-reduce moves (bfloat16 needs the bf16 gather)
    param_gather_dtype: Optional[str] = None
    grad_reduce_dtype: str = "float32"
    gather_overlap: str = "auto"        # auto | off | on: on = explicit prefetch of the next block's
    #   gather in the forward and the previous block's in the backward (ZeRO-3 only); auto and off
    #   leave FSDP2's own prefetch
    use_flash_attention: bool = True    # the Hopper flash-attention kernels on the card
    pos_dropout: float = 0.0
    att_dropout: float = 0.0
    mlp_dropout: float = 0.0

    # --- optimization ---
    batch_size: int = 1024
    num_epochs: int = 300
    lr: float = 1e-3
    weight_decay: float = 0.1
    clip_grad_norm: float = 1.0
    warmup_steps: int = 10000
    grad_ckpt: bool = True              # recompute each block in the backward (--no_grad_ckpt clears)
    reshard_after_forward: bool = True  # --no_reshard_after_forward clears (ZeRO-3 -> ZeRO-2)
    flatten_parameters: bool = False    # accepted for parity; a no-op (FSDP2 keeps one DTensor per parameter)
    run_without_fsdp: bool = False      # pure data-parallel baseline (params replicated: HSDP, shard group 1)
    shard_on_cpu: bool = False          # draw each leaf's init on the host, keep the rank's shard
    remat_policy: str = "none_saveable" # what a recomputed block keeps (only if grad_ckpt): nothing; its
    #   matmul outputs (dots_saveable); those and the attention core's o and lse (dots_attn_saveable)
    scan_blocks: bool = True            # the JAX layout the port writes: stacked params/blocks/... (True) or
    #   params/blocks_<i>/... (--no_scan_blocks); the torch model keeps one module a block either way
    scan_unroll: int = 1                # vitax's blocks a scan step; the eager step has no scan: 1 only
    remat_window: int = 0               # >1: one activation checkpoint around each group of this many blocks
    #   (instead of each block); needs grad_ckpt and num_blocks % remat_window == 0
    grad_accum_steps: int = 1           # K > 1: K strided microbatches of B/K per optimizer step
    fused_optimizer: str = "auto"       # auto | on | off, as in vitax; the card always runs the clip+AdamW kernel, and off raises there
    steps_per_epoch: int = 0            # 0 = dataset length // batch_size
    max_steps: int = 0                  # stop after N optimizer steps (0 = no limit)
    eval_max_batches: int = 0           # cap val batches per eval (0 = the whole split)

    # --- telemetry (telemetry/; host work only: the step launches the same kernels either way) ---
    metrics_dir: str = ""               # if set, one schema-1 JSONL record a log step (loss, lr, sec/iter,
    #   images/s, tokens/s, data wait, optimizer update, MFU, memory) under <metrics_dir>/metrics.jsonl
    tensorboard: bool = False           # mirror step records as TensorBoard scalars under <metrics_dir>/tb
    peak_tflops: float = 0.0            # per-card peak TFLOP/s for MFU; 0 = from the card's name
    #   (telemetry/flops.py PEAK_TFLOPS; a card not listed reads MFU 0)
    debug_nans: bool = False            # autograd anomaly mode with NaN checks, and a loss and grad-norm
    #   fetch every step (one sync a step) that raises FloatingPointError at the first non-finite value
    log_memory: bool = True             # device memory in the step log line (--no_log_memory clears)
    profile_dir: str = ""               # if set, a torch.profiler trace of a window of steps under it, a file a rank
    profile_start_step: int = 2         # completed steps after which the profiler window opens
    profile_num_steps: int = 5          # steps the window spans (the default: steps 3-7)
    compile_cache_dir: str = ""         # where the kernels' libraries are built and reused across restarts
    #   ("" = vitax_torch/_build); a warm directory builds nothing

    # --- failure reaction (faults.py, telemetry/watchdog.py, train/control.py; host work only) ---
    hang_timeout_s: float = 0.0         # >0: watchdog dumps every thread's stack and the card's memory stats after
    #   this many seconds without a step (the job left running)
    hang_action: str = "dump"           # dump | checkpoint_exit: after the dump, an emergency mid-epoch
    #   checkpoint at the next step boundary and exit 42 for the supervisor (supervise.py); a loop that
    #   never reaches a boundary is hard-exited with 42 after a deadline
    fault_plan: str = ""                # JSON fault plan (faults.py; or VITAX_FAULT_PLAN): deterministic crash,
    #   hang, write-error, loader-stall, SIGTERM and peer-loss drills at a chosen site and call
    control_sync_steps: int = 10        # agreement cadence of the control word across processes, in steps
    #   (plus every epoch boundary); every process must use the same value
    peer_heartbeat_s: float = 0.0       # >0: heartbeats through the c10d store every N s; a peer silent for
    #   peer_grace_s is declared lost and the survivors exit 42 within the deadline
    peer_grace_s: float = 0.0           # silence before a peer is declared lost, and the survivor's exit deadline
    #   after it; 0 = 10 x peer_heartbeat_s
    arbiter_url: str = ""               # chip arbiter (python -m vitax_torch.arbiter): rank 0 posts step
    #   heartbeats to <arbiter_url>/telemetry from a thread; the step is the same either way. "" = off

    # --- mesh: (dp, fsdp, tp, sp, pp, ep) over the processes, one card each; -1 = all remaining ---
    dp_size: int = 1
    fsdp_size: int = -1
    tp_size: int = 1
    sp_size: int = 1
    sp_impl: str = "ring"               # ring (K/V rotation over the sp group) | ulysses (all-to-all head<->token)
    pp_size: int = 1                    # pipeline stages: stage s holds blocks [s L/pp, (s + 1) L/pp)
    pp_microbatches: int = 0            # microbatches of the rank's rows a pipeline step (0 = pp_size)
    pp_schedule: str = "gpipe"          # gpipe (all forwards, then all backwards) | 1f1b (interleaved)
    ep_size: int = 1                    # expert-parallel dim (also carries batch; experts sharded across it)

    # --- mixture of experts (models/moe.py; vitax/config.py:136-140) ---
    moe_experts: int = 0                # 0 = dense MLP; >0 = top-k routed MoE MLP in every block
    moe_capacity_factor: float = 1.25   # static expert capacity C = ceil(cf * tokens / experts)
    moe_top_k: int = 1                  # 1 = Switch (top-1); 2 = GShard-style top-2 with renormalized gates
    moe_aux_weight: float = 0.01        # load-balance aux loss weight (Switch Transformer)
    moe_impl: str = "einsum"            # einsum (GShard one-hot dispatch) | gather (index dispatch)

    # --- serving ---
    serve_port: int = 8000              # HTTP port (0 = ephemeral, tests)
    serve_max_batch: int = 8            # largest power-of-two batch bucket
    max_batch_wait_ms: float = 5.0      # batcher flush deadline for the oldest queued request
    serve_topk: int = 5                 # classes returned per /predict response
    serve_quant_dtype: str = ""         # expected weight quantization of the npz export: "" (full precision),
    #   "int8" or "float8_e4m3"; the file's __quant__ manifest is authoritative and this asserts it
    serve_act_quant: str = "off"        # "int8": per-tensor dynamic int8 activations, int8 x int8 block matmuls
    #   (needs --serve_quant_dtype int8; the head stays weight-only)
    fused_dequant: str = "auto"         # auto | on | off, as in vitax; the card always runs the dequant_matmul
    #   kernel and off raises there; on the CPU auto is off (dequantize at use) and on runs the plain kernel
    serve_queue_max: int = 1024         # batcher queue bound (0 = unbounded); full -> 503
    serve_request_timeout_s: float = 60.0  # a handler's wait on its batch future
    serve_brownout_enter_frac: float = 0.75  # degraded mode at this fraction of serve_queue_max (0 = off)
    serve_brownout_exit_frac: float = 0.25   # ... and back at or below this fraction
    serve_brownout_dwell_s: float = 2.0      # for this long, both ways
    serve_brownout_wait_ms: float = 1.0      # batcher deadline while degraded
    serve_allow_chaos: bool = False     # arm POST /chaos (a fault plan installed into a running replica)
    serve_cache_max: int = 0            # fleet router's prediction cache entries (0 = off)
    serve_cache_ttl_s: float = 300.0    # ... and their lifetime
    serve_batch_window_ms: float = 0.0  # fleet router: compose concurrent /predict bodies this long (0 = off)
    serve_batch_max: int = 0            # ... into groups of at most this many (0 = --serve_max_batch)

    # --- scenario registry (programs/registry.py; vitax/config.py:271-284) ---
    task: str = "train"                 # train | finetune | probe | distill; each scenario's validator
    #   runs at the end of validate()
    init_npz: str = ""                  # finetune/probe warm start: a consolidated npz export whose params
    #   overwrite the fresh init leaf for leaf (the head may re-init)
    teacher_npz: str = ""               # distill: the consolidated npz export of the frozen teacher
    reinit_head: bool = False           # finetune: keep the fresh head init even when the export's head fits
    backbone_lr_mult: float = 1.0       # finetune: multiply the backbone's updates by this after AdamW
    distill_alpha: float = 0.5          # distill loss: (1-alpha)*CE(labels) + alpha*KL(teacher)
    distill_temp: float = 2.0           # distill softmax temperature T (the KL term scaled by T^2)

    @property
    def resolved_param_gather_dtype(self) -> str:
        """Gather-dtype policy after None -> --dtype resolution."""
        return self.param_gather_dtype or self.dtype

    @property
    def comm_cast_active(self) -> bool:
        """True when params are gathered in bf16 (cast while still sharded)."""
        return self.dtype == "bfloat16" and self.resolved_param_gather_dtype == "bfloat16"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def check_tp(self, tp: int) -> None:
        """Refuse a tp size (given, or resolved from --tp_size -1 by
        parallel/mesh.py mesh_sizes) that D, the MLP hidden or the heads do
        not divide: vitax's refusals first, with its messages
        (parallel/rules.py: the attention proj's input dim D, then fc1's
        output dim, the MLP hidden)."""
        from vitax_torch.parallel.rules import rule_pspec
        d = self.embed_dim
        rule_pspec("blocks.0.attn.proj.weight", (d, d), 1, 1, tp)
        rule_pspec("blocks.0.mlp.fc1.weight", (self.mlp_hidden_dim, d), 1, 1, tp)
        if self.num_heads % tp:
            raise ValueError(f"--num_heads {self.num_heads} not divisible by --tp_size {tp}: each tp rank runs "
                             f"whole heads (the attention kernels take (B, N, H/tp, Dh))")

    def sp_ep_refusal(self, sp: Optional[int] = None, ep: Optional[int] = None) -> str:
        """The message refusing MoE under sp beside ep > 1: validate() gives
        the stated sizes, parallel/mesh.py mesh_sizes those a -1 resolved."""
        sp, ep = self.sp_size if sp is None else sp, self.ep_size if ep is None else ep
        return (f"--moe_experts with --sp_size {sp} and --ep_size {ep}: vitax has no green reference for MoE under "
                f"sp beside ep > 1 (its init sample is dp * fsdp rows, vitax/train/state.py:86-89, while the ring's "
                f"shard_map takes the batch over (dp, fsdp, ep), so vitax fails at init); ROADMAP item 11. MoE "
                f"runs under sp with --ep_size 1, and beside ep without sp")

    def check_pp(self) -> None:
        """vitax's refusals under --pp_size > 1 (vitax/config.py:345-427),
        with its messages, and pp beside tp, which has no green reference
        (vitax's pp under tp cases are xfail) and stays refused (ROADMAP
        item 11)."""
        checks = (
            (self.scan_blocks, "--pp_size needs the stacked block tree (drop --no_scan_blocks)"),
            (self.gather_overlap != "on",
             "--gather_overlap on with --pp_size > 1 is rejected: the pipeline schedules own their gathers "
             "(just-in-time in-body gathers pinned per stage, vitax/parallel/pipeline.py) and a second prefetch "
             "schedule would double-gather every block"),
            (self.grad_accum_steps == 1,
             "--grad_accum_steps > 1 with --pp_size > 1 is rejected: the pipeline already microbatches the step "
             "(--pp_microbatches) and nesting a second accumulation scan around it would double-count the "
             "memory/bubble trade — raise --pp_microbatches instead"),
            (self.reshard_after_forward or self.fsdp_size == 1,
             "--no_reshard_after_forward (ZeRO-2) under --pp_size > 1 with fsdp sharding is not supported: the "
             "pipeline body gathers each block's shards just-in-time (ZeRO-3 semantics) and a step-top full "
             "gather would defeat that. With --fsdp_size 1 the flag is a no-op and allowed; --fsdp_size -1 is "
             "treated as sharded here (validate() runs before the device count is known) — pass an explicit "
             "--fsdp_size 1 if the remaining mesh is a single device"),
            (self.num_blocks % self.pp_size == 0,
             f"--num_blocks {self.num_blocks} not divisible by --pp_size {self.pp_size}"),
            (self.pp_microbatches >= 0, f"--pp_microbatches must be >= 0 (0 = --pp_size), got {self.pp_microbatches}"),
            (self.pp_schedule in ("gpipe", "1f1b"),
             f"unknown pp_schedule {self.pp_schedule!r} (expected 'gpipe' or '1f1b')"),
            (self.moe_experts == 0 or self.ep_size == 1 or self.moe_impl == "einsum",
             "--moe_experts with --ep_size > 1 under --pp_size > 1 runs the manual all-to-all dispatch inside the "
             "pipeline body, which only the einsum impl implements (vitax/models/moe.py MoeMlp.ep_axis)"),
            (self.moe_experts == 0 or (self.tp_size == 1 and self.sp_size == 1),
             "--moe_experts under --pp_size > 1 composes with dp/fsdp/ep only: the MoE dispatch einsums inside the "
             "pipeline body are not exercised under auto-tp/sp meshes"),
            (self.pp_schedule != "1f1b" or (max(self.pos_dropout, self.att_dropout, self.mlp_dropout) == 0.0
                                            and self.moe_experts == 0),
             "--pp_schedule 1f1b v1 is dense/deterministic only (dropout and MoE ride the gpipe schedule); the "
             "interleaved backward always recomputes the stage forward (none_saveable semantics)"),
            (self.pp_schedule != "1f1b" or (self.tp_size == 1 and self.sp_size == 1),
             "--pp_schedule 1f1b runs a fully-manual shard_map engine; tp/sp under pp ride the gpipe schedule "
             "(GSPMD-auto axes in the pipeline body)"),
            (self.tp_size == 1,
             f"--pp_size {self.pp_size} with --tp_size {self.tp_size}: vitax's pipeline bodies under tp have no "
             f"green reference (its pp x tp cases are xfail, tests/test_pipeline.py:371-374), so the port refuses "
             f"them (ROADMAP item 11); the port's mesh takes pp beside dp, fsdp, sp and ep"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    def check_remat_window(self) -> None:
        """vitax's --scan_unroll and --remat_window refusals
        (vitax/config.py:380-393), with its messages, then --scan_unroll
        other than 1, which the eager step cannot honour."""
        checks = (
            (self.scan_unroll >= 1, f"--scan_unroll must be >= 1, got {self.scan_unroll}"),
            (self.remat_window <= 1 or (self.scan_blocks and self.grad_ckpt),
             "--remat_window needs the scanned stacked tree and remat on"),
            (self.remat_window <= 1 or self.num_blocks % self.remat_window == 0,
             f"--num_blocks {self.num_blocks} not divisible by --remat_window {self.remat_window}"),
            (self.remat_window <= 1 or self.scan_unroll == 1,
             "--remat_window subsumes --scan_unroll (the window IS the unrolled group); drop one of the two"),
            (self.remat_window <= 1 or self.pp_size == 1,
             "--remat_window composes with dropout and MoE (v2) but not pp: the pipeline path owns checkpoint "
             "placement (vitax/parallel/pipeline.py)"),
            (self.remat_window >= 0, f"--remat_window must be >= 0 (0 or 1 = per-block remat), got "
                                     f"{self.remat_window}"),
            (self.remat_window <= 1 or self.remat_policy != "dots_attn_saveable",
             f"--remat_window {self.remat_window} with --remat_policy dots_attn_saveable: the port runs each "
             f"attention core between two checkpointed regions of its own block, so there is no group of blocks "
             f"to checkpoint as one; use none_saveable or dots_saveable, or drop --remat_window"),
            (self.scan_unroll == 1,
             f"--scan_unroll {self.scan_unroll}: the port's step runs its blocks eagerly, one module a block, so "
             f"there is no scan to unroll (vitax's XLA fusion knob); use --remat_window to group blocks under "
             f"one checkpoint"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    def validate(self) -> "Config":
        """Reject settings the port cannot run; returns self."""
        self.check_remat_window()
        if self.pp_size > 1:
            self.check_pp()
        if self.tp_size > 1:
            self.check_tp(self.tp_size)
        checks = (
            (self.sp_impl in ("ring", "ulysses"),
             f"unknown sp_impl {self.sp_impl!r} (expected 'ring' or 'ulysses')"),
            (all(getattr(self, name) == -1 or getattr(self, name) >= 1
                 for name in ("dp_size", "fsdp_size", "tp_size", "sp_size", "pp_size", "ep_size")),
             f"mesh sizes must be >= 1 or -1 (all remaining processes), got --dp_size {self.dp_size} --fsdp_size "
             f"{self.fsdp_size} --tp_size {self.tp_size} --sp_size {self.sp_size} --pp_size {self.pp_size} "
             f"--ep_size {self.ep_size}"),
            # vitax/config.py:428-439, with its messages
            (self.ep_size <= 1 or self.moe_experts > 0, "--ep_size > 1 needs --moe_experts"),
            (self.ep_size <= 1 or self.moe_experts % self.ep_size == 0,
             f"--moe_experts {self.moe_experts} not divisible by --ep_size {self.ep_size}"),
            (self.moe_experts >= 0, f"--moe_experts must be >= 0, got {self.moe_experts}"),
            (self.moe_experts == 0 or self.moe_impl in ("gather", "einsum"), f"unknown moe_impl {self.moe_impl!r}"),
            (self.moe_experts == 0 or self.moe_top_k in (1, 2),
             f"--moe_top_k must be 1 or 2, got {self.moe_top_k}"),
            (self.moe_experts == 0 or self.moe_top_k <= self.moe_experts,
             f"--moe_top_k {self.moe_top_k} > --moe_experts {self.moe_experts}: the second choice would be a "
             f"dead branch with gate ~0"),
            (self.moe_experts == 0 or self.moe_capacity_factor > 0,
             f"--moe_capacity_factor must be > 0, got {self.moe_capacity_factor}"),
            (self.moe_experts == 0 or self.sp_size <= 1 or self.ep_size <= 1, self.sp_ep_refusal()),
            (self.prefetch_batches >= 1,
             f"--prefetch_batches must be >= 1, got {self.prefetch_batches}: the loader needs at least one "
             f"queued batch to hand the consumer"),
            (self.data_format in DATA_FORMATS,
             f"unknown data_format {self.data_format!r} (expected 'imagefolder' or 'stream')"),
            (self.stream_prefetch >= 1,
             f"--stream_prefetch must be >= 1, got {self.stream_prefetch}: the streaming loader needs at "
             f"least one queued batch to hand the consumer"),
            (self.data_format != "stream" or not self.fake_data,
             "--data_format stream with --fake_data is contradictory: fake data needs no input pipeline — "
             "generate a shard set from an ImageFolder tree with python -m vitax_torch.tools.make_shards instead"),
            (self.data_format != "stream" or bool(self.data_dir),
             "--data_format stream needs --data_dir pointing at a shard root (the output of "
             "python -m vitax_torch.tools.make_shards, holding train/stream_meta.json)"),
            (self.batch_size >= 1, f"--batch_size must be >= 1, got {self.batch_size}"),
            (self.grad_accum_steps >= 1 and self.batch_size % self.grad_accum_steps == 0,
             f"--batch_size {self.batch_size} must be a multiple of --grad_accum_steps "
             f"{self.grad_accum_steps} (>= 1)"),
            (self.remat_policy in REMAT_POLICIES,
             f"unknown remat_policy {self.remat_policy!r} (expected one of {', '.join(REMAT_POLICIES)})"),
            (self.gather_overlap in ("auto", "off", "on"),
             f"unknown gather_overlap {self.gather_overlap!r} (expected 'auto', 'off' or 'on')"),
            (self.gather_overlap != "on" or self.scan_blocks,
             "--gather_overlap on needs the scanned stacked block tree (drop --no_scan_blocks): the double-buffered "
             "prefetch slot rides the scan carry"),
            (self.gather_overlap != "on" or (self.reshard_after_forward and not self.run_without_fsdp),
             "--gather_overlap on needs ZeRO-3 (per-block gathers): under ZeRO-2 (--no_reshard_after_forward) "
             "the gathered params stay live through the backward and under --run_without_fsdp params are "
             "replicated — there is no per-block gather to overlap"),
            (self.gather_overlap != "on" or (self.grad_ckpt and self.remat_policy == "none_saveable"),
             "--gather_overlap on requires --grad_ckpt with remat_policy=none_saveable: the schedule's "
             "backward re-gathers each block's shards and recomputes its forward (exactly per-block remat); "
             "other policies save residuals the overlap path would silently discard"),
            (self.resolved_param_gather_dtype in ("bfloat16", "float32"),
             f"unknown param_gather_dtype {self.param_gather_dtype!r}"),
            (self.grad_reduce_dtype in ("bfloat16", "float32"),
             f"unknown grad_reduce_dtype {self.grad_reduce_dtype!r}"),
            (self.dtype != "float32" or self.param_gather_dtype != "bfloat16",
             "--param_gather_dtype bfloat16 with --dtype float32 would gather a downcast tree into an f32 "
             "model and silently change compute precision; use --dtype bfloat16 (f32 master params are "
             "kept either way)"),
            (self.grad_reduce_dtype != "bfloat16" or self.comm_cast_active,
             "--grad_reduce_dtype bfloat16 requires the bf16 comm-cast to be active (--dtype bfloat16 and "
             "param_gather_dtype bfloat16): the bf16 reduction rides the cast boundary"),
            (self.profile_start_step >= 0,
             f"--profile_start_step must be >= 0, got {self.profile_start_step}"),
            (self.profile_num_steps >= 1,
             f"--profile_num_steps must be >= 1, got {self.profile_num_steps}: an empty profiler window would "
             f"open a trace it never closes in-loop"),
            (self.peak_tflops >= 0,
             f"--peak_tflops must be >= 0 (0 = detect from device kind), got {self.peak_tflops}"),
            (not self.tensorboard or bool(self.metrics_dir),
             "--tensorboard needs --metrics_dir: the TB event files live under <metrics_dir>/tb next to the "
             "JSONL record they mirror"),
            (self.fused_optimizer in ("auto", "on", "off"),
             f"unknown fused_optimizer {self.fused_optimizer!r} (expected 'auto', 'on' or 'off')"),
            (self.log_step_interval >= 1, f"--log_step_interval must be >= 1, got {self.log_step_interval}"),
            (self.ckpt_epoch_interval >= 1,
             f"--ckpt_epoch_interval must be >= 1, got {self.ckpt_epoch_interval}: a checkpoint is "
             f"saved every N epochs and at the last one"),
            (self.keep_checkpoints >= 0,
             f"--keep_checkpoints must be >= 0 (0 = keep all), got {self.keep_checkpoints}"),
            (self.hang_timeout_s >= 0, f"--hang_timeout_s must be >= 0 (0 = watchdog off), got {self.hang_timeout_s}"),
            (self.hang_action in ("dump", "checkpoint_exit"),
             f"unknown hang_action {self.hang_action!r} (expected 'dump' or 'checkpoint_exit')"),
            (self.control_sync_steps >= 1,
             f"--control_sync_steps must be >= 1 (it is a collective cadence every host shares), got "
             f"{self.control_sync_steps}"),
            (self.peer_heartbeat_s >= 0,
             f"--peer_heartbeat_s must be >= 0 (0 = liveness off), got {self.peer_heartbeat_s}"),
            (self.peer_grace_s >= 0,
             f"--peer_grace_s must be >= 0 (0 = 10 x peer_heartbeat_s), got {self.peer_grace_s}"),
            (not (self.peer_grace_s > 0 and self.peer_heartbeat_s == 0),
             "--peer_grace_s without --peer_heartbeat_s does nothing: the grace window bounds heartbeat silence, "
             "and no heartbeats are being sent"),
            (self.replicate_steps >= 0,
             f"--replicate_steps must be >= 0 (0 = peer replication off), got {self.replicate_steps}"),
            (not (self.peer_dir and self.replicate_steps == 0),
             "--peer_dir without --replicate_steps does nothing: the peer store is only written by the "
             "replication window"),
            (self.test_epoch_interval >= 1,
             f"--test_epoch_interval must be >= 1, got {self.test_epoch_interval}"),
            (min(self.steps_per_epoch, self.max_steps, self.eval_max_batches, self.warmup_steps) >= 0,
             "--steps_per_epoch, --max_steps, --eval_max_batches and --warmup_steps must be >= 0"),
            (self.image_size % self.patch_size == 0,
             f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"),
            (self.embed_dim % self.num_heads == 0,
             f"embed_dim {self.embed_dim} not divisible by num_heads {self.num_heads}"),
            (self.dtype in ("bfloat16", "float32"), f"unknown dtype {self.dtype!r}"),
            *((0.0 <= getattr(self, name) < 1.0,
               f"--{name} must be in [0, 1), got {getattr(self, name)}: rate >= 1 would zero every "
               f"activation and the kernels' 1/(1-rate) rescale turns that into inf/NaN rather than "
               f"torch's all-zeros") for name in ("pos_dropout", "att_dropout", "mlp_dropout")),
            (0 <= self.serve_port <= 65535, f"--serve_port must be in [0, 65535], got {self.serve_port}"),
            (self.serve_max_batch >= 1 and self.serve_max_batch & (self.serve_max_batch - 1) == 0,
             f"--serve_max_batch must be a power of two >= 1, got {self.serve_max_batch}"),
            (self.max_batch_wait_ms >= 0, f"--max_batch_wait_ms must be >= 0, got {self.max_batch_wait_ms}"),
            (self.serve_topk >= 1, f"--serve_topk must be >= 1, got {self.serve_topk}"),
            (self.serve_quant_dtype in QUANT_DTYPE_CHOICES,
             f"--serve_quant_dtype must be '', 'int8' or 'float8_e4m3', got {self.serve_quant_dtype!r}"),
            (self.serve_act_quant in ("off", "int8"),
             f"--serve_act_quant must be 'off' or 'int8', got {self.serve_act_quant!r}"),
            (self.serve_act_quant == "off" or self.serve_quant_dtype == "int8",
             f"--serve_act_quant {self.serve_act_quant} requires --serve_quant_dtype int8 (int8 x int8 "
             f"matmuls need int8 weights as the other operand), got {self.serve_quant_dtype!r}"),
            (self.serve_act_quant == "off" or self.moe_experts == 0,
             f"--serve_act_quant is dense-model only (MoE expert dispatch keeps its float einsum path), got "
             f"--moe_experts {self.moe_experts}"),
            (self.fused_dequant in ("auto", "on", "off"),
             f"--fused_dequant must be 'auto', 'on' or 'off', got {self.fused_dequant!r}"),
            (self.fused_dequant != "on" or bool(self.serve_quant_dtype),
             "--fused_dequant on requires a quantized --serve_quant_dtype: there is no weight dequant "
             "to fuse into a full-precision serve matmul"),
            (self.fused_dequant != "on" or self.moe_experts == 0,
             f"--fused_dequant on is dense-model only (MoE expert matmuls keep their einsum path), got "
             f"--moe_experts {self.moe_experts}"),
            (self.serve_queue_max >= 0, f"--serve_queue_max must be >= 0, got {self.serve_queue_max}"),
            (self.serve_request_timeout_s > 0,
             f"--serve_request_timeout_s must be > 0, got {self.serve_request_timeout_s}"),
            (0.0 <= self.serve_brownout_enter_frac <= 1.0,
             f"--serve_brownout_enter_frac must be in [0, 1], got {self.serve_brownout_enter_frac}"),
            (self.serve_brownout_enter_frac == 0
             or 0.0 <= self.serve_brownout_exit_frac <= self.serve_brownout_enter_frac,
             f"--serve_brownout_exit_frac must be in [0, {self.serve_brownout_enter_frac}], "
             f"got {self.serve_brownout_exit_frac}"),
            (self.serve_brownout_dwell_s >= 0,
             f"--serve_brownout_dwell_s must be >= 0, got {self.serve_brownout_dwell_s}"),
            (self.serve_brownout_wait_ms >= 0,
             f"--serve_brownout_wait_ms must be >= 0, got {self.serve_brownout_wait_ms}"),
            (self.serve_cache_max >= 0,
             f"--serve_cache_max must be >= 0 (0 = prediction cache off), got {self.serve_cache_max}"),
            (self.serve_cache_ttl_s > 0,
             f"--serve_cache_ttl_s must be > 0, got {self.serve_cache_ttl_s}: a cache that never expires would "
             f"replay answers across model redeploys; disable the cache with --serve_cache_max 0 instead"),
            (self.serve_batch_window_ms >= 0,
             f"--serve_batch_window_ms must be >= 0 (0 = cross-replica continuous batching off), got "
             f"{self.serve_batch_window_ms}"),
            (self.serve_batch_max >= 0,
             f"--serve_batch_max must be >= 0 (0 = use --serve_max_batch), got {self.serve_batch_max}"),
            (0.0 <= self.distill_alpha <= 1.0,
             f"--distill_alpha must be in [0, 1] (the CE/KL mix), got {self.distill_alpha}"),
            (self.distill_temp > 0, f"--distill_temp must be > 0, got {self.distill_temp}"),
            (self.backbone_lr_mult >= 0, f"--backbone_lr_mult must be >= 0, got {self.backbone_lr_mult}"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        if self.fault_plan:
            from vitax_torch import faults
            try:                            # at startup, not at the step the plan names
                faults.parse_plan(self.fault_plan)
            except ValueError as e:
                raise ValueError(f"--fault_plan invalid: {e}") from e
        get_scenario(self.task).validate(self)     # each --task's pairwise checks live with its registry entry
        return self


# Flags spelled other than --<field>: (flag, action, dest).
_BOOL_FLAGS = (("--fake_data", "store_true", "fake_data"),
               ("--host_normalize", "store_false", "device_normalize"),
               ("--no_flash_attention", "store_false", "use_flash_attention"),
               ("--no_grad_ckpt", "store_false", "grad_ckpt"),
               ("--no_reshard_after_forward", "store_false", "reshard_after_forward"),
               ("--flatten_parameters", "store_true", "flatten_parameters"),
               ("--run_without_fsdp", "store_true", "run_without_fsdp"),
               ("--shard_on_cpu", "store_true", "shard_on_cpu"),
               ("--tensorboard", "store_true", "tensorboard"),
               ("--debug_nans", "store_true", "debug_nans"),
               ("--no_log_memory", "store_false", "log_memory"),
               ("--reinit_head", "store_true", "reinit_head"),
               ("--zero_stall_ckpt", "store_true", "zero_stall_ckpt"),
               ("--no_scan_blocks", "store_false", "scan_blocks"),
               ("--serve_allow_chaos", "store_true", "serve_allow_chaos"))
_CHOICES = {"dtype": ["bfloat16", "float32"], "data_format": list(DATA_FORMATS), "sp_impl": ["ring", "ulysses"],
            "pp_schedule": ["gpipe", "1f1b"],
            "moe_top_k": [1, 2], "moe_impl": ["gather", "einsum"],
            "fused_optimizer": ["auto", "on", "off"], "gather_overlap": ["auto", "off", "on"],
            "param_gather_dtype": ["bfloat16", "float32"], "grad_reduce_dtype": ["float32", "bfloat16"],
            "remat_policy": list(REMAT_POLICIES),
            "serve_quant_dtype": list(QUANT_DTYPE_CHOICES), "serve_act_quant": ["off", "int8"],
            "fused_dequant": ["auto", "on", "off"], "task": list(TASKS), "hang_action": ["dump", "checkpoint_exit"]}
# vitax/config.py build_parser's help of the checkpoint and telemetry flags
_HELP = {"ckpt_dir": "checkpoint root: epoch_<N>/ per saved epoch (default %(default)s)",
         "resume_epoch": "N = resume from the checkpoint of epoch N; -1 = auto-resume the latest "
                         "committed one, or start fresh (default %(default)s)",
         "ckpt_epoch_interval": "save every N epochs and at the last one (default %(default)s)",
         "zero_stall_ckpt": "route checkpoint saves through the zero-stall snapshot pipeline "
                            "(vitax_torch/checkpoint/snapshot.py): the device-to-host copy queued on a side stream, "
                            "the DCP write on a background worker — step N+1 never waits for a non-final save",
         "replicate_steps": ">0: every N steps, mirror this process's staged state shard to its ring buddy "
                            "through the c10d store (vitax_torch/checkpoint/peer.py) so a lost rank restores from "
                            "the surviving buddy without the checkpoint directory (0 = off)",
         "peer_dir": "local peer-store root (default <ckpt_dir>/peerstore; VITAX_PEER_DIR env overrides) — "
                     "per-host scratch, not shared storage",
         "hang_timeout_s": ">0: watchdog dumps all-thread Python stacks + device memory stats (rank-tagged, "
                           "without killing the job) after this many seconds with no completed step",
         "hang_action": "what the watchdog does after its dump: dump = leave the job running (default); "
                        "checkpoint_exit = emergency-save a committed checkpoint at the next step boundary and "
                        "exit 42 for a supervisor (python -m vitax_torch.supervise) to restart",
         "control_sync_steps": "multi-process failure-signal agreement cadence in steps "
                               "(vitax_torch/train/control.py; one tiny collective per cadence, plus every epoch "
                               "boundary) — processes must share the same value",
         "peer_heartbeat_s": ">0: heartbeat peers through the c10d store every N seconds; a peer silent for "
                             "--peer_grace_s is declared dead and survivors escalate to checkpoint_exit (exit "
                             "42) instead of blocking in collectives (0 = off)",
         "peer_grace_s": "heartbeat-silence window before a peer is declared lost, and the survivor's own exit "
                         "deadline after the verdict (0 = 10 x --peer_heartbeat_s)",
         "fault_plan": "JSON fault-injection plan (vitax_torch/faults.py), e.g. '{\"site\": \"step\", "
                       "\"at\": 6, \"action\": \"crash\"}' — deterministic crash/hang/write-error/loader-stall/"
                       "SIGTERM drills for the failure-reaction machinery (VITAX_FAULT_PLAN env var is the "
                       "flagless equivalent)",
         "keep_checkpoints": ">0: checkpoint GC, prune committed epoch dirs beyond the newest K after "
                             "each save; torn dirs are never touched (0 = keep all; default %(default)s)",
         "metrics_dir": "write one JSONL telemetry record per log step (schema 1: loss, lr, sec/iter, "
                        "tokens/s, data-wait, MFU, memory) under <metrics_dir>/metrics.jsonl; summarize with "
                        "tools/metrics_report.py",
         "tensorboard": "mirror telemetry records as TensorBoard scalars under <metrics_dir>/tb (warns and "
                        "degrades to a no-op when tensorboard is not installed)",
         "peak_tflops": "per-card peak TFLOP/s for MFU accounting (0 = detect from the card's name via the "
                        "vitax_torch/telemetry/flops.py table; a card not listed reads MFU 0)",
         "debug_nans": "autograd anomaly detection with NaN checks for the run, and the loss and grad norm "
                       "fetched every step (one device sync a step) to raise FloatingPointError at the first "
                       "non-finite value",
         "log_memory": "leave device memory out of the step log line",
         "task": "which registered scenario to run: train = reference pretraining (CE over labels); finetune = "
                 "warm start from --init_npz with the head re-initialized for a new --num_classes (--reinit_head "
                 "/ shape mismatch) and optional --backbone_lr_mult; probe = linear probe, backbone frozen, "
                 "optimizer moments for the head only; distill = knowledge distillation, frozen teacher "
                 "(--teacher_npz) and student in one step, loss (1-alpha)*CE + alpha*KL at --distill_temp",
         "init_npz": "finetune/probe warm start: consolidated npz export loaded into the fresh state",
         "teacher_npz": "distillation teacher: consolidated npz export (quantized exports dequantize to f32 "
                        "for the teacher forward)",
         "reinit_head": "finetune: keep the fresh head init even when the export's head shapes match",
         "backbone_lr_mult": "finetune: scale non-head updates by this after AdamW (1.0 = off)",
         "distill_alpha": "distill loss mix: (1-alpha)*CE + alpha*KL",
         "distill_temp": "distill softmax temperature (KL scaled by T^2)"}


def build_parser() -> argparse.ArgumentParser:
    """Every Config field as a flag, spelled as in vitax/config.py build_parser."""
    d = Config()
    parser = argparse.ArgumentParser(description="vitax_torch: the ViT on PyTorch and CUDA")
    bools = {dest for _, _, dest in _BOOL_FLAGS}
    for f in dataclasses.fields(Config):
        if f.name in bools:
            continue
        default = getattr(d, f.name)
        parser.add_argument(f"--{f.name}", type=str if default is None else type(default), default=default,
                            choices=_CHOICES.get(f.name), help=_HELP.get(f.name))
    for flag, action, dest in _BOOL_FLAGS:
        parser.add_argument(flag, action=action, dest=dest, help=_HELP.get(dest))
    return parser


def config_fields_from_namespace(ns: argparse.Namespace) -> dict:
    """Config kwargs from a parsed namespace that may carry extra flags."""
    return {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
