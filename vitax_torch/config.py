"""Configuration of the port's serve and train paths: the fields they
read, with the names, defaults and CLI flags of vitax/config.py (Config,
build_parser, validate), so one command line means the same run to both
packages. Settings whose path is a later slice of the port are rejected by
validate() with a message that names the slice. The zero-stall and peer
checkpoint flags (zero_stall_ckpt, replicate_steps, peer_dir) are not
fields yet: the parser rejects them as unknown arguments. The mesh takes
dp and fsdp (FSDP2 over the processes torchrun starts, one card each);
tp, sp and pp above 1 wait for ROADMAP item 11."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

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

    # --- mesh: (dp, fsdp) over the processes, one card each; -1 = all remaining ---
    dp_size: int = 1
    fsdp_size: int = -1
    tp_size: int = 1
    sp_size: int = 1
    pp_size: int = 1

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

    def validate(self) -> "Config":
        """Reject settings the port cannot run; returns self."""
        for name in ("tp_size", "sp_size", "pp_size"):
            if getattr(self, name) != 1:
                raise ValueError(f"--{name} {getattr(self, name)}: tensor, sequence and pipeline parallelism "
                                 f"wait for ROADMAP item 11; the port's mesh takes --dp_size and --fsdp_size")
        checks = (
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
            (self.fused_dequant in ("auto", "on", "off"),
             f"--fused_dequant must be 'auto', 'on' or 'off', got {self.fused_dequant!r}"),
            (self.fused_dequant != "on" or bool(self.serve_quant_dtype),
             "--fused_dequant on requires a quantized --serve_quant_dtype: there is no weight dequant "
             "to fuse into a full-precision serve matmul"),
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
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
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
               ("--no_log_memory", "store_false", "log_memory"))
_CHOICES = {"dtype": ["bfloat16", "float32"], "data_format": list(DATA_FORMATS),
            "fused_optimizer": ["auto", "on", "off"], "gather_overlap": ["auto", "off", "on"],
            "param_gather_dtype": ["bfloat16", "float32"], "grad_reduce_dtype": ["float32", "bfloat16"],
            "remat_policy": list(REMAT_POLICIES),
            "serve_quant_dtype": list(QUANT_DTYPE_CHOICES), "serve_act_quant": ["off", "int8"],
            "fused_dequant": ["auto", "on", "off"]}
# vitax/config.py build_parser's help of the checkpoint and telemetry flags
_HELP = {"ckpt_dir": "checkpoint root: epoch_<N>/ per saved epoch (default %(default)s)",
         "resume_epoch": "N = resume from the checkpoint of epoch N; -1 = auto-resume the latest "
                         "committed one, or start fresh (default %(default)s)",
         "ckpt_epoch_interval": "save every N epochs and at the last one (default %(default)s)",
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
         "log_memory": "leave device memory out of the step log line"}


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
