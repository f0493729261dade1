"""Training orchestration (vitax/train/loop.py train, _run_epochs,
_run_logging, eval_on_val), on one device, or one card per process under
torchrun with FSDP2 (ZeRO-3, ZeRO-2 or the DP baseline,
parallel/sharding.py).

Under a process group train() builds the ("dp", "fsdp") mesh, the model
on the meta device, shards it (apply_fsdp), then inits each rank's shards
(bitwise the unsharded init) or restores them; each rank reads its slice
of every global batch; eval counts are summed over the ranks, so top-1 is
over the whole val split; only rank 0 prints. Without one (no WORLD_SIZE
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
the next step, and a stream loader's cursor is checked against it. No
SIGTERM save yet: that is a later slice.

Telemetry (telemetry/, vitax's): with --metrics_dir, rank 0 writes
<metrics_dir>/metrics.jsonl: a run_start event, a restore event on a
resume, a control/elastic_resume event when the process count changed, a
schema-1 step record at every log step from the host values the loop
fetched there, and an eval event a pass. The update's own seconds
(opt_update_s) are timed at those log steps only, by CUDA events on the
card that launch nothing, so the step launches the same kernels in the
same order with telemetry on or off. Every process meets the others at
vitax's four named barriers: loaded dataset, loaded model, loaded
optimizer, training begins. --debug_nans turns on autograd's anomaly
mode with NaN checks and fetches the loss and grad norm every step.
"""

from __future__ import annotations

import dataclasses
import math
import pprint
import time
from typing import Callable, Dict, List, Optional

import torch

from vitax_torch import distributed
from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.config import Config
from vitax_torch.data.loader import build_datasets
from vitax_torch.models.vit import build_model, count_params
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.ops.fused_optimizer import fused_optimizer_active
from vitax_torch.parallel.mesh import batch_shard, build_mesh
from vitax_torch.parallel.sharding import apply_fsdp, init_sharded, reshard
from vitax_torch.platform import DeviceLike, device_kind
from vitax_torch.telemetry import build_recorder, install_thread_excepthook, restore_thread_excepthook
from vitax_torch.train.control import elastic_resume_plan
from vitax_torch.train.state import ADAMW_HPARAMS, TrainState, build_optimizer, make_train_state
from vitax_torch.train.step import _needs_dropout, make_eval_step, make_train_step
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
    "grad_norm", "data_wait_s"} to it, each eval {"epoch", "top1",
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
    mesh = build_mesh(cfg, device) if distributed.is_distributed() else None
    _, ranks = batch_shard(mesh)
    if cfg.batch_size % ranks or (cfg.batch_size // ranks) % cfg.grad_accum_steps:
        raise ValueError(f"--batch_size {cfg.batch_size} must split into {ranks} equal rank batches, each a "
                         f"multiple of --grad_accum_steps {cfg.grad_accum_steps}")
    auto_resume = cfg.resume_epoch < 0
    if auto_resume:                     # the latest committed checkpoint, if any, as rank 0 sees it
        found = distributed.broadcast_from_process0(ckpt_io.latest_epoch(cfg.ckpt_dir) or 0)
        cfg = dataclasses.replace(cfg, resume_epoch=found)
        master_print(f"auto-resume: {'epoch ' + str(found) if found else 'no checkpoint found, fresh start'}")
    master_print(f"\n=== cfg ===\n{pprint.pformat(cfg)}\n")
    master_print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                        if device.type == "cuda" else ""))
    if mesh is not None:
        kind = ("DP (HSDP, shard group 1)" if cfg.run_without_fsdp else
                "ZeRO-3" if cfg.reshard_after_forward else "ZeRO-2")
        master_print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {ranks} process(es), one "
                     f"{device.type} device each; {kind}, params gathered in "
                     f"{'bfloat16' if cfg.comm_cast_active else 'float32'}, grads reduced in "
                     f"{cfg.grad_reduce_dtype}")

    train_ds, train_loader, _, val_loader = data if data is not None else build_datasets(cfg, device)
    distributed.barrier("loaded dataset")
    master_print(f"\n=== dataset ===\n{train_ds!r}\n")

    # a mid-epoch checkpoint re-enters its epoch at the recorded step
    resume_step, topology_change, resume_rounded = (_elastic_resume(cfg, cfg.resume_epoch)
                                                    if cfg.resume_epoch > 0 else (0, None, False))
    attention_impl = make_attention_impl(cfg, device)
    master_print(f"attention core: {getattr(attention_impl, 'vitax_name', 'dense')} on {device.type} "
                 f"(N {cfg.num_patches}); grad_ckpt {cfg.grad_ckpt}, remat_policy {cfg.remat_policy}")
    if _needs_dropout(cfg):
        where = "in the flash core" if attention_impl else "dense"
        master_print(f"dropout: att {cfg.att_dropout} ({where}), mlp and proj {cfg.mlp_dropout}, "
                     f"pos {cfg.pos_dropout}; seeds per (step, microbatch, block) from seed {cfg.seed}")
    if mesh is not None:                # built on meta, sharded, then each rank's shards filled
        model = apply_fsdp(build_model(cfg, "meta", attention_impl=attention_impl), cfg, mesh)
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
    optimizer, schedule = build_optimizer(cfg, max_iteration)
    state = make_train_state(model)
    if cfg.resume_epoch > 0:
        if auto_resume:                 # survive one bad checkpoint: fall back to an earlier one
            state, restored = ckpt_io.restore_state_with_fallback(cfg.ckpt_dir, cfg.resume_epoch, state)
            if restored != cfg.resume_epoch:
                cfg = dataclasses.replace(cfg, resume_epoch=restored)
                resume_step, topology_change, resume_rounded = _elastic_resume(cfg, restored)
        else:                           # an explicit --resume_epoch N means N: fail hard
            state = ckpt_io.restore_state(cfg.ckpt_dir, cfg.resume_epoch, state)
        master_print(f"restored epoch {cfg.resume_epoch}: step {state.step}")
    distributed.barrier("loaded model")
    master_print(f"global parameter num: {count_params(model)}")
    master_print(
        f"\n=== optimizer ===\nAdamW(lr=warmup_cosine(base={cfg.lr}, warmup={cfg.warmup_steps}, "
        f"max_iteration={max_iteration}), betas=({ADAMW_HPARAMS['b1']}, {ADAMW_HPARAMS['b2']}), "
        f"eps={ADAMW_HPARAMS['eps']}, weight_decay={cfg.weight_decay}, "
        f"clip_grad_norm={cfg.clip_grad_norm}, fused={fused})\n")
    distributed.barrier("loaded optimizer")
    if cfg.grad_accum_steps > 1:
        master_print(f"grad accumulation: {cfg.grad_accum_steps} microbatches of "
                     f"{cfg.batch_size // cfg.grad_accum_steps} (one optimizer step per loader batch)")

    train_step = make_train_step(cfg, optimizer, device, mesh)
    eval_step = make_eval_step(cfg)

    # rank 0's telemetry; host work only, the step's launches are the same without it
    recorder = build_recorder(cfg, distributed.process_count(), device_kind(device), rank=rank, device=device)
    install_thread_excepthook(recorder, rank)       # ... and now thread_crash events too
    if recorder is not None:
        master_print(f"telemetry: JSONL step records -> {cfg.metrics_dir} (MFU vs {recorder.peak_tflops:.0f} "
                     f"TF/s/card peak" + (", tensorboard mirror on" if cfg.tensorboard else "") + ")")
        recorder.event("run_start", device_kind=recorder.device_kind, n_devices=recorder.n_devices,
                       peak_tflops=recorder.peak_tflops, flops_per_step=recorder.flops_per_step,
                       batch_size=cfg.batch_size)
        if cfg.resume_epoch > 0:
            recorder.event("restore", path="dcp", epoch=int(cfg.resume_epoch), resume_step=int(resume_step))
        if topology_change is not None:
            recorder.event("control", event="elastic_resume", from_processes=topology_change[0],
                           to_processes=topology_change[1], epoch=cfg.resume_epoch, resume_step=resume_step,
                           epoch_rounded=resume_rounded)
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        master_print("debug_nans: autograd anomaly mode with NaN checks; the loss and grad norm are fetched "
                     "every step")
    distributed.barrier("training begins")
    master_print("training begins")
    try:
        return _run_epochs(cfg, state, train_step, train_loader, val_loader, eval_step, schedule,
                           records, train_ds, resume_step=resume_step, resume_rounded=resume_rounded,
                           recorder=recorder)
    finally:
        torch.autograd.set_detect_anomaly(*anomaly)
        try:
            ckpt_io.wait_until_finished()   # no exit with a save in flight
        finally:
            restore_thread_excepthook(hook)
            if recorder is not None:
                recorder.close()


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


def _run_epochs(cfg: Config, state: TrainState, train_step: Callable, train_loader, val_loader,
                eval_step: Callable, schedule: Callable,
                records: Optional[List[Dict[str, float]]] = None, train_ds=None,
                resume_step: int = 0, resume_rounded: bool = False, recorder=None) -> TrainState:
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
    for epoch in range(max(start_epoch, 1), cfg.num_epochs + 1):
        master_print(f"starting epoch {epoch}")
        time_epoch_b = time_step_b = time.time()
        metrics = None
        start_step = resume_step if epoch == start_epoch else 0
        for step, batch in enumerate(train_loader.epoch(epoch, start_step=start_step), start=start_step):
            if cfg.steps_per_epoch and step >= cfg.steps_per_epoch:
                break
            will_log = total_steps == 0 or (step + 1) % cfg.log_step_interval == 0
            state, metrics = _checked(cfg, train_step, state, batch, total_steps + 1,
                                      time_update=will_log and recorder is not None)
            total_steps += 1
            steps_since_record += 1
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
                steps_since_record = 0
                if records is not None or recorder is not None:
                    grad_norm = float(metrics["grad_norm"])
                if recorder is not None:
                    recorder.record_step(step=total_steps, epoch=epoch, step_in_epoch=step + 1, loss=host_loss,
                                         lr=lr, sec_per_iter=smoothed_time.avg, data_wait_s=data_wait_s,
                                         opt_update_s=metrics["opt_update"].seconds(), grad_norm=grad_norm)
                if records is not None:
                    records.append({"epoch": epoch, "step": total_steps, "loss": host_loss, "lr": lr,
                                    "sec_per_iter": smoothed_time.avg, "step_seconds": step_seconds,
                                    "grad_norm": grad_norm, "data_wait_s": data_wait_s})
            if cfg.max_steps and total_steps >= cfg.max_steps:
                break
        if metrics is not None:
            float(metrics["loss"])             # wait for the last step: honest epoch time
        master_print(f"epoch {epoch} done ({time.time() - time_epoch_b:.2f} sec)")
        decode = _decode_line(train_ds)
        if decode:
            master_print(f"epoch {epoch} {decode}")
        if epoch % cfg.ckpt_epoch_interval == 0 or epoch == cfg.num_epochs:
            # the snapshot is taken before save_state returns; the write
            # commits in the background while the next epoch trains, and
            # the last epoch's save waits for its commit
            t0 = time.perf_counter()
            path = ckpt_io.save_state(cfg.ckpt_dir, epoch, state, wait=epoch == cfg.num_epochs,
                                      keep=cfg.keep_checkpoints)
            if records is not None:
                records.append({"epoch": epoch, "ckpt_path": path, "ckpt_stall_s": time.perf_counter() - t0})
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
