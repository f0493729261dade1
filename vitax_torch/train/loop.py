"""Training orchestration (vitax/train/loop.py train, _run_epochs,
_run_logging, eval_on_val), on one device.

The loop dispatches one train step per batch and reads nothing back from
the device except at a log step: there it fetches the loss once (which
also waits for the step, so the step time it logs is the device's, not the
enqueue's). Eval counts stay on the device until the end of the pass. No
checkpoint, resume or telemetry file yet: those are later slices. Dropout
seeds are the JAX loop's data_rng (key(seed + 1), :550) ported as a host
function of (seed, step, microbatch): train/step.py dropout_seeds. Each
log record carries data_wait_s, the seconds a step waited on the loader
(:654), and each epoch ends with a line saying which decode path (native
or PIL) fed it.
"""

from __future__ import annotations

import pprint
import time
from typing import Callable, Dict, List, Optional

import torch

from vitax_torch.config import Config
from vitax_torch.data.loader import build_datasets
from vitax_torch.models.vit import build_model, count_params
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.ops.fused_optimizer import fused_optimizer_active
from vitax_torch.platform import DeviceLike, resolve_device
from vitax_torch.train.state import ADAMW_HPARAMS, TrainState, build_optimizer, make_train_state
from vitax_torch.train.step import _needs_dropout, make_eval_step, make_train_step
from vitax_torch.utils.logging import master_print
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
    "grad_norm", "data_wait_s"} to it, and each eval {"epoch", "top1",
    "top5"}. `data` is build_datasets' (train_ds, train_loader, val_ds,
    val_loader), default build_datasets(cfg, device)."""
    cfg.validate()
    device = resolve_device(device)
    fused = fused_optimizer_active(cfg, device)     # raises for --fused_optimizer off on the card
    set_float32_precision()
    master_print(f"\n=== cfg ===\n{pprint.pformat(cfg)}\n")
    master_print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                        if device.type == "cuda" else ""))

    train_ds, train_loader, _, val_loader = data if data is not None else build_datasets(cfg, device)
    master_print(f"\n=== dataset ===\n{train_ds!r}\n")

    attention_impl = make_attention_impl(cfg, device)
    master_print(f"attention core: {getattr(attention_impl, 'vitax_name', 'dense')} on {device.type} "
                 f"(N {cfg.num_patches}); grad_ckpt {cfg.grad_ckpt}, remat_policy {cfg.remat_policy}")
    if _needs_dropout(cfg):
        where = "in the flash core" if attention_impl else "dense"
        master_print(f"dropout: att {cfg.att_dropout} ({where}), mlp and proj {cfg.mlp_dropout}, "
                     f"pos {cfg.pos_dropout}; seeds per (step, microbatch, block) from seed {cfg.seed}")
    model = build_model(cfg, device, attention_impl=attention_impl).train()
    steps_per_epoch = cfg.steps_per_epoch or train_loader.steps_per_epoch
    max_iteration = steps_per_epoch * cfg.num_epochs
    optimizer, schedule = build_optimizer(cfg, max_iteration)
    state = make_train_state(model)
    master_print(f"global parameter num: {count_params(model)}")
    master_print(
        f"\n=== optimizer ===\nAdamW(lr=warmup_cosine(base={cfg.lr}, warmup={cfg.warmup_steps}, "
        f"max_iteration={max_iteration}), betas=({ADAMW_HPARAMS['b1']}, {ADAMW_HPARAMS['b2']}), "
        f"eps={ADAMW_HPARAMS['eps']}, weight_decay={cfg.weight_decay}, "
        f"clip_grad_norm={cfg.clip_grad_norm}, fused={fused})\n")
    if cfg.grad_accum_steps > 1:
        master_print(f"grad accumulation: {cfg.grad_accum_steps} microbatches of "
                     f"{cfg.batch_size // cfg.grad_accum_steps} (one optimizer step per loader batch)")

    train_step = make_train_step(cfg, optimizer, device)
    eval_step = make_eval_step(cfg)
    return _run_epochs(cfg, state, train_step, train_loader, val_loader, eval_step, schedule,
                       records, train_ds)


def _decode_line(dataset) -> Optional[str]:
    """Which decode path fed the dataset so far, from its counts."""
    if not hasattr(dataset, "decoded"):
        return None
    c = dataset.decoded.snapshot()
    return (f"decoded so far: {c['native']} items native, {c['pil']} through PIL ({c['pil_jpeg']} of them "
            f"JPEG); decode path {'native' if dataset.use_native else 'PIL'}")


def _run_epochs(cfg: Config, state: TrainState, train_step: Callable, train_loader, val_loader,
                eval_step: Callable, schedule: Callable,
                records: Optional[List[Dict[str, float]]] = None, train_ds=None) -> TrainState:
    smoothed_loss = SmoothedValue(window_size=5)
    smoothed_time = SmoothedValue(window_size=5)
    total_steps = 0
    steps_since_record = 0
    for epoch in range(1, cfg.num_epochs + 1):
        master_print(f"starting epoch {epoch}")
        time_epoch_b = time_step_b = time.time()
        metrics = None
        for step, batch in enumerate(train_loader.epoch(epoch)):
            if cfg.steps_per_epoch and step >= cfg.steps_per_epoch:
                break
            state, metrics = train_step(state, batch)
            total_steps += 1
            steps_since_record += 1
            will_log = total_steps == 1 or (step + 1) % cfg.log_step_interval == 0
            host_loss = float(metrics["loss"]) if will_log else None    # the log step's one fetch
            t_new = time.time()
            step_seconds = t_new - time_step_b
            smoothed_time.update(step_seconds, batch_size=1)
            time_step_b = t_new
            if will_log:
                lr = float(schedule(metrics["lr_step"]))
                _run_logging(cfg, epoch, step, host_loss, lr, smoothed_loss, smoothed_time)
                data_wait_s = train_loader.consume_wait_s() / steps_since_record
                steps_since_record = 0
                if records is not None:
                    records.append({"epoch": epoch, "step": total_steps, "loss": host_loss, "lr": lr,
                                    "sec_per_iter": smoothed_time.avg, "step_seconds": step_seconds,
                                    "grad_norm": float(metrics["grad_norm"]), "data_wait_s": data_wait_s})
            if cfg.max_steps and total_steps >= cfg.max_steps:
                break
        if metrics is not None:
            float(metrics["loss"])             # wait for the last step: honest epoch time
        master_print(f"epoch {epoch} done ({time.time() - time_epoch_b:.2f} sec)")
        decode = _decode_line(train_ds)
        if decode:
            master_print(f"epoch {epoch} {decode}")
        if epoch % cfg.test_epoch_interval == 0 or epoch == cfg.num_epochs:
            top1, top5, _, _ = eval_on_val(cfg, val_loader, eval_step, state)
            master_print(f"accuracy on val: {top1:.4f} (top-5 {top5:.4f})")
            if records is not None:
                records.append({"epoch": epoch, "top1": top1, "top5": top5})
        if cfg.max_steps and total_steps >= cfg.max_steps:
            break
    return state


def _run_logging(cfg: Config, epoch: int, step: int, loss: float, lr: float,
                 smoothed_loss: SmoothedValue, smoothed_time: SmoothedValue) -> None:
    """The reference's throttled step log line; the caller already fetched
    the loss and resolved the lr."""
    smoothed_loss.update(loss, batch_size=1)
    master_print(f"epoch {epoch} step {step + 1}, lr: {lr:.4f}, "
                 f"loss: {smoothed_loss.avg:.4f}, sec/iter: {smoothed_time.avg:.4f}")


def eval_on_val(cfg: Config, val_loader, eval_step: Callable, state: TrainState):
    """Top-1 and top-5 accuracy over the val split with drop_last (the
    remainder of the split is ignored, as in the reference), capped at
    cfg.eval_max_batches. Returns (top1, top5, n_correct, total)."""
    correct = None
    total = 0
    for step, batch in enumerate(val_loader.epoch(0)):
        if cfg.eval_max_batches and step >= cfg.eval_max_batches:
            break
        c = eval_step(state, batch)
        correct = c if correct is None else {k: correct[k] + c[k] for k in c}
        total += cfg.batch_size
    n_correct = int(correct["correct"]) if correct is not None else 0
    n_top5 = int(correct["correct_top5"]) if correct is not None else 0
    top1 = n_correct / total if total else 0.0
    top5 = n_top5 / total if total else 0.0
    return top1, top5, n_correct, total
