"""Recorder (vitax/telemetry/record.py): versioned per-step run records,
fanned out to sinks.

One `record_step` per log step turns the loop's host values into a schema-1
record with the JAX package's keys:

    schema, time, step, epoch, step_in_epoch, loss, lr, grad_norm,
    sec_per_iter, images_per_sec, tokens_per_sec, data_wait_s, ckpt_stall_s,
    opt_update_s, mfu, mem_used_bytes[, mem_peak_bytes, mem_limit_bytes]

MFU comes from the analytic FLOP count (telemetry/flops.py) over the
measured sec/iter; ckpt_stall_s is the zero-stall pipeline's staging
stall over the record's window (checkpoint/snapshot.py consume_stall_s),
0.0 without the pipeline. `event()` appends non-step records to the same
stream, tagged with `kind`, as vitax's loop writes them:

    run_start, finetune, distill, eval, thread_crash
    restore          path "peer" | "dcp", epoch, resume_step, dcp_reads
                     (checkpoint-directory reads of the restore), seconds
    fault            site, action, index of a fired fault (faults.py)
    hang, hang_escalation, hang_hard_exit
                     the watchdog's dump (stacks, memory), its escalation
                     and its last words (telemetry/watchdog.py)
    control          event: agreed_preempt | agreed_escalation |
                     fault_flagged | peer_loss | elastic_resume |
                     peer_restore_negotiated | peer_restore_failed
                     (train/control.py, checkpoint/peer.py); the supervisor
                     appends topology_change and `restart` records itself
    peer_replication bytes, version, src, buddy, seconds of a window
Everything here is host work: the loop launches the same kernels in the
same order with a Recorder or without one.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

from vitax_torch.telemetry.flops import detect_peak_tflops, mfu, model_flops_per_step

SCHEMA_VERSION = 1

# what a step record must hold: tools/metrics_report.py keys off this set
REQUIRED_STEP_KEYS = ("schema", "step", "loss", "sec_per_iter", "data_wait_s", "mfu", "mem_used_bytes")


class Recorder:
    """Fan structured records out to sinks; owns the run's MFU constants.
    `device` is the one whose memory the step records report."""

    def __init__(self, cfg, sinks, n_devices: int, device_kind: str, rank: int = 0, device=None):
        self.cfg = cfg
        self.sinks = list(sinks)
        self.n_devices = n_devices
        self.device_kind = device_kind
        self.rank = rank
        self.device = device
        self.peak_tflops = detect_peak_tflops(device_kind, getattr(cfg, "peak_tflops", 0.0))
        self.flops_per_step = model_flops_per_step(cfg)
        self.tokens_per_step = cfg.batch_size * cfg.num_patches

    def _write(self, record: dict) -> None:
        for sink in self.sinks:
            try:
                sink.write(record)
            except Exception as e:  # noqa: BLE001 - telemetry must not kill training
                print(f"vitax_torch.telemetry: sink {type(sink).__name__} failed ({type(e).__name__}: {e})",
                      file=sys.stderr, flush=True)

    def record_step(self, *, step: int, epoch: int, step_in_epoch: int, loss: float, lr: float,
                    sec_per_iter: float, data_wait_s: float, grad_norm: Optional[float] = None,
                    ckpt_stall_s: float = 0.0, opt_update_s: float = 0.0) -> dict:
        """One record a log step. `sec_per_iter` and `data_wait_s` are the
        per-step averages since the previous record; `step` is the global
        optimizer-step count. `opt_update_s` is the seconds of the log
        step's own update (global norm and clip+AdamW, train/step.py)."""
        record = {
            "schema": SCHEMA_VERSION,
            "time": time.time(),
            "step": int(step),
            "epoch": int(epoch),
            "step_in_epoch": int(step_in_epoch),
            "loss": float(loss),
            "lr": float(lr),
            "sec_per_iter": float(sec_per_iter),
            "images_per_sec": self.cfg.batch_size / sec_per_iter if sec_per_iter > 0 else 0.0,
            "tokens_per_sec": self.tokens_per_step / sec_per_iter if sec_per_iter > 0 else 0.0,
            "data_wait_s": float(data_wait_s),
            "ckpt_stall_s": float(ckpt_stall_s),
            "opt_update_s": float(opt_update_s),
            "mfu": mfu(self.cfg, sec_per_iter, self.n_devices, self.peak_tflops),
        }
        if grad_norm is not None:
            record["grad_norm"] = float(grad_norm)
        record.update(memory_stats_bytes(self.device))
        self._write(record)
        return record

    def event(self, kind: str, **payload) -> dict:
        """A non-step record tagged with `kind`; the TensorBoard sink skips it."""
        record = {"schema": SCHEMA_VERSION, "time": time.time(), "kind": kind, "rank": self.rank, **payload}
        self._write(record)
        return record

    def close(self) -> None:
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # vtx: ignore[VTX106] a failing sink must not break the others' close
                pass


def memory_stats_bytes(device=None) -> dict:
    """The record's mem_*_bytes fields from utils/logging.py
    memory_stats_dict: mem_used_bytes always (0 on the CPU, which reports
    nothing), peak and limit where the device reports them."""
    from vitax_torch.utils.logging import memory_stats_dict
    stats = memory_stats_dict(device)
    out = {"mem_used_bytes": int(stats.get("bytes_in_use", 0))}
    if stats.get("peak_bytes_in_use"):
        out["mem_peak_bytes"] = int(stats["peak_bytes_in_use"])
    if stats.get("bytes_limit"):
        out["mem_limit_bytes"] = int(stats["bytes_limit"])
    return out


def build_recorder(cfg, n_devices: int, device_kind: str, rank: int = 0, device=None) -> Optional[Recorder]:
    """The run's Recorder, or None: without --metrics_dir, on a rank other
    than 0 (rank 0 owns the global step records), or, after one warning,
    where metrics_dir cannot be created or written."""
    metrics_dir = getattr(cfg, "metrics_dir", "") or ""
    if not metrics_dir or rank != 0:
        return None
    from vitax_torch.telemetry.sinks import JsonlSink
    try:
        os.makedirs(metrics_dir, exist_ok=True)
        sinks = [JsonlSink(os.path.join(metrics_dir, "metrics.jsonl"))]
    except OSError as e:
        print(f"vitax_torch.telemetry: --metrics_dir {metrics_dir!r} is not writable ({e}); telemetry "
              f"disabled for this run", file=sys.stderr, flush=True)
        return None
    if getattr(cfg, "tensorboard", False):
        from vitax_torch.telemetry.sinks import make_tensorboard_sink
        tb = make_tensorboard_sink(os.path.join(metrics_dir, "tb"))
        if tb is not None:
            sinks.append(tb)
    return Recorder(cfg, sinks, n_devices, device_kind, rank=rank, device=device)
