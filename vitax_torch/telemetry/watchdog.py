"""Hang watchdog (vitax/telemetry/watchdog.py): detect a stalled training
loop, dump the evidence and, when asked, escalate so a supervisor can
restart the job.

A daemon thread the loop pets once a step. If `timeout_s` passes without
a pet it dumps, without killing the job, every live thread's Python stack
(where is the loop stuck: a queue get, a device sync, a checkpoint
write?) and the card's allocator stats (torch.cuda.memory_stats), rank
tagged on stderr, and a `kind: "hang"` event through the Recorder where
one is attached (rank 0). It dumps once a stall: after a dump it stays
quiet until the next pet.

Escalation (--hang_action checkpoint_exit): after the dump the watchdog
raises a sticky flag and emits `kind: "hang_escalation"`. The loop reads
the flag through the control plane at the step boundary (the watchdog
thread never touches the card's state), takes an emergency committed
checkpoint and exits EXIT_HANG (42) for the supervisor (supervise.py) to
restart. If the loop never reaches a boundary, the watchdog itself
os._exit(42)s once `hard_deadline_s` more seconds pass, after its last
words (`on_hard_exit`: a flushed `hang_hard_exit` event and the fault
published to the peers); `acknowledge_escalation()` re-arms that deadline
to cover the emergency save. With --hang_action dump the job runs on.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

# the exit code a supervisor reads as "restart me after a hang"; distinct
# from crash codes and from 0
EXIT_HANG = 42

HANG_ACTIONS = ("dump", "checkpoint_exit")

# torch.cuda.memory_stats keys a dump prints (the allocator's state of a stall)
_CUDA_STAT_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak", "reserved_bytes.all.current",
                   "reserved_bytes.all.peak", "active_bytes.all.current", "num_alloc_retries", "num_ooms")


def dump_all_stacks() -> str:
    """Python stacks of every live thread, tagged with thread names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "unknown")
        stack = "".join(traceback.format_stack(frame))
        parts.append(f"--- thread {name} (ident {ident}) ---\n{stack}")
    return "\n".join(parts)


def cuda_memory_stats(device=None) -> dict:
    """The allocator's stats of a stall from torch.cuda.memory_stats on
    `device` ({} on the CPU): bytes allocated, reserved and active, their
    peaks, retries and OOMs."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: int(stats.get(k, 0)) for k in _CUDA_STAT_KEYS}


class Watchdog:
    """Heartbeat monitor: start() it, pet() it every step, stop() it.

    `on_fire(payload)` runs on the watchdog thread at each dump (the loop
    wires it to Recorder.event("hang", ...)); `fire_count` counts dumps.
    With action "checkpoint_exit" the first dump of a stall also
    escalates: escalation_requested() turns True for good, `on_escalate`
    runs once, and a hard deadline of `hard_deadline_s` (default 2 x
    timeout_s) starts; without acknowledge_escalation() or stop() in time
    the watchdog calls `hard_exit(EXIT_HANG)` (os._exit; injectable so
    tests never die). `device` is the card whose memory a dump reports.
    """

    def __init__(self, timeout_s: float, on_fire: Optional[Callable[[dict], None]] = None, rank: int = 0,
                 poll_s: Optional[float] = None, action: str = "dump", hard_deadline_s: Optional[float] = None,
                 on_escalate: Optional[Callable[[dict], None]] = None,
                 on_hard_exit: Optional[Callable[[dict], None]] = None,
                 hard_exit: Callable[[int], None] = os._exit, device=None):
        assert timeout_s > 0, timeout_s
        assert action in HANG_ACTIONS, action
        self.timeout_s = float(timeout_s)
        self.on_fire = on_fire
        self.rank = rank
        self.action = action
        self.hard_deadline_s = float(hard_deadline_s) if hard_deadline_s else 2.0 * self.timeout_s
        self.on_escalate = on_escalate
        # last words before the hard exit; assignable after construction
        # (the control plane is built after the watchdog)
        self.on_hard_exit = on_hard_exit
        self._hard_exit = hard_exit
        self.device = device
        self.poll_s = poll_s if poll_s else min(max(timeout_s / 4.0, 0.05), 5.0)
        self.fire_count = 0
        # the pet and deadline words move together between the loop thread and _run
        self._lock = threading.Lock()
        self._last_pet = time.monotonic()
        self._fired_since_pet = False
        self._escalated = threading.Event()
        self._hard_deadline_at: Optional[float] = None  # monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        """Has start() been called? The loop starts the watchdog when the
        first step's loss is back, so neither the kernels' first-use build
        nor the first step's warm-up lies inside a hang window."""
        return self._thread is not None

    def start(self) -> "Watchdog":
        with self._lock:
            self._last_pet = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True, name="vitax-torch-watchdog")
        self._thread.start()
        return self

    def pet(self) -> None:
        """The loop made progress: re-arm the dump (not the escalation: once
        requested, the loop must checkpoint and exit)."""
        with self._lock:
            self._last_pet = time.monotonic()
            self._fired_since_pet = False

    def escalation_requested(self) -> bool:
        """Sticky: True once a stall under "checkpoint_exit" dumped, or a
        caller escalated."""
        return self._escalated.is_set()

    def request_escalation(self, reason: str = "external") -> None:
        """Escalate from outside the stall detector (the control plane's
        peer-loss path): arm the hard deadline and raise the flag as a dump
        would, without the dump. Idempotent."""
        if self._escalated.is_set():
            return
        with self._lock:                # the deadline runs before the flag shows
            self._hard_deadline_at = time.monotonic() + self.hard_deadline_s
        self._escalated.set()
        self._call(self.on_escalate, "on_escalate", {"reason": reason, "timeout_s": self.timeout_s,
                                                     "exit_code": EXIT_HANG, "hard_deadline_s": self.hard_deadline_s})

    def acknowledge_escalation(self) -> None:
        """The loop is taking the emergency checkpoint: push the hard exit
        out by another hard_deadline_s, so the save runs bounded too."""
        with self._lock:
            self._hard_deadline_at = time.monotonic() + self.hard_deadline_s

    def arm_exit_deadline(self) -> None:
        """Bound a blocking exit-path collective (the coordinated exit's
        barrier) under any --hang_action: a peer that died mid-save would
        wedge this process there; a clean return is followed by stop()."""
        with self._lock:
            self._hard_deadline_at = time.monotonic() + self.hard_deadline_s

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            with self._lock:
                stalled = now - self._last_pet
                fire = stalled >= self.timeout_s and not self._fired_since_pet
                if fire:
                    self._fired_since_pet = True        # once a stall, not a poll
                hard = self._hard_deadline_at is not None and now >= self._hard_deadline_at
            # outside the lock: both run sinks that may call back into us
            if fire:
                self._fire(stalled)
            if hard:
                self._hard_exit_now()

    def _call(self, sink, what: str, payload: dict) -> None:
        if sink is None:
            return
        try:                            # JSONL sinks flush per record: the event outlives an exit
            sink(payload)
        except Exception as e:  # noqa: BLE001 - a sink must not block the watchdog
            print(f"[vitax_torch.watchdog rank {self.rank}] {what} sink failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)

    def _hard_exit_now(self) -> None:
        print(f"[vitax_torch.watchdog rank {self.rank}] escalation deadline ({self.hard_deadline_s:.1f}s) passed "
              f"without the loop reaching a step boundary — hard-exiting with code {EXIT_HANG} for the supervisor",
              file=sys.stderr, flush=True)
        self._call(self.on_hard_exit, "on_hard_exit",
                   {"rank": self.rank, "exit_code": EXIT_HANG, "hard_deadline_s": self.hard_deadline_s})
        with self._lock:
            self._hard_deadline_at = None   # a test's exit returns: disarm
        self._hard_exit(EXIT_HANG)

    def _fire(self, stalled_s: float) -> None:
        from vitax_torch.telemetry.record import memory_stats_bytes
        self.fire_count += 1
        try:
            mem = memory_stats_bytes(self.device)
            cuda = cuda_memory_stats(self.device)
        except Exception as e:  # noqa: BLE001 - a dead card must not mute the dump
            mem, cuda = {"error": f"{type(e).__name__}: {e}"}, {}
        stacks = dump_all_stacks()
        escalating = self.action == "checkpoint_exit" and not self._escalated.is_set()
        verdict = (f"escalating: emergency checkpoint + exit {EXIT_HANG} at the next step boundary (hard deadline "
                   f"{self.hard_deadline_s:.1f}s)" if escalating else "job left running")
        print(f"[vitax_torch.watchdog rank {self.rank}] no step progress for {stalled_s:.1f}s (timeout "
              f"{self.timeout_s:.1f}s); dumping all-thread stacks + device memory ({verdict})\n{stacks}\n"
              f"[vitax_torch.watchdog rank {self.rank}] memory: {mem} {cuda}", file=sys.stderr, flush=True)
        payload = {"stalled_s": round(stalled_s, 3), "timeout_s": self.timeout_s, "stacks": stacks, **mem}
        if cuda:
            payload["cuda_memory_stats"] = cuda
        self._call(self.on_fire, "on_fire", payload)
        if escalating:
            with self._lock:            # the deadline runs before the flag shows
                self._hard_deadline_at = time.monotonic() + self.hard_deadline_s
            self._escalated.set()
            self._call(self.on_escalate, "on_escalate",
                       {"stalled_s": round(stalled_s, 3), "timeout_s": self.timeout_s, "exit_code": EXIT_HANG,
                        "hard_deadline_s": self.hard_deadline_s})
