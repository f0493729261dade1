"""The training loop's profiler window (vitax/train/loop.py:553-615) over
torch.profiler.

With --profile_dir the window opens after --profile_start_step completed
steps, spans --profile_num_steps steps, then synchronizes the device and
writes one Chrome trace a rank, <profile_dir>/rank<r>.pt.trace.json: the
host's ops and, on the card, every kernel by name. Each step inside the
window runs under a `vitax_step_<n>` range (n the run's global step), so a
reader counts the window's steps from the trace alone. The profiler is
armed one step before the window (torch.profiler's warm-up: collected,
then dropped), where there is one: started at the window itself, an H100
run's trace lost the first milliseconds of the first step's kernels. The
card is synchronized between the warm-up step and the window, and
read_trace keeps the kernels that start inside the window's ranges. A
window still open when the loop ends (fewer steps than it spans) is
closed by `close()`, as vitax's loop closes its trace in its finally.
Outside the window nothing is recorded and the step is the same; the
warm-up step runs under the profiler.

`read_trace(path)` returns (the window's step ranges, its device kernels)
from such a file, for the chip check and the tests.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

import torch

STEP_PREFIX = "vitax_step_"


class ProfilerWindow:
    """One window of steps under torch.profiler; a no-op without a dir."""

    def __init__(self, profile_dir: str, start_step: int, num_steps: int, device: torch.device, rank: int = 0,
                 say: Callable[[str], None] = print):
        self.dir = profile_dir
        self.start_at = start_step
        self.stop_at = start_step + num_steps
        self.warmup = 1 if start_step >= 1 else 0      # the step before the window, where there is one
        self.device = device
        self.path = os.path.join(profile_dir, f"rank{rank}.pt.trace.json") if profile_dir else ""
        self._say = say
        self._prof = None
        self._range = None
        self.done = False

    def before_step(self, completed: int) -> None:
        """Arm the profiler one step before the window, and mark each
        coming step inside it."""
        if self.dir and not self.done and self._prof is None and completed == self.start_at - self.warmup:
            from torch.profiler import ProfilerActivity, profile, schedule
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities, on_trace_ready=self._write,
                                 schedule=schedule(wait=0, warmup=self.warmup, active=self.stop_at - self.start_at,
                                                   repeat=1))
            self._prof.start()
        if self._prof is not None and completed >= self.start_at:
            self._range = torch.profiler.record_function(f"{STEP_PREFIX}{completed + 1}")
            self._range.__enter__()

    def after_step(self, completed: int) -> None:
        """End the step's range and advance the profiler; after the
        window's last step, synchronize and write the trace."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._prof is None:
            return
        if completed >= self.stop_at:
            self.close()
            return
        if completed == self.start_at - 1 and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the warm-up step's kernels end before the window records
        self._prof.step()

    def close(self) -> None:
        """Synchronize, stop and write the trace, if the profiler is armed."""
        if self._prof is None:
            return
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()                     # the active steps' trace, through _write
        self.done = True

    def _write(self, prof) -> None:
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(self.path)
        self._say(f"profile trace written to {self.dir}")


def trace_events(path: str) -> List[dict]:
    """Every event of a Chrome trace torch.profiler wrote."""
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def read_trace(path: str) -> Tuple[List[int], List[dict]]:
    """(the global step numbers the window's ranges name, in order; the
    device kernel events {"name", "ts", "dur"} in microseconds that start
    at or after the window's first step range) of a trace ProfilerWindow
    wrote. The trace also holds device work of the warm-up step (an H100
    run's held its last kernels); the card is synchronized before the
    window's first step, so its kernels start after that range opens."""
    events = trace_events(path)
    ranges = [e for e in events
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(STEP_PREFIX)]
    steps = sorted(int(e["name"][len(STEP_PREFIX):]) for e in ranges)
    t0 = min((float(e["ts"]) for e in ranges), default=float("-inf"))
    kernels = [{"name": e["name"], "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
               for e in events if e.get("cat") == "kernel" and e.get("ph") == "X" and float(e["ts"]) >= t0]
    return steps, kernels


def window_busy(kernels: List[dict]) -> Optional[Tuple[float, float]]:
    """(device busy ms as the union of the kernels' intervals, the span ms
    from the first kernel's start to the last one's end), or None without
    kernels."""
    if not kernels:
        return None
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3
