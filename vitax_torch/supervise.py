"""Supervised auto-restart (vitax/supervise.py): run training as a child
process and keep it alive.

    python -m vitax_torch.supervise [flags] -- python -m vitax_torch.train ...
    python -m vitax_torch.supervise [flags] -- torchrun --nproc_per_node N -m vitax_torch.train ...

The supervisor launches the command with --resume_epoch -1 forced on
(auto-resume from the latest committed checkpoint, checkpoint/io.py), then:

- restarts it on any nonzero exit (a crash, an OOM kill, the watchdog's
  or the control plane's exit 42, telemetry/watchdog.py EXIT_HANG) with
  capped exponential backoff and a restart budget;
- detects crash loops: a child that dies without moving the durable
  frontier (the latest committed epoch and its mid-epoch sidecar, maxed
  with the peer store's frontier when the child runs with
  --replicate_steps) is a deterministic bug, not flaky infrastructure;
  after `crash_loop_tolerance` such deaths in a row it gives up with
  EXIT_BUDGET (3). Only commit_success.txt makes an epoch count, so a
  torn directory a crash left never reads as progress;
- forwards SIGTERM/SIGINT to the child once for a clean preemption drain
  (the child saves mid-epoch and exits 0) and passes the child's code
  through instead of restarting, killing it after `term_grace_s`;
- appends schema-1 `kind: "restart"` events to <metrics_dir>/metrics.jsonl,
  the stream the child's Recorder writes, so tools/metrics_report.py
  counts restarts and the last exit code;
- announces a topology change: when the frontier's sidecar records another
  process count than the one the next child runs under (--expect_processes,
  default WORLD_SIZE from the environment, else the child's
  --nproc_per_node x --nnodes; else checking stays off), a
  `kind: "control"` `topology_change` event; the child's elastic resume
  (train/control.py elastic_resume_plan) does the rest.

Exit codes: 0 (the child completed, or drained after a forwarded SIGTERM
with 0), EXIT_BUDGET 3 (budget spent or crash loop), or the child's own
code passed through after a forwarded SIGTERM.

topology_env builds one rank's environment for an N-process relaunch
(the chip arbiter's TrainDirector, vitax_torch/arbiter/daemon.py).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

EXIT_BUDGET = 3  # distinct from the child's codes: the supervisor gave up

DEFAULT_MAX_RESTARTS = 10
DEFAULT_BACKOFF_S = 1.0
DEFAULT_BACKOFF_MAX_S = 60.0
DEFAULT_CRASH_LOOP_TOLERANCE = 2
DEFAULT_TERM_GRACE_S = 30.0

SCHEMA_VERSION = 1  # telemetry/record.py's, kept literal: the supervisor imports no torch for its events


def backoff_delay(restart_count: int, backoff_s: float, backoff_max_s: float) -> float:
    """Capped exponential backoff before restart N (1-based): backoff_s
    doubles a restart up to backoff_max_s."""
    return min(backoff_s * (2 ** max(restart_count - 1, 0)), backoff_max_s)


def terminate_children(procs: Sequence, grace_s: float, sleep: Callable[[float], None] = time.sleep,
                       poll_interval_s: float = 0.1) -> List[Optional[int]]:
    """SIGTERM every process once, before any wait (ranks that must reach a
    joint save together all hear it at once), then each its drain window
    and SIGKILL past it: returns their exit codes (None only for one that
    outlives the kill too)."""
    for proc in procs:
        try:
            proc.send_signal(signal.SIGTERM)
        except (OSError, ValueError):
            pass  # already gone: poll() returns its code
    codes = []
    for proc in procs:
        deadline = time.monotonic() + grace_s
        while proc.poll() is None and time.monotonic() < deadline:
            sleep(poll_interval_s)
        if proc.poll() is None:
            try:
                proc.kill()
            except (OSError, ValueError):
                pass
            for _ in range(600):  # a killed process is reaped promptly
                if proc.poll() is not None:
                    break
                sleep(poll_interval_s)
        codes.append(proc.poll())
    return codes


def terminate_child(proc, grace_s: float, sleep: Callable[[float], None] = time.sleep,
                    poll_interval_s: float = 0.1) -> Optional[int]:
    """SIGTERM, a drain window, then SIGKILL: returns the child's exit code
    (None only if it outlives the kill too)."""
    return terminate_children([proc], grace_s, sleep, poll_interval_s)[0]


def ensure_auto_resume(argv: Sequence[str]) -> List[str]:
    """Force --resume_epoch -1 on the child command: a restart from scratch
    (the default 0) would throw away every committed epoch."""
    argv = list(argv)
    for i, arg in enumerate(argv):
        if arg == "--resume_epoch":
            if i + 1 < len(argv):
                argv[i + 1] = "-1"
            return argv
        if arg.startswith("--resume_epoch="):
            argv[i] = "--resume_epoch=-1"
            return argv
    return argv + ["--resume_epoch", "-1"]


def scrape_flag(argv: Sequence[str], flag: str) -> Optional[str]:
    """Value of `flag` in a child argv (`--flag v` and `--flag=v`)."""
    for i, arg in enumerate(argv):
        if arg == flag and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith(flag + "="):
            return arg.split("=", 1)[1]
    return None


def checkpoint_progress(ckpt_dir: str) -> Tuple[int, int]:
    """The child's durable frontier: (latest committed epoch, its sidecar's
    step), tuple-ordered so a new epoch or a later mid-epoch save of the
    same epoch counts as progress."""
    from vitax_torch.checkpoint.io import committed_epochs, load_resume_step
    epochs = committed_epochs(ckpt_dir)
    if not epochs:
        return (0, 0)
    latest = epochs[-1]
    return (latest, load_resume_step(ckpt_dir, latest) or 0)


def peer_store_root(child_argv: Sequence[str], ckpt_dir: str) -> str:
    """Root of the child's peer store (checkpoint/peer.py), or "" when the
    child replicates nothing: VITAX_PEER_DIR > --peer_dir >
    <ckpt_dir>/peerstore, gated on --replicate_steps > 0."""
    steps = scrape_flag(child_argv, "--replicate_steps")
    try:
        if int(steps or 0) <= 0:
            return ""
    except ValueError:
        return ""
    env = os.environ.get("VITAX_PEER_DIR", "")
    if env:
        return env
    flagged = scrape_flag(child_argv, "--peer_dir")
    if flagged:
        return flagged
    from vitax_torch.checkpoint.peer import default_peer_root
    return default_peer_root(ckpt_dir)


def run_progress(ckpt_dir: str, peer_root: str = "") -> Tuple[int, int]:
    """The DCP frontier maxed with the peer store's, both normalized by
    peer.progress_key (a boundary save of epoch e counts as (e + 1, 0)): a
    child that died between commits but after a replication window still
    made progress its restart restores. (0, 0) = none."""
    from vitax_torch.checkpoint.peer import progress_key, store_frontier
    epoch, step = checkpoint_progress(ckpt_dir)
    progress = progress_key(epoch, step) if (epoch or step) else (0, 0)
    if peer_root:
        progress = max(progress, store_frontier(peer_root))
    return progress


def checkpoint_topology(ckpt_dir: str) -> Optional[int]:
    """The process count that wrote the frontier checkpoint's mid-epoch
    sidecar, or None (a boundary save, no checkpoint)."""
    from vitax_torch.checkpoint.io import committed_epochs, load_resume_meta
    epochs = committed_epochs(ckpt_dir)
    if not epochs:
        return None
    count = (load_resume_meta(ckpt_dir, epochs[-1]) or {}).get("process_count")
    return int(count) if isinstance(count, int) and count >= 1 else None


TOPOLOGY_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def topology_env(base_env: dict, process_count: int, process_id: int = 0, coordinator_port: int = 0) -> dict:
    """One rank's environment for an N-process launch on this host
    (vitax/supervise.py topology_env): exactly the bring-up variables
    distributed.maybe_initialize reads, as torchrun sets them. A
    one-process launch gets them removed, so a stale WORLD_SIZE=2 carried
    across an elastic shrink cannot wedge bring-up waiting on a phantom
    peer. Every relaunch at a new topology takes its environment from here
    (the arbiter's TrainDirector)."""
    env = dict(base_env)
    for key in TOPOLOGY_VARS:
        env.pop(key, None)
    if process_count > 1:
        assert coordinator_port > 0, "multi-process launches need a fresh coordinator port"
        env.update(RANK=str(process_id), WORLD_SIZE=str(process_count), LOCAL_RANK=str(process_id),
                   LOCAL_WORLD_SIZE=str(process_count), MASTER_ADDR="localhost", MASTER_PORT=str(coordinator_port))
    return env


def expected_process_count(child_argv: Sequence[str] = ()) -> int:
    """The process count the next child runs under: WORLD_SIZE from the
    environment, else the child's torchrun --nproc_per_node (times
    --nnodes), else 0 = topology checking off."""
    world = os.environ.get("WORLD_SIZE", "")
    if world.isdigit() and int(world) >= 1:
        return int(world)
    nproc, nnodes = scrape_flag(child_argv, "--nproc_per_node"), scrape_flag(child_argv, "--nnodes") or "1"
    if nproc and nproc.isdigit() and nnodes.isdigit():
        return int(nproc) * int(nnodes)
    return 0


class Supervisor:
    """The restart loop around one training child. `spawn`, `progress_fn`
    and `sleep` are injectable, so the restart, backoff and crash-loop
    logic is testable with fake children."""

    def __init__(self, child_argv: Sequence[str], ckpt_dir: str, metrics_dir: str = "",
                 max_restarts: int = DEFAULT_MAX_RESTARTS, backoff_s: float = DEFAULT_BACKOFF_S,
                 backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
                 crash_loop_tolerance: int = DEFAULT_CRASH_LOOP_TOLERANCE,
                 term_grace_s: float = DEFAULT_TERM_GRACE_S, spawn: Optional[Callable] = None,
                 progress_fn: Optional[Callable[[], Tuple]] = None, sleep: Callable[[float], None] = time.sleep,
                 poll_interval_s: float = 0.1, expect_processes: int = 0,
                 topology_fn: Optional[Callable[[], Optional[int]]] = None, peer_root: str = ""):
        assert max_restarts >= 0, max_restarts
        assert crash_loop_tolerance >= 0, crash_loop_tolerance
        assert backoff_s >= 0 and backoff_max_s >= 0
        self.child_argv = ensure_auto_resume(child_argv)
        self.ckpt_dir = ckpt_dir
        self.metrics_dir = metrics_dir
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.crash_loop_tolerance = crash_loop_tolerance
        self.term_grace_s = term_grace_s
        self.poll_interval_s = poll_interval_s
        self._spawn = spawn or (lambda argv: subprocess.Popen(argv))
        self.peer_root = peer_root
        self._progress = progress_fn or (lambda: run_progress(self.ckpt_dir, self.peer_root))
        self._sleep = sleep
        self.expect_processes = expect_processes
        self._topology = topology_fn or (lambda: checkpoint_topology(self.ckpt_dir))
        self.topology_changes = 0
        self._topology_noted: Optional[int] = None
        self.restart_count = 0
        self.last_exit_code: Optional[int] = None
        self._term_requested = False
        self._term_forwarded = False

    # -- signal forwarding ------------------------------------------------------
    def _on_term(self, signum, frame):  # noqa: ARG002 - signal handler signature
        self._term_requested = True

    def _install_handlers(self) -> None:
        try:
            signal.signal(signal.SIGTERM, self._on_term)
            signal.signal(signal.SIGINT, self._on_term)
        except ValueError:
            pass  # not the main thread (tests): no forwarding

    # -- telemetry --------------------------------------------------------------
    def _append_event(self, kind: str, **payload) -> None:
        """One schema-1 event appended to the run's metrics.jsonl (the child
        is not running while the supervisor writes). Fail-soft."""
        record = {"schema": SCHEMA_VERSION, "time": time.time(), "kind": kind, "rank": 0, **payload}
        if not self.metrics_dir:
            return
        try:
            os.makedirs(self.metrics_dir, exist_ok=True)
            with open(os.path.join(self.metrics_dir, "metrics.jsonl"), "a", encoding="utf-8") as f:
                f.write(json.dumps(record, sort_keys=True) + "\n")
        except OSError as e:
            self._log(f"cannot write {kind} event ({e}); continuing")

    def _event(self, **payload) -> None:
        self._log(f"restart {payload.get('restart')}: child exit {payload.get('exit_code')}, "
                  f"{'progress' if payload.get('progress') else 'NO progress'} since last start, backing off "
                  f"{payload.get('backoff_s'):.2f}s")
        self._append_event("restart", **payload)

    def _check_topology(self) -> None:
        """Before each launch: say loudly (a log line and a control event)
        when the frontier's recorded process count differs from this
        launch's; once for each distinct mismatch."""
        if not self.expect_processes:
            return
        recorded = self._topology()
        if recorded is None or recorded == self.expect_processes or recorded == self._topology_noted:
            return
        self._topology_noted = recorded
        self.topology_changes += 1
        self._log(f"TOPOLOGY CHANGE: checkpoint frontier was written by {recorded} process(es); child launching "
                  f"with {self.expect_processes} — elastic resume will re-derive steps_per_epoch and remap or "
                  f"epoch-round the stream cursor")
        self._append_event("control", event="topology_change", from_processes=recorded,
                           to_processes=self.expect_processes)

    @staticmethod
    def _log(msg: str) -> None:
        print(f"[vitax_torch.supervise] {msg}", file=sys.stderr, flush=True)

    # -- the child --------------------------------------------------------------
    def _wait(self, child) -> int:
        """Wait for the child, forwarding one SIGTERM when asked and killing
        it after the grace window."""
        kill_at: Optional[float] = None
        while True:
            rc = child.poll()
            if rc is not None:
                return rc
            if self._term_requested and not self._term_forwarded:
                self._term_forwarded = True
                self._log(f"forwarding SIGTERM to the child (clean drain; hard kill after {self.term_grace_s:.0f}s)")
                try:
                    child.send_signal(signal.SIGTERM)
                except (OSError, ValueError):
                    pass  # already gone
                kill_at = time.monotonic() + self.term_grace_s
            if kill_at is not None and time.monotonic() >= kill_at:
                self._log("grace window passed; killing the child")
                try:
                    child.kill()
                except (OSError, ValueError):
                    pass
                kill_at = None
            self._sleep(self.poll_interval_s)

    def run(self) -> int:
        self._install_handlers()
        no_progress = 0
        self._log(f"supervising: {' '.join(map(str, self.child_argv))}")
        if self.peer_root:
            self._log(f"peer-replication store at {self.peer_root}: its frontier counts as checkpoint progress")
        while True:
            before = self._progress()
            self._check_topology()
            rc = self._wait(self._spawn(self.child_argv))
            self.last_exit_code = rc
            if self._term_requested:
                # the drain was ours to ask for: pass its code through
                self._log(f"child exited {rc} after forwarded SIGTERM; supervisor exiting")
                return rc
            if rc == 0:
                self._log("child completed cleanly")
                return 0
            after = self._progress()
            progressed = after > before
            no_progress = 0 if progressed else no_progress + 1
            if no_progress > self.crash_loop_tolerance:
                self._log(f"CRASH LOOP: {no_progress} consecutive exit(s) with no checkpoint progress (frontier "
                          f"{after}); giving up with exit {EXIT_BUDGET}")
                return EXIT_BUDGET
            self.restart_count += 1
            if self.restart_count > self.max_restarts:
                self._log(f"restart budget ({self.max_restarts}) exhausted; giving up with exit {EXIT_BUDGET}")
                return EXIT_BUDGET
            delay = backoff_delay(self.restart_count, self.backoff_s, self.backoff_max_s)
            self._event(exit_code=rc, restart=self.restart_count, backoff_s=delay, progress=progressed,
                        epoch=after[0], step_in_epoch=after[1])
            if delay > 0:
                self._sleep(delay)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vitax_torch.supervise",
        description="supervised auto-restart for vitax_torch training: `python -m vitax_torch.supervise [flags] "
                    "-- python -m vitax_torch.train ...` (the child is forced to --resume_epoch -1)")
    p.add_argument("--ckpt_dir", type=str, default="",
                   help="checkpoint dir for crash-loop progress detection (default: the child command's "
                        "--ckpt_dir, else the trainer's default)")
    p.add_argument("--metrics_dir", type=str, default="",
                   help="append kind:'restart' events to <metrics_dir>/metrics.jsonl (default: the child "
                        "command's)")
    p.add_argument("--max_restarts", type=int, default=DEFAULT_MAX_RESTARTS,
                   help=f"total restarts before giving up with exit {EXIT_BUDGET}")
    p.add_argument("--backoff_s", type=float, default=DEFAULT_BACKOFF_S,
                   help="first restart delay; doubles per restart")
    p.add_argument("--backoff_max_s", type=float, default=DEFAULT_BACKOFF_MAX_S, help="backoff cap")
    p.add_argument("--crash_loop_tolerance", type=int, default=DEFAULT_CRASH_LOOP_TOLERANCE,
                   help=f"consecutive no-checkpoint-progress exits tolerated before giving up with exit {EXIT_BUDGET}")
    p.add_argument("--term_grace_s", type=float, default=DEFAULT_TERM_GRACE_S,
                   help="seconds a SIGTERM-forwarded child gets to drain before a hard kill")
    p.add_argument("--expect_processes", type=int, default=0,
                   help="process count the child launches with, for topology-change detection against the "
                        "checkpoint frontier (default 0 = WORLD_SIZE, else the child's torchrun "
                        "--nproc_per_node x --nnodes; else checking stays off)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("supervise: missing child command — usage: python -m vitax_torch.supervise [flags] -- python -m "
              "vitax_torch.train ...", file=sys.stderr)
        return 2
    split = argv.index("--")
    own, child = argv[:split], argv[split + 1:]
    if not child:
        print("supervise: empty child command after --", file=sys.stderr)
        return 2
    args = build_parser().parse_args(own)
    ckpt_dir = args.ckpt_dir or scrape_flag(child, "--ckpt_dir") or "/tmp/vit_fsdp"  # the trainer's default
    metrics_dir = args.metrics_dir or scrape_flag(child, "--metrics_dir") or ""
    sup = Supervisor(child, ckpt_dir, metrics_dir=metrics_dir, max_restarts=args.max_restarts,
                     backoff_s=args.backoff_s, backoff_max_s=args.backoff_max_s,
                     crash_loop_tolerance=args.crash_loop_tolerance, term_grace_s=args.term_grace_s,
                     expect_processes=args.expect_processes or expected_process_count(child),
                     peer_root=peer_store_root(child, ckpt_dir))
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
