"""The coordinated failure control plane and the elastic-resume plan
(vitax/train/control.py).

Every process-local failure signal folds into one packed control word,
agreed across the processes at the loop's sync points, so that all of
them take the same action at the same step:

  bit 0  PREEMPT    SIGTERM delivered (train/preempt.py)
  bit 1  ESCALATE   the watchdog's hang escalation (telemetry/watchdog.py)
  bit 2  FAULT      a process flagged a fault (the watchdog's hard exit
                    publishing its cause on the way out)
  bit 3  PEER_LOST  the liveness monitor declared a peer dead

The agreement is the bitwise OR of the word over the processes
(distributed.or_across_processes), every `sync_steps` steps in the loop
and at each epoch boundary. Alone, poll() reads the local flags every step
and runs no collective. The loop's reaction at the step boundary: preempt
alone -> a jointly committed preemption checkpoint and exit 0; escalate,
fault or peer_lost -> a jointly committed emergency checkpoint and exit 42
(EXIT_HANG) on every process.

Peer liveness: a collective over a dead peer blocks (NCCL) or raises
(gloo). PeerLiveness heartbeats through the c10d store of the process
group (host TCP, no card): each process bumps `vitax/hb/<rank>` every
`interval_s`, and a monitor thread declares a peer lost when its key
stops advancing for `grace_s`, then escalates this process with a
bounded exit: the watchdog's escalation (its hard deadline covers a loop
wedged in a collective) and a timer of its own, so the survivor exits 42
within the deadline. The default store is served by rank 0, so rank 0's
death takes the store with it: a store error counts as no advance, and
the grace window turns it into a lost-peer verdict.

Elastic resume: elastic_resume_plan decides where a resumed run re-enters
a checkpointed epoch under the current process count.

The chip arbiter's heartbeat (--arbiter_url, ArbiterReporter): rank 0
posts its latest step to <arbiter_url>/telemetry from a thread, so the
arbiter (vitax_torch/arbiter/) drains the job only while it progresses.

Everything here is host work: the step launches the same kernels with the
plane on or off.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from vitax_torch import faults
from vitax_torch.telemetry.watchdog import EXIT_HANG

BIT_PREEMPT = 1 << 0
BIT_ESCALATE = 1 << 1
BIT_FAULT = 1 << 2
BIT_PEER_LOST = 1 << 3
_ALL_BITS = BIT_PREEMPT | BIT_ESCALATE | BIT_FAULT | BIT_PEER_LOST

# out of band: the peer-restore agreement (agree_peer_restore) folds it
# through the same OR, but unpack_word rejects it, so a leak of the
# restore-time fold into a step-time poll fails loudly. Raised = veto.
BIT_PEER_RESTORE = 1 << 4

# bound on the coordinated exit's barrier when neither the watchdog nor
# liveness runs (ControlPlane.arm_exit_deadline)
DEFAULT_EXIT_DEADLINE_S = 300.0

# agreement cadence in steps (--control_sync_steps); the processes must agree on it
DEFAULT_SYNC_STEPS = 10

# store key namespaces (one key a process)
HEARTBEAT_KEY_PREFIX = "vitax/hb"
FAULT_KEY_PREFIX = "vitax/fault"


def pack_word(preempt: bool = False, escalate: bool = False, fault: bool = False, peer_lost: bool = False) -> int:
    """Fold the four process-local failure signals into one small int."""
    return ((BIT_PREEMPT if preempt else 0) | (BIT_ESCALATE if escalate else 0) | (BIT_FAULT if fault else 0)
            | (BIT_PEER_LOST if peer_lost else 0))


@dataclasses.dataclass(frozen=True)
class Signals:
    """An unpacked control word: what the processes agreed happened."""

    preempt: bool = False
    escalate: bool = False
    fault: bool = False
    peer_lost: bool = False

    @property
    def word(self) -> int:
        return pack_word(self.preempt, self.escalate, self.fault, self.peer_lost)

    @property
    def any(self) -> bool:
        return self.preempt or self.escalate or self.fault or self.peer_lost

    @property
    def emergency(self) -> bool:
        """Signals that take the EXIT_HANG path rather than the clean
        preemption drain."""
        return self.escalate or self.fault or self.peer_lost

    def describe(self) -> str:
        names = [n for n, on in (("preempt", self.preempt), ("escalate", self.escalate), ("fault", self.fault),
                                 ("peer_lost", self.peer_lost)) if on]
        return "+".join(names) or "none"


def unpack_word(word: int) -> Signals:
    """Inverse of pack_word. Bits outside the layout are refused: a fold
    that returns garbage must fail loudly, not read as "no signal"."""
    word = int(word)
    if word < 0 or word & ~_ALL_BITS:
        raise ValueError(f"control word {word:#x} has bits outside the defined layout {_ALL_BITS:#x} — mixed "
                         f"vitax versions across hosts?")
    return Signals(preempt=bool(word & BIT_PREEMPT), escalate=bool(word & BIT_ESCALATE),
                   fault=bool(word & BIT_FAULT), peer_lost=bool(word & BIT_PEER_LOST))


def agree_peer_restore(local_ok: bool, process_count: Optional[int] = None,
                       collective: Optional[Callable[[int], int]] = None) -> bool:
    """The all-processes gate on the peer-restore path: each folds
    BIT_PEER_RESTORE (raised = "I cannot restore from peers") through the
    OR collective, so one process whose shard failed vetoes the peer path
    for all, and all fall back to the DCP checkpoint together. Alone, the
    local verdict is the agreement."""
    if process_count is None:
        from vitax_torch import distributed
        process_count = distributed.process_count()
    if process_count <= 1:
        return bool(local_ok)
    if collective is None:
        from vitax_torch import distributed
        collective = distributed.or_across_processes
    agreed = int(collective(0 if local_ok else BIT_PEER_RESTORE))
    return not (agreed & BIT_PEER_RESTORE)


# compare_set's expected value that no stored value equals: for a missing
# key compare_set returns it and inserts nothing, for a present one it
# returns the value, so it is a get that never waits
_ABSENT = b"\x00vitax-absent\x00"


class StoreKV:
    """The c10d store as the KV the plane and the peer transport use:
    set, a bounded get (a poll of compare_set, so no get ever blocks past
    its timeout), delete. Errors of the store itself propagate: the
    callers count them as no advance, or as a failed fetch."""

    def __init__(self, store):
        self.store = store

    def key_value_set(self, key: str, value, allow_overwrite: bool = True) -> None:  # noqa: ARG002 - vitax's signature
        self.store.set(key, value)

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        """The key's value within `timeout_ms`, else TimeoutError. Never a
        check() then get(): a key deleted between the two (a replica's
        chunk its sender replaces) left get() waiting out the store's own
        timeout (60 s), as rank 1 of a drained pair did on the H100."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            value = self.store.compare_set(key, _ABSENT, _ABSENT)
            if value != _ABSENT:
                return value
            if time.monotonic() >= deadline:
                raise TimeoutError(f"store key {key!r} not set within {timeout_ms} ms")
            time.sleep(min(0.01, timeout_ms / 10000.0))

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        return self.blocking_key_value_get_bytes(key, timeout_ms).decode()

    def key_value_delete(self, key: str) -> None:
        self.store.delete_key(key)

    def key_exists(self, key: str) -> bool:
        return self.store.check([key])


def store_client() -> Optional[StoreKV]:
    """The process group's c10d store as a StoreKV, or None without a
    group (one process, unit tests) or where this torch exposes none."""
    try:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return StoreKV(dist.distributed_c10d._get_default_store())
    except Exception:  # noqa: BLE001 - a private-API drift turns liveness off, never crashes
        return None


class ControlPlane:
    """Folds the local failure flags into a word and agrees it across the
    processes.

    The loop calls poll(step_in_epoch) at every step boundary and
    poll(None) at each epoch boundary. Alone, the local word every call;
    under a group, Signals() off cadence and one OR fold on it (the
    `collective` seam: tests fold words with a plain function). The plane
    also owns the liveness monitor (start_liveness) and the reaction to a
    lost peer. `watchdog`, `on_event` (Recorder kind "control" events on
    rank 0) and `hard_exit` are injectable.
    """

    def __init__(self, sync_steps: int = DEFAULT_SYNC_STEPS, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, watchdog=None,
                 collective: Optional[Callable[[int], int]] = None,
                 on_event: Optional[Callable[[dict], None]] = None,
                 hard_exit: Optional[Callable[[int], None]] = None):
        assert sync_steps >= 1, sync_steps
        if process_index is None or process_count is None:
            from vitax_torch import distributed
            process_index, process_count = distributed.process_index(), distributed.process_count()
        self.sync_steps = int(sync_steps)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.watchdog = watchdog
        self._collective = collective
        self._on_event = on_event
        self._hard_exit = hard_exit
        self._fault = threading.Event()
        self._peer_lost = threading.Event()
        self._lost_peers: list = []
        self._announced = False
        self._liveness: Optional[PeerLiveness] = None
        self._exit_timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()

    # -- the local word ---------------------------------------------------------
    def local_word(self) -> int:
        """This process's packed signals; every other module reads the
        agreed word through poll(), never the raw flags."""
        from vitax_torch.train import preempt
        word = 0
        if preempt.requested():  # vtx: ignore[VTX107] the control plane is the sanctioned raw-flag poller
            word |= BIT_PREEMPT
        if (self.watchdog is not None
                and self.watchdog.escalation_requested()):  # vtx: ignore[VTX107] sanctioned raw-flag poller
            word |= BIT_ESCALATE
        if self._fault.is_set():
            word |= BIT_FAULT
        if self._peer_lost.is_set():
            word |= BIT_PEER_LOST
        return word

    def set_fault(self, reason: str = "") -> None:
        """Raise this process's fault bit (sticky), folded into the next
        agreement so every process exits through the coordinated path."""
        self._fault.set()
        self._emit("fault_flagged", reason=reason)

    def publish_fault(self, reason: str) -> None:
        """set_fault, and the cause written under vitax/fault/<rank> in the
        store, so peers that only see a lost heartbeat can name it. Safe on
        the way out of a hard exit: never raises."""
        self._fault.set()
        client = store_client()
        if client is None:
            return
        try:
            client.key_value_set(f"{FAULT_KEY_PREFIX}/{self.process_index}", reason)
        except Exception as e:  # noqa: BLE001 - publishing the cause is best effort
            print(f"vitax_torch.control: could not publish fault cause ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)

    def _fold(self) -> Callable[[int], int]:
        if self._collective is not None:
            return self._collective
        from vitax_torch import distributed
        return distributed.or_across_processes

    # -- agreement --------------------------------------------------------------
    def warmup(self) -> None:
        """One throwaway fold of word 0, so the agreement's first
        collective (and NCCL's communicator) is set up outside any
        hang-deadline window. A collective: every process calls it. No-op
        alone."""
        if self.process_count > 1:
            self._fold()(0)

    def poll(self, step_in_epoch: Optional[int], epoch: int = 0) -> Signals:
        """The step-boundary check: the agreed signals (every process sees
        the same value at the same call), or Signals() when nothing is
        flagged or the step is off cadence. Under a group, a collective on
        cadence."""
        if self.process_count == 1:
            sig = unpack_word(self.local_word())
        else:
            if step_in_epoch is not None and (step_in_epoch + 1) % self.sync_steps:
                return Signals()
            faults.fire("barrier_timeout")  # drill point: a hang here starves the agreement
            sig = unpack_word(self._fold()(self.local_word()))
        if sig.any:
            self._announce(sig, step_in_epoch, epoch)
        return sig

    def _announce(self, sig: Signals, step_in_epoch, epoch: int) -> None:
        """One kind "control" event a run, for the first agreed word."""
        with self._lock:
            if self._announced:
                return
            self._announced = True
        self._emit("agreed_escalation" if sig.emergency else "agreed_preempt", word=sig.word,
                   signals=sig.describe(), epoch=int(epoch),
                   step_in_epoch=None if step_in_epoch is None else int(step_in_epoch) + 1)

    def _emit(self, event: str, **payload) -> None:
        if self._on_event is None:
            return
        try:                            # JSONL sinks flush per record: events outlive a hard exit
            self._on_event({"event": event, **payload})
        except Exception as e:  # noqa: BLE001 - observability must not mask the failure path
            print(f"vitax_torch.control: event sink failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)

    # -- peer liveness ----------------------------------------------------------
    def start_liveness(self, interval_s: float, grace_s: float, client=None) -> bool:
        """Heartbeat and monitor the peers. False (with a loud line) alone
        or without a store: liveness stays off, never fatal."""
        if self.process_count <= 1:
            return False
        client = client if client is not None else store_client()
        if client is None:
            print("vitax_torch.control: peer liveness requested but the process group has no c10d store; "
                  "peer-death detection disabled for this run", file=sys.stderr, flush=True)
            return False
        liveness = PeerLiveness(process_index=self.process_index, process_count=self.process_count,
                                interval_s=interval_s, grace_s=grace_s, client=client, on_loss=self._on_peer_loss)
        with self._lock:
            self._liveness = liveness
        liveness.start()
        return True

    def _on_peer_loss(self, peer: int, silent_s: float, cause: Optional[str]) -> None:
        """A peer's heartbeat stopped: escalate this process under a bounded
        deadline (the watchdog's, and a timer of the plane's own for runs
        whose watchdog is off or not yet armed). A healthy loop reaches the
        next boundary first and exits through the coordinated path; either
        way the survivor is gone within the deadline."""
        with self._lock:
            self._lost_peers.append(peer)
        self._peer_lost.set()
        why = f" (peer published cause: {cause})" if cause else ""
        print(f"vitax_torch.control: peer {peer} lost — no heartbeat for {silent_s:.1f}s{why}; escalating to "
              f"checkpoint_exit (exit {EXIT_HANG} within the liveness deadline)", file=sys.stderr, flush=True)
        self._emit("peer_loss", peer=int(peer), silent_s=round(silent_s, 3), cause=cause, exit_code=EXIT_HANG)
        with self._lock:
            liveness = self._liveness
        deadline_s = liveness.grace_s if liveness is not None else 30.0
        if self.watchdog is not None:
            self.watchdog.request_escalation(f"peer {peer} lost (heartbeat silent {silent_s:.1f}s)")
        self._start_timer(deadline_s, self._deadline_exit, peer)

    def _start_timer(self, deadline_s: float, fn, arg) -> None:
        """The plane's exit timer: its own daemon thread, so the exit never
        waits for a loop thread wedged in a collective; the first wins."""
        with self._lock:
            if self._exit_timer is None:
                self._exit_timer = threading.Timer(deadline_s, fn, args=(arg,))
                self._exit_timer.daemon = True
                self._exit_timer.start()

    def _exit_now(self) -> None:
        (self._hard_exit or os._exit)(EXIT_HANG)

    def _deadline_exit(self, peer: int) -> None:
        print(f"vitax_torch.control: loop did not reach a step boundary within the liveness deadline after "
              f"losing peer {peer} — hard-exiting {EXIT_HANG} for the supervisor", file=sys.stderr, flush=True)
        self._exit_now()

    def arm_exit_deadline(self, deadline_s: Optional[float] = None) -> None:
        """Bound the coordinated exit's barrier: a peer that dies after the
        agreement but before the barrier would wedge the survivors there.
        The running watchdog's deadline where there is one, else the plane's
        own timer of DEFAULT_EXIT_DEADLINE_S. No-op alone; idempotent."""
        if self.process_count <= 1:
            return
        if self.watchdog is not None and getattr(self.watchdog, "running", False):
            self.watchdog.arm_exit_deadline()
            return
        self._start_timer(float(deadline_s) if deadline_s else DEFAULT_EXIT_DEADLINE_S, self._drain_deadline_exit,
                          float(deadline_s) if deadline_s else DEFAULT_EXIT_DEADLINE_S)

    def _drain_deadline_exit(self, deadline: float) -> None:
        print(f"vitax_torch.control: coordinated-exit barrier did not complete within {deadline:.0f}s — a peer "
              f"likely died mid-drain; hard-exiting {EXIT_HANG} for the supervisor", file=sys.stderr, flush=True)
        self._exit_now()

    def peer_loss_suspected(self, wait: bool = True) -> Optional[int]:
        """Classify an error that escaped a collective: is a dead peer its
        likely cause? gloo raises where NCCL blocks, and a lost rank 0 takes
        the store with it. Returns the lost peer once the monitor's verdict
        lands (waiting up to grace + one beat when `wait`), or None: no
        liveness, or every peer still beating (a real bug: re-raise)."""
        with self._lock:
            liveness = self._liveness
        if liveness is None:
            return None
        deadline = time.monotonic() + liveness.grace_s + liveness.interval_s + 1.0
        while wait and time.monotonic() < deadline and not self._peer_lost.is_set():
            time.sleep(min(liveness.interval_s, 0.2))
        if not self._peer_lost.is_set():
            return None
        with self._lock:
            return self._lost_peers[0] if self._lost_peers else None

    def stop(self) -> None:
        with self._lock:
            liveness, self._liveness = self._liveness, None
        if liveness is not None:
            liveness.stop()             # joins its threads: not under our lock
        with self._lock:
            if self._exit_timer is not None:
                self._exit_timer.cancel()
                self._exit_timer = None


class PeerLiveness:
    """Store heartbeats: every process bumps its key; a monitor thread flags
    peers whose key stops advancing for `grace_s`.

    Every read is bounded, and a store error counts as no advance, so a
    survivor converges on the verdict instead of dying on a TCP error.
    `on_loss` fires at most once a peer, on the monitor thread (which must
    not touch the card). `client` and `clock` are injectable."""

    def __init__(self, process_index: int, process_count: int, interval_s: float, grace_s: float, client,
                 on_loss: Callable[[int, float, Optional[str]], None], clock: Callable[[], float] = time.monotonic):
        assert interval_s > 0, interval_s
        assert grace_s > 0, grace_s
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.interval_s = float(interval_s)
        self.grace_s = float(grace_s)
        self.client = client
        self.on_loss = on_loss
        self.clock = clock
        self.peers = [p for p in range(self.process_count) if p != self.process_index]
        self.lost: set = set()
        self._stop = threading.Event()
        self._threads: list = []

    def start(self) -> None:
        for name, target in (("vitax-torch-hb-beat", self._beat), ("vitax-torch-hb-monitor", self._monitor)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.interval_s + 1.0)

    def _key(self, peer: int) -> str:
        return f"{HEARTBEAT_KEY_PREFIX}/{peer}"

    def _beat(self) -> None:
        seq = 0
        while True:
            seq += 1
            try:
                self.client.key_value_set(self._key(self.process_index), str(seq))
            except Exception as e:  # noqa: BLE001 - a lost beat must not kill the beater
                print(f"vitax_torch.control: heartbeat write failed ({type(e).__name__}: {e}); retrying",
                      file=sys.stderr, flush=True)
            if self._stop.wait(self.interval_s):
                return

    def _monitor(self) -> None:
        # a peer that never writes is flagged too: the grace clock starts now
        last_seen: Dict[int, tuple] = {p: (None, self.clock()) for p in self.peers}
        # short reads, whatever interval_s: the peers are read one by one
        timeout_ms = max(int(min(self.interval_s, 0.2) * 1000), 50)
        while not self._stop.wait(self.interval_s):
            now = self.clock()
            for peer in self.peers:
                if peer in self.lost:
                    continue
                try:
                    value = self.client.blocking_key_value_get(self._key(peer), timeout_ms)
                except Exception:  # noqa: BLE001 - timeout or store error == no advance; the grace window decides
                    value = None
                prev_value, since = last_seen[peer]
                if value is not None and value != prev_value:
                    last_seen[peer] = (value, now)
                elif now - since >= self.grace_s:
                    self.lost.add(peer)
                    self.on_loss(peer, now - since, self._cause(peer))

    def _cause(self, peer: int) -> Optional[str]:
        """The cause the dying peer published (publish_fault), if any."""
        try:
            return self.client.blocking_key_value_get(f"{FAULT_KEY_PREFIX}/{peer}", 200)
        except Exception:  # noqa: BLE001 - no published cause is the common case
            return None


class ArbiterReporter:
    """Rank 0's heartbeat to the chip arbiter (--arbiter_url; vitax's
    ArbiterReporter, vitax/train/control.py:594-700): POST /telemetry with
    the latest step, epoch and process count, so the arbiter's policy gates
    on "training is progressing" rather than on process liveness.

    One daemon thread posts the latest snapshot every `interval_s`; the
    loop's `update()` is a lock and three assignments. An unchanged
    snapshot is posted again every `refresh_s` (a slow trainer is not a
    stalled one). Transport failures are counted and swallowed: an
    unreachable arbiter never slows a step. `http_json` is injectable."""

    def __init__(self, arbiter_url: str, process_count: int = 1, interval_s: float = 2.0, refresh_s: float = 10.0,
                 http_json: Optional[Callable] = None, timeout_s: float = 2.0):
        assert arbiter_url, "ArbiterReporter needs a non-empty arbiter_url"
        assert interval_s > 0, interval_s
        assert refresh_s > 0, refresh_s
        self.url = arbiter_url.rstrip("/") + "/telemetry"
        self.process_count = int(process_count)
        self.interval_s = float(interval_s)
        self.refresh_s = float(refresh_s)
        self.timeout_s = float(timeout_s)
        self._http_json = http_json or self._default_http_json
        self._lock = threading.Lock()
        # guarded by _lock:
        self._latest: Optional[dict] = None
        self._posted: Optional[dict] = None
        self._last_post_t = 0.0
        self.posts_total = 0
        self.post_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_http_json(url: str, payload: dict, timeout: float) -> dict:
        import json
        import urllib.request
        req = urllib.request.Request(url, data=json.dumps(payload).encode("utf-8"),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.load(resp)

    def update(self, step: int, epoch: int) -> None:
        """The loop's call; never blocks on I/O."""
        with self._lock:
            self._latest = {"step": int(step), "epoch": int(epoch), "process_count": self.process_count}

    def post_once(self, force: bool = False) -> bool:
        """One delivery of the latest unsent snapshot (the thread's body;
        tests call it). True iff something was posted; `force` posts an
        unchanged snapshot again (the refresh)."""
        with self._lock:
            latest = self._latest
            if latest is None or (not force and latest == self._posted):
                return False
        try:
            self._http_json(self.url, latest, self.timeout_s)
        except Exception:  # noqa: BLE001 - an unreachable arbiter must never hurt training
            with self._lock:
                self.post_failures += 1
            return False
        with self._lock:
            self._posted = latest
            self._last_post_t = time.time()
            self.posts_total += 1
        return True

    def start(self) -> None:
        assert self._thread is None, "reporter already running"
        self._thread = threading.Thread(target=self._loop, daemon=True, name="vitax-arbiter-report")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                last = self._last_post_t
            self.post_once(force=time.time() - last >= self.refresh_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.interval_s + 1.0)
            self._thread = None
        self.post_once()  # the last step matters most


# -- elastic resume (topology change) -------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResumePlan:
    """How to re-enter a checkpointed epoch under the current topology."""

    resume_step: int           # steps already done; 0 = epoch-boundary entry
    topology_changed: bool     # sidecar written under a different layout
    epoch_rounded: bool        # stream cursor invalidated -> boundary resume
    from_processes: int        # 0 when the sidecar has no process_count
    skipped_steps: int         # mid-epoch progress dropped by the rounding


def elastic_resume_plan(meta: Optional[dict], process_count: int) -> ResumePlan:
    """The resume step for a restart that may run another process count.

    `meta` is the mid-epoch sidecar (checkpoint/io.py load_resume_meta, or
    a peer snapshot's meta) or None for an epoch-boundary checkpoint. The
    index-sampled loaders partition rank-interleaved, so their
    step-granular resume survives any change of count; a stream cursor's
    shard assignment does not, so when the sidecar holds one and the count
    changed, the resume rounds down to the epoch boundary (re-running the
    partial epoch)."""
    step = int(meta.get("step_in_epoch") or 0) if meta else 0
    recorded = int(meta.get("process_count") or 0) if meta else 0
    changed = bool(recorded) and recorded != int(process_count)
    has_cursor = bool(meta) and isinstance(meta.get("stream_cursor"), dict)
    rounded = changed and has_cursor and step > 0
    return ResumePlan(resume_step=0 if rounded else step,
                      topology_changed=changed,
                      epoch_rounded=rounded,
                      from_processes=recorded,
                      skipped_steps=step if rounded else 0)
