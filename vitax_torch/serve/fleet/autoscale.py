"""Autoscaler: grow and shrink the fleet from signals it already keeps
(vitax/serve/fleet/autoscale.py).

Scale out when one of these holds for `dwell_s`:
- admission sheds advancing at >= `shed_rate_per_s`;
- the predicted wait (depth * EWMA(service) / capacity, warming replicas
  at admission's fraction) at or past the --slo_p99_ms deadline;
- a replica advertising brownout (degraded: true).
Scale in when none holds and in-flight per READY replica stays at or
below `idle_occupancy` with no sheds, for `dwell_s`. After every action a
`cooldown_s` dead time; the size stays in [min_replicas, max_replicas],
and a fleet below the floor (a replica out of restarts) is repaired on
the next tick whatever the traffic.

A new replica enters as any does: STARTING until its own /healthz says
ready. Scale-in retires the victim (out of rotation for good), waits for
its in-flight count to reach zero (or `drain_timeout_s`), then discards
it, which SIGTERM-drains a managed process: no accepted request is lost.
`scale_out()` provisions (a local spawn or a placement agent's replica)
and `release(replica)` frees a remote one after its drain. When a
scale-out is refused here (the fleet at max_replicas, or every placement
agent full), a `request_capacity(reason)` closure escalates the sustained
demand to the chip arbiter (vitax_torch/arbiter/) and cools down, as
vitax's does (:108,197,252-262); an outcome "escalated" scale_out event
records it, and an unreachable arbiter is an escalate_failed event, never
a dead loop. Decisions are kind "autoscale" records; `clock` is
injectable.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

from vitax_torch.serve.fleet.replica import ReplicaManager

DEFAULT_INTERVAL_S = 0.5
DEFAULT_DWELL_S = 3.0
DEFAULT_COOLDOWN_S = 10.0
DEFAULT_SHED_RATE_PER_S = 1.0
DEFAULT_WAIT_OVERSHOOT_FRAC = 1.0
DEFAULT_IDLE_OCCUPANCY = 0.25
DEFAULT_DRAIN_TIMEOUT_S = 30.0


class Autoscaler:
    """Hysteretic fleet sizing over a ReplicaManager."""

    def __init__(self, manager: ReplicaManager, admission=None, min_replicas: int = 1, max_replicas: int = 1,
                 scale_out: Optional[Callable[[], object]] = None,
                 release: Optional[Callable[[object], None]] = None,
                 request_capacity: Optional[Callable[[str], object]] = None,
                 interval_s: float = DEFAULT_INTERVAL_S, dwell_s: float = DEFAULT_DWELL_S,
                 cooldown_s: float = DEFAULT_COOLDOWN_S, shed_rate_per_s: float = DEFAULT_SHED_RATE_PER_S,
                 wait_overshoot_frac: float = DEFAULT_WAIT_OVERSHOOT_FRAC,
                 idle_occupancy: float = DEFAULT_IDLE_OCCUPANCY, drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
                 recorder=None, clock: Callable[[], float] = time.monotonic):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(f"need 1 <= min_replicas {min_replicas} <= max_replicas {max_replicas}")
        if dwell_s < 0 or cooldown_s < 0 or shed_rate_per_s <= 0 or idle_occupancy < 0:
            raise ValueError(f"dwell_s {dwell_s}, cooldown_s {cooldown_s} and idle_occupancy {idle_occupancy} "
                             f"must be >= 0, shed_rate_per_s {shed_rate_per_s} > 0")
        self.manager = manager
        self.admission = admission
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = interval_s
        self.dwell_s = dwell_s
        self.cooldown_s = cooldown_s
        self.shed_rate_per_s = shed_rate_per_s
        self.wait_overshoot_frac = wait_overshoot_frac
        self.idle_occupancy = idle_occupancy
        self.drain_timeout_s = drain_timeout_s
        self.recorder = recorder
        self._clock = clock
        self._scale_out_fn = scale_out
        self._release_fn = release
        self._request_capacity_fn = request_capacity     # the arbiter's escalation: demand the fleet cannot meet
        self._lock = threading.Lock()
        # hysteresis state, guarded by _lock
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._cooldown_until = 0.0
        self._last_tick: Optional[float] = None
        self._shed_seen = 0
        self._shed_rate = 0.0
        self._draining = None            # the replica a scale-in drains
        self._drain_deadline = 0.0
        self.scale_out_total = 0
        self.scale_in_total = 0
        self.escalations_total = 0
        self.last_event: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _signals(self) -> dict:
        """One sample of every input, read outside self._lock (the manager
        and admission lock their own; never nested)."""
        adm = self.admission.snapshot() if self.admission is not None else {}
        return {"ready": self.manager.ready_count(), "depth": self.manager.total_in_flight(),
                "degraded": self.manager.degraded_count(), "warming": self.manager.warming_count(),
                "active": self.manager.active_count(), "shed_total": adm.get("shed_total", 0),
                "ewma_service_s": adm.get("ewma_service_s"),
                "deadline_s": (adm.get("deadline_ms") or 0.0) / 1000.0,
                "warming_frac": adm.get("warming_capacity_frac", 0.5)}

    def _pressure(self, sig: dict) -> Optional[str]:
        """Which scale-out signal fires, or None."""
        if self._shed_rate >= self.shed_rate_per_s:
            return "shed_rate"
        ewma, deadline = sig["ewma_service_s"], sig["deadline_s"]
        if deadline > 0 and ewma:
            capacity = sig["ready"] + sig["warming_frac"] * sig["warming"]
            if sig["depth"] * ewma / max(capacity, 1e-9) >= deadline * self.wait_overshoot_frac:
                return "predicted_wait"
        if sig["degraded"] > 0:
            return "brownout"
        return None

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One evaluation (the loop's, every interval_s; tests call it):
        "scale_out", "scale_in", "retire" or None."""
        now = self._clock() if now is None else now
        sig = self._signals()
        with self._lock:
            if self._last_tick is not None and now > self._last_tick:
                self._shed_rate = (sig["shed_total"] - self._shed_seen) / (now - self._last_tick)
            self._shed_seen = sig["shed_total"]
            self._last_tick = now
            draining = self._draining
        if draining is not None:
            return self._continue_drain(draining, now)
        action = None
        with self._lock:
            pressure = self._pressure(sig)
            if pressure is not None:
                self._idle_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                sustained = now - self._pressure_since >= self.dwell_s
                if sustained and now >= self._cooldown_until:
                    if sig["active"] < self.max_replicas and self._scale_out_fn is not None:
                        action = "scale_out"
                    elif self._request_capacity_fn is not None:
                        action = "escalate"     # refused here (the ceiling, or nothing to spawn with)
            else:
                self._pressure_since = None
                occupancy = sig["depth"] / max(sig["ready"], 1)
                if sig["ready"] > 0 and self._shed_rate == 0.0 and occupancy <= self.idle_occupancy:
                    if self._idle_since is None:
                        self._idle_since = now
                    if (now - self._idle_since >= self.dwell_s and now >= self._cooldown_until
                            and sig["active"] > self.min_replicas):
                        action = "retire"
                else:
                    self._idle_since = None
            # floor repair: below min, grow back whatever the traffic
            if (action is None and sig["active"] < self.min_replicas and now >= self._cooldown_until
                    and self._scale_out_fn is not None):
                action, pressure = "scale_out", "below_min"
        if action == "escalate":
            return self._do_escalate(pressure, now, sig)
        if action == "scale_out":
            return self._do_scale_out(pressure, now, sig)
        if action == "retire":
            return self._do_retire(now, sig)
        return None

    def _do_scale_out(self, reason: str, now: float, sig: dict):
        try:
            replica = self._scale_out_fn()
        except Exception as e:  # noqa: BLE001 - a failed provision must not kill the loop
            replica = None
            self._event(event="scale_out_failed", reason=reason, detail=f"{type(e).__name__}: {e}")
            if self._request_capacity_fn is not None:
                # every placement agent full (409) surfaces here: escalate as at the ceiling
                return self._do_escalate(reason, now, sig)
        with self._lock:
            self._pressure_since = None
            self._cooldown_until = now + self.cooldown_s
            if replica is None:
                return None
            self.scale_out_total += 1
            self.last_event = {"event": "scale_out", "reason": reason, "replica": getattr(replica, "name", "?"),
                               "size": sig["active"] + 1}
        self._event(**self.last_event)
        return "scale_out"

    def _do_escalate(self, reason: str, now: float, sig: dict):
        """Pressure the fleet cannot meet here: ask the arbiter and cool
        down (the borrowed replica arrives later through /fleet/adopt). An
        unreachable arbiter is an escalate_failed event."""
        try:
            self._request_capacity_fn(reason)
        except Exception as e:  # noqa: BLE001 - an unreachable arbiter must not kill the loop
            self._event(event="escalate_failed", reason=reason, detail=f"{type(e).__name__}: {e}")
            with self._lock:
                self._pressure_since = None
                self._cooldown_until = now + self.cooldown_s
            return None
        with self._lock:
            self._pressure_since = None
            self._cooldown_until = now + self.cooldown_s
            self.escalations_total += 1
            self.last_event = {"event": "scale_out", "outcome": "escalated", "reason": reason, "size": sig["active"]}
        self._event(**self.last_event)
        return "escalated"

    def _do_retire(self, now: float, sig: dict):
        """Start a scale-in: the least-loaded READY replica leaves rotation
        for good; _continue_drain discards it once its in-flight is zero."""
        victim, victim_flight = None, 0
        for r in self.manager.ready_replicas():
            flight = self.manager.in_flight_of(r)
            if victim is None or flight < victim_flight:
                victim, victim_flight = r, flight
        if victim is None:
            return None
        self.manager.retire(victim)
        with self._lock:
            self._idle_since = None
            self._draining = victim
            self._drain_deadline = now + self.drain_timeout_s
            self._cooldown_until = now + self.cooldown_s
        self._event(event="retire", replica=victim.name, in_flight=victim_flight, size=sig["active"])
        return "retire"

    def _continue_drain(self, replica, now: float):
        """Finish a scale-in once the retired replica is idle, or at
        drain_timeout_s (the discard's SIGTERM drain still answers what is
        left)."""
        in_flight = self.manager.in_flight_of(replica)
        with self._lock:
            deadline = self._drain_deadline
        if in_flight > 0 and now < deadline:
            return None
        if self._release_fn is not None:
            try:
                self._release_fn(replica)
            except Exception as e:  # noqa: BLE001 - a remote release is best effort
                self._event(event="release_failed", replica=replica.name, detail=f"{type(e).__name__}: {e}")
        self.manager.discard(replica)
        with self._lock:
            self._draining = None
            self.scale_in_total += 1
            self._cooldown_until = now + self.cooldown_s
            self.last_event = {"event": "scale_in", "replica": replica.name, "forced": in_flight > 0,
                               "size": self.manager.active_count()}
        self._event(**self.last_event)
        return "scale_in"

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("autoscaler loop already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="vitax-torch-fleet-autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                print(f"[vitax_torch.fleet] autoscaler tick failed: {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4 + 5.0)
            self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"min_replicas": self.min_replicas, "max_replicas": self.max_replicas,
                    "scale_out_total": self.scale_out_total, "scale_in_total": self.scale_in_total,
                    "escalations_total": self.escalations_total,
                    "shed_rate_per_s": round(self._shed_rate, 4),
                    "draining": self._draining.name if self._draining is not None else None,
                    "last_event": self.last_event}

    def _event(self, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event("autoscale", **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill scaling
                pass
