"""Per-replica circuit breaker and the router's retry budget
(vitax/serve/fleet/breaker.py).

- `CircuitBreaker` (one a replica): closed -> open after `fail_threshold`
  consecutive dispatch failures; while open the router skips the replica.
  After `cooldown_s` it admits exactly one probe dispatch (half-open):
  success closes it, failure opens it for another cooldown. It sees real
  dispatches, so a replica that answers /healthz but fails every request
  is contained too.
- `RetryBudget` (one a router): a token bucket capping retries and hedges
  at a fraction of traffic. Each dispatched request deposits `ratio`
  tokens (capped at `cap`), each retry or hedge withdraws one; a dry
  bucket turns retries into fast 503s instead of a retry storm. `ratio`
  <= 0 disables it (every withdraw granted).

Transitions reach telemetry through `on_event` (kind "breaker" in the
router's serve.jsonl); counters fold into the router's /metrics.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"          # dispatches flow
OPEN = "open"              # tripped: no dispatch until the cooldown elapses
HALF_OPEN = "half_open"    # cooldown over: exactly one probe in flight

DEFAULT_FAIL_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 2.0
DEFAULT_BUDGET_RATIO = 0.1
DEFAULT_BUDGET_CAP = 10.0


class CircuitBreaker:
    """Closed/open/half-open over consecutive dispatch failures; handler
    threads record outcomes concurrently, so every transition holds a lock."""

    def __init__(self, name: str, fail_threshold: int = DEFAULT_FAIL_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S, clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable[[dict], None]] = None):
        if fail_threshold < 1 or cooldown_s < 0:
            raise ValueError(f"fail_threshold {fail_threshold} must be >= 1 and cooldown_s {cooldown_s} >= 0")
        self.name = name
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_event = on_event
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        self.opens_total = 0      # closed -> open
        self.reopens_total = 0    # failed half-open probes
        self.closes_total = 0     # successful probes

    def eligible(self) -> bool:
        """May a dispatch be sent here now (no reservation)? Closed: yes;
        open: once the cooldown elapsed; half-open: while the probe slot is free."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return self._clock() >= self._open_until
            return not self._probe_in_flight

    def begin(self) -> bool:
        """Reserve the dispatch just picked for this replica: free when
        closed; past an open cooldown, go half-open and take the probe slot.
        False: another thread holds the probe (or the cooldown runs)."""
        event = None
        with self._lock:
            if self._state == CLOSED:
                ok = True
            elif self._state == OPEN:
                ok = self._clock() >= self._open_until
                if ok:
                    self._state = HALF_OPEN
                    self._probe_in_flight = True
                    event = {"event": "half_open"}
            else:
                ok = not self._probe_in_flight
                if ok:
                    self._probe_in_flight = True
        if event is not None:
            self._emit(event)
        return ok

    def release_unused(self) -> None:
        """Hand back a begin() reservation without an outcome."""
        with self._lock:
            self._probe_in_flight = False

    def record_success(self) -> None:
        event = None
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probe_in_flight = False
                self.closes_total += 1
                event = {"event": "close"}
        if event is not None:
            self._emit(event)

    def record_failure(self) -> None:
        event = None
        with self._lock:
            if self._state == HALF_OPEN:          # the probe failed: another cooldown
                self._state = OPEN
                self._probe_in_flight = False
                self._open_until = self._clock() + self.cooldown_s
                self.reopens_total += 1
                event = {"event": "reopen"}
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.fail_threshold:
                    self._state = OPEN
                    self._open_until = self._clock() + self.cooldown_s
                    self.opens_total += 1
                    event = {"event": "open", "failures": self._consecutive_failures}
            # OPEN: a straggler from before the trip changes nothing
        if event is not None:
            self._emit(event)

    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "consecutive_failures": self._consecutive_failures,
                    "opens_total": self.opens_total, "reopens_total": self.reopens_total,
                    "closes_total": self.closes_total}

    def _emit(self, payload: dict) -> None:
        # outside the lock: the sink must never block a transition
        if self._on_event is not None:
            try:
                self._on_event({"replica": self.name, **payload})
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill dispatch
                pass


class RetryBudget:
    """Token bucket bounding retries and hedges to a fraction of traffic;
    it starts full, so a cold router absorbs a startup blip's retries."""

    def __init__(self, ratio: float = DEFAULT_BUDGET_RATIO, cap: float = DEFAULT_BUDGET_CAP):
        if ratio < 0 or cap < 1:
            raise ValueError(f"ratio {ratio} must be >= 0 and cap {cap} >= 1")
        self.ratio = ratio
        self.cap = float(cap)
        self._lock = threading.Lock()
        self._tokens = float(cap)
        self.deposits_total = 0
        self.granted_total = 0
        self.exhausted_total = 0

    @property
    def enabled(self) -> bool:
        return self.ratio > 0

    def deposit(self) -> None:
        """One dispatched request earns `ratio` tokens."""
        if not self.enabled:
            return
        with self._lock:
            self.deposits_total += 1
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def withdraw(self) -> bool:
        """Spend one token on a retry or hedge; False: the caller fails fast."""
        if not self.enabled:
            return True
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.granted_total += 1
                return True
            self.exhausted_total += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"ratio": self.ratio, "cap": self.cap, "tokens": round(self._tokens, 3),
                    "deposits_total": self.deposits_total, "granted_total": self.granted_total,
                    "exhausted_total": self.exhausted_total}
