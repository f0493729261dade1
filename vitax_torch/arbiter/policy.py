"""Borrow/return policy: when does serve get a training host back?
(vitax/arbiter/policy.py)

Same two chatter guards as the fleet autoscaler (vitax_torch/serve/fleet/
autoscale.py), composed at the pod level: a `dwell_s` streak requirement
so traffic blips never move a host, and a `cooldown_s` dead time after
every executed action so one borrow's consequences (warmup, admission
relaxing toward the new capacity) are observed before the next decision.
Inputs are signals the stack already emits — the fleet's shed rate and
predicted-wait overshoot (autoscaler signal definitions), explicit
`request_capacity` escalations from a maxed-out autoscaler, and the
train job's step telemetry (a stalled train job is never shrunk: a drain
needs the step loop alive to reach its preemption checkpoint).

Three modes (`--arbiter_policy`):

  train_priority  borrow ONLY on explicit autoscaler escalation backed
                  by live pressure; return as soon as pressure clears
                  (quiet dwell = dwell_s).
  serve_priority  borrow on any sustained pressure signal; hold borrowed
                  hosts through lulls (quiet dwell = 4x dwell_s).
  slo_bounded     borrow when the SLO is at risk (shed rate / predicted
                  wait / escalation); return after a 2x-dwell quiet
                  streak — the middle ground and the default.

Pure state machine: `tick(signals, counts, borrowed, now)` takes every
input as an argument and returns a Decision; no clock reads, no I/O —
unit-tested socketless with an injected `now` exactly like
Autoscaler.tick(now=...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

POLICIES = ("train_priority", "serve_priority", "slo_bounded")

DEFAULT_DWELL_S = 3.0
DEFAULT_COOLDOWN_S = 10.0
DEFAULT_SHED_RATE_PER_S = 1.0

# quiet-dwell multiple per policy: how long pressure must stay clear
# before a borrowed host goes back to training
_QUIET_MULT = {"train_priority": 1.0, "slo_bounded": 2.0,
               "serve_priority": 4.0}


@dataclass(frozen=True)
class Decision:
    """One tick's verdict. action is "borrow", "return", or None; deny is
    True when a sustained borrow demand was REFUSED (floor, cooldown,
    stalled train job) — the daemon surfaces those as deny events so a
    starved fleet is visible, not silent."""

    action: Optional[str]
    reason: str
    deny: bool = False


class ArbiterPolicy:
    """Hysteretic borrow/return decisions; all state is tick-local."""

    def __init__(self, policy: str = "slo_bounded",
                 min_train_hosts: int = 1,
                 dwell_s: float = DEFAULT_DWELL_S,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 shed_rate_per_s: float = DEFAULT_SHED_RATE_PER_S,
                 quiet_dwell_s: Optional[float] = None):
        assert min_train_hosts >= 1, min_train_hosts
        assert dwell_s >= 0 and cooldown_s >= 0, (dwell_s, cooldown_s)
        assert shed_rate_per_s > 0, shed_rate_per_s
        self.min_train_hosts = min_train_hosts
        self.dwell_s = dwell_s
        self.cooldown_s = cooldown_s
        self.shed_rate_per_s = shed_rate_per_s
        self._explicit_quiet = quiet_dwell_s
        self._pressure_since: Optional[float] = None
        self._quiet_since: Optional[float] = None
        self._cooldown_until = 0.0
        self.set_policy(policy)

    def set_policy(self, policy: str) -> None:
        """Switch modes (POST /policy); hysteresis streaks reset so the new
        mode earns its own dwell instead of inheriting the old streak."""
        assert policy in POLICIES, policy
        self.policy = policy
        self.quiet_dwell_s = (self._explicit_quiet
                              if self._explicit_quiet is not None
                              else self.dwell_s * _QUIET_MULT[policy])
        self._pressure_since = None
        self._quiet_since = None

    # -- signal folding -------------------------------------------------------

    def _pressure(self, signals: dict) -> Optional[str]:
        """Which borrow signal fires, or None. `signals` keys (all
        optional): shed_rate_per_s, predicted_wait_overshoot (bool),
        escalations (request_capacity calls since last tick)."""
        escalated = int(signals.get("escalations", 0)) > 0
        shed = (float(signals.get("shed_rate_per_s", 0.0))
                >= self.shed_rate_per_s)
        wait = bool(signals.get("predicted_wait_overshoot", False))
        if self.policy == "train_priority":
            # the fleet must ASK (escalation) and the ask must be backed by
            # live pressure — train_priority never moves on raw signals
            if escalated and (shed or wait):
                return "escalation"
            return None
        if escalated:
            return "escalation"
        if shed:
            return "shed_rate"
        if wait:
            return "predicted_wait"
        return None

    # -- decision -------------------------------------------------------------

    def tick(self, signals: dict, counts: dict, borrowed: int,
             now: float) -> Decision:
        """One evaluation. `counts` is HostLedger.counts(); `borrowed` is
        how many hosts the daemon currently holds on loan to serve."""
        why = self._pressure(signals)
        if why is not None:
            self._quiet_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            if now - self._pressure_since < self.dwell_s:
                return Decision(None, "dwell")
            # sustained demand: borrow, or say loudly why not
            if counts.get("train", 0) - 1 < self.min_train_hosts:
                return Decision(None, "min_train_hosts", deny=True)
            if not signals.get("train_progressing", True):
                # a wedged step loop cannot reach its preemption save; a
                # drain now would hang, not hand off
                return Decision(None, "train_stalled", deny=True)
            if now < self._cooldown_until:
                return Decision(None, "cooldown", deny=True)
            return Decision("borrow", why)
        self._pressure_since = None
        if borrowed <= 0:
            return Decision(None, "idle")
        if self._quiet_since is None:
            self._quiet_since = now
        if now - self._quiet_since < self.quiet_dwell_s:
            return Decision(None, "quiet_dwell")
        if not signals.get("train_progressing", True):
            # the return's re-expand drains the current generation too —
            # same preemption-save requirement as a borrow
            return Decision(None, "train_stalled", deny=True)
        if now < self._cooldown_until:
            return Decision(None, "cooldown")
        return Decision("return", "pressure_cleared")

    def action_taken(self, now: float) -> None:
        """An executed borrow/return opens the cooldown window and resets
        both streaks (the daemon calls this, not tick — a decision the
        executor failed to carry out must not burn the cooldown)."""
        self._cooldown_until = now + self.cooldown_s
        self._pressure_since = None
        self._quiet_since = None

    def snapshot(self) -> dict:
        return {"policy": self.policy,
                "min_train_hosts": self.min_train_hosts,
                "dwell_s": self.dwell_s,
                "quiet_dwell_s": self.quiet_dwell_s,
                "cooldown_s": self.cooldown_s,
                "cooldown_until": self._cooldown_until}
