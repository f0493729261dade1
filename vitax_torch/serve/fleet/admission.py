"""Admission control: shed what the fleet cannot answer inside its
deadline (vitax/serve/fleet/admission.py).

The router predicts each arrival's queue delay,

    predicted_wait = in_flight_depth * EWMA(service time) / capacity

with capacity the ready replicas plus `warming_capacity_frac` of each
warming one, and answers 429 with a `Retry-After` sized from the
overshoot when the prediction passes the --slo_p99_ms deadline. Clients
that honour Retry-After close the loop: offered load converges on what the
fleet serves inside the deadline. Every shed is a kind "admission" record.
A deadline <= 0 turns shedding off.
"""

from __future__ import annotations

import math
import threading
from typing import Optional


class AdmissionController:
    """Predictive admission for one router; `observe` and `check` are
    called from concurrent handler threads."""

    def __init__(self, deadline_ms: float, recorder=None, ewma_alpha: float = 0.2,
                 warming_capacity_frac: float = 0.5):
        if not 0.0 <= warming_capacity_frac <= 1.0:
            raise ValueError(f"warming_capacity_frac must be in [0, 1], got {warming_capacity_frac}")
        self.deadline_s = deadline_ms / 1000.0
        self.recorder = recorder
        self.ewma_alpha = ewma_alpha
        self.warming_capacity_frac = warming_capacity_frac
        self.ewma_service_s: Optional[float] = None
        self.admitted_total = 0
        self.shed_total = 0
        self._lock = threading.Lock()

    def observe(self, service_s: float) -> None:
        """Fold one successful dispatch's service time into the EWMA."""
        with self._lock:
            prev = self.ewma_service_s
            self.ewma_service_s = (service_s if prev is None else
                                   self.ewma_alpha * service_s + (1.0 - self.ewma_alpha) * prev)

    def check(self, depth: int, ready_replicas: int, warming_replicas: int = 0) -> Optional[int]:
        """Admit (None) or shed (the Retry-After seconds). Admits while
        shedding is off, before the first observation, and with no ready
        replica (the router's 503 owns that case)."""
        with self._lock:
            ewma = self.ewma_service_s
            if self.deadline_s <= 0 or ewma is None or ready_replicas <= 0:
                self.admitted_total += 1
                return None
            capacity = ready_replicas + self.warming_capacity_frac * max(warming_replicas, 0)
            predicted = depth * ewma / max(capacity, 1e-9)
            if predicted <= self.deadline_s:
                self.admitted_total += 1
                return None
            self.shed_total += 1
            retry_after = max(int(math.ceil(predicted - self.deadline_s)), 1)
        self._event(decision="shed", depth=depth, predicted_wait_s=round(predicted, 6),
                    deadline_ms=self.deadline_s * 1000.0, warming_replicas=warming_replicas,
                    retry_after_s=retry_after)
        return retry_after

    def record_shed(self, **payload) -> None:
        """Count a shed decided elsewhere (a replica's queue_full the router
        mapped to 429), so the fleet's shed count is whole."""
        with self._lock:
            self.shed_total += 1
        self._event(decision="shed", **payload)

    def snapshot(self) -> dict:
        with self._lock:
            return {"deadline_ms": self.deadline_s * 1000.0,
                    "ewma_service_s": round(self.ewma_service_s, 6) if self.ewma_service_s is not None else None,
                    "warming_capacity_frac": self.warming_capacity_frac,
                    "admitted_total": self.admitted_total, "shed_total": self.shed_total}

    def _event(self, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event("admission", **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill admission
                pass
