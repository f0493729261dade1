"""Content-addressed prediction cache at the router
(vitax/serve/fleet/cache.py).

A replica answers the same bytes with the same top-k every time (eval
forward over warmed buckets, no sampling), so the cache is exact: the key
is the SHA-256 of the request body plus the requested topk, and a hit
replays the first miss's 200 body byte for byte without reaching a
replica. Bounded LRU (`max_entries`, a hit refreshes recency) with a TTL
(`ttl_s`; 0 = no expiry) as the valve for weight swaps behind a running
router. A hit is a kind "cache" record carrying the running totals;
misses are only counted. `clock` is injectable for tests.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

DEFAULT_TTL_S = 300.0


class PredictionCache:
    """Bounded LRU + TTL map: SHA-256(body) + topk -> verbatim 200 bytes."""

    def __init__(self, max_entries: int, ttl_s: float = DEFAULT_TTL_S, recorder=None,
                 clock: Callable[[], float] = time.monotonic):
        if max_entries < 0 or ttl_s < 0:
            raise ValueError(f"max_entries {max_entries} and ttl_s {ttl_s} must be >= 0")
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()    # key -> (payload, expiry or 0.0)
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0
        self.expirations_total = 0

    @property
    def enabled(self) -> bool:
        return self.max_entries > 0

    @staticmethod
    def key(body: bytes, topk) -> str:
        """The body's hash and the requested topk: one image at two topk
        values is two responses."""
        return f"{hashlib.sha256(body).hexdigest()}:{topk}"

    def get(self, body: bytes, topk) -> Optional[bytes]:
        """The cached 200 payload for this request, or None."""
        if not self.enabled:
            return None
        k = self.key(body, topk)
        with self._lock:
            entry = self._entries.get(k)
            if entry is None:
                self.misses_total += 1
                return None
            payload, expires = entry
            if expires and self._clock() >= expires:
                del self._entries[k]
                self.expirations_total += 1
                self.misses_total += 1
                return None
            self._entries.move_to_end(k)
            self.hits_total += 1
            hits, misses = self.hits_total, self.misses_total
        self._event(decision="hit", key=k[:16], bytes=len(payload), hits_total=hits, misses_total=misses)
        return payload

    def put(self, body: bytes, topk, payload: bytes) -> None:
        """Store one 200 response verbatim, evicting the LRU past the bound."""
        if not self.enabled:
            return
        k = self.key(body, topk)
        expires = (self._clock() + self.ttl_s) if self.ttl_s else 0.0
        with self._lock:
            self._entries[k] = (payload, expires)
            self._entries.move_to_end(k)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions_total += 1

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            hits, misses = self.hits_total, self.misses_total
            total = hits + misses
            return {"enabled": self.enabled, "max_entries": self.max_entries, "ttl_s": self.ttl_s,
                    "size": len(self._entries), "hits_total": hits, "misses_total": misses,
                    "hit_rate": round(hits / total, 4) if total else None,
                    "evictions_total": self.evictions_total, "expirations_total": self.expirations_total}

    def _event(self, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event("cache", **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill the hot path
                pass
