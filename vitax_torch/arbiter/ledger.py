"""Leased host ledger: who owns each card-bearing host right now
(vitax/arbiter/ledger.py).

The ledger is the arbiter's single source of truth, and the only state
that must survive an arbiter restart: every host in the pod maps to an
owner in {train, serve, free}, and every ownership flip is a new LEASE
recorded with the monotonically increasing ledger version that granted
it. Persistence is atomic (tmp + os.replace into place) and every
mutation persists before it is visible to readers, so a killed arbiter
recovers exactly the last granted state — a borrow that died between the
train shrink and the fleet adopt is re-derived from the ledger ("host h1
is serve-owned but has no replica url") instead of being forgotten.

No sockets, no threads of its own: callers (the Arbiter daemon and its
HTTP handlers) share one lock here. `clock` is injectable so lease
timestamps are deterministic under test.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

LEDGER_SCHEMA = 1
OWNERS = ("train", "serve", "free")


class HostLedger:
    """Versioned host -> owner leases with atomic persistence."""

    def __init__(self, hosts: Sequence[str] = (), owner: str = "train",
                 path: str = "",
                 clock: Callable[[], float] = time.time):
        assert owner in OWNERS, owner
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        # guarded by _lock:
        self.version = 0
        self._hosts: Dict[str, dict] = {}
        recovered = self._load() if path else False
        with self._lock:
            for h in hosts:
                if h not in self._hosts:
                    self.version += 1
                    self._hosts[h] = {"owner": owner,
                                      "lease_version": self.version,
                                      "since": self._clock()}
            if not recovered or hosts:
                self._persist()
        self.recovered = recovered

    # -- persistence ----------------------------------------------------------

    def _load(self) -> bool:
        """Recover the last persisted ledger; False when none exists (or it
        is unreadable — a torn tmp never lands, so an unreadable file means
        external damage and the arbiter starts fresh, loudly)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        hosts = data.get("hosts")
        version = data.get("version")
        if not isinstance(hosts, dict) or not isinstance(version, int):
            return False
        with self._lock:
            self.version = version
            self._hosts = {
                str(h): {"owner": (e.get("owner")
                                   if e.get("owner") in OWNERS else "free"),
                         "lease_version": int(e.get("lease_version", 0)),
                         "since": float(e.get("since", 0.0))}
                for h, e in hosts.items() if isinstance(e, dict)}
        return True

    def _persist(self) -> None:
        """Atomic write-into-place; caller holds _lock. A crash between tmp
        write and replace leaves the previous ledger intact."""
        if not self.path:
            return
        payload = {"schema": LEDGER_SCHEMA, "version": self.version,
                   "hosts": self._hosts}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- leases ---------------------------------------------------------------

    def assign(self, host: str, owner: str) -> dict:
        """Grant `host` to `owner` under a fresh lease; persists before
        returning, so a crash after assign() never forgets the flip."""
        assert owner in OWNERS, owner
        with self._lock:
            if host not in self._hosts:
                raise KeyError(f"unknown host {host!r}")
            self.version += 1
            entry = {"owner": owner, "lease_version": self.version,
                     "since": self._clock()}
            self._hosts[host] = entry
            self._persist()
            return dict(entry, host=host, version=self.version)

    def owner_of(self, host: str) -> Optional[str]:
        with self._lock:
            entry = self._hosts.get(host)
            return entry["owner"] if entry else None

    def hosts_owned(self, owner: str) -> List[str]:
        """Hosts under `owner`, oldest lease first — the borrow path picks
        the NEWEST train lease (last element) so repeated borrows peel from
        one end and returns restore in reverse order."""
        with self._lock:
            held = [(e["lease_version"], h)
                    for h, e in self._hosts.items() if e["owner"] == owner]
        return [h for _, h in sorted(held)]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {o: 0 for o in OWNERS}
            for e in self._hosts.values():
                out[e["owner"]] += 1
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"schema": LEDGER_SCHEMA, "version": self.version,
                    "hosts": {h: dict(e) for h, e in self._hosts.items()}}
