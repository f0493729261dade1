"""Cross-host placement: serve replicas provisioned on other hosts over
HTTP (vitax/serve/fleet/placement.py).

One placement agent (`python -m vitax_torch.serve.fleet.agent`) runs on
each serving host over its own ReplicaManager, so a provisioned replica
gets a local one's lifecycle: health sweeps, restart with backoff, SIGTERM
drain. The router's fleet adopts the returned URL (health-checked, never
restarted: the agent owns it).

Agent endpoints:
    GET  /healthz       liveness, replica count, slots
    GET  /replicas      the agent manager's snapshot
    POST /provision     {"argv": [serve flags...], "name": ..., "port": 0}
                        -> {"name", "url", "port"} (port 0 = the agent's
                        next); 409 once every slot (--agent_max_replicas)
                        is taken
    POST /release       {"name": ...}: drain and stop that replica

`PlacementClient` is the router side's urllib handle on one agent. The
agent execs `python -m vitax_torch.serve <argv> --serve_port N` on what its
callers send, so it binds on infrastructure networks only.
"""

from __future__ import annotations

import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

from vitax_torch.serve.fleet.replica import ReplicaManager

DEFAULT_AGENT_PORT = 7070
DEFAULT_BASE_PORT = 8100
DEFAULT_CLIENT_TIMEOUT_S = 30.0


class AgentFullError(RuntimeError):
    """Every replica slot of the agent's host is taken (HTTP 409): the
    fleet tries its next agent."""


class PlacementAgent:
    """A host's replica factory over its own ReplicaManager."""

    def __init__(self, advertise_host: str = "127.0.0.1", base_port: int = DEFAULT_BASE_PORT,
                 manager: Optional[ReplicaManager] = None, recorder=None, max_slots: int = 0, **manager_kw):
        self.advertise_host = advertise_host
        self.base_port = base_port
        self.manager = manager if manager is not None else ReplicaManager(recorder=recorder, **manager_kw)
        self.recorder = recorder
        self.max_slots = max_slots            # live replicas this host takes (0 = unbounded)
        self.provisions_total = 0
        self.releases_total = 0
        self._next_port = 0
        self._lock = threading.Lock()

    def slots(self) -> dict:
        return {"used": len(self.manager.snapshot()), "max": self.max_slots}

    def provision(self, argv: Sequence[str], name: Optional[str] = None, port: int = 0) -> dict:
        """Spawn one `python -m vitax_torch.serve` replica on this host; the
        manager owns it from here."""
        if not isinstance(argv, (list, tuple)) or not all(isinstance(a, str) for a in argv):
            raise ValueError("argv must be a list of strings")
        if self.max_slots and len(self.manager.snapshot()) >= self.max_slots:
            raise AgentFullError(f"agent at capacity: {self.max_slots} slot(s) in use")
        with self._lock:
            if port == 0:
                port = self.base_port + self._next_port
                self._next_port += 1
            count = self.provisions_total
            self.provisions_total += 1
        name = name or f"agent_replica_{count}"
        if self.manager.find(name) is not None:
            raise ValueError(f"replica {name!r} already exists on this agent")
        url = f"http://{self.advertise_host}:{port}"
        self.manager.manage([sys.executable, "-m", "vitax_torch.serve", *argv, "--serve_port", str(port)], url,
                            name=name)
        self._event(event="provision", replica=name, port=port, url=url)
        return {"name": name, "url": url, "port": port}

    def release(self, name: str) -> bool:
        """Retire, drain and stop one replica; False if unknown."""
        replica = self.manager.find(name)
        if replica is None:
            return False
        self.manager.retire(replica)
        self.manager.discard(replica)
        with self._lock:
            self.releases_total += 1
        self._event(event="release", replica=name)
        return True

    def snapshot(self) -> dict:
        with self._lock:
            out = {"provisions_total": self.provisions_total, "releases_total": self.releases_total}
        out["replicas"] = self.manager.snapshot()
        return out

    def _event(self, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event("placement", **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill placement
                pass


def _make_handler(agent: PlacementAgent):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - access logging off
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "replicas": len(agent.manager.snapshot()),
                                  "ready": agent.manager.ready_count(), "slots": agent.slots()})
            elif self.path == "/replicas":
                self._reply(200, agent.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad JSON body: {e}"})
                return
            if self.path == "/provision":
                try:
                    out = agent.provision(payload.get("argv", []), name=payload.get("name"),
                                          port=int(payload.get("port", 0)))
                except AgentFullError as e:
                    self._reply(409, {"error": str(e), "slots": agent.slots()})
                    return
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                self._reply(200, out)
            elif self.path == "/release":
                name = payload.get("name", "")
                if agent.release(name):
                    self._reply(200, {"released": name})
                else:
                    self._reply(404, {"error": f"unknown replica {name!r}"})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


def start_agent(agent: PlacementAgent, port: int = DEFAULT_AGENT_PORT):
    """Bind the agent API on a background thread and start the manager's
    health loop; returns the httpd (server_address[1] is the bound port)."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(agent))
    httpd.daemon_threads = True
    threading.Thread(  # vtx: ignore[VTX205] stop_agent's httpd.shutdown() ends serve_forever
        target=httpd.serve_forever, daemon=True, name="vitax-torch-placement-agent").start()
    agent.manager.start()
    return httpd


def stop_agent(httpd, agent: PlacementAgent) -> None:
    """Stop the API, then SIGTERM-drain every replica the agent owns."""
    httpd.shutdown()
    httpd.server_close()
    agent.manager.stop()


class PlacementClient:
    """The router side's handle on one agent; `http_json` is injectable."""

    def __init__(self, agent_url: str, timeout_s: float = DEFAULT_CLIENT_TIMEOUT_S, http_json=None):
        self.agent_url = agent_url.rstrip("/")
        self.timeout_s = timeout_s
        self._http_json = http_json or self._default_http_json

    @staticmethod
    def _default_http_json(url: str, payload: Optional[dict], timeout: float) -> dict:
        data = json.dumps(payload).encode("utf-8") if payload is not None else None
        req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"} if data else {})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.load(resp)

    def healthz(self) -> dict:
        return self._http_json(self.agent_url + "/healthz", None, self.timeout_s)

    def replicas(self) -> dict:
        return self._http_json(self.agent_url + "/replicas", None, self.timeout_s)

    def provision(self, argv: List[str], name: Optional[str] = None, port: int = 0) -> dict:
        """{"name", "url", "port"} of a replica spawned on the agent's host
        (adopt() its url); AgentFullError on the agent's 409."""
        try:
            return self._http_json(self.agent_url + "/provision", {"argv": list(argv), "name": name, "port": port},
                                   self.timeout_s)
        except urllib.error.HTTPError as e:
            if e.code == 409:
                raise AgentFullError(f"agent {self.agent_url} at capacity") from e
            raise

    def release(self, name: str) -> dict:
        return self._http_json(self.agent_url + "/release", {"name": name}, self.timeout_s)
