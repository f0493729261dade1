"""CLI entry: python -m vitax_torch.serve.fleet, N replicas behind one
router (vitax/serve/fleet/__main__.py).

Takes every `python -m vitax_torch.serve` flag, forwarded to the replicas
(--device included), and the fleet's own:

    python -m vitax_torch.serve.fleet --replicas 2 --npz int8.npz --serve_quant_dtype int8 \\
        --serve_port 8000 --slo_p99_ms 500 [--serve_cache_max 64] [--serve_batch_window_ms 5]
    python -m vitax_torch.serve.fleet --replicas 2 --npz full.npz --device cpu --serve_port 0 --base_port 8101

The router binds --serve_port; replica i binds --base_port + i (default
serve_port + 1) and is `python -m vitax_torch.serve` on the card unless
--device cpu is given. With --metrics_dir the router writes
<metrics_dir>/serve.jsonl (lifecycle, admission, cache, breaker, retries)
and replica i its own under <metrics_dir>/replica_<i>/. A replica that
exits before it was ever ready (no card without --device cpu, a bad
export) ends the fleet with a message and exit 1: nothing falls back to
the CPU. SIGTERM or SIGINT stops the router, then SIGTERM-drains every
replica; the fleet exits 0 when each drained to exit 0.

With --arbiter_url (the chip arbiter, python -m vitax_torch.arbiter) the
autoscaler at --max_replicas, or with every placement agent full,
escalates to POST <arbiter>/request, and the router takes the arbiter's
hooks: POST /fleet/adopt {"url"} puts the replica the arbiter provisioned
on a borrowed host into rotation as borrowed_<k>, POST /fleet/release
{"url"} retires it, waits for its in-flight count to reach 0 (at most
--serve_request_timeout_s) and discards it (the process is the agent's,
which drains it).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import List, Sequence

from vitax_torch.config import Config, build_parser, config_fields_from_namespace

# fleet and source flags a replica must not get (both "--flag v" and
# "--flag=v" are stripped); vitax's list, --arbiter_url included
_FLEET_ONLY_FLAGS = (
    "--replicas", "--base_port", "--slo_p99_ms", "--health_interval_s", "--fail_threshold",
    "--replica_max_restarts",
    # router-side containment (breaker.py)
    "--breaker_threshold", "--breaker_cooldown_s", "--retry_budget_ratio", "--hedge_after_ms",
    # autoscaling and placement
    "--min_replicas", "--max_replicas", "--warming_capacity_frac", "--autoscale_dwell_s", "--autoscale_cooldown_s",
    "--autoscale_idle_frac", "--placement_agents", "--arbiter_url",
    # the router's cache and batching (Config fields a replica does not use)
    "--serve_cache_max", "--serve_cache_ttl_s", "--serve_batch_window_ms", "--serve_batch_max",
    # re-issued for each replica
    "--serve_port", "--metrics_dir",
)


def strip_flags(argv: Sequence[str], flags: Sequence[str]) -> List[str]:
    """argv without the value-taking `flags` and their values, in both
    spellings."""
    out: List[str] = []
    skip = False
    for arg in argv:
        if skip:
            skip = False
            continue
        if arg.split("=", 1)[0] in flags:
            skip = "=" not in arg
            continue
        out.append(arg)
    return out


def replica_argv(argv: Sequence[str], port: int, metrics_dir: str = "") -> List[str]:
    """One replica's command: the fleet's argv without the fleet-only
    flags, on this replica's port and metrics dir."""
    child = [sys.executable, "-m", "vitax_torch.serve", *strip_flags(argv, _FLEET_ONLY_FLAGS),
             "--serve_port", str(port)]
    if metrics_dir:
        child += ["--metrics_dir", metrics_dir]
    return child


def build_fleet_parser():
    parser = build_parser()
    src = parser.add_argument_group("vitax_torch serve source")
    src.add_argument("--npz", type=str, default="",
                     help="consolidated .npz export to serve (overrides --ckpt_dir and --epoch)")
    src.add_argument("--epoch", type=int, default=-1, help="checkpoint epoch to serve (-1 = the latest under "
                                                           "--ckpt_dir)")
    src.add_argument("--device", type=str, default="cuda",
                     help="the replicas' torch device (default cuda; cpu for hosts without a card)")
    fleet = parser.add_argument_group("vitax_torch serve fleet")
    fleet.add_argument("--replicas", type=int, default=2, help="engine replicas to spawn behind the router")
    fleet.add_argument("--base_port", type=int, default=0, help="replica i binds base_port + i (0 = serve_port + 1)")
    fleet.add_argument("--slo_p99_ms", type=float, default=0.0,
                       help="p99 deadline for admission: arrivals whose predicted wait exceeds it are shed with "
                            "429 + Retry-After (0 = shedding off)")
    fleet.add_argument("--health_interval_s", type=float, default=0.5, help="seconds between /healthz sweeps")
    fleet.add_argument("--fail_threshold", type=int, default=2,
                       help="failed health polls in a row that eject a READY replica")
    fleet.add_argument("--replica_max_restarts", type=int, default=10,
                       help="restarts with backoff a replica before the fleet gives up on it")
    fleet.add_argument("--breaker_threshold", type=int, default=3,
                       help="dispatch failures in a row that open a replica's circuit breaker")
    fleet.add_argument("--breaker_cooldown_s", type=float, default=2.0,
                       help="seconds an open breaker waits before its half-open probe")
    fleet.add_argument("--retry_budget_ratio", type=float, default=0.1,
                       help="retry/hedge tokens earned a dispatched request (0 = unlimited)")
    fleet.add_argument("--hedge_after_ms", type=float, default=0.0,
                       help="hedge a request on another replica past max(this, rolling p99) (0 = off)")
    fleet.add_argument("--min_replicas", type=int, default=0, help="autoscaler floor (0 = --replicas)")
    fleet.add_argument("--max_replicas", type=int, default=0,
                       help="autoscaler ceiling; > 0 turns the autoscaler on (0 = a static fleet)")
    fleet.add_argument("--warming_capacity_frac", type=float, default=0.5,
                       help="admission counts a warming replica as this fraction of a ready one")
    fleet.add_argument("--autoscale_dwell_s", type=float, default=3.0,
                       help="a scale signal must hold this long before the autoscaler acts")
    fleet.add_argument("--autoscale_cooldown_s", type=float, default=10.0,
                       help="dead time after every scaling action")
    fleet.add_argument("--autoscale_idle_frac", type=float, default=0.25,
                       help="scale-in: in-flight per ready replica at or below this, with no sheds")
    fleet.add_argument("--placement_agents", type=str, default="",
                       help="comma-separated placement-agent URLs (python -m vitax_torch.serve.fleet.agent); "
                            "replicas and scale-outs go round-robin to them instead of spawning here")
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_fleet_parser()
    ns = parser.parse_args(argv)
    try:
        cfg = Config(**config_fields_from_namespace(ns)).validate()
    except ValueError as e:
        parser.error(str(e))
    if ns.replicas < 1:
        parser.error(f"--replicas must be >= 1, got {ns.replicas}")
    min_replicas = ns.min_replicas or ns.replicas
    if ns.max_replicas and min_replicas > ns.max_replicas:
        parser.error(f"--min_replicas {min_replicas} must be <= --max_replicas {ns.max_replicas}")
    if not ns.base_port and cfg.serve_port == 0:
        parser.error("--serve_port 0 (an ephemeral router port) needs --base_port for the replicas")
    base_port = ns.base_port or cfg.serve_port + 1

    from vitax_torch import faults
    from vitax_torch.serve.fleet.admission import AdmissionController
    from vitax_torch.serve.fleet.autoscale import Autoscaler
    from vitax_torch.serve.fleet.cache import PredictionCache
    from vitax_torch.serve.fleet.placement import AgentFullError, PlacementClient
    from vitax_torch.serve.fleet.replica import ReplicaManager
    from vitax_torch.serve.fleet.router import Router, start_router, stop_router
    from vitax_torch.serve.server import build_serve_recorder

    recorder = build_serve_recorder(cfg, ns.device)
    # the replica_health and router_dispatch sites live here; --fault_plan
    # also reaches every replica for the engine and batcher sites
    if cfg.fault_plan or os.environ.get(faults.ENV_VAR, ""):
        faults.install_from_config(cfg)
        if recorder is not None:
            faults.set_reporter(lambda p: recorder.event("serve_fault", **p))
    manager = ReplicaManager(recorder=recorder, health_interval_s=ns.health_interval_s,
                             fail_threshold=ns.fail_threshold, max_restarts=ns.replica_max_restarts)

    # one provisioning closure for the first replicas and every scale-out
    agents = [PlacementClient(u.strip()) for u in ns.placement_agents.split(",") if u.strip()]
    placed: dict = {}          # local name -> (client, remote name)
    spawn_state = {"next": 0, "rr": 0}
    spawn_lock = threading.Lock()

    def spawn_replica():
        with spawn_lock:
            i, rr = spawn_state["next"], spawn_state["rr"]
            spawn_state["next"] += 1
            spawn_state["rr"] += 1
        name = f"replica_{i}"
        if agents:
            # round-robin; a full agent (409) sends the replica to the next
            last_full = None
            for k in range(len(agents)):
                client = agents[(rr + k) % len(agents)]
                try:
                    out = client.provision(strip_flags(argv, _FLEET_ONLY_FLAGS), name=name)
                except AgentFullError as e:
                    last_full = e
                    continue
                replica = manager.adopt(out["url"], name=name)
                with spawn_lock:
                    placed[name] = (client, out["name"])
                return replica
            raise last_full
        port = base_port + i
        metrics_dir = os.path.join(cfg.metrics_dir, f"replica_{i}") if cfg.metrics_dir else ""
        return manager.manage(replica_argv(argv, port, metrics_dir), f"http://127.0.0.1:{port}", name=name)

    def release_replica(replica):
        # a placed replica is also freed on its agent after the drain
        with spawn_lock:
            entry = placed.pop(replica.name, None)
        if entry is not None:
            client, remote_name = entry
            client.release(remote_name)

    for _ in range(ns.replicas):
        spawn_replica()
    manager.start()
    admission = AdmissionController(ns.slo_p99_ms, recorder=recorder, warming_capacity_frac=ns.warming_capacity_frac)
    # the arbiter's escalation: a fire-and-forget POST; its ticker decides and
    # calls back on /fleet/adopt
    request_capacity = None
    if cfg.arbiter_url:
        import json
        import urllib.request

        def request_capacity(reason: str):
            req = urllib.request.Request(cfg.arbiter_url.rstrip("/") + "/request",
                                         data=json.dumps({"reason": reason}).encode("utf-8"),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                return json.load(resp)

    autoscaler = None
    if ns.max_replicas > 0:
        autoscaler = Autoscaler(manager, admission=admission, min_replicas=min_replicas,
                                max_replicas=ns.max_replicas, scale_out=spawn_replica, release=release_replica,
                                dwell_s=ns.autoscale_dwell_s, cooldown_s=ns.autoscale_cooldown_s,
                                idle_occupancy=ns.autoscale_idle_frac, recorder=recorder,
                                request_capacity=request_capacity)
        autoscaler.start()
    cache = (PredictionCache(cfg.serve_cache_max, ttl_s=cfg.serve_cache_ttl_s, recorder=recorder)
             if cfg.serve_cache_max > 0 else None)
    router = Router(manager, admission=admission, recorder=recorder, request_timeout_s=cfg.serve_request_timeout_s,
                    breaker_threshold=ns.breaker_threshold, breaker_cooldown_s=ns.breaker_cooldown_s,
                    retry_budget_ratio=ns.retry_budget_ratio, hedge_after_ms=ns.hedge_after_ms, cache=cache,
                    autoscaler=autoscaler, batch_window_ms=cfg.serve_batch_window_ms,
                    batch_max=cfg.serve_batch_max or cfg.serve_max_batch)
    if cfg.arbiter_url:
        # the arbiter's side of a loan: adopt its replica, and on return
        # retire -> in-flight 0 -> discard (the agent owns the process)
        borrow_state = {"next": 0}

        def fleet_adopt(url: str) -> dict:
            with spawn_lock:
                k = borrow_state["next"]
                borrow_state["next"] += 1
            replica = manager.adopt(url, name=f"borrowed_{k}")
            return {"adopted": replica.name, "url": url}

        def fleet_release(url: str) -> dict:
            target = next((manager.find(name) for name, snap in manager.snapshot().items()
                           if snap.get("url") == url), None)
            if target is None:
                return {"released": None, "url": url}
            manager.retire(target)
            pause, waited = threading.Event(), 0.0
            while manager.in_flight_of(target) > 0 and waited < cfg.serve_request_timeout_s:
                pause.wait(0.05)
                waited += 0.05
            manager.discard(target)
            return {"released": target.name, "url": url, "in_flight_at_discard": manager.in_flight_of(target)}

        router.fleet_adopt_fn = fleet_adopt
        router.fleet_release_fn = fleet_release
    httpd = start_router(router, cfg.serve_port)
    scale_desc = f"autoscale [{min_replicas}, {ns.max_replicas}]" if autoscaler is not None else "static"
    print(f"fleet: router on :{httpd.server_address[1]}, {ns.replicas} replicas "
          f"({'placed' if agents else f'on :{base_port}..'}, device {ns.device}), {scale_desc}, "
          f"slo_p99_ms {ns.slo_p99_ms or 'off'}, cache {cfg.serve_cache_max or 'off'}, "
          f"batch_window_ms {cfg.serve_batch_window_ms or 'off'}"
          + (f", arbiter {cfg.arbiter_url}" if cfg.arbiter_url else ""), flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    failed = {}
    while not stop.wait(timeout=0.5):
        failed = manager.startup_failures()
        if failed:
            print("fleet: " + ", ".join(f"{name} exited with code {rc}" for name, rc in failed.items())
                  + " before it was ever ready (its stderr says why; on a host without a CUDA card pass "
                  "--device cpu); shutting down", file=sys.stderr, flush=True)
            break
    if not failed:
        print("fleet: shutting down (router first, then replica drains)", flush=True)
    stop_router(httpd, router)
    if autoscaler is not None:
        autoscaler.stop()
    manager.stop()          # SIGTERM-drains each replica
    for client, remote_name in list(placed.values()):
        try:
            client.release(remote_name)
        except Exception:  # vtx: ignore[VTX106] best effort: the agent drains on its own shutdown too
            pass
    if recorder is not None:
        recorder.close()
    if failed:
        return 1
    undrained = {name: snap["exit_code"] for name, snap in manager.snapshot().items()
                 if snap["managed"] and snap["exit_code"] not in (0, None)}
    if undrained:
        print(f"fleet: replicas that did not drain to exit 0: {undrained}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
