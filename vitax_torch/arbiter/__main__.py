"""CLI entry: python -m vitax_torch.arbiter — run the chip-ledger arbiter
(vitax/arbiter/__main__.py).

    python -m vitax_torch.arbiter \\
        --hosts h0,h1 --ledger_path /pod/ledger.json \\
        --arbiter_port 8200 --arbiter_policy slo_bounded \\
        --min_train_hosts 1 \\
        --fleet_url http://router:8000 \\
        --agent_urls h1=http://h1:8100 \\
        --serve_argv "--npz /ckpts/model.npz --serve_quant_dtype int8" \\
        --metrics_dir /pod/metrics \\
        -- --fake_data --replicate_steps 2 --peer_heartbeat_s 1 ...

Everything after `--` is the training command (a command that starts
with a flag runs as `python -m vitax_torch.train <flags>`); the arbiter
launches one process of it per train-owned host
(vitax_torch/supervise.py topology_env builds RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT) and resizes the job through drain-and-relaunch on every
borrow/return. Without a training command the arbiter only keeps the
ledger and serve side (training managed externally). `--agent_urls`
names the placement agent on each borrowable host; a borrowed host
without one still flips the ledger and shrinks training, it just cannot
warm a replica. SIGTERM/SIGINT stop the loop, return nothing, and drain
the training job cleanly — the persisted ledger carries the loan state
into the next arbiter launch; the CLI exits 1 when a rank of that last
drain did not exit 0 (vitax's exits 0 either way).
"""

from __future__ import annotations

import argparse
import shlex
import signal
import sys
import threading

from vitax_torch.arbiter.daemon import (Arbiter, FleetSignals, JsonlRecorder,
                                        TrainDirector, default_http_json,
                                        start_arbiter, stop_arbiter)
from vitax_torch.arbiter.ledger import HostLedger
from vitax_torch.arbiter.policy import POLICIES, ArbiterPolicy


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vitax_torch.arbiter",
        description="chip-ledger arbiter for co-located train + serve")
    p.add_argument("--hosts", type=str, required=True,
                   help="comma-separated host names in the pod; all start "
                        "train-owned unless the ledger file says otherwise")
    p.add_argument("--ledger_path", type=str, default="",
                   help="ledger persistence file (restart recovers leases); "
                        "empty = in-memory only")
    p.add_argument("--arbiter_port", type=int, default=8200,
                   help="HTTP port for GET /ledger, GET /metrics, "
                        "POST /request, gated POST /policy (0 = ephemeral)")
    p.add_argument("--arbiter_policy", type=str, default="slo_bounded",
                   choices=list(POLICIES),
                   help="borrow/return mode (see vitax_torch/arbiter/policy.py)")
    p.add_argument("--min_train_hosts", type=int, default=1,
                   help="training never shrinks below this many hosts")
    p.add_argument("--arbiter_dwell_s", type=float, default=3.0,
                   help="pressure must hold this long before a borrow")
    p.add_argument("--arbiter_cooldown_s", type=float, default=10.0,
                   help="dead time after every executed borrow/return")
    p.add_argument("--arbiter_interval_s", type=float, default=1.0,
                   help="seconds between decision ticks")
    p.add_argument("--arbiter_allow_admin", action="store_true",
                   help="arm POST /policy (runtime policy flips); NEVER "
                        "enable on an internet-reachable port")
    p.add_argument("--fleet_url", type=str, default="",
                   help="fleet router base URL: pressure signals are pulled "
                        "from /metrics, borrowed replicas handed over via "
                        "POST /fleet/adopt and drained via POST /fleet/release")
    p.add_argument("--agent_urls", type=str, default="",
                   help="comma-separated host=url placement-agent pairs for "
                        "borrowable hosts (python -m vitax_torch.serve.fleet.agent)")
    p.add_argument("--serve_argv", type=str, default="",
                   help="replica argv (shell-quoted) provisioned on a "
                        "borrowed host, e.g. '--npz m.npz "
                        "--serve_quant_dtype int8'")
    p.add_argument("--metrics_dir", type=str, default="",
                   help="write kind:\"arbiter\" events to "
                        "<metrics_dir>/metrics.jsonl")
    p.add_argument("--train_grace_s", type=float, default=120.0,
                   help="drain window per resize: SIGTERM -> joint "
                        "checkpoint -> exit 0, hard-kill after this")
    p.add_argument("--train_log_dir", type=str, default="",
                   help="per-process training logs (train_g<gen>_p<rank>"
                        ".log); empty = inherit stdout")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    train_argv: list = []
    if "--" in argv:
        split = argv.index("--")
        argv, train_argv = argv[:split], argv[split + 1:]
    ns = build_parser().parse_args(argv)

    hosts = [h.strip() for h in ns.hosts.split(",") if h.strip()]
    assert hosts, "--hosts must name at least one host"
    agent_urls = {}
    for pair in ns.agent_urls.split(","):
        if pair.strip():
            host, _, url = pair.partition("=")
            assert url, f"--agent_urls entry {pair!r} is not host=url"
            agent_urls[host.strip()] = url.strip().rstrip("/")

    ledger = HostLedger(hosts, owner="train", path=ns.ledger_path)
    policy = ArbiterPolicy(ns.arbiter_policy,
                           min_train_hosts=ns.min_train_hosts,
                           dwell_s=ns.arbiter_dwell_s,
                           cooldown_s=ns.arbiter_cooldown_s)
    recorder = JsonlRecorder(ns.metrics_dir) if ns.metrics_dir else None

    train = None
    if train_argv:
        train = TrainDirector(train_argv, term_grace_s=ns.train_grace_s,
                              log_dir=ns.train_log_dir)

    serve_argv = shlex.split(ns.serve_argv)
    placed = {}  # host -> (client, remote replica name)
    placed_lock = threading.Lock()

    def provision(host: str):
        from vitax_torch.serve.fleet.placement import PlacementClient
        if host not in agent_urls:
            return None  # ledger-only borrow: no agent to warm a replica on
        client = PlacementClient(agent_urls[host])
        out = client.provision(serve_argv, name=f"borrow_{host}")
        with placed_lock:
            placed[host] = (client, out["name"])
        return out["url"]

    def release(host: str, url: str) -> None:  # noqa: ARG001 — seam signature
        with placed_lock:
            entry = placed.pop(host, None)
        if entry is not None:
            client, remote_name = entry
            client.release(remote_name)

    fleet_adopt = fleet_release = None
    signals_fn = None
    if ns.fleet_url:
        fleet_url = ns.fleet_url.rstrip("/")
        signals_fn = FleetSignals(fleet_url)
        def _fleet_adopt(url: str) -> None:
            default_http_json(fleet_url + "/fleet/adopt", {"url": url}, 30.0)

        def _fleet_release(url: str) -> None:
            # drain-to-zero on the router side can take a while
            default_http_json(fleet_url + "/fleet/release", {"url": url},
                              60.0)

        fleet_adopt, fleet_release = _fleet_adopt, _fleet_release

    arbiter = Arbiter(ledger, policy, train=train, provision=provision,
                      release=release, fleet_adopt=fleet_adopt,
                      fleet_release=fleet_release, signals_fn=signals_fn,
                      recorder=recorder, interval_s=ns.arbiter_interval_s,
                      allow_admin=ns.arbiter_allow_admin)

    if train is not None:
        train.start(max(len(ledger.hosts_owned("train")), 1))
    httpd = start_arbiter(arbiter, ns.arbiter_port)
    ledger_state = "recovered" if ledger.recovered else "fresh"
    print(f"arbiter: on :{httpd.server_address[1]}, "
          f"{len(hosts)} hosts ({ledger_state} ledger), "
          f"policy {ns.arbiter_policy}, min_train_hosts "
          f"{ns.min_train_hosts}, fleet {ns.fleet_url or 'off'}, "
          f"train {'managed' if train else 'external'}", flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — handler signature
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread (embedded use)
    while not stop.wait(timeout=0.5):
        pass
    print("arbiter: shutting down (loop first, then train drain)",
          flush=True)
    stop_arbiter(httpd, arbiter)
    codes = train.stop() if train is not None else []
    if recorder is not None:
        recorder.close()
    if train is not None:
        # vitax exits 0 whatever the drain did; here a dirty drain is the exit code
        print(f"arbiter: training drained, exit codes {codes}", flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
