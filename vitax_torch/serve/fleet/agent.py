"""CLI entry: python -m vitax_torch.serve.fleet.agent, one placement agent
a host (vitax/serve/fleet/agent.py).

Binds the agent API (placement.py) and waits. A fleet router provisions
replicas here with `--placement_agents http://this-host:7070`; the agent's
own ReplicaManager supervises each (restart with backoff, SIGTERM drain).

    python -m vitax_torch.serve.fleet.agent --agent_port 7070 \\
        --agent_advertise 10.0.0.7 --agent_base_port 8100

SIGTERM or SIGINT stops the API, then drains every replica it owns.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from vitax_torch.serve.fleet.placement import (DEFAULT_AGENT_PORT, DEFAULT_BASE_PORT, PlacementAgent, start_agent,
                                               stop_agent)


def build_agent_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m vitax_torch.serve.fleet.agent",
                                     description="vitax_torch placement agent: spawn and supervise serve replicas "
                                                 "on this host for a remote fleet router")
    parser.add_argument("--agent_port", type=int, default=DEFAULT_AGENT_PORT,
                        help="port the agent API binds (0 = ephemeral)")
    parser.add_argument("--agent_advertise", type=str, default="127.0.0.1",
                        help="host in the provisioned replicas' URLs: the address the router reaches this host at")
    parser.add_argument("--agent_base_port", type=int, default=DEFAULT_BASE_PORT,
                        help="replica i of this agent binds base_port + i (a provision may name its port)")
    parser.add_argument("--health_interval_s", type=float, default=0.5,
                        help="seconds between the agent's replica /healthz sweeps")
    parser.add_argument("--replica_max_restarts", type=int, default=10,
                        help="restarts with backoff a replica before the agent gives up on it")
    parser.add_argument("--agent_max_replicas", type=int, default=0,
                        help="replica slots on this host (0 = unbounded); /provision answers 409 when all are taken")
    return parser


def main(argv=None) -> int:
    ns = build_agent_parser().parse_args(argv)
    agent = PlacementAgent(advertise_host=ns.agent_advertise, base_port=ns.agent_base_port,
                           health_interval_s=ns.health_interval_s, max_slots=ns.agent_max_replicas,
                           max_restarts=ns.replica_max_restarts)
    httpd = start_agent(agent, ns.agent_port)
    print(f"placement agent: API on :{httpd.server_address[1]}, replicas from :{ns.agent_base_port} "
          f"(advertised as {ns.agent_advertise})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    while not stop.wait(timeout=0.5):
        pass
    print("placement agent: shutting down (replica drains)", flush=True)
    stop_agent(httpd, agent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
