"""vitax_torch.serve.fleet — N serve replicas behind one router
(vitax/serve/fleet/).

    python -m vitax_torch.serve.fleet --replicas 2 --npz int8.npz --serve_quant_dtype int8 \\
        --serve_port 8000 --slo_p99_ms 500

- replica.py   ReplicaManager: spawn or adopt replicas, rotate them on
               /healthz, restart with backoff (vitax_torch/supervise.py)
- router.py    Router: least-loaded dispatch, one retry elsewhere, hedges,
               the fleet's /metrics; BatchComposer: concurrent /predict
               bodies as one /predict_batch
- breaker.py   CircuitBreaker a replica, RetryBudget a router
- admission.py AdmissionController: 429 + Retry-After past --slo_p99_ms
- cache.py     PredictionCache: SHA-256(body) + topk -> the 200 bytes
- autoscale.py Autoscaler: hysteretic scale-out and retire -> drain ->
               discard scale-in in [--min_replicas, --max_replicas]
- placement.py PlacementAgent and PlacementClient (agent.py: its CLI):
               replicas provisioned on other hosts

Host Python: the replicas are `python -m vitax_torch.serve` processes.
Clients see the single-engine contract.
"""

from vitax_torch.serve.fleet.admission import AdmissionController  # noqa: F401
from vitax_torch.serve.fleet.autoscale import Autoscaler  # noqa: F401
from vitax_torch.serve.fleet.breaker import CircuitBreaker, RetryBudget  # noqa: F401
from vitax_torch.serve.fleet.cache import PredictionCache  # noqa: F401
from vitax_torch.serve.fleet.placement import PlacementAgent, PlacementClient, start_agent, stop_agent  # noqa: F401
from vitax_torch.serve.fleet.replica import DEAD, EJECTED, READY, STARTING, Replica, ReplicaManager  # noqa: F401
from vitax_torch.serve.fleet.router import BatchComposer, Router, RouterMetrics, start_router, stop_router  # noqa: F401
