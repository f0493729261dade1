"""vitax_torch.arbiter — chip-ledger arbiter for co-located train and
serve (vitax/arbiter/).

One pod, two tenants: the training job (vitax_torch/supervise.py's
restart contract, vitax_torch/train/control.py's agreed preemption, the
peer-replicated elastic resume of checkpoint/peer.py) and the serving
fleet (vitax_torch/serve/fleet/: its autoscaler and placement agents).
Neither owns the pod's cards; the arbiter owns a leased host ledger
(ledger.py), decides borrow and return under a hysteretic policy
(policy.py), and speaks both sides' contracts to move a host between
them (daemon.py):

  borrow: drain training to a joint preemption checkpoint (SIGTERM ->
  train/preempt.py -> committed save + exit 0), relaunch at N - k
  processes (the elastic resume restores from the surviving peer stores,
  no checkpoint-directory reads), provision an int8 replica on the freed
  host through the placement agent's POST /provision, and hand its URL to
  the fleet router's POST /fleet/adopt.

  return: POST /fleet/release to the router (retire, drain to zero),
  POST /release to the agent (SIGTERM-drain the replica process), then
  re-expand training back to N.

`python -m vitax_torch.arbiter` runs the daemon; GET /ledger, GET
/metrics, POST /request, POST /telemetry and the gated POST /policy are
its surface. Every seam is injectable (clock, spawn, transport, the
fleet and agent callables), so the state machine tests socketless. The
package imports the standard library only.
"""

from vitax_torch.arbiter.ledger import OWNERS, HostLedger          # noqa: F401
from vitax_torch.arbiter.policy import ArbiterPolicy, Decision     # noqa: F401
from vitax_torch.arbiter.daemon import (                           # noqa: F401
    Arbiter, TrainDirector, start_arbiter, stop_arbiter)
