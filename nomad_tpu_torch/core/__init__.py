"""Server core (reference: nomad_tpu.core, itself after nomad/).

The single-server loop (`Server`, the eval broker, blocked evals,
heartbeats, the plan queue and applier, the wave pipeline, the workers,
the periodic dispatcher, the drainer and the deployment and volume
watchers), the event stream with its fanout ring, the decision records
(`explain`) and the observability planes.  The cluster plane (`raft`,
`cluster`, `membership`, `regions`, `wire`, `federation`, `workerpool`)
is not ported yet.

The exports are the reference's.  Importing them runs `server`, which
imports `ops`, whose executor imports core planes back: that holds
because `ops/__init__` binds the engine before it imports the executor,
so each module of the port imports first in a fresh interpreter
(`tests/test_torch_imports.py` checks the orders that cross)."""

from .blocked_evals import BlockedEvals  # noqa: F401
from .deployment_watcher import DeploymentWatcher  # noqa: F401
from .drainer import NodeDrainer  # noqa: F401
from .eval_broker import EvalBroker  # noqa: F401
from .heartbeat import HeartbeatTimers, invalidate_heartbeat  # noqa: F401
from .periodic import CronSpec, PeriodicDispatch  # noqa: F401
from .plan_apply import PendingPlan, PlanApplier, PlanQueue  # noqa: F401
from .server import Server  # noqa: F401
from .stream import Event, EventBroker as StreamBroker, Subscription  # noqa: F401,E501
from .worker import Worker  # noqa: F401
