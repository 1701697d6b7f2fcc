"""Server core (reference: nomad_tpu.core, itself after nomad/).

The single-server loop (`Server`, the eval broker, blocked evals,
heartbeats, the plan queue and applier, the wave pipeline, the workers,
the periodic dispatcher, the drainer and the deployment and volume
watchers), the event stream with its fanout ring, the decision records
(`explain`), the observability planes, the cluster plane (`wire`,
`membership`, `raft`, `cluster`, `federation`) and the worker pool
(`workerpool`, which exports nothing here).

The exports are the reference's.  Unlike the reference's, this init
binds them lazily, at first access (`from nomad_tpu_torch.core import
Server`): the state store reaches `core.wire` through `chaos` (its clock
import runs `chaos/__init__`, which imports the transport, which imports
the wire codec), and an eager init would pull the server, the engine
and the executor into every `StateStore()`.  `tests/test_torch_imports.py`
checks both that and the import orders that cross."""

import importlib

_EXPORTS = {
    "BlockedEvals": "blocked_evals",
    "DeploymentWatcher": "deployment_watcher",
    "NodeDrainer": "drainer",
    "EvalBroker": "eval_broker",
    "HeartbeatTimers": "heartbeat",
    "invalidate_heartbeat": "heartbeat",
    "CronSpec": "periodic",
    "PeriodicDispatch": "periodic",
    "PendingPlan": "plan_apply",
    "PlanApplier": "plan_apply",
    "PlanQueue": "plan_apply",
    "Server": "server",
    "Event": "stream",
    "StreamBroker": "stream",
    "Subscription": "stream",
    "Worker": "worker",
}

# the stream module's EventBroker is exported under another name
_RENAMED = {"StreamBroker": "EventBroker"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__),
                    _RENAMED.get(name, name))
    globals()[name] = value
    return value
