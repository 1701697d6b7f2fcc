"""Client core (reference: client/client.go).

Registers the node, heartbeats, long-polls its allocations (the blocking
query `Node.GetClientAllocs` analog), runs alloc runners through the driver
registry, and batches client status updates back to the server
(`Node.UpdateAlloc` / allocSync).

The server is reached through an `rpc` object exposing the node/alloc
endpoint surface; `InProcessRPC` wraps a core.Server directly and
nomad_tpu_torch.rpc provides the TCP implementation of the same interface.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.structs import (
    ALLOC_DESIRED_RUN,
    Allocation,
    NODE_STATUS_READY,
    Node,
)

from .alloc_runner import AllocRunner
from .drivers import new_driver_registry
from .fingerprint import FingerprintManager
from .state import StateDB


class InProcessRPC:
    """Direct in-process server access (the `-dev` wiring)."""

    def __init__(self, server) -> None:
        self.server = server

    def register_node(self, node: Node) -> None:
        self.server.register_node(node)

    def heartbeat_node(self, node_id: str) -> None:
        self.server.heartbeat_node(node_id)

    def update_node_status(self, node_id: str, status: str) -> None:
        self.server.update_node_status(node_id, status)

    def get_client_allocs(self, node_id: str, min_index: int,
                          timeout: float = 5.0):
        return self.server.get_client_allocs(node_id, min_index, timeout)

    def update_allocs(self, allocs: List[Allocation]) -> None:
        self.server.update_allocs_from_client(allocs)

    def update_service_registrations(self, regs) -> None:
        self.server.state.upsert_service_registrations(regs)

    def remove_service_registrations(self, alloc_id: str) -> None:
        self.server.state.delete_service_registrations_by_alloc(alloc_id)

    def read_variable(self, namespace: str, path: str, token: str):
        return self.server.read_variable(namespace, path, token)

    def derive_identity_tokens(self, alloc_id: str):
        tokens, err = self.server.derive_identity_tokens(alloc_id)
        if err:
            return {}
        return tokens


class Client:
    def __init__(self, rpc, node: Optional[Node] = None,
                 data_dir: str = "", drivers: Optional[Dict] = None,
                 heartbeat_interval: float = 10.0,
                 sync_interval: float = 0.2,
                 devices=None,
                 plugin_dir: str = "",
                 secrets_provider=None) -> None:
        self.rpc = rpc
        # the Vault seam (integrations/secrets.py): default to the native
        # nomad-variables provider whenever the RPC surface supports it
        if secrets_provider is None and hasattr(rpc, "read_variable"):
            from nomad_tpu_torch.integrations import VariablesSecretsProvider
            secrets_provider = VariablesSecretsProvider(rpc)
        self.secrets_provider = secrets_provider
        self.data_dir = data_dir
        self.drivers = drivers if drivers is not None \
            else new_driver_registry()
        # external plugins (reference: client plugin_dir): discovered
        # driver plugins join the registry; device plugins extend the
        # fingerprinted device groups
        self.plugin_manager = None
        if plugin_dir:
            from nomad_tpu_torch.plugins import PluginManager
            self.plugin_manager = PluginManager(plugin_dir)
            self.plugin_manager.scan()
            self.plugin_manager.start_supervisor()
            # the dispensed shims are stable objects (relaunch swaps the
            # connection inside them), so copying refs here stays live
            self.drivers.update(self.plugin_manager.drivers)
            devices = list(devices or [])
            devices.extend(self.plugin_manager.fingerprint_devices())
        self.node = node or Node()
        self.heartbeat_interval = heartbeat_interval
        self.sync_interval = sync_interval
        self.state_db = StateDB(data_dir)
        from .services import ServiceManager
        self.services = ServiceManager(rpc, self.node)
        self.alloc_runners: Dict[str, AllocRunner] = {}
        self._known_index = 0
        self._dirty_allocs: Dict[str, Allocation] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        fp = FingerprintManager(self.drivers, data_dir, devices=devices)
        fp.run(self.node)
        self.node.status = NODE_STATUS_READY
        from nomad_tpu_torch.structs import compute_class
        self.node.computed_class = compute_class(self.node)

    # ----------------------------------------------------------- control

    def start(self) -> None:
        """register + heartbeat + watch_allocations + alloc_sync loops."""
        try:
            self.rpc.register_node(self.node)
        except Exception as exc:
            # likely no leader yet (cluster still electing at boot):
            # register from a background retry loop instead of failing
            # the agent (reference: client retryRegisterNode)
            from nomad_tpu_torch.core.logging import log
            log("client", "warn", "node registration deferred",
                node=self.node.id, error=str(exc))
            t = threading.Thread(target=self._register_retry_loop,
                                 daemon=True, name="client-register")
            t.start()
            self._threads.append(t)
        for name, fn in (("heartbeat", self._heartbeat_loop),
                         ("watch-allocs", self._watch_loop),
                         ("alloc-sync", self._sync_loop)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"client-{name}")
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        self.services.shutdown()
        for ar in list(self.alloc_runners.values()):
            ar.destroy()
        for t in self._threads:
            t.join(timeout=2)
        # task threads can still be in their kill path (kill_timeout_s);
        # wait them out before closing the state db they write to
        self.wait_until_idle(timeout=10.0)
        self.state_db.close()
        if self.plugin_manager is not None:
            self.plugin_manager.shutdown()

    # ------------------------------------------------------------- loops

    def _register_retry_loop(self) -> None:
        from nomad_tpu_torch.core.logging import log
        last_err = ""
        while not self._stop.wait(1.0):
            try:
                self.rpc.register_node(self.node)
                log("client", "info", "node registered",
                    node=self.node.id)
                return
            except Exception as exc:
                # log each DISTINCT error once — a permanent failure
                # (bad payload, server-side error) must stay diagnosable,
                # not drown as an eternal silent retry
                if str(exc) != last_err:
                    last_err = str(exc)
                    log("client", "warn", "node registration retry failing",
                        node=self.node.id, error=last_err)
                continue

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self.rpc.heartbeat_node(self.node.id)
            except Exception:
                pass

    def _watch_loop(self) -> None:
        """reference: client.watchAllocations — blocking query on the
        node's alloc set, then reconcile runners."""
        while not self._stop.is_set():
            try:
                allocs, index = self.rpc.get_client_allocs(
                    self.node.id, self._known_index, timeout=1.0)
            except Exception:
                if self._stop.wait(0.5):
                    return
                continue
            if index <= self._known_index:
                continue
            self._known_index = index
            self.run_allocs(allocs)

    def run_allocs(self, allocs: List[Allocation]) -> None:
        """reference: client.runAllocs — diff against current runners."""
        seen = set()
        for alloc in allocs:
            seen.add(alloc.id)
            ar = self.alloc_runners.get(alloc.id)
            if ar is None:
                if alloc.desired_status != ALLOC_DESIRED_RUN or \
                        alloc.client_terminal_status():
                    continue
                ar = AllocRunner(alloc.copy(), self.drivers, self.node,
                                 alloc_dir=self.data_dir,
                                 on_update=self._on_alloc_update,
                                 checks_healthy=self.services.checks_healthy,
                                 restore_handles=self.state_db
                                 .get_task_handles(alloc.id),
                                 on_handle=self.state_db.put_task_handle,
                                 device_reserver=(
                                     self.plugin_manager.reserve
                                     if self.plugin_manager else None),
                                 identity_fetcher=getattr(
                                     self.rpc, "derive_identity_tokens",
                                     None),
                                 secrets_provider=self.secrets_provider)
                with self._lock:
                    self.alloc_runners[alloc.id] = ar
                    self.state_db.put_allocation(alloc)
                ar.run()
            else:
                ar.update(alloc)
        # allocs no longer assigned to this node: destroy.  Removal and
        # row deletion happen under the lock shared with _on_alloc_update
        # so a late task-thread update cannot resurrect the row.
        for alloc_id in list(self.alloc_runners):
            if alloc_id not in seen:
                ar = self.alloc_runners[alloc_id]
                with self._lock:
                    del self.alloc_runners[alloc_id]
                    self.state_db.delete_allocation(alloc_id)
                ar.destroy()

    def _on_alloc_update(self, ar: AllocRunner) -> None:
        client_status, dep_status, task_states = ar.client_update()
        # service registration rides status transitions: register when the
        # alloc reaches running, deregister once it is terminal
        # (reference: serviceregistration groupservice/task services hooks)
        try:
            if client_status == "running":
                self.services.register_alloc(ar.alloc)   # idempotent
            elif client_status in ("complete", "failed", "lost") \
                    and self.services.is_registered(ar.alloc.id):
                self.services.deregister_alloc(ar.alloc.id)
        except Exception:  # noqa: BLE001 - discovery must not kill sync
            pass
        with self._lock:
            if ar.alloc.id not in self.alloc_runners:
                # server already dropped this alloc and run_allocs removed
                # it; a late task-thread update must not resurrect the
                # state-db row or re-dirty an untracked alloc
                return
            upd = Allocation(
                id=ar.alloc.id, namespace=ar.alloc.namespace,
                job_id=ar.alloc.job_id, node_id=self.node.id,
                task_group=ar.alloc.task_group,
                client_status=client_status,
                deployment_status=dep_status,
                task_states=task_states)
            upd.modify_time = time.time()
            self._dirty_allocs[upd.id] = upd
            # inside the critical section: run_allocs removes runners and
            # deletes their rows under the same lock, so put cannot race a
            # concurrent removal and resurrect the row
            self.state_db.put_allocation(ar.alloc)

    def _sync_loop(self) -> None:
        """reference: client.allocSync — batch client status updates."""
        while not self._stop.wait(self.sync_interval):
            self.sync_once()
        self.sync_once()

    def sync_once(self) -> None:
        with self._lock:
            dirty = list(self._dirty_allocs.values())
            self._dirty_allocs.clear()
        if dirty:
            try:
                self.rpc.update_allocs(dirty)
            except Exception:
                with self._lock:
                    for a in dirty:
                        self._dirty_allocs.setdefault(a.id, a)

    # ------------------------------------------------------------ helpers

    def wait_until_idle(self, timeout: float = 10.0) -> bool:
        """Test helper: wait for every runner to reach a terminal state."""
        deadline = time.time() + timeout
        for ar in list(self.alloc_runners.values()):
            if not ar.wait(max(0.0, deadline - time.time())):
                return False
        return True
