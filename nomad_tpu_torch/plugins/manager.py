"""Plugin manager: discovery, launch, supervision, dispense
(reference: client/pluginmanager/drivermanager + devicemanager,
nomad/plugins catalog loading from the agent's plugin_dir).

Discovery: every executable file (or *.py file, launched with the current
interpreter) directly inside `plugin_dir` is treated as a plugin binary.
Each is launched and handshaken once at scan; its `plugin_info` decides
whether it dispenses as a task driver or a device plugin.  A supervisor
thread (started by `start_supervisor`, the client does this) rescans
periodically, relaunching crashed plugins — the reference's
drivermanager restarts plugin processes the same way.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional

from nomad_tpu_torch.core.logging import log

from .base import PluginClient, PluginError, launch_plugin
from .device import ExternalDevicePlugin
from .driver import ExternalDriver


class PluginManager:
    def __init__(self, plugin_dir: str,
                 socket_dir: Optional[str] = None) -> None:
        self.plugin_dir = plugin_dir
        self.socket_dir = socket_dir or os.path.join(plugin_dir, ".sockets")
        self._lock = threading.Lock()
        self._cmds: Dict[str, List[str]] = {}      # path -> launch argv
        self._clients: Dict[str, PluginClient] = {}
        self.drivers: Dict[str, ExternalDriver] = {}
        self.devices: Dict[str, ExternalDevicePlugin] = {}
        self._group_plugin: Dict[str, str] = {}    # group id -> plugin name
        self._stop = threading.Event()
        self._supervisor: Optional[threading.Thread] = None

    def start_supervisor(self, interval: float = 10.0) -> None:
        """Relaunch crashed plugins periodically (reference:
        drivermanager's instance loop)."""
        if self._supervisor is not None:
            return

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.scan()
                except Exception as e:  # noqa: BLE001 - keep supervising
                    log("plugins", "error", "plugin rescan failed",
                        error=str(e))

        self._supervisor = threading.Thread(
            target=loop, daemon=True, name="plugin-supervisor")
        self._supervisor.start()

    # ------------------------------------------------------------ discovery

    def scan(self) -> None:
        """Discover + launch plugins (idempotent; relaunches dead ones,
        drops plugins whose files were removed, launches in parallel so
        one slow plugin doesn't serialize client startup)."""
        if not os.path.isdir(self.plugin_dir):
            return
        cmds: Dict[str, List[str]] = {}
        for entry in sorted(os.listdir(self.plugin_dir)):
            path = os.path.join(self.plugin_dir, entry)
            if not os.path.isfile(path):
                continue
            if entry.endswith(".py"):
                cmds[path] = [sys.executable, path]
            elif os.access(path, os.X_OK):
                cmds[path] = [path]
        to_launch = []
        with self._lock:
            # prune plugins whose files disappeared (drop their shims)
            for path in list(self._clients):
                if path not in cmds:
                    self._forget(path, self._clients[path])
            self._cmds = cmds
            for path, cmd in cmds.items():
                client = self._clients.get(path)
                if client is not None and client.alive():
                    continue
                if client is not None:
                    # keep the dispensed shim: _launch swaps its client
                    self._forget(path, client, drop_dispensed=False)
                to_launch.append((path, cmd))
        if not to_launch:
            return
        if len(to_launch) == 1:
            self._launch(*to_launch[0])
            return
        threads = [threading.Thread(target=self._launch, args=(p, c),
                                    daemon=True) for p, c in to_launch]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _launch(self, path: str, cmd: List[str]) -> None:
        client = None
        for attempt in (1, 2):      # cold interpreter starts can be slow
            try:
                client = launch_plugin(cmd, self.socket_dir)
                break
            except PluginError as e:
                log("plugins", "error", "plugin launch failed",
                    plugin=path, attempt=attempt, error=str(e))
        if client is None:
            return
        info = client.info
        with self._lock:
            self._register(path, client, info)

    def _register(self, path: str, client: PluginClient, info) -> None:
        self._clients[path] = client
        name = info.get("name", path)
        if info.get("type") == "driver":
            existing = self.drivers.get(name)
            if existing is not None:
                # relaunch: swap the connection IN PLACE so registries
                # holding this ExternalDriver keep working
                existing.client = client
            else:
                self.drivers[name] = ExternalDriver(client)
            log("plugins", "info", "external driver dispensed",
                name=name, plugin=path)
        elif info.get("type") == "device":
            existing = self.devices.get(name)
            if existing is not None:
                existing.client = client
            else:
                self.devices[name] = ExternalDevicePlugin(client)
            log("plugins", "info", "external device plugin dispensed",
                name=name, plugin=path)
        else:
            log("plugins", "warn", "unknown plugin type",
                plugin=path, type=info.get("type"))
            client.close()
            self._clients.pop(path, None)

    def _forget(self, path: str, client: PluginClient,
                drop_dispensed: bool = True) -> None:
        client.close()
        self._clients.pop(path, None)
        if not drop_dispensed:
            return
        name = client.info.get("name")
        if client.info.get("type") == "driver":
            self.drivers.pop(name, None)
        elif client.info.get("type") == "device":
            self.devices.pop(name, None)

    # ------------------------------------------------------------- queries

    def fingerprint_devices(self):
        """All device groups reported by live device plugins; records
        which plugin owns each group id for reserve() routing."""
        groups = []
        for p in list(self.devices.values()):
            try:
                mine = p.fingerprint()
            except Exception as e:  # noqa: BLE001 - a dead plugin is not fatal
                log("plugins", "warn", "device fingerprint failed",
                    plugin=p.name, error=str(e))
                continue
            for g in mine:
                self._group_plugin[g.id()] = p.name
            groups.extend(mine)
        return groups

    def reserve(self, allocated_devices, task_name: str = ""):
        """Map assigned device instances onto env vars via the owning
        device plugin's reserve() (reference: device_hook.go calling
        DevicePlugin.Reserve).  Returns merged env vars; plugin failures
        degrade to the generic NOMAD_DEVICE_* exposure."""
        envs: Dict[str, str] = {}
        for ad in allocated_devices or ():
            if task_name and ad.task and ad.task != task_name:
                continue
            pname = self._group_plugin.get(ad.group_id())
            plug = self.devices.get(pname) if pname else None
            if plug is None:
                continue
            try:
                r = plug.reserve(ad.device_ids) or {}
            except Exception as e:  # noqa: BLE001
                log("plugins", "warn", "device reserve failed",
                    plugin=pname, error=str(e))
                continue
            for k, v in (r.get("envs") or {}).items():
                envs[str(k)] = str(v)
        return envs

    def shutdown(self) -> None:
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=2)
        with self._lock:
            for path, client in list(self._clients.items()):
                self._forget(path, client)
