"""External device plugins
(reference: plugins/device/ DevicePlugin — Fingerprint/Reserve/Stats).

A device plugin advertises device groups (vendor/type/name + instance
IDs + attributes) that the client merges into its node's
`NodeResources.devices`, and maps reserved instance IDs onto container/
process specs (env vars, mounts) at task start.
"""

from __future__ import annotations

from typing import Dict, List

from nomad_tpu_torch.structs import NodeDeviceResource

from .base import PluginClient, serve


class DevicePlugin:
    """Contract for plugin authors (reference: device.DevicePlugin)."""

    name = "device"

    def fingerprint(self) -> List[NodeDeviceResource]:
        raise NotImplementedError

    def reserve(self, device_ids: List[str]) -> Dict:
        """-> {"envs": {...}, "mounts": [...], "devices": [...]}
        (reference: device.ContainerReservation)."""
        return {"envs": {}, "mounts": [], "devices": []}

    def stats(self) -> Dict:
        return {}


def _group_to_wire(g: NodeDeviceResource) -> Dict:
    return {"vendor": g.vendor, "type": g.type, "name": g.name,
            "instance_ids": list(g.instance_ids),
            "attributes": dict(g.attributes)}


def group_from_wire(d: Dict) -> NodeDeviceResource:
    return NodeDeviceResource(
        vendor=d.get("vendor", ""), type=d.get("type", ""),
        name=d.get("name", ""),
        instance_ids=list(d.get("instance_ids") or []),
        attributes=dict(d.get("attributes") or {}))


def serve_device(plugin: DevicePlugin) -> None:
    """Plugin-process entry point."""
    handlers = {
        "fingerprint": lambda: [
            _group_to_wire(g) for g in plugin.fingerprint()],
        "reserve": lambda device_ids: plugin.reserve(list(device_ids)),
        "stats": lambda: plugin.stats(),
    }
    serve(handlers, {"type": "device", "name": plugin.name, "version": "1"})


class ExternalDevicePlugin:
    """Host-side shim."""

    def __init__(self, client: PluginClient) -> None:
        self.client = client
        self.name = client.info.get("name", "device")

    def fingerprint(self) -> List[NodeDeviceResource]:
        if not self.client.alive():
            return []
        return [group_from_wire(d)
                for d in (self.client.call("fingerprint", timeout=10.0)
                          or [])]

    def reserve(self, device_ids: List[str]) -> Dict:
        return self.client.call("reserve", device_ids=list(device_ids),
                                timeout=10.0) or {}

    def stats(self) -> Dict:
        return self.client.call("stats", timeout=5.0) or {}
