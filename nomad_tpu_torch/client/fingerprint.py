"""Node fingerprinting (reference: client/fingerprint/*).

Each fingerprinter returns (attributes, resources-partial); the manager
merges them into the Node before registration and re-runs periodic ones.
"""

from __future__ import annotations

import os
import platform
import shutil
import socket
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import NodeResources
from nomad_tpu_torch.utils.version import VERSION


def fp_arch() -> Dict[str, str]:
    """reference: fingerprint/arch.go"""
    return {"cpu.arch": platform.machine(), "arch": platform.machine()}


def fp_kernel() -> Dict[str, str]:
    """reference: fingerprint/host.go"""
    return {
        "kernel.name": platform.system().lower(),
        "kernel.version": platform.release(),
        "os.name": platform.system().lower(),
        "os.version": platform.version(),
        "unique.hostname": socket.gethostname(),
    }


def fp_cpu() -> Tuple[Dict[str, str], int]:
    """reference: fingerprint/cpu.go — total MHz = cores × clock.
    /proc cpuinfo clock when available, else a 1GHz/core floor."""
    cores = os.cpu_count() or 1
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except (OSError, ValueError):
        pass
    total = int(cores * mhz)
    return ({"cpu.numcores": str(cores), "cpu.frequency": str(int(mhz)),
             "cpu.totalcompute": str(total)}, total)


def fp_memory() -> Tuple[Dict[str, str], int]:
    """reference: fingerprint/memory.go"""
    total_mb = 1024
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total_mb = int(line.split()[1]) // 1024
                    break
    except (OSError, ValueError):
        pass
    return ({"memory.totalbytes": str(total_mb * 1024 * 1024)}, total_mb)


def fp_storage(data_dir: str = "/") -> Tuple[Dict[str, str], int]:
    """reference: fingerprint/storage.go"""
    try:
        usage = shutil.disk_usage(data_dir or "/")
        free_mb = usage.free // (1024 * 1024)
    except OSError:
        free_mb = 1024
    return ({"unique.storage.bytesfree": str(free_mb * 1024 * 1024),
             "unique.storage.volume": data_dir or "/"}, free_mb)


def fp_nomad() -> Dict[str, str]:
    """reference: fingerprint/nomad.go"""
    return {"nomad.version": VERSION, "nomad.revision": "tpu"}


def fp_devices(devices) -> Dict[str, str]:
    """Advertise configured/plugin-reported device groups as node attrs
    (reference: client/devicemanager fingerprint channel feeding
    structs.NodeDeviceResource).  Groups come from client config or an
    external device plugin; there is no hardware probe here."""
    attrs: Dict[str, str] = {}
    for d in devices:
        base = f"device.{d.id()}"
        attrs[f"{base}.count"] = str(len(d.instance_ids))
        for k, v in d.attributes.items():
            attrs[f"{base}.attr.{k}"] = v
    return attrs


def fp_network() -> Dict[str, str]:
    """reference: fingerprint/network.go — advertise IP only; speed probing
    is out of scope in-process."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
    except OSError:
        ip = "127.0.0.1"
    return {"unique.network.ip-address": ip}


class FingerprintManager:
    """reference: client/fingerprint_manager.go"""

    def __init__(self, drivers: Optional[Dict] = None,
                 data_dir: str = "", devices=None) -> None:
        self.drivers = drivers or {}
        self.data_dir = data_dir
        self.devices = list(devices or [])
        self.extra: List[Callable[[], Dict[str, str]]] = []

    def run(self, node) -> None:
        """Populate node.attributes/resources/drivers in place."""
        attrs = node.attributes
        attrs.update(fp_arch())
        attrs.update(fp_kernel())
        attrs.update(fp_nomad())
        attrs.update(fp_network())
        cpu_attrs, cpu = fp_cpu()
        attrs.update(cpu_attrs)
        mem_attrs, mem = fp_memory()
        attrs.update(mem_attrs)
        st_attrs, disk = fp_storage(self.data_dir)
        attrs.update(st_attrs)
        if node.resources is None or node.resources.cpu == 0:
            node.resources = NodeResources(cpu=cpu, memory_mb=mem,
                                           disk_mb=disk)
        if self.devices:
            attrs.update(fp_devices(self.devices))
            have = {d.id() for d in node.resources.devices}
            node.resources.devices.extend(
                d for d in self.devices if d.id() not in have)
        for name, drv in self.drivers.items():
            fp = drv.fingerprint()
            attrs.update(fp)
            # a driver with an empty fingerprint (binary/daemon absent)
            # is NOT healthy on this node — docker/java/qemu gate on it
            node.drivers[name] = bool(fp)
        for fn in self.extra:
            attrs.update(fn())
