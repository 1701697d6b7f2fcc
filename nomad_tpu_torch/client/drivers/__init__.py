"""Task driver plugins (reference: drivers/ + plugins/drivers).

In-process plugin registry instead of go-plugin gRPC subprocesses: every
driver implements the `Driver` interface (the DriverPlugin contract —
fingerprint / start_task / wait_task / stop_task / destroy_task /
inspect_task / signal_task / exec_task).
"""

from .base import Driver, DriverCapabilities, TaskHandle, TaskResult
from .docker import DockerDriver
from .execdriver import ExecDriver
from .java import JavaDriver
from .mock import MockDriver
from .qemu import QemuDriver
from .rawexec import RawExecDriver

BUILTIN_DRIVERS = {
    "mock": MockDriver,
    "raw_exec": RawExecDriver,
    "exec": ExecDriver,
    "docker": DockerDriver,
    "java": JavaDriver,
    "qemu": QemuDriver,
}


def new_driver_registry(names=None):
    """Instantiate the builtin drivers (reference:
    client/pluginmanager/drivermanager Dispense)."""
    out = {}
    for name, cls in BUILTIN_DRIVERS.items():
        if names is None or name in names:
            out[name] = cls()
    return out
