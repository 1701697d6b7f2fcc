"""Qemu driver (reference: drivers/qemu) — boots VM images via
qemu-system-x86_64, process-managed like raw_exec (stop is a SIGTERM to
the qemu process; the reference's graceful ACPI shutdown via the monitor
socket is not implemented).

Task config: {"image_path": str, "accelerator": str?, "args": [...]};
memory comes from task.resources.memory_mb."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict

from .base import DriverError, TaskHandle
from .rawexec import RawExecDriver

QEMU_BIN = "qemu-system-x86_64"


class QemuDriver(RawExecDriver):
    name = "qemu"

    def available(self) -> bool:
        return shutil.which(QEMU_BIN) is not None

    def fingerprint(self) -> Dict[str, str]:
        if not self.available():
            return {}
        out = {"driver.qemu": "1"}
        try:
            r = subprocess.run([QEMU_BIN, "--version"],
                               capture_output=True, text=True, timeout=10)
            if r.returncode == 0 and r.stdout:
                out["driver.qemu.version"] = \
                    r.stdout.splitlines()[0].strip()
        except (subprocess.TimeoutExpired, OSError):
            pass
        return out

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        image = cfg.get("image_path")
        if not image:
            raise DriverError("qemu: config.image_path required")
        argv = [QEMU_BIN, "-machine", "type=pc",
                "-name", task_id, "-m",
                f"{task.resources.memory_mb or 512}M",
                "-drive", f"file={image}", "-nographic", "-nodefaults"]
        if cfg.get("accelerator"):
            argv += ["-accel", str(cfg["accelerator"])]
        argv += [str(a) for a in cfg.get("args", [])]
        import dataclasses
        shim = dataclasses.replace(
            task, config={"command": argv[0], "args": argv[1:]})
        handle = super().start_task(task_id, shim, env, task_dir)
        handle.driver = self.name
        return handle
