"""Java driver (reference: drivers/java) — launches a JVM for a jar or
class, reusing the raw_exec process machinery (the reference's java driver
is likewise a thin layer over the shared executor).

Task config: {"jar_path": str} or {"class": str, "class_path": str?},
plus {"jvm_options": [...], "args": [...]}."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict

from .base import DriverError, TaskHandle
from .rawexec import RawExecDriver


class JavaDriver(RawExecDriver):
    name = "java"

    def available(self) -> bool:
        return shutil.which("java") is not None

    def fingerprint(self) -> Dict[str, str]:
        if not self.available():
            return {}
        out = {"driver.java": "1"}
        try:
            r = subprocess.run(["java", "-version"], capture_output=True,
                               text=True, timeout=10)
            first = (r.stderr or r.stdout).splitlines()
            if first:
                out["driver.java.version"] = first[0].strip()
        except (subprocess.TimeoutExpired, OSError):
            pass
        return out

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        argv = ["java"] + [str(o) for o in cfg.get("jvm_options", [])]
        if cfg.get("jar_path"):
            argv += ["-jar", str(cfg["jar_path"])]
        elif cfg.get("class"):
            if cfg.get("class_path"):
                argv += ["-cp", str(cfg["class_path"])]
            argv.append(str(cfg["class"]))
        else:
            raise DriverError("java: config.jar_path or config.class "
                              "required")
        argv += [str(a) for a in cfg.get("args", [])]
        import dataclasses
        shim = dataclasses.replace(
            task, config={"command": argv[0], "args": argv[1:]})
        handle = super().start_task(task_id, shim, env, task_dir)
        handle.driver = self.name
        return handle
