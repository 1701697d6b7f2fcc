"""Task environment (reference: client/taskenv) — the NOMAD_* env vars and
${...} interpolation available to tasks and templates."""

from __future__ import annotations

import re
from typing import Dict

_VAR = re.compile(r"\$\{([^}]+)\}")


def build_task_env(alloc, task, node, task_dir: str = "",
                   secrets_dir: str = "") -> Dict[str, str]:
    """reference: taskenv.Builder.Build"""
    env = {
        "NOMAD_ALLOC_ID": alloc.id,
        "NOMAD_ALLOC_NAME": alloc.name,
        "NOMAD_ALLOC_INDEX": str(alloc.index()),
        "NOMAD_TASK_NAME": task.name,
        "NOMAD_GROUP_NAME": alloc.task_group,
        "NOMAD_JOB_ID": alloc.job_id,
        "NOMAD_JOB_NAME": alloc.job.name if alloc.job else alloc.job_id,
        "NOMAD_NAMESPACE": alloc.namespace,
        "NOMAD_DC": node.datacenter if node else "",
        "NOMAD_REGION": "global",
        "NOMAD_CPU_LIMIT": str(task.resources.cpu),
        "NOMAD_MEMORY_LIMIT": str(task.resources.memory_mb),
    }
    if task_dir:
        env["NOMAD_TASK_DIR"] = task_dir
        env["NOMAD_ALLOC_DIR"] = task_dir
    if secrets_dir:
        env["NOMAD_SECRETS_DIR"] = secrets_dir
    for label, port in alloc.allocated_ports.items():
        env[f"NOMAD_PORT_{label}"] = str(port)
        env[f"NOMAD_HOST_PORT_{label}"] = str(port)
    # assigned device instances (reference: device_hook.go — drivers map
    # these onto isolation primitives; exec-class drivers get env vars)
    # key carries the full vendor/type/name id (nvidia/gpu vs amd/gpu must
    # not collide); two requests landing on the SAME group merge their ids
    dev_ids: Dict[str, list] = {}
    for ad in getattr(alloc, "allocated_devices", ()) or ():
        if ad.task and ad.task != task.name:
            continue
        key = "_".join(p for p in (ad.vendor, ad.type, ad.name) if p)
        key = key.upper().replace("-", "_").replace(".", "_")
        dev_ids.setdefault(key, []).extend(ad.device_ids)
    for key, ids in dev_ids.items():
        env[f"NOMAD_DEVICE_{key}"] = ",".join(ids)
    for k, v in (task.env or {}).items():
        env[k] = interpolate(v, env, node)
    return env


def interpolate(s: str, env: Dict[str, str], node=None) -> str:
    """${env.X} / ${attr.X} / ${meta.X} / ${node.X} interpolation
    (reference: taskenv ReplaceEnv)."""
    def repl(m):
        key = m.group(1)
        if node is not None:
            if key.startswith("attr."):
                return node.attributes.get(key[5:], "")
            if key.startswith("meta."):
                return node.meta.get(key[5:], "")
            if key == "node.datacenter":
                return node.datacenter
            if key == "node.class":
                return node.node_class
            if key == "node.unique.name":
                return node.name
            if key == "node.unique.id":
                return node.id
        return env.get(key, env.get(key.replace("env.", ""), m.group(0)))
    return _VAR.sub(repl, s)
