"""ACL policy model + parser (reference: acl/policy.go)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_LIST = "list"
POLICY_SCALE = "scale"

CAP_DENY = "deny"

# Namespace capabilities (reference: acl/policy.go Namespace*)
CAP_LIST_JOBS = "list-jobs"
CAP_PARSE_JOB = "parse-job"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
CAP_CSI_REGISTER_PLUGIN = "csi-register-plugin"
CAP_CSI_WRITE_VOLUME = "csi-write-volume"
CAP_CSI_READ_VOLUME = "csi-read-volume"
CAP_CSI_LIST_VOLUME = "csi-list-volume"
CAP_CSI_MOUNT_VOLUME = "csi-mount-volume"
CAP_LIST_SCALING_POLICIES = "list-scaling-policies"
CAP_READ_SCALING_POLICY = "read-scaling-policy"
CAP_READ_JOB_SCALING = "read-job-scaling"
CAP_SCALE_JOB = "scale-job"
CAP_VARIABLES_READ = "variables-read"
CAP_VARIABLES_WRITE = "variables-write"
CAP_VARIABLES_LIST = "variables-list"
CAP_VARIABLES_DESTROY = "variables-destroy"

NS_CAPABILITIES = {
    CAP_LIST_JOBS, CAP_PARSE_JOB, CAP_READ_JOB, CAP_SUBMIT_JOB,
    CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS, CAP_ALLOC_EXEC,
    CAP_ALLOC_LIFECYCLE, CAP_ALLOC_NODE_EXEC, CAP_CSI_REGISTER_PLUGIN,
    CAP_CSI_WRITE_VOLUME, CAP_CSI_READ_VOLUME, CAP_CSI_LIST_VOLUME,
    CAP_CSI_MOUNT_VOLUME, CAP_LIST_SCALING_POLICIES,
    CAP_READ_SCALING_POLICY, CAP_READ_JOB_SCALING, CAP_SCALE_JOB,
    CAP_VARIABLES_READ, CAP_VARIABLES_WRITE, CAP_VARIABLES_LIST,
    CAP_VARIABLES_DESTROY, CAP_DENY,
}


def _expand_policy(policy: str) -> List[str]:
    """reference: expandNamespacePolicy."""
    read = [CAP_LIST_JOBS, CAP_PARSE_JOB, CAP_READ_JOB,
            CAP_CSI_LIST_VOLUME, CAP_CSI_READ_VOLUME, CAP_READ_JOB_SCALING,
            CAP_LIST_SCALING_POLICIES, CAP_READ_SCALING_POLICY,
            CAP_VARIABLES_LIST, CAP_VARIABLES_READ]
    write = read + [CAP_SCALE_JOB, CAP_SUBMIT_JOB, CAP_DISPATCH_JOB,
                    CAP_READ_LOGS, CAP_READ_FS, CAP_ALLOC_EXEC,
                    CAP_ALLOC_LIFECYCLE, CAP_CSI_WRITE_VOLUME,
                    CAP_CSI_MOUNT_VOLUME, CAP_VARIABLES_WRITE,
                    CAP_VARIABLES_DESTROY]
    if policy == POLICY_DENY:
        return [CAP_DENY]
    if policy == POLICY_READ:
        return list(read)
    if policy == POLICY_WRITE:
        return list(write)
    if policy == POLICY_SCALE:
        return [CAP_LIST_SCALING_POLICIES, CAP_READ_SCALING_POLICY,
                CAP_READ_JOB_SCALING, CAP_SCALE_JOB]
    raise ValueError(f"unknown namespace policy {policy!r}")


@dataclass
class NamespacePolicy:
    name: str                     # may contain glob '*'
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)

    def expanded(self) -> List[str]:
        caps = list(self.capabilities)
        if self.policy:
            caps.extend(_expand_policy(self.policy))
        return caps


@dataclass
class Policy:
    namespaces: List[NamespacePolicy] = field(default_factory=list)
    node: str = ""                # "", deny, read, write
    agent: str = ""
    operator: str = ""
    quota: str = ""
    node_pools: List[NamespacePolicy] = field(default_factory=list)


_COARSE = ("", POLICY_DENY, POLICY_READ, POLICY_WRITE, POLICY_LIST)


def parse_policy(src: str) -> Policy:
    """HCL or JSON policy document -> Policy (reference: acl.Parse)."""
    src = src.strip()
    if src.startswith("{"):
        return _from_obj(json.loads(src))
    from nomad_tpu_torch.jobspec.hcl import parse as hcl_parse, Attr, Block

    p = Policy()
    for node in hcl_parse(src):
        if isinstance(node, Block):
            label = node.labels[0] if node.labels else "*"
            body = {a.name: _literal(a.expr) for a in node.body
                    if isinstance(a, Attr)}
            if node.type == "namespace":
                np = NamespacePolicy(
                    name=label,
                    policy=body.get("policy", ""),
                    capabilities=list(body.get("capabilities", [])))
                _validate_ns(np)
                p.namespaces.append(np)
            elif node.type == "node_pool":
                p.node_pools.append(NamespacePolicy(
                    name=label, policy=body.get("policy", "")))
            elif node.type in ("node", "agent", "operator", "quota"):
                lvl = body.get("policy", "")
                if lvl not in _COARSE:
                    raise ValueError(
                        f"invalid {node.type} policy {lvl!r}")
                setattr(p, node.type, lvl)
            else:
                raise ValueError(f"unknown policy block {node.type!r}")
    return p


def _from_obj(obj: Dict) -> Policy:
    p = Policy()
    for name, body in (obj.get("Namespaces") or obj.get("namespaces")
                       or {}).items():
        np = NamespacePolicy(
            name=name,
            policy=body.get("Policy", body.get("policy", "")),
            capabilities=list(body.get("Capabilities",
                                       body.get("capabilities", []))))
        _validate_ns(np)
        p.namespaces.append(np)
    for k in ("node", "agent", "operator", "quota"):
        lvl = obj.get(k.capitalize(), obj.get(k, ""))
        if isinstance(lvl, dict):
            lvl = lvl.get("Policy", lvl.get("policy", ""))
        if lvl not in _COARSE:
            raise ValueError(f"invalid {k} policy {lvl!r}")
        setattr(p, k, lvl)
    return p


def _validate_ns(np: NamespacePolicy) -> None:
    if np.policy and np.policy not in (POLICY_DENY, POLICY_READ,
                                       POLICY_WRITE, POLICY_SCALE):
        raise ValueError(f"invalid namespace policy {np.policy!r}")
    for cap in np.capabilities:
        if cap not in NS_CAPABILITIES:
            raise ValueError(f"unknown namespace capability {cap!r}")
    if not np.policy and not np.capabilities:
        raise ValueError(f"namespace {np.name!r} grants nothing")


def _literal(expr):
    from nomad_tpu_torch.jobspec.hcl import EvalContext, Evaluator
    return Evaluator(EvalContext()).evaluate(expr)
