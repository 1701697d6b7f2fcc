"""Compiled ACL (reference: acl/acl.go).

Merges policies into capability sets.  Namespace rules support glob names;
the rule with the greatest number of literal characters wins for a given
namespace (reference: maxPrivilege via longest-match radix lookup)."""

from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, List, Optional, Set

from .policy import CAP_DENY, Policy

_LEVELS = {"": 0, "deny": 0, "list": 1, "read": 2, "write": 3}


class ACL:
    def __init__(self, management: bool = False) -> None:
        self.management = management
        # exact/glob namespace name -> capability set
        self._ns: Dict[str, Set[str]] = {}
        self._node_pool: Dict[str, str] = {}
        self.node = ""
        self.agent = ""
        self.operator = ""
        self.quota = ""
        # workload identity: read-only variable access restricted to
        # these (namespace, path-prefix) pairs (reference: the implicit
        # workload-identity policy over nomad/jobs/<job_id>)
        self.var_prefixes: Optional[List[tuple]] = None

    # --------------------------------------------------------- namespaces

    def _ns_caps(self, ns: str) -> Set[str]:
        if ns in self._ns:
            return self._ns[ns]
        best: Optional[str] = None
        for pat in self._ns:
            if fnmatch.fnmatchcase(ns, pat):
                if best is None or _literal_len(pat) > _literal_len(best):
                    best = pat
        return self._ns.get(best, set()) if best is not None else set()

    def allow_namespace_operation(self, ns: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._ns_caps(ns)
        if CAP_DENY in caps:
            return False
        return cap in caps

    def allow_namespace(self, ns: str) -> bool:
        """Any (non-deny) capability in the namespace."""
        if self.management:
            return True
        caps = self._ns_caps(ns)
        return bool(caps) and CAP_DENY not in caps

    def allow_variable(self, ns: str, path: str, write: bool) -> bool:
        """Path-aware variable check for ONE exact path: path-restricted
        ACLs (workload identities) may only READ at/under their prefixes;
        everything else falls back to the namespace capability.  List
        endpoints filter each candidate through this."""
        if self.management:
            return True
        if self.var_prefixes is not None:
            if write:
                return False
            return any(ns == pns
                       and (path == pre or path.startswith(pre + "/"))
                       for pns, pre in self.var_prefixes)
        cap = "variables-write" if write else "variables-read"
        return self.allow_namespace_operation(ns, cap)

    # ------------------------------------------------------------- coarse

    def _coarse(self, have: str, want: str) -> bool:
        if self.management:
            return True
        return _LEVELS.get(have, 0) >= _LEVELS.get(want, 0) > 0

    def allow_node_read(self) -> bool:
        return self._coarse(self.node, "read")

    def allow_node_write(self) -> bool:
        return self._coarse(self.node, "write")

    def allow_agent_read(self) -> bool:
        return self._coarse(self.agent, "read")

    def allow_agent_write(self) -> bool:
        return self._coarse(self.agent, "write")

    def allow_operator_read(self) -> bool:
        return self._coarse(self.operator, "read")

    def allow_operator_write(self) -> bool:
        return self._coarse(self.operator, "write")

    def is_management(self) -> bool:
        return self.management


def _literal_len(pattern: str) -> int:
    return sum(1 for ch in pattern if ch not in "*?[]")


def compile_acl(policies: Iterable[Policy]) -> ACL:
    """reference: acl.NewACL — merge with max-privilege semantics."""
    out = ACL()
    for p in policies:
        for np in p.namespaces:
            caps = out._ns.setdefault(np.name, set())
            caps.update(np.expanded())
        for np in p.node_pools:
            cur = out._node_pool.get(np.name, "")
            if _LEVELS.get(np.policy, 0) > _LEVELS.get(cur, 0):
                out._node_pool[np.name] = np.policy
        for attr in ("node", "agent", "operator", "quota"):
            lvl = getattr(p, attr)
            if _LEVELS.get(lvl, 0) > _LEVELS.get(getattr(out, attr), 0):
                setattr(out, attr, lvl)
    # an explicit deny wins inside one namespace rule set UNLESS another
    # policy granted real capabilities (max-privilege merge drops the deny)
    for name, caps in out._ns.items():
        if CAP_DENY in caps and len(caps) > 1:
            caps.discard(CAP_DENY)
    return out


def management_acl() -> ACL:
    return ACL(management=True)


def workload_acl(namespace: str, var_prefix: str) -> ACL:
    """The implicit workload-identity policy: read/list variables at and
    under `var_prefix` in `namespace`, nothing else (reference: the
    auto-generated workload identity policy)."""
    acl = ACL()
    # variables ONLY — no read-job: it would expose every job spec and
    # (via /v1/client/fs) every sibling alloc's filesystem and logs
    acl._ns[namespace] = {"variables-read", "variables-list"}
    acl.var_prefixes = [(namespace, var_prefix)]
    return acl
