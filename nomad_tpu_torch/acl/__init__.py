"""ACL system (reference: acl/policy.go + acl/acl.go).

Policies are HCL (or JSON) documents granting capabilities per namespace
(with glob matching), plus coarse node/agent/operator/quota levels:

    namespace "default" { policy = "write" }
    namespace "ops-*"   { capabilities = ["read-job", "submit-job"] }
    node     { policy = "read" }
    agent    { policy = "write" }
    operator { policy = "read" }

`parse_policy` produces a Policy; `compile_acl` merges several policies
into an ACL object answering `allow_namespace_operation(ns, cap)` etc.
Management tokens bypass all checks (reference: ACLsDisabledToken /
ManagementACL).
"""

from .policy import (  # noqa: F401
    CAP_DENY,
    NS_CAPABILITIES,
    POLICY_DENY,
    POLICY_LIST,
    POLICY_READ,
    POLICY_WRITE,
    NamespacePolicy,
    Policy,
    parse_policy,
)
from .acl import ACL, compile_acl, management_acl, workload_acl  # noqa: F401
