"""External-system integration planes (reference: nomad/vault.go,
nomad/consul.go and their client-side hooks).

The reference integrates two external HashiCorp systems; this framework
ships NATIVE equivalents behind pluggable seams, so an external provider
can be dropped in without touching the scheduler or client core:

  - Secrets (the Vault seam): `SecretsProvider` — tasks reference
    secrets in templates as ``${nomad_var.<path>#<key>}``; the client's
    SecretsHook resolves them through the provider using the task's
    workload identity before templates render.  The built-in provider is
    backed by nomad variables (encrypted KV in the state store), exactly
    the reference's native-variables-in-templates path.
  - Service registration (the Consul seam): the client's native service
    registration + health checks (client/services.py) registers into the
    server's service catalog; an external-catalog driver implements the
    same `update/remove` surface the in-process one exposes.
"""

from .secrets import SecretsProvider, VariablesSecretsProvider

__all__ = ["SecretsProvider", "VariablesSecretsProvider"]
