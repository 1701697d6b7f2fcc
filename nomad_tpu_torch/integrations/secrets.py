"""Secrets providers — the Vault integration seam
(reference: nomad/vault.go + client vault_hook/template secret renders).

A provider resolves (namespace, path) -> {key: value} under a caller
credential.  The built-in implementation reads nomad variables through
the server with the task's WORKLOAD IDENTITY token, so a task can only
reach its own job's variable subtree (the implicit workload ACL) — the
same trust shape as Vault's task-scoped tokens, without the external
dependency.  An external Vault/KMS-backed provider implements the same
two-method surface and plugs in at Client(secrets_provider=...).
"""

from __future__ import annotations

from typing import Dict, Optional


class SecretsProvider:
    """The pluggable seam: fetch a secret bundle for a task."""

    def fetch(self, namespace: str, path: str,
              token: str) -> Optional[Dict[str, str]]:
        """Return the secret's key/value items, or None when the path
        does not exist.  Raises PermissionError when the credential is
        not allowed to read the path."""
        raise NotImplementedError


class VariablesSecretsProvider(SecretsProvider):
    """Built-in provider over nomad variables via the server RPC surface
    (InProcessRPC / RemoteRPC `read_variable`)."""

    def __init__(self, rpc) -> None:
        self.rpc = rpc

    def fetch(self, namespace: str, path: str,
              token: str) -> Optional[Dict[str, str]]:
        items, err = self.rpc.read_variable(namespace, path, token)
        if err:
            raise PermissionError(err)
        return items
