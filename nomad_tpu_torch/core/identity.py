"""Workload identity tokens
(reference: nomad/structs workload identity [v1.4+], client
identity_hook.go, and the implicit variables policy that grants every
workload read access to its own job's variable subtree).

A workload identity is a signed claim {namespace, job_id, alloc_id,
task, exp} minted by the servers and handed to each task as NOMAD_TOKEN.
The HTTP/API layer accepts it wherever an ACL token is accepted; it
compiles to a read-only ACL scoped to the job's variable paths
(`nomad/jobs/<job_id>` and deeper), mirroring the reference's implicit
policy.

Format is a JWT-shaped compact token — base64url(header).base64url(
claims).base64url(HMAC-SHA256 sig) — signed with a cluster-wide secret
that lives in the replicated state store (so every server verifies, and
`operator snapshot` carries it)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from typing import Dict, Optional

from nomad_tpu_torch.chaos.clock import Clock, SystemClock

_HEADER = {"alg": "HS256", "typ": "JWT"}

IDENTITY_PREFIX = "nomad-wi."      # marks tokens for cheap routing

# injected timebase for the `now=None` defaults (chaos/clock.py): a
# virtual-time soak must see identity iat/exp on the same timeline as
# heartbeats and ACL expiry.  Server.__init__ binds its clock here next
# to telemetry.configure / flightrec.configure.
_CLOCK: Clock = SystemClock()


def configure(clock: Clock) -> None:
    global _CLOCK
    _CLOCK = clock


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def mint(secret: str, *, namespace: str, job_id: str, alloc_id: str,
         task: str, ttl_s: float = 0.0,
         now: Optional[float] = None) -> str:
    """Sign one workload identity.  ttl_s=0 → tied to the alloc's
    lifetime only (no expiry claim; the reference's default identities
    are likewise alloc-scoped)."""
    t = now if now is not None else _CLOCK.time()
    claims = {"nomad_namespace": namespace, "nomad_job_id": job_id,
              "nomad_allocation_id": alloc_id, "nomad_task": task,
              "iat": int(t)}
    if ttl_s:
        claims["exp"] = int(t + ttl_s)
    h = _b64(json.dumps(_HEADER, separators=(",", ":")).encode())
    c = _b64(json.dumps(claims, separators=(",", ":"),
                        sort_keys=True).encode())
    signing_input = f"{h}.{c}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{IDENTITY_PREFIX}{h}.{c}.{_b64(sig)}"


def verify(secret: str, token: str,
           now: Optional[float] = None) -> Optional[Dict]:
    """-> claims dict, or None for anything invalid/expired/forged."""
    if not token.startswith(IDENTITY_PREFIX):
        return None
    body = token[len(IDENTITY_PREFIX):]
    parts = body.split(".")
    if len(parts) != 3:
        return None
    signing_input = f"{parts[0]}.{parts[1]}".encode()
    want = hmac.new(secret.encode(), signing_input,
                    hashlib.sha256).digest()
    try:
        got = _unb64(parts[2])
    except Exception:  # noqa: BLE001 - malformed is just invalid
        return None
    if not hmac.compare_digest(want, got):
        return None
    try:
        claims = json.loads(_unb64(parts[1]))
    except Exception:  # noqa: BLE001
        return None
    exp = claims.get("exp")
    t = now if now is not None else _CLOCK.time()
    if exp is not None and t > exp:
        return None
    return claims


def variable_prefix(job_id: str) -> str:
    """The variable subtree this workload may read (reference: the
    implicit workload policy paths nomad/jobs/<job_id>...)."""
    return f"nomad/jobs/{job_id}"


from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("identity", configure=configure)
