"""JWT auth methods + binding rules — SSO token exchange
(reference: nomad/acl_endpoint.go ACL.Login, structs.ACLAuthMethod /
ACLBindingRule [v1.5+]; the `nomad login` flow).

A client presents a third-party JWT to `POST /v1/acl/login`; the server
validates it against the named auth method's keys and bound
issuer/audiences, evaluates the method's binding rules over the verified
claims, and mints a normal ACL token carrying the bound policies (or a
management token for a `management` binding).

Deliberate deviations (declared in README):
  - OIDC discovery needs egress + an interactive browser flow; method
    type "OIDC" is rejected at creation with that reason.  JWT methods
    with static validation keys cover the machine-to-machine flows.
  - HS256 shared-secret validation is supported alongside RS256 —
    useful where no PKI exists; the claims checks are identical.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import re
import time
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import (
    ACLAuthMethod,
    ACLBindingRule,
    ACLToken,
)


class AuthError(Exception):
    """Login failed (bad token, no matching rules, bad method)."""


def _unb64(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def validate_method(method: ACLAuthMethod) -> Optional[str]:
    """Returns an error string for an unusable method, else None."""
    if method.type == "OIDC":
        return ("auth method type OIDC is unsupported in this build "
                "(discovery needs egress + a browser flow); use type "
                "JWT with JWTValidationPubKeys/JWTValidationSecrets")
    if method.type != "JWT":
        return f"unknown auth method type {method.type!r}"
    cfg = method.config or {}
    if not (cfg.get("JWTValidationPubKeys")
            or cfg.get("JWTValidationSecrets")):
        return ("a JWT auth method needs JWTValidationPubKeys (RS256) "
                "or JWTValidationSecrets (HS256)")
    return None


def _verify_sig(header: Dict, signing_input: bytes, sig: bytes,
                cfg: Dict) -> bool:
    alg = header.get("alg")
    if alg == "HS256":
        for secret in cfg.get("JWTValidationSecrets") or ():
            want = hmac.new(str(secret).encode(), signing_input,
                            hashlib.sha256).digest()
            if hmac.compare_digest(want, sig):
                return True
        return False
    if alg == "RS256":
        try:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import padding
            from cryptography.hazmat.primitives.serialization import (
                load_pem_public_key)
        except Exception:  # noqa: BLE001 - no cryptography in this env
            return False
        for pem in cfg.get("JWTValidationPubKeys") or ():
            try:
                key = load_pem_public_key(str(pem).encode())
                key.verify(sig, signing_input, padding.PKCS1v15(),
                           hashes.SHA256())
                return True
            except (InvalidSignature, ValueError):
                continue
        return False
    return False     # unknown alg: fail closed


def verify_jwt(method: ACLAuthMethod, token: str,
               now: Optional[float] = None) -> Dict:
    """Validate `token` against `method`; returns the claims dict or
    raises AuthError.  Checks: signature (any configured key), exp/nbf,
    BoundIssuer, BoundAudiences."""
    t = now if now is not None else time.time()
    parts = token.split(".")
    if len(parts) != 3:
        raise AuthError("malformed JWT")
    try:
        header = json.loads(_unb64(parts[0]))
        claims = json.loads(_unb64(parts[1]))
        sig = _unb64(parts[2])
    except (ValueError, json.JSONDecodeError):
        raise AuthError("malformed JWT")
    if not isinstance(header, dict) or not isinstance(claims, dict):
        # adversarial-but-valid JSON (e.g. an array header) must fail
        # AUTH, not crash the unauthenticated login endpoint
        raise AuthError("malformed JWT")
    cfg = method.config or {}
    signing_input = f"{parts[0]}.{parts[1]}".encode()
    if not _verify_sig(header, signing_input, sig, cfg):
        raise AuthError("JWT signature verification failed")
    try:
        if "exp" in claims and float(claims["exp"]) < t:
            raise AuthError("JWT expired")
        if "nbf" in claims and float(claims["nbf"]) > t:
            raise AuthError("JWT not yet valid")
    except (TypeError, ValueError):
        raise AuthError("malformed JWT time claim")
    bound_iss = cfg.get("BoundIssuer")
    if bound_iss and claims.get("iss") != bound_iss:
        raise AuthError("issuer not bound to this auth method")
    bound_aud = cfg.get("BoundAudiences")
    if bound_aud:
        aud = claims.get("aud")
        auds = set(aud) if isinstance(aud, list) else {aud}
        if not auds & set(bound_aud):
            raise AuthError("audience not bound to this auth method")
    return claims


_SEL_TERM = re.compile(r"^\s*claims\.([\w.-]+)\s*==\s*(.+?)\s*$")
_INTERP = re.compile(r"\$\{claims\.([\w.-]+)\}")


def selector_matches(selector: str, claims: Dict) -> bool:
    """Comma-ANDed `claims.<name>==<value>` terms; empty matches all.
    Values compare as strings (quotes optional)."""
    if not selector.strip():
        return True
    for term in selector.split(","):
        m = _SEL_TERM.match(term)
        if not m:
            return False        # unparseable selector never matches
        name, want = m.group(1), m.group(2).strip().strip("'\"")
        have = claims.get(name)
        if isinstance(have, list):
            if want not in [str(x) for x in have]:
                return False
        elif str(have) != want:
            return False
    return True


def bind_name_for(rule: ACLBindingRule, claims: Dict) -> Optional[str]:
    """Interpolate ${claims.x}; None when a referenced claim is absent
    (the rule then grants nothing — reference semantics)."""
    missing = False

    def sub(m):
        nonlocal missing
        v = claims.get(m.group(1))
        if v is None:
            missing = True
            return ""
        return str(v)

    out = _INTERP.sub(sub, rule.bind_name)
    return None if missing else out


def login(state, method_name: str, login_token: str,
          now: Optional[float] = None) -> Tuple[ACLToken, List[str]]:
    """The ACL.Login flow: verify the JWT, evaluate binding rules, mint
    an ACL token.  Returns (token, bound policy names); raises AuthError
    when nothing binds (a login that grants nothing must not mint an
    empty token)."""
    t = now if now is not None else time.time()
    if not method_name:
        # reference: `nomad login` without -method uses the default one
        defaults = [m for m in state.acl_auth_methods() if m.default]
        if not defaults:
            raise AuthError("no auth method named and none is default")
        method_name = defaults[0].name
    method = state.acl_auth_method_by_name(method_name)
    if method is None:
        raise AuthError(f"unknown auth method {method_name!r}")
    claims = verify_jwt(method, login_token, now=t)
    policies: List[str] = []
    management = False
    for rule in state.acl_binding_rules(auth_method=method_name):
        if not selector_matches(rule.selector, claims):
            continue
        if rule.bind_type == "management":
            management = True
            continue
        name = bind_name_for(rule, claims)
        if name:
            policies.append(name)
    if not management and not policies:
        raise AuthError("no binding rules matched the presented identity")
    token = ACLToken(
        name=f"{method_name} login "
             f"({claims.get('sub') or claims.get('iss') or 'jwt'})",
        type="management" if management else "client",
        policies=[] if management else sorted(set(policies)),
        global_=method.token_locality == "global",
        create_time=t,
        # minted tokens age out with the method's TTL (and never outlive
        # the presented JWT)
        expiration_time=min(
            t + method.max_token_ttl_s,
            float(claims["exp"]) if "exp" in claims else float("inf")),
    )
    return token, token.policies
