"""The port's ACL package (nomad_tpu_torch/acl) against the reference's
(nomad_tpu/acl) on the same inputs: seeded policies, written as HCL and
as JSON, through parse_policy and compile_acl give the same answer to
every question an ACL answers; invalid documents raise alike; HS256 JWT
verification, binding-rule selection and the login flow agree."""

import base64
import hashlib
import hmac
import json

import numpy as np
import pytest

from torch_parity import PACKAGES, pkg

NAMESPACE_RULES = ("default", "prod", "prod-*", "dev*", "*", "team-a",
                   "team-?")
NAMESPACE_QUERIES = ("default", "prod", "prod-eu", "dev", "devops",
                     "team-a", "team-b", "other")
NS_LEVELS = ("", "deny", "read", "write", "scale")
COARSE_LEVELS = ("", "deny", "read", "write", "list")
COARSE = ("node", "agent", "operator", "quota")
VAR_PATHS = ("nomad/jobs/web", "nomad/jobs/web/db", "app/config")


def random_policy(rng, caps):
    """One policy as (HCL text, JSON text): up to three namespace rules,
    each with a level and/or capabilities, and the coarse levels."""
    rules = {}
    for name in rng.choice(NAMESPACE_RULES, size=rng.integers(1, 4),
                           replace=False).tolist():
        level = NS_LEVELS[rng.integers(len(NS_LEVELS))]
        chosen = sorted(rng.choice(caps, size=rng.integers(0, 4),
                                   replace=False).tolist())
        if not level and not chosen:
            level = "read"
        rules[name] = (level, chosen)
    coarse = {k: COARSE_LEVELS[rng.integers(len(COARSE_LEVELS))]
              for k in COARSE}
    hcl = []
    for name, (level, chosen) in rules.items():
        body = []
        if level:
            body.append(f'  policy = "{level}"')
        if chosen:
            body.append("  capabilities = [" +
                        ", ".join(f'"{c}"' for c in chosen) + "]")
        hcl.append(f'namespace "{name}" {{\n' + "\n".join(body) + "\n}")
    for k, level in coarse.items():
        if level:
            hcl.append(f'{k} {{\n  policy = "{level}"\n}}')
    doc = {"Namespaces": {name: {"Policy": level, "Capabilities": chosen}
                          for name, (level, chosen) in rules.items()}}
    for k, level in coarse.items():
        doc[k.capitalize()] = {"Policy": level}
    return "\n".join(hcl), json.dumps(doc)


def answers(acl, caps):
    """Every answer the compiled ACL gives, keyed by the question."""
    out = {"management": acl.is_management()}
    for ns in NAMESPACE_QUERIES:
        out[("ns", ns)] = acl.allow_namespace(ns)
        for cap in caps:
            out[(ns, cap)] = acl.allow_namespace_operation(ns, cap)
        for path in VAR_PATHS:
            for write in (False, True):
                out[("var", ns, path, write)] = acl.allow_variable(
                    ns, path, write)
    for k in ("node", "agent", "operator"):
        for mode in ("read", "write"):
            out[(k, mode)] = getattr(acl, f"allow_{k}_{mode}")()
    return out


def capabilities():
    caps = sorted(pkg("nomad_tpu", "acl.policy").NS_CAPABILITIES)
    assert caps == sorted(pkg("nomad_tpu_torch", "acl.policy")
                          .NS_CAPABILITIES)
    return caps


@pytest.mark.parametrize("seed", range(8))
def test_seeded_policies_answer_alike(seed):
    caps = capabilities()
    rng = np.random.default_rng(seed)
    docs = [random_policy(rng, caps) for _ in range(rng.integers(1, 4))]
    got = {}
    for name in PACKAGES:
        acl = pkg(name, "acl")
        for form in (0, 1):
            policies = [acl.parse_policy(d[form]) for d in docs]
            got[(name, form)] = answers(acl.compile_acl(policies), caps)
    want = got[("nomad_tpu", 0)]
    # HCL and JSON of one policy mean the same in the reference too
    assert got[("nomad_tpu", 1)] == want
    assert got[("nomad_tpu_torch", 0)] == want
    assert got[("nomad_tpu_torch", 1)] == want


def test_management_and_workload_acls_answer_alike():
    caps = capabilities()
    got = []
    for name in PACKAGES:
        acl = pkg(name, "acl")
        got.append((answers(acl.management_acl(), caps),
                     answers(acl.workload_acl("default", "nomad/jobs/web"),
                             caps),
                     answers(acl.ACL(), caps)))
    assert got[0] == got[1]


BAD_POLICIES = {
    "unknown_level": 'namespace "x" {\n  policy = "admin"\n}',
    "unknown_capability": 'namespace "x" {\n  capabilities = ["fly"]\n}',
    "grants_nothing": 'namespace "x" {\n}',
    "unknown_block": 'quux {\n  policy = "read"\n}',
    "bad_coarse": 'node {\n  policy = "scale"\n}',
    "json_bad_coarse": '{"Agent": {"Policy": "root"}}',
}


@pytest.mark.parametrize("case", sorted(BAD_POLICIES))
def test_invalid_policies_raise_alike(case):
    errors = []
    for name in PACKAGES:
        with pytest.raises(ValueError) as exc:
            pkg(name, "acl").parse_policy(BAD_POLICIES[case])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------- JWT

SECRET = "s3cret"
NOW = 1_700_000_000.0


def _b64(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def hs256(claims, secret=SECRET, header=None):
    head = _b64(json.dumps(header or {"alg": "HS256", "typ": "JWT"})
                .encode())
    body = _b64(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{head}.{body}.{_b64(sig)}"


GOOD = {"iss": "idp", "aud": ["nomad"], "sub": "alice", "team": "web",
        "groups": ["eng", "ops"], "exp": NOW + 60, "nbf": NOW - 60}
TOKENS = {
    "good": hs256(GOOD),
    "bad_signature": hs256(GOOD, secret="other"),
    "expired": hs256({**GOOD, "exp": NOW - 1}),
    "not_yet_valid": hs256({**GOOD, "nbf": NOW + 1}),
    "wrong_issuer": hs256({**GOOD, "iss": "elsewhere"}),
    "wrong_audience": hs256({**GOOD, "aud": "other"}),
    "bad_time_claim": hs256({**GOOD, "exp": "soon"}),
    "malformed": "a.b",
    "array_header": hs256(GOOD, header=["HS256"]),
    "alg_none": hs256(GOOD, header={"alg": "none"}),
    "rs256_unknown_key": hs256(GOOD, header={"alg": "RS256"}),
}


def _method(name):
    structs = pkg(name, "structs")
    return structs.ACLAuthMethod(
        name="sso", type="JWT", max_token_ttl_s=600.0, config={
            "JWTValidationSecrets": [SECRET],
            "JWTValidationPubKeys": ["not a key"],
            "BoundIssuer": "idp", "BoundAudiences": ["nomad"]})


def _verify(name, token):
    am = pkg(name, "acl.auth_methods")
    try:
        return "claims", am.verify_jwt(_method(name), token, now=NOW)
    except am.AuthError as exc:
        return "error", str(exc)


@pytest.mark.parametrize("case", sorted(TOKENS))
def test_jwt_verification_agrees(case):
    ref, port = (_verify(name, TOKENS[case]) for name in PACKAGES)
    assert ref == port
    assert (ref[0] == "claims") == (case == "good")


RULES = (("claims.team==web", "policy", "team-${claims.team}"),
         ("claims.groups==ops", "policy", "ops"),
         ("claims.team==db", "management", ""),
         ("", "policy", "${claims.missing}"),
         ("claims.sub == 'alice', claims.team==web", "policy", "alice"))


@pytest.mark.parametrize("claims", [GOOD, {**GOOD, "team": "db"},
                                    {**GOOD, "team": "none",
                                     "groups": []}],
                         ids=["web", "db", "none"])
def test_login_binds_alike(claims):
    out = []
    for name in PACKAGES:
        structs = pkg(name, "structs")
        am = pkg(name, "acl.auth_methods")
        state = pkg(name, "state").StateStore()
        state.upsert_acl_auth_method(_method(name))
        for i, (sel, kind, bind) in enumerate(RULES):
            state.upsert_acl_binding_rule(structs.ACLBindingRule(
                id=f"rule-{i}", auth_method="sso", selector=sel,
                bind_type=kind, bind_name=bind))
        try:
            token, pols = am.login(state, "sso", hs256(claims), now=NOW)
            out.append((token.name, token.type, token.policies, pols,
                        token.global_, token.expiration_time))
        except am.AuthError as exc:
            out.append(("error", str(exc)))
        for sel, _, _ in RULES:
            out.append(am.selector_matches(sel, claims))
    assert out[:len(out) // 2] == out[len(out) // 2:]
