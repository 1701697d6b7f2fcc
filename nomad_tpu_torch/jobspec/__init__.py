"""Jobspec parsing (reference: `jobspec/` HCL1 + `jobspec2/` HCL2).

Public surface:
    parse(src, variables=..., env=...) -> structs.Job
    parse_file(path, ...)              -> structs.Job
    parse_json(obj_or_str)             -> structs.Job

HCL2 features supported (SURVEY.md §2 layer 13): `variable` blocks with
types/defaults and caller overrides (the `-var` plane), `locals`, functions,
string templates, heredocs, `dynamic` blocks, for-expressions, arithmetic /
conditional expressions.  Runtime interpolations (`${node.*}`, `${attr.*}`,
`${meta.*}`, `${env.*}`, `${NOMAD_*}`) are preserved verbatim for the
scheduler / taskenv planes, matching jobspec2's split between parse-time HCL
evaluation and runtime variable interpolation.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from nomad_tpu_torch.structs import Job

from . import hcl as _hcl
from .hcl import ParseError
from .schema import eval_body, job_from_block, parse_duration

__all__ = ["parse", "parse_file", "parse_json", "parse_duration",
           "ParseError", "hcl_to_dict"]

# Roots preserved verbatim for runtime interpolation.
# NOTE: secrets references (${nomad_var.<path>#<key>}) are deliberately
# NOT a runtime root: their paths contain '/' and '#', which HCL would
# silently mangle as operators.  Jobspecs must escape them as
# $${nomad_var...} (standard HCL2 literal-${ escaping) so the raw text
# reaches the client's SecretsHook; unescaped uses fail loudly here.
_RUNTIME_ROOTS = ("node", "attr", "meta", "env", "device", "NOMAD_*")


def _type_default(type_expr: Any) -> Any:
    if isinstance(type_expr, str):
        return {"string": "", "number": 0, "bool": False,
                "list": [], "map": {}}.get(type_expr)
    return None


def _coerce(value: Any, type_name: str) -> Any:
    if type_name == "number" and isinstance(value, str):
        return float(value) if "." in value else int(value)
    if type_name == "bool" and isinstance(value, str):
        return value == "true"
    if type_name in ("list", "map") and isinstance(value, str):
        return json.loads(value)
    return value


def parse(src: str, variables: Optional[Dict[str, Any]] = None,
          env: Optional[Dict[str, str]] = None) -> Job:
    """Parse an HCL jobspec into a Job.

    `variables` plays the role of `-var`/`-var-file` CLI flags; `env`
    seeds `var.*` from NOMAD_VAR_* the way jobspec2 does.
    """
    body = _hcl.parse(src)

    overrides: Dict[str, Any] = {}
    for k, v in (env or {}).items():
        if k.startswith("NOMAD_VAR_"):
            overrides[k[len("NOMAD_VAR_"):]] = v
    overrides.update(variables or {})

    # Pass 1: variable declarations (evaluated with no context).
    var_values: Dict[str, Any] = {}
    base_ev = _hcl.Evaluator(_hcl.EvalContext({}), _RUNTIME_ROOTS)
    job_block = None
    locals_blocks = []
    for item in body:
        if isinstance(item, _hcl.Block) and item.type == "variable":
            name = item.labels[0] if item.labels else ""
            spec = eval_body(item.body, base_ev)
            type_name = str(spec.get("type", "")).strip("${}")
            if name in overrides:
                var_values[name] = _coerce(overrides[name], type_name)
            elif "default" in spec.attrs:
                var_values[name] = spec.attrs["default"]
            else:
                dflt = _type_default(type_name)
                if dflt is None:
                    raise ParseError(f"missing value for variable {name!r}")
                var_values[name] = dflt
        elif isinstance(item, _hcl.Block) and item.type == "locals":
            locals_blocks.append(item)
        elif isinstance(item, _hcl.Block) and item.type == "job":
            job_block = item

    ctx = _hcl.EvalContext({"var": var_values, "local": {}})
    ev = _hcl.Evaluator(ctx, _RUNTIME_ROOTS)

    # Pass 2: locals (may reference vars and other locals, in any order;
    # iterate to a fixed point, then fail on remaining cycles).
    pending = [item for lb in locals_blocks for item in lb.body
               if isinstance(item, _hcl.Attr)]
    while pending:
        progressed = False
        errors = []
        for item in list(pending):
            try:
                ctx.variables["local"][item.name] = ev.evaluate(item.expr)
            except ParseError as exc:
                errors.append(exc)
                continue
            pending.remove(item)
            progressed = True
        if not progressed:
            raise errors[0]

    if job_block is None:
        raise ParseError("no job block found")
    evaluated = eval_body([job_block], ev)
    return job_from_block(evaluated.children("job")[0])


def parse_file(path: str, variables: Optional[Dict[str, Any]] = None,
               env: Optional[Dict[str, str]] = None) -> Job:
    with open(path) as f:
        src = f.read()
    if path.endswith(".json"):
        return parse_json(src)
    return parse(src, variables=variables, env=env)


def hcl_to_dict(src: str) -> Dict[str, Any]:
    """Generic HCL -> dict (for agent config files, ACL policies, …)."""
    body = _hcl.parse(src)
    ev = _hcl.Evaluator(_hcl.EvalContext({}), _RUNTIME_ROOTS + ("*",))
    from .schema import _block_to_dict
    return _block_to_dict(eval_body(body, ev))


def parse_json(obj) -> Job:
    """JSON jobspec (the `api.Job` wire shape, as accepted by
    `nomad job run -json` / the HTTP API)."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if "Job" in obj:
        obj = obj["Job"]
    from .api_json import job_from_api_dict
    return job_from_api_dict(obj)
