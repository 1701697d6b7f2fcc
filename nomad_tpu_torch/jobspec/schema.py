"""Jobspec schema: evaluated HCL tree -> structs.Job.

Mirrors the behavior of the reference's `jobspec/parse*.go` + `jobspec2/`
(block names, field names, defaults, duration strings) while targeting this
framework's native data model.  Field-by-field semantics re-derived from the
upstream jobspec documentation and parser behavior; nothing is translated.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.structs import (
    Affinity,
    Constraint,
    EphemeralDisk,
    Job,
    MigrateStrategy,
    Multiregion,
    NetworkResource,
    OP_DISTINCT_HOSTS,
    OP_DISTINCT_PROPERTY,
    OP_EQ,
    OP_IS_NOT_SET,
    OP_IS_SET,
    OP_REGEX,
    OP_SEMVER,
    OP_SET_CONTAINS,
    OP_SET_CONTAINS_ALL,
    OP_SET_CONTAINS_ANY,
    OP_VERSION,
    ParameterizedJobConfig,
    PeriodicConfig,
    Port,
    RequestedDevice,
    ReschedulePolicy,
    Resources,
    RestartPolicy,
    Service,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
    UpdateStrategy,
    VolumeRequest,
)

from .hcl import Attr, Block, ParseError


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")
_DUR_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
              "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(v: Any, default: float = 0.0) -> float:
    """Go-style duration string ("1h30m", "500ms", bare seconds) -> seconds."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if not s:
        return default
    if re.fullmatch(r"-?\d+(\.\d+)?", s):
        return float(s)
    total = 0.0
    pos = 0
    neg = s.startswith("-")
    if neg:
        pos = 1
    for m in _DUR_RE.finditer(s, pos):
        if m.start() != pos:
            raise ParseError(f"invalid duration {v!r}")
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ParseError(f"invalid duration {v!r}")
    return -total if neg else total


_OPERAND_ALIASES = {
    "=": OP_EQ, "==": OP_EQ, "is": OP_EQ,
    "!=": "!=", "not": "!=",
    "regexp": OP_REGEX, "version": OP_VERSION, "semver": OP_SEMVER,
    "set_contains": OP_SET_CONTAINS,
    "set_contains_all": OP_SET_CONTAINS_ALL,
    "set_contains_any": OP_SET_CONTAINS_ANY,
    "distinct_hosts": OP_DISTINCT_HOSTS,
    "distinct_property": OP_DISTINCT_PROPERTY,
    "is_set": OP_IS_SET, "is_not_set": OP_IS_NOT_SET,
    "<": "<", "<=": "<=", ">": ">", ">=": ">=",
}


class _B:
    """Evaluated view of a block body: attrs dict + child blocks."""

    def __init__(self, attrs: Dict[str, Any], blocks: List["_EB"]):
        self.attrs = attrs
        self.blocks = blocks

    def get(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def dur(self, name: str, default: float = 0.0) -> float:
        return parse_duration(self.attrs.get(name), default)

    def children(self, type_: str) -> List["_EB"]:
        return [b for b in self.blocks if b.type == type_]

    def child(self, type_: str) -> Optional["_EB"]:
        bs = self.children(type_)
        return bs[0] if bs else None


class _EB(_B):
    def __init__(self, type_: str, labels: List[str],
                 attrs: Dict[str, Any], blocks: List["_EB"]):
        super().__init__(attrs, blocks)
        self.type = type_
        self.labels = labels

    @property
    def label(self) -> str:
        return self.labels[0] if self.labels else ""


def eval_body(body: List[Any], evaluator) -> _B:
    """Evaluate attrs, expand `dynamic` blocks, recurse into children."""
    attrs: Dict[str, Any] = {}
    blocks: List[_EB] = []
    for item in body:
        if isinstance(item, Attr):
            attrs[item.name] = evaluator.evaluate(item.expr)
        elif isinstance(item, Block):
            if item.type == "dynamic":
                blocks.extend(_expand_dynamic(item, evaluator))
            else:
                sub = eval_body(item.body, evaluator)
                blocks.append(_EB(item.type, item.labels, sub.attrs, sub.blocks))
    return _B(attrs, blocks)


def _expand_dynamic(blk: Block, evaluator) -> List[_EB]:
    """`dynamic "tag" { for_each = ...  labels = [...]  content { ... } }`"""
    from .hcl import Evaluator
    name = blk.labels[0] if blk.labels else ""
    for_each: Any = []
    iterator = name
    labels_expr = None
    content_block = None
    # only for_each/iterator are evaluated with the OUTER context; labels
    # and content see the per-iteration variable.
    for item in blk.body:
        if isinstance(item, Attr):
            if item.name == "for_each":
                for_each = evaluator.evaluate(item.expr)
            elif item.name == "iterator":
                iterator = str(evaluator.evaluate(item.expr))
            elif item.name == "labels":
                labels_expr = item.expr
        elif isinstance(item, Block) and item.type == "content":
            content_block = item
    out: List[_EB] = []
    items = for_each.items() if isinstance(for_each, dict) \
        else enumerate(for_each or [])
    for k, v in items:
        sub_ctx = evaluator.ctx.child({iterator: {"key": k, "value": v}})
        sub_ev = Evaluator(sub_ctx, evaluator.keep_unknown)
        labels = [str(x) for x in sub_ev.evaluate(labels_expr)] \
            if labels_expr is not None else []
        if content_block is not None:
            sub = eval_body(content_block.body, sub_ev)
            out.append(_EB(name, labels, sub.attrs, sub.blocks))
    return out


# ---------------------------------------------------------------------------
# block -> struct converters
# ---------------------------------------------------------------------------


def _constraints(b: _B) -> List[Constraint]:
    out = []
    for c in b.children("constraint"):
        operand = str(c.get("operator", OP_EQ))
        operand = _OPERAND_ALIASES.get(operand, operand)
        lt = str(c.get("attribute", ""))
        rt = c.get("value", "")
        # sugar: `constraint { distinct_hosts = true }` etc.
        for sugar in (OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY,
                      OP_VERSION, OP_SEMVER, OP_REGEX, OP_SET_CONTAINS):
            if c.get(sugar) is not None:
                operand = sugar
                v = c.get(sugar)
                if sugar == OP_DISTINCT_HOSTS:
                    rt = ""
                elif sugar == OP_DISTINCT_PROPERTY:
                    lt = str(v)
                    rt = str(c.get("value", ""))
                else:
                    rt = str(v)
        out.append(Constraint(ltarget=lt, operand=operand,
                              rtarget=_to_str(rt)))
    return out


def _to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _affinities(b: _B) -> List[Affinity]:
    out = []
    for a in b.children("affinity"):
        operand = str(a.get("operator", OP_EQ))
        out.append(Affinity(
            ltarget=str(a.get("attribute", "")),
            operand=_OPERAND_ALIASES.get(operand, operand),
            rtarget=_to_str(a.get("value", "")),
            weight=int(a.get("weight", 50))))
    return out


def _spreads(b: _B) -> List[Spread]:
    out = []
    for s in b.children("spread"):
        targets = tuple(
            SpreadTarget(value=t.label or str(t.get("value", "")),
                         percent=int(t.get("percent", 0)))
            for t in s.children("target"))
        out.append(Spread(attribute=str(s.get("attribute", "")),
                          weight=int(s.get("weight", 50)),
                          targets=targets))
    return out


def _update(b: Optional[_EB]) -> Optional[UpdateStrategy]:
    if b is None:
        return None
    u = UpdateStrategy()
    u.stagger_s = b.dur("stagger", u.stagger_s)
    u.max_parallel = int(b.get("max_parallel", u.max_parallel))
    u.health_check = str(b.get("health_check", u.health_check))
    u.min_healthy_time_s = b.dur("min_healthy_time", u.min_healthy_time_s)
    u.healthy_deadline_s = b.dur("healthy_deadline", u.healthy_deadline_s)
    u.progress_deadline_s = b.dur("progress_deadline", u.progress_deadline_s)
    u.auto_revert = bool(b.get("auto_revert", u.auto_revert))
    u.auto_promote = bool(b.get("auto_promote", u.auto_promote))
    u.canary = int(b.get("canary", u.canary))
    return u


def _migrate(b: Optional[_EB]) -> MigrateStrategy:
    m = MigrateStrategy()
    if b is None:
        return m
    m.max_parallel = int(b.get("max_parallel", m.max_parallel))
    m.health_check = str(b.get("health_check", m.health_check))
    m.min_healthy_time_s = b.dur("min_healthy_time", m.min_healthy_time_s)
    m.healthy_deadline_s = b.dur("healthy_deadline", m.healthy_deadline_s)
    return m


def _restart(b: Optional[_EB], job_type: str) -> RestartPolicy:
    # reference defaults differ per type (batch: 3 attempts / 24h interval)
    if job_type == "batch":
        r = RestartPolicy(attempts=3, interval_s=86400.0, delay_s=15.0)
    else:
        r = RestartPolicy(attempts=2, interval_s=1800.0, delay_s=15.0)
    if b is None:
        return r
    r.attempts = int(b.get("attempts", r.attempts))
    r.interval_s = b.dur("interval", r.interval_s)
    r.delay_s = b.dur("delay", r.delay_s)
    r.mode = str(b.get("mode", r.mode))
    return r


def _reschedule(b: Optional[_EB], job_type: str) -> Optional[ReschedulePolicy]:
    if b is None:
        return None
    if job_type == "batch":
        r = ReschedulePolicy(attempts=1, interval_s=86400.0, delay_s=5.0,
                             delay_function="constant", unlimited=False)
    else:
        r = ReschedulePolicy(attempts=0, interval_s=0.0, delay_s=30.0,
                             delay_function="exponential",
                             max_delay_s=3600.0, unlimited=True)
    r.attempts = int(b.get("attempts", r.attempts))
    r.interval_s = b.dur("interval", r.interval_s)
    r.delay_s = b.dur("delay", r.delay_s)
    r.delay_function = str(b.get("delay_function", r.delay_function))
    r.max_delay_s = b.dur("max_delay", r.max_delay_s)
    if b.get("unlimited") is not None:
        r.unlimited = bool(b.get("unlimited"))
    return r


def _network(b: _EB) -> NetworkResource:
    n = NetworkResource(mode=str(b.get("mode", "host")),
                        mbits=int(b.get("mbits", 0)))
    for p in b.children("port"):
        port = Port(label=p.label,
                    value=int(p.get("static", 0)),
                    to=int(p.get("to", 0)),
                    host_network=str(p.get("host_network", "default")))
        if port.value:
            n.reserved_ports.append(port)
        else:
            n.dynamic_ports.append(port)
    return n


def _service(b: _EB) -> Service:
    checks = []
    for c in b.children("check"):
        chk: Dict[str, Any] = dict(c.attrs)
        for dur_field in ("interval", "timeout"):
            if dur_field in chk:
                chk[dur_field] = parse_duration(chk[dur_field])
        checks.append(chk)
    return Service(
        name=str(b.get("name", b.label)),
        port_label=_to_str(b.get("port", "")),
        provider=str(b.get("provider", "consul")),
        tags=[str(t) for t in b.get("tags", [])],
        checks=checks)


def _resources(b: Optional[_EB]) -> Resources:
    r = Resources()
    if b is None:
        return r
    r.cpu = int(b.get("cpu", r.cpu))
    r.memory_mb = int(b.get("memory", r.memory_mb))
    r.memory_max_mb = int(b.get("memory_max", 0))
    r.disk_mb = int(b.get("disk", 0))
    for nb in b.children("network"):
        r.networks.append(_network(nb))
    for db in b.children("device"):
        r.devices.append(RequestedDevice(
            name=db.label,
            count=int(db.get("count", 1)),
            constraints=_constraints(db),
            affinities=_affinities(db)))
    return r


def _task(b: _EB, job_type: str) -> Task:
    t = Task(name=b.label or "task")
    t.driver = str(b.get("driver", "exec"))
    cfg = b.child("config")
    if cfg is not None:
        t.config = _block_to_dict(cfg)
    envb = b.child("env")
    if envb is not None:
        t.env = {k: _to_str(v) for k, v in envb.attrs.items()}
    t.resources = _resources(b.child("resources"))
    t.constraints = _constraints(b)
    t.affinities = _affinities(b)
    t.services = [_service(s) for s in b.children("service")]
    t.leader = bool(b.get("leader", False))
    t.kill_timeout_s = b.dur("kill_timeout", 5.0)
    for a in b.children("artifact"):
        art = dict(a.attrs)
        opts = a.child("options")
        if opts is not None:
            art["options"] = dict(opts.attrs)
        t.artifacts.append(art)
    for tpl in b.children("template"):
        tp = dict(tpl.attrs)
        for dur_field in ("splay", "wait"):
            if dur_field in tp:
                tp[dur_field] = parse_duration(tp[dur_field])
        t.templates.append(tp)
    v = b.child("vault")
    if v is not None:
        t.vault = dict(v.attrs)
    lc = b.child("lifecycle")
    if lc is not None:
        t.lifecycle = {"hook": str(lc.get("hook", "")),
                       "sidecar": bool(lc.get("sidecar", False))}
    dp = b.child("dispatch_payload")
    if dp is not None:
        t.dispatch_payload_file = str(dp.get("file", ""))
    return t


def _block_to_dict(b: _B) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(b.attrs)
    for child in b.blocks:
        d = _block_to_dict(child)
        if child.labels:
            out.setdefault(child.type, {})[child.label] = d
        else:
            existing = out.get(child.type)
            if isinstance(existing, list):
                existing.append(d)
            else:
                out[child.type] = [d]
    return out


def _group(b: _EB, job: Job) -> TaskGroup:
    g = TaskGroup(name=b.label or "group")
    g.count = int(b.get("count", 1))
    g.constraints = _constraints(b)
    g.affinities = _affinities(b)
    g.spreads = _spreads(b)
    g.restart_policy = _restart(b.child("restart"), job.type)
    g.reschedule_policy = _reschedule(b.child("reschedule"), job.type)
    g.migrate = _migrate(b.child("migrate"))
    g.update = _update(b.child("update")) or job.update
    ed = b.child("ephemeral_disk")
    if ed is not None:
        g.ephemeral_disk = EphemeralDisk(
            size_mb=int(ed.get("size", 300)),
            sticky=bool(ed.get("sticky", False)),
            migrate=bool(ed.get("migrate", False)))
    for nb in b.children("network"):
        g.networks.append(_network(nb))
    for vb in b.children("volume"):
        g.volumes[vb.label] = VolumeRequest(
            name=vb.label,
            type=str(vb.get("type", "host")),
            source=str(vb.get("source", "")),
            read_only=bool(vb.get("read_only", False)),
            access_mode=str(vb.get("access_mode", "")),
            attachment_mode=str(vb.get("attachment_mode", "")),
            per_alloc=bool(vb.get("per_alloc", False)))
    g.services = [_service(s) for s in b.children("service")]
    mcd = b.get("max_client_disconnect")
    if mcd is not None:
        g.max_client_disconnect_s = parse_duration(mcd)
    for tb in b.children("task"):
        g.tasks.append(_task(tb, job.type))
    return g


def job_from_block(b: _EB) -> Job:
    job = Job(id=b.label, name=b.label)
    job.region = str(b.get("region", "global"))
    job.namespace = str(b.get("namespace", "default"))
    job.type = str(b.get("type", "service"))
    job.priority = int(b.get("priority", 50))
    job.all_at_once = bool(b.get("all_at_once", False))
    job.datacenters = [str(d) for d in b.get("datacenters", ["dc1"])]
    job.node_pool = str(b.get("node_pool", "default"))
    meta = b.child("meta")
    if meta is not None:
        job.meta = {k: _to_str(v) for k, v in meta.attrs.items()}
    job.constraints = _constraints(b)
    job.affinities = _affinities(b)
    job.spreads = _spreads(b)
    job.update = _update(b.child("update"))
    p = b.child("periodic")
    if p is not None:
        spec = str(p.get("cron", p.get("crontab", "")))
        job.periodic = PeriodicConfig(
            enabled=bool(p.get("enabled", True)),
            spec=spec,
            prohibit_overlap=bool(p.get("prohibit_overlap", False)),
            timezone=str(p.get("time_zone", "UTC")))
        job.type = job.type if job.type != "service" else "batch"
    pz = b.child("parameterized")
    if pz is not None:
        job.parameterized = ParameterizedJobConfig(
            payload=str(pz.get("payload", "optional")),
            meta_required=[str(x) for x in pz.get("meta_required", [])],
            meta_optional=[str(x) for x in pz.get("meta_optional", [])])
    mr = b.child("multiregion")
    if mr is not None:
        strategy = mr.child("strategy")
        job.multiregion = Multiregion(
            strategy=dict(strategy.attrs) if strategy else {},
            regions=[{"name": r.label, **r.attrs}
                     for r in mr.children("region")])
    for gb in b.children("group"):
        job.task_groups.append(_group(gb, job))
    if not job.task_groups:
        raise ParseError(f"job {job.id!r} has no task groups")
    return job
