"""Agent configuration files (reference: command/agent/config.go +
config_parse.go — the HCL agent config plane of SURVEY §6.6a).

Supported shape (a practical subset of the reference's):

    bind_addr = "127.0.0.1"
    log_level = "debug"     # producer-side LogRing min_level gate
    ports { http = 4646 }
    server {
      enabled         = true
      num_schedulers  = 2
      heartbeat_ttl   = "30s"
      acl_enabled     = false
      transport       = "tcp"      # or "sim"  (chaos/)
      clock           = "wall"     # or "virtual"
      device_executor = "torch"    # or "bridge" (ops/executor.py)
      profile_hz      = 19         # host sampler rate; 0 disables
      scheduler_workers = 2        # alias of num_schedulers
      worker_mode     = "thread"   # or "process" (core/workerpool.py)
      slo {                        # health watchdog (core/flightrec.py)
        p99_plan_queue_ms   = 500
        refute_rate         = 0.25
        invalidations_per_s = 50
        networked_ratio     = 0.25
        heartbeat_misses    = 64
        window_s            = 60
        interval_s          = 5
      }
    }
    client {
      enabled    = true
      count      = 2            # in-process client nodes (dev topology)
      node_class = "compute"
      datacenter = "dc1"
      meta { rack = "r1" }
    }
    acl { enabled = true }

Multiple `-config` files merge left to right; CLI flags win last
(reference: config merge order).

Differences from the reference (nomad_tpu/agent_config.py): the
`device_executor` knob defaults to "torch" and accepts "torch" and
"bridge", as the port's `ops.executor.make_executor` names them; "jax"
is an unknown value and raises ValueError here.  "bridge" builds the
native CUDA library's executor when the Server is built (and raises
there on a mesh or on the CPU)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class AgentConfig:
    bind_addr: str = "127.0.0.1"
    http_port: int = 4646
    log_level: str = "info"
    # scheduling domain (reference: the top-level `region` agent option)
    region: str = "global"
    server_enabled: bool = True
    num_workers: int = 1
    # scheduler worker plane (core/workerpool.py): "thread" (default)
    # keeps workers as in-process threads; "process" runs the batchable
    # scheduler types in num_workers spawned processes over replica
    # state, with device work funneled to the parent-owned executor.
    # Thread mode is required for clock = "virtual".
    worker_mode: str = "thread"
    heartbeat_ttl: float = 30.0
    client_enabled: bool = True
    client_count: int = 1
    node_class: str = ""
    datacenter: str = "dc1"
    client_meta: Dict[str, str] = field(default_factory=dict)
    acl_enabled: bool = False
    # cluster shared secret: AES-256-GCM encryption + authentication of
    # every server-plane wire frame (reference: the serf `encrypt`
    # gossip key); empty = plaintext (dev)
    encrypt: str = ""
    # cluster-plane seams (chaos/): "tcp" speaks real sockets
    # on the wall clock (production default); "sim"/"virtual" route the
    # same wire frames through the in-process SimNetwork/VirtualClock
    # so fault-injection scenarios are a config choice, not a
    # test-only monkeypatch
    transport: str = "tcp"
    clock: str = "wall"
    # device-executor backend for the scheduling workers'
    # wave launches (ops/executor.py): "torch" runs the hand-written
    # CUDA kernels on resident device tensors; "bridge" runs them through
    # the native CUDA library (native/bridge.py), and errors at agent
    # start where it cannot run (never a silent fallback)
    device_executor: str = "torch"
    # continuous-profiling sampler rate (core/profiling.py): the host
    # stack sampler is always-on at profiling.DEFAULT_HZ when this is
    # None; a positive value re-tunes it and <= 0 disables it
    profile_hz: Optional[float] = None
    # health-watchdog SLO thresholds (core/flightrec.py DEFAULT_SLO);
    # only the keys present here override the defaults, and a negative
    # threshold disables its rule
    slo: Dict[str, float] = field(default_factory=dict)
    # read-path follower mode (core/fanout.py ReadFollower): a
    # comma-separated list of upstream HTTP addresses whose journal this
    # agent tails via /v1/operator/export, serving stale-bounded reads
    # locally.  Exclusive with cluster mode; empty = normal agent.
    follow: str = ""

    def merge(self, other: "AgentConfig",
              set_fields: set) -> "AgentConfig":
        """Fields explicitly set in `other` override self."""
        import dataclasses
        out = dataclasses.replace(self)
        for f in set_fields:
            setattr(out, f, getattr(other, f))
        return out


_BLOCK_KEYS = {
    "ports": {"http"},
    "server": {"enabled", "num_schedulers", "scheduler_workers",
               "worker_mode", "heartbeat_ttl",
               "acl_enabled", "transport", "clock", "device_executor",
               "profile_hz"},
    "client": {"enabled", "count", "node_class", "datacenter"},
    "acl": {"enabled"},
}


def parse_agent_config(src: str):
    """HCL text -> (AgentConfig, set of explicitly-set field names)."""
    from nomad_tpu_torch.jobspec.hcl import Attr, Block, parse
    from nomad_tpu_torch.acl.policy import _literal

    cfg = AgentConfig()
    set_fields: set = set()

    def put(field_name: str, value: Any) -> None:
        setattr(cfg, field_name, value)
        set_fields.add(field_name)

    for node in parse(src):
        if isinstance(node, Attr):
            v = _literal(node.expr)
            if node.name == "bind_addr":
                put("bind_addr", str(v))
            elif node.name == "log_level":
                level = str(v).lower()
                from nomad_tpu_torch.core.logging import LEVELS
                if level not in LEVELS:
                    raise ValueError(
                        f"log_level must be one of {sorted(LEVELS)}, "
                        f"got {level!r}")
                put("log_level", level)
            elif node.name == "encrypt":
                put("encrypt", str(v))
            elif node.name == "region":
                put("region", str(v))
            elif node.name == "follow":
                put("follow", str(v))
            else:
                raise ValueError(f"unknown agent setting {node.name!r}")
        elif isinstance(node, Block):
            body = {a.name: _literal(a.expr) for a in node.body
                    if isinstance(a, Attr)}
            sub_blocks = [b for b in node.body if isinstance(b, Block)]
            known = _BLOCK_KEYS.get(node.type)
            if known is not None:
                for key in body:
                    if key not in known:
                        raise ValueError(
                            f"unknown {node.type} setting {key!r}")
            if node.type == "ports":
                if "http" in body:
                    put("http_port", int(body["http"]))
            elif node.type == "server":
                if "enabled" in body:
                    put("server_enabled", bool(body["enabled"]))
                if "num_schedulers" in body:
                    put("num_workers", int(body["num_schedulers"]))
                if "scheduler_workers" in body:
                    # preferred name (the reference's num_schedulers is
                    # kept as an alias); later key wins like any merge
                    put("num_workers", int(body["scheduler_workers"]))
                if "worker_mode" in body:
                    v = str(body["worker_mode"])
                    if v not in ("thread", "process"):
                        raise ValueError(
                            "server worker_mode must be 'thread' or "
                            f"'process', got {v!r}")
                    put("worker_mode", v)
                if "heartbeat_ttl" in body:
                    from nomad_tpu_torch.jobspec.schema import parse_duration
                    put("heartbeat_ttl",
                        parse_duration(body["heartbeat_ttl"], 30.0))
                if "acl_enabled" in body:
                    put("acl_enabled", bool(body["acl_enabled"]))
                if "transport" in body:
                    v = str(body["transport"])
                    if v not in ("tcp", "sim"):
                        raise ValueError(
                            f"server transport must be 'tcp' or 'sim', "
                            f"got {v!r}")
                    put("transport", v)
                if "clock" in body:
                    v = str(body["clock"])
                    if v not in ("wall", "virtual"):
                        raise ValueError(
                            f"server clock must be 'wall' or 'virtual', "
                            f"got {v!r}")
                    put("clock", v)
                if "device_executor" in body:
                    v = str(body["device_executor"])
                    # the names ops.executor.make_executor takes; literal so
                    # config parsing never imports the torch stack
                    if v not in ("torch", "bridge"):
                        raise ValueError(
                            "server device_executor must be 'torch' or "
                            f"'bridge', got {v!r}")
                    put("device_executor", v)
                if "profile_hz" in body:
                    v = body["profile_hz"]
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        raise ValueError(
                            f"server profile_hz must be a number, "
                            f"got {v!r}")
                    put("profile_hz", float(v))
                for b in sub_blocks:
                    if b.type != "slo":
                        raise ValueError(
                            f"unknown server block {b.type!r}")
                    # mirror core.flightrec.DEFAULT_SLO; literal so
                    # config parsing stays import-light
                    known_slo = {"p99_plan_queue_ms", "refute_rate",
                                 "invalidations_per_s",
                                 "networked_ratio", "heartbeat_misses",
                                 "rss_mb", "window_s", "interval_s",
                                 "cluster_scrape_failures",
                                 "cluster_follower_lag",
                                 "cluster_heartbeat_misses"}
                    slo = {}
                    for a in b.body:
                        if not isinstance(a, Attr):
                            raise ValueError("slo accepts only "
                                             "key = number settings")
                        if a.name not in known_slo:
                            raise ValueError(
                                f"unknown slo setting {a.name!r} "
                                f"(expected one of {sorted(known_slo)})")
                        v = _literal(a.expr)
                        if isinstance(v, bool) or not isinstance(
                                v, (int, float)):
                            raise ValueError(
                                f"slo {a.name} must be a number, "
                                f"got {v!r}")
                        slo[a.name] = float(v)
                    put("slo", slo)
            elif node.type == "client":
                if "enabled" in body:
                    put("client_enabled", bool(body["enabled"]))
                if "count" in body:
                    put("client_count", int(body["count"]))
                if "node_class" in body:
                    put("node_class", str(body["node_class"]))
                if "datacenter" in body:
                    put("datacenter", str(body["datacenter"]))
                for b in sub_blocks:
                    if b.type == "meta":
                        meta = {a.name: str(_literal(a.expr))
                                for a in b.body if isinstance(a, Attr)}
                        put("client_meta", meta)
            elif node.type == "acl":
                if "enabled" in body:
                    put("acl_enabled", bool(body["enabled"]))
            else:
                raise ValueError(f"unknown agent block {node.type!r}")
    return cfg, set_fields


def load_agent_config(paths: List[str]) -> AgentConfig:
    """Merge config files left to right (later files win)."""
    cfg = AgentConfig()
    for path in paths:
        with open(path) as f:
            parsed, set_fields = parse_agent_config(f.read())
        cfg = cfg.merge(parsed, set_fields)
    return cfg
