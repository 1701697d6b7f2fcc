"""Agent: one process running server and/or client plus the HTTP API
(reference: command/agent/agent.go; `-dev` runs both).

Differences from the reference (nomad_tpu/agent.py), because the port
runs on PyTorch and CUDA:
  - `device=None` is a keyword the reference lacks.  It is forwarded to
    the `Server` (or, in cluster mode, the `ClusterServer`):
    CUDA unless given, raising when CUDA is absent.  Tests pass
    `device="cpu"`;
  - `device_executor="torch"` is the default (the Server's rule:
    "bridge" runs the native CUDA library, and raises on a mesh or on
    the CPU; any other name raises ValueError).
A `plugin_dir` for the clients and `worker_mode="process"` are the
reference's (the port's `plugins/` and `core/workerpool.py`).
Cluster mode (`server_name`, `join`, `bootstrap_expect > 1`), the read
follower (`follow`), a non-empty `encrypt` and the transport and
federation wiring are the reference's, as are `start`, `shutdown`,
`address`, `stats`, `_refresh_gauges` and `metrics`."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.api.http_server import HTTPAPIServer
from nomad_tpu_torch.client.client import Client, InProcessRPC
from nomad_tpu_torch.core.server import Server
from nomad_tpu_torch.structs import Node


class Agent:
    def __init__(self, server_enabled: bool = True,
                 client_enabled: bool = True,
                 num_clients: int = 1,
                 num_workers: int = 1,
                 http_host: str = "127.0.0.1",
                 http_port: int = 0,
                 heartbeat_ttl: float = 30.0,
                 acl_enabled: bool = False,
                 nodes: Optional[List[Node]] = None,
                 server_name: str = "",
                 bootstrap_expect: int = 1,
                 join: Optional[List] = None,
                 rpc_port: int = 0, raft_port: int = 0, serf_port: int = 0,
                 data_dir: Optional[str] = None,
                 plugin_dir: str = "",
                 encrypt: str = "",
                 region: str = "global",
                 join_wan: Optional[List[str]] = None,
                 join_wan_token: str = "",
                 transport: str = "tcp",
                 clock: str = "wall",
                 log_level: str = "",
                 device_executor: str = "torch",
                 slo: Optional[Dict[str, float]] = None,
                 profile_hz: Optional[float] = None,
                 worker_mode: str = "thread",
                 follow: str = "",
                 device=None) -> None:
        # producer-side log gate (agent_config log_level): records below
        # this level never reach the ring or its subscribers.  Only set
        # when explicitly configured — the process-wide ring default
        # ("trace") must survive embedded/test agents
        if log_level:
            from nomad_tpu_torch.core.logging import LEVELS, RING
            if log_level not in LEVELS:
                raise ValueError(f"unknown log_level {log_level!r} "
                                 f"(expected one of {sorted(LEVELS)})")
            RING.min_level = log_level
        # cluster shared secret: encrypt + authenticate every server-plane
        # wire frame (raft/gossip/RPC) — core/wire.py.  The key is
        # process-global (one cluster per process): set_key raises on a
        # conflicting non-empty key, and a plaintext agent in a keyed
        # process is a loud config error — neither silent inheritance of
        # the old key nor a silent downgrade that would strip encryption
        # out from under the running cluster.
        from nomad_tpu_torch.core import wire
        if encrypt:
            wire.set_key(encrypt)
        elif wire.has_key():
            raise ValueError(
                "this process already has a cluster encrypt key installed; "
                "in-process agents must share it (pass the same encrypt "
                "value, or reset deliberately with wire.set_key(None))")
        if not server_enabled:
            raise NotImplementedError(
                "client-only agents need a remote RPC transport; "
                "in-process agents always embed the server")
        # every client needs a writable sandbox for task dirs, logs, and
        # the restart-survival state db (reference: agent data_dir,
        # defaulting instead of silently running sandboxless)
        self._owns_data_dir = not data_dir
        if not data_dir:
            import tempfile
            data_dir = tempfile.mkdtemp(prefix="nomad-tpu-agent-")
        self.data_dir = data_dir
        # cluster-plane seams (agent_config server { transport, clock }):
        # "sim"/"virtual" put this agent's whole server plane on the
        # process-shared SimNetwork/VirtualClock — fault injection by
        # config, not by test-only monkeypatching.  Transport/Clock
        # instances pass through for embedding scenarios directly.
        from nomad_tpu_torch.chaos import resolve_clock, resolve_transport
        self.clock = resolve_clock(clock)
        # read-follower role (core/fanout.ReadFollower): `follow` is a
        # comma-separated candidate list of upstream HTTP addresses.  A
        # follower embeds a normal server whose store is the replica
        # target, but NEVER establishes leadership (no schedulers, no
        # tick-driven expiry — replicated writes land via apply_export)
        # and runs no clients (an in-process client would write to the
        # non-authoritative local store).  Writes proxy to the upstream
        # through the HTTP router.  ACL/variable tables only replicate
        # via full exports, so follower mode pairs with the upstream's
        # enforcement (writes + consistent reads) rather than local ACLs.
        self.follow = [u.strip() for u in follow.split(",") if u.strip()]
        self.follower = None
        if self.follow:
            if server_name or join or bootstrap_expect > 1:
                raise ValueError("follow= is exclusive with cluster mode "
                                 "(a raft member replicates via raft)")
            client_enabled = False
        cluster_mode = bool(server_name or join or bootstrap_expect > 1)
        if cluster_mode:
            # multi-server: raft-replicated state + gossip membership
            # (reference: server { bootstrap_expect, server_join })
            from .core.cluster import ClusterServer
            import uuid
            seeds = []
            for s in (join or []):
                if not isinstance(s, str):
                    seeds.append((str(s[0]), int(s[1])))
                    continue
                host, sep, port = s.rpartition(":")
                if not sep or not port.isdigit():
                    raise ValueError(
                        f"-join expects host:port, got {s!r}")
                seeds.append((host, int(port)))
            name = server_name or f"server-{uuid.uuid4().hex[:8]}"
            self.transport = resolve_transport(transport, node_name=name,
                                               clock=self.clock)
            self.server = ClusterServer(
                name,
                rpc_port=rpc_port, raft_port=raft_port, serf_port=serf_port,
                join=seeds, data_dir=data_dir,
                bootstrap_expect=bootstrap_expect,
                num_workers=num_workers, heartbeat_ttl=heartbeat_ttl,
                acl_enabled=acl_enabled,
                transport=self.transport, clock=self.clock,
                device_executor=device_executor, slo=slo,
                profile_hz=profile_hz, worker_mode=worker_mode,
                device=device)
        else:
            self.transport = resolve_transport(transport, node_name="agent",
                                               clock=self.clock)
            self.server = Server(num_workers=num_workers, dev_mode=False,
                                 heartbeat_ttl=heartbeat_ttl,
                                 acl_enabled=acl_enabled, clock=self.clock,
                                 device_executor=device_executor,
                                 slo=slo, profile_hz=profile_hz,
                                 worker_mode=worker_mode, device=device)
        self.clients: List[Client] = []
        if client_enabled:
            if cluster_mode:
                # in cluster mode the local server may be a follower (or
                # mid-election): clients go through the TCP RPC, which
                # forwards writes to the leader and retries transitions
                from .core.cluster import RemoteRPC
                # same transport as the server plane: under "sim" the
                # clients' RPC frames ride the simulated fabric too
                rpc = RemoteRPC([self.server.rpc.addr],
                                transport=self.transport,
                                clock=self.clock)
            else:
                rpc = InProcessRPC(self.server)
            import os
            for i in range(num_clients):
                node = nodes[i] if nodes and i < len(nodes) else None
                cdir = os.path.join(data_dir, f"client{i}")
                os.makedirs(cdir, exist_ok=True)
                self.clients.append(Client(rpc, node=node, data_dir=cdir,
                                           plugin_dir=plugin_dir))
        if self.follow:
            from nomad_tpu_torch.core.fanout import ReadFollower
            self.follower = ReadFollower(self.server.state, self.clock,
                                         self.follow)
        self.http = HTTPAPIServer(self, host=http_host, port=http_port)
        if cluster_mode:
            # cluster-scope metric federation (core/federation.py): the
            # gossip meta carries each server's HTTP address (the meta
            # dict is shared by reference with the local Member, so the
            # mutation rides every subsequent ping/sync), and the leader
            # side of Server.tick drives the puller.  Distinct from the
            # multi-REGION federation below: this one is intra-cluster.
            from nomad_tpu_torch.core.federation import FederationPuller
            self.server.gossip.meta["http"] = self.address
            self.server.federation = FederationPuller(
                self.server.name,
                targets=self._federation_targets,
                clock=self.clock,
                state=self.server.state)
        if self.follower is not None:
            # announce this read follower to whichever upstream it pulls
            # from, so the leader's puller scrapes it too (follower lag
            # rides the cluster SLO rules)
            port = self.address.rsplit(":", 1)[-1]
            self.follower.announce = (f"follower-{port}", self.address)
        # multi-region federation (reference: nomad/regions.go + WAN serf):
        # this agent's region + the push-pull address table; ?region=X
        # requests proxy through it (api/http_server.Router.route)
        from .core.regions import RegionFederation
        self.server.region = region
        self.federation = RegionFederation(region)
        self.federation.set_self_url(self.address)
        self._join_wan = list(join_wan or [])
        self._join_wan_token = join_wan_token
        self._started_at = time.time()

    # ------------------------------------------------------------ control

    def start(self) -> "Agent":
        if self.follower is not None:
            # follower role: serve reads, never schedule — leadership
            # stays with the upstream (establish=False keeps the broker,
            # plan queue, and blocked-eval machinery disabled)
            self.server.start(establish=False)
            self.follower.start()
        else:
            self.server.start()
        for c in self.clients:
            c.start()
        self.http.start()
        for peer in self._join_wan:
            self.federation.join(peer, token=self._join_wan_token)
        return self

    def shutdown(self) -> None:
        if self.follower is not None:
            self.follower.stop()
        self.http.shutdown()
        for c in self.clients:
            c.shutdown()
        self.server.shutdown()
        if self._owns_data_dir:
            # the default sandbox was ours to provision, so it is ours to
            # clean (task dirs can hold secret-bearing files)
            import shutil
            shutil.rmtree(self.data_dir, ignore_errors=True)

    @property
    def address(self) -> str:
        return self.http.addr

    def _federation_targets(self) -> List:
        """Gossip-derived (origin, http-url) scrape targets for the
        metric-federation puller (peers whose agents published an HTTP
        address into their gossip meta)."""
        out = []
        for name, m in sorted(self.server.gossip.alive_members().items()):
            url = (m.meta or {}).get("http")
            if url:
                out.append((name, url))
        return out

    # -------------------------------------------------------------- intro

    def stats(self) -> Dict:
        s = self.server
        out = {
            "uptime_s": round(time.time() - self._started_at, 1),
            "state_index": s.state.latest_index(),
            "broker": dict(s.eval_broker.stats),
            "workers": [dict(w.stats) for w in s.workers],
            "plan_queue_depth_peak": s.plan_queue.stats["depth_peak"],
            "clients": len(self.clients),
            "threads": threading.active_count(),
        }
        if self.follower is not None:
            out["follower"] = self.follower.stats()
        return out

    def _refresh_gauges(self) -> None:
        """Point-in-time gauges the registry cannot accumulate itself.
        State sizes come from `state.counts()` — NOT a snapshot; a
        Prometheus-style 1s scrape must not COW-mark every store table
        on the hot path."""
        from nomad_tpu_torch.core.telemetry import REGISTRY
        s = self.server
        REGISTRY.set_gauge("nomad.broker.total_ready",
                           s.eval_broker.pending_evals())
        REGISTRY.set_gauge("nomad.blocked_evals.total_blocked",
                           s.blocked_evals.num_blocked())
        REGISTRY.set_gauge("nomad.plan.queue_depth", s.plan_queue.depth())
        REGISTRY.set_gauge("nomad.plan.queue_depth_peak",
                           s.plan_queue.stats["depth_peak"])
        counts = s.state.counts()
        REGISTRY.set_gauge("nomad.state.nodes", counts["nodes"])
        REGISTRY.set_gauge("nomad.state.jobs", counts["jobs"])
        REGISTRY.set_gauge("nomad.state.evals", counts["evals"])
        # scheduling-quality gauges from the store's incremental ledger
        # (O(nodes in use); no COW-marking snapshot) — scrape-time
        # refresh so the series is current even between plan commits
        from nomad_tpu_torch.core.plan_apply import publish_quality
        publish_quality(s.state)
        timers = getattr(s, "stage_timers", None)
        if timers is not None:
            rep = timers.report()
            for pair, secs in rep["overlap_s"].items():
                key = pair.replace("*", "_")
                REGISTRY.set_gauge(f"nomad.wavepipe.overlap.{key}_s",
                                   secs)

    def metrics(self, format: str = ""):
        """Load-bearing series per SURVEY.md §6.5.  Default: a flat JSON
        dict (legacy keys + registry counters/gauges and histogram
        p50/p95/p99 summaries).  `format="prometheus"` renders the full
        registry as text exposition instead."""
        from nomad_tpu_torch.core.telemetry import REGISTRY
        s = self.server
        self._refresh_gauges()
        if format == "prometheus":
            return REGISTRY.prometheus()
        counts = s.state.counts()
        out = {
            "nomad.broker.total_ready": s.eval_broker.pending_evals(),
            "nomad.broker.acked": s.eval_broker.stats["acked"],
            "nomad.broker.nacked": s.eval_broker.stats["nacked"],
            "nomad.broker.failed": s.eval_broker.stats["failed"],
            "nomad.blocked_evals.total_blocked":
                s.blocked_evals.num_blocked(),
            "nomad.plan.queue_depth": s.plan_queue.depth(),
            "nomad.worker.invoked":
                sum(w.stats["invoked"] for w in s.workers),
            "nomad.state.nodes": counts["nodes"],
            "nomad.state.jobs": counts["jobs"],
        }
        # wavepipe per-stage wall totals + the overlap gauges that prove
        # host commit hides under device compute (core/wavepipe.py)
        timers = getattr(s, "stage_timers", None)
        if timers is not None:
            rep = timers.report()
            for stage, secs in rep["stage_s"].items():
                out[f"nomad.wavepipe.{stage}_s"] = secs
            for pair, secs in rep["overlap_s"].items():
                key = pair.replace("*", "_")
                out[f"nomad.wavepipe.overlap.{key}_s"] = secs
        # registry series: counters/gauges flat, histograms as
        # name.{p50,p95,p99,sum,count} (legacy keys above win on clash)
        snap = REGISTRY.snapshot()
        for name, v in snap["counters"].items():
            out.setdefault(name, v)
        for name, v in snap["gauges"].items():
            out.setdefault(name, v)
        for name, h in snap["histograms"].items():
            for k in ("p50", "p95", "p99", "sum", "count"):
                out.setdefault(f"{name}.{k}", h[k])
        return out
