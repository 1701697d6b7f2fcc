"""HTTP API (reference: command/agent/http.go + *_endpoint.go).

`/v1/...` JSON endpoints over the in-process Server, shaped like the
reference's API (CamelCase wire forms via structs.codec).  Implemented on
the stdlib ThreadingHTTPServer — no external dependencies.

Blocking queries: list GETs accept `?index=N&wait=SECS` and long-poll the
state store until its index passes N (reference: blockingRPC); responses
carry `X-Nomad-Index`.

`/v1/event/stream` streams newline-delimited JSON event batches with
`?topic=Topic:Key` filters, mirroring the reference's endpoint.

Differences from the reference (nomad_tpu/api/http_server.py): three
endpoints speak the cluster plane's msgpack frames (`core/wire.py`) or
its federation (`core/federation.py`), which the port has not ported
(ROADMAP queue 1 item 4).  They answer HTTP 501 with an error naming
that item: the read follower's journal tail `GET /v1/operator/export`,
the metric-federation scrape `GET /v1/agent/self?compact=true`, and
`GET /v1/trace/<id>?cluster=true`.  The catch-all handler leaves out
the reference's `core.raft.NotLeaderError` branch, which no port server
can raise before item 4.  Every other route is the reference's.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import (
    Allocation,
    DrainStrategy,
    Evaluation,
    Job,
    Node,
    SchedulerConfiguration,
    codec,
)

DEFAULT_NAMESPACE = "default"


class APIError(Exception):
    def __init__(self, status: int, msg: str) -> None:
        super().__init__(msg)
        self.status = status


def _cluster_plane(what: str) -> APIError:
    """The 501 of an endpoint that needs the cluster plane."""
    return APIError(501, f"{what} needs the cluster plane (core/wire.py, "
                         "core/federation.py), which is not ported yet "
                         "(ROADMAP queue 1 item 4)")


class TextResponse(str):
    """A handler return value rendered as text/plain instead of JSON
    (the Prometheus exposition format is not JSON)."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"


class BytesResponse(bytes):
    """A handler return value shipped verbatim — msgpack bodies (the
    /v1/operator/export journal frames ride core/wire.packb, which JSON
    cannot carry)."""

    content_type = "application/msgpack"


def _decode_job(wire: Dict, ns: str) -> Job:
    """Wire Job -> struct; an ABSENT Namespace falls back to the request's
    ?namespace= (the decoder's default-namespace output can't distinguish
    'unset' from an explicit 'default')."""
    job = codec.decode(Job, wire)
    if "Namespace" not in wire:
        job.namespace = ns
    return job


def _stub(job: Job) -> Dict[str, Any]:
    return {
        "ID": job.id, "Name": job.name, "Namespace": job.namespace,
        "Type": job.type, "Priority": job.priority, "Status": job.status,
        "Stop": job.stop, "Version": job.version,
        "ParentID": job.parent_id,
        "Periodic": job.periodic is not None,
        "ParameterizedJob": job.parameterized is not None,
        "JobModifyIndex": job.job_modify_index,
        "ModifyIndex": job.modify_index,
    }


def _token_stub(t) -> Dict[str, Any]:
    # the secret never appears in list responses
    return {"AccessorID": t.accessor_id, "Name": t.name, "Type": t.type,
            "Policies": list(t.policies), "Global": t.global_}


def _node_stub(n: Node) -> Dict[str, Any]:
    return {
        "ID": n.id, "Name": n.name, "Datacenter": n.datacenter,
        "NodePool": n.node_pool, "NodeClass": n.node_class,
        "Status": n.status,
        "SchedulingEligibility": n.scheduling_eligibility,
        "Drain": n.drain is not None,
        "ModifyIndex": n.modify_index,
    }


class Router:
    """Maps (method, path) to handlers over an agent (server + clients)."""

    def __init__(self, agent) -> None:
        self.agent = agent
        from nomad_tpu_torch.client.exec_session import ExecSessionRegistry
        self.exec_sessions = ExecSessionRegistry()

    @property
    def server(self):
        return self.agent.server

    # ------------------------------------------------------------ routing

    def route(self, method: str, path: str, qs: Dict[str, List[str]],
              body: Optional[Dict], token: str = "") -> Tuple[int, Any]:
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != "v1":
            raise APIError(404, "not found")
        parts = parts[1:]
        # cross-region forwarding (reference: rpcHandler.forward region
        # hop): a foreign ?region= proxies the request verbatim to that
        # region's agent BEFORE local enforcement — the target region
        # authenticates the forwarded token against ITS own ACL state
        # read-follower hop (core/fanout.ReadFollower): a follower agent
        # serves stale-bounded GETs from its replica and proxies every
        # write — plus ?stale=false consistent reads — to its upstream,
        # which enforces the forwarded token against the authoritative
        # ACL state (delta exports do not replicate tokens/variables)
        follower = getattr(self.agent, "follower", None)
        if follower is not None and (
                method != "GET"
                or (qs.get("stale") or ["true"])[0] == "false"):
            clean = {k: v for k, v in qs.items() if k != "stale"}
            qs_str = urllib.parse.urlencode(clean, doseq=True)
            raw = (json.dumps(body).encode()
                   if body is not None else None)
            status, data = follower.proxy(method, path, qs_str, raw,
                                          token=token)
            payload, err = self._decode_forwarded(status, data)
            if err:
                raise APIError(status, err)
            return status, payload
        fed = getattr(self.agent, "federation", None)
        region = (qs.get("region") or [""])[0]
        if fed is not None and region and region != fed.region:
            clean = {k: v for k, v in qs.items() if k != "region"}
            qs_str = urllib.parse.urlencode(clean, doseq=True)
            raw = (json.dumps(body).encode()
                   if body is not None else None)
            status, data = fed.forward(region, method, path, qs_str,
                                       raw, token=token)
            payload, err = self._decode_forwarded(status, data)
            if err:
                raise APIError(status, err)
            return status, payload
        ns = (qs.get("namespace") or [DEFAULT_NAMESPACE])[0]
        acl = self._enforce(method, parts, ns, token)
        try:
            return 200, self._dispatch(method, parts, ns, qs, body, acl,
                                       token=token)
        except APIError:
            raise
        except (KeyError, IndexError) as e:
            raise APIError(404, f"not found: {e}")

    def _register_multiregion(self, job: Job, token: str = "") -> Dict:
        """Fan a multiregion job out as one registration per region
        (reference: the `multiregion` stanza; staged deployment strategies
        are enterprise upstream — the fan-out itself is the OSS-visible
        contract).  Per-region Count/Datacenters override the template;
        foreign regions register through the federation table with the
        caller's token (each region enforces its own ACLs)."""
        fed = getattr(self.agent, "federation", None)
        if fed is None:
            raise APIError(400, "multiregion job on a non-federated agent")
        entries = job.multiregion.regions
        # validate EVERY entry before registering ANY region: a bad entry
        # after valid ones would otherwise leave a partial fan-out behind
        # a 400 (and a retry would re-register the good regions)
        names = [str(e.get("Name") or e.get("name") or "") for e in entries]
        if not all(names):
            raise APIError(400, "multiregion region entry needs a Name")
        results: Dict[str, Any] = {}
        for entry, name in zip(entries, names):
            copy = job.copy()
            copy.region = name
            copy.multiregion = None      # the copies must not re-fan-out
            dcs = entry.get("Datacenters") or entry.get("datacenters")
            if dcs:
                copy.datacenters = list(dcs)
            count = entry.get("Count") or entry.get("count")
            if count:
                for tg in copy.task_groups:
                    tg.count = int(count)
            if name == fed.region:
                ev = self.server.register_job(copy)
                results[name] = {"EvalID": ev.id if ev else ""}
                continue
            raw = json.dumps({"Job": codec.encode(copy)}).encode()
            qs_str = urllib.parse.urlencode(
                {"namespace": copy.namespace})
            status, data = fed.forward(name, "PUT", "/v1/jobs", qs_str,
                                       raw, token=token)
            payload, err = self._decode_forwarded(status, data)
            results[name] = {"Error": err} if err else payload
        local = results.get(fed.region, {})
        return {"EvalID": local.get("EvalID", ""), "Regions": results}

    @staticmethod
    def _decode_forwarded(status: int, data: bytes):
        """(status, raw bytes) from a federation forward ->
        (payload, error message or '') — the one place forwarded response
        bodies are interpreted."""
        try:
            payload = json.loads(data.decode() or "null")
        except ValueError:
            payload = data.decode(errors="replace")
        if status < 400:
            return payload, ""
        msg = (payload.get("error", str(payload))
               if isinstance(payload, dict) else str(payload))
        return payload, msg or f"region request failed ({status})"

    @staticmethod
    def _check_ns(acl, ns: str, cap: str) -> None:
        """Re-check a namespace capability against the namespace an object
        actually lives in (by-ID lookups and body-supplied namespaces must
        not ride on the query-string namespace's grant)."""
        if acl is not None and not acl.allow_namespace_operation(ns, cap):
            raise APIError(403, f"permission denied: needs {cap} in {ns!r}")

    # -------------------------------------------------------- enforcement

    def _enforce(self, method: str, p: List[str], ns: str, token: str):
        """Capability checks per endpoint family when ACLs are on
        (reference: the aclObj checks at the top of every RPC handler).
        Returns the compiled ACL (None when ACLs are disabled) so handlers
        can re-check object namespaces."""
        s = self.server
        if not getattr(s, "acl_enabled", False):
            return None
        head = p[0] if p else ""
        if head == "acl" and p[1:2] == ["bootstrap"]:
            return None                 # one-shot, self-guarding
        if (head == "acl" and p[1:2] == ["login"]
                and method in ("PUT", "POST")):
            return None     # token exchange: the JWT itself authenticates
        if (head == "acl" and p[1:3] == ["token", "self"]
                and method == "GET"):
            # any valid token may READ itself; non-GET verbs fall through
            # to normal enforcement (the bypass must stay scoped to the
            # single handler that uses it)
            return None
        acl, err = s.resolve_token(token)
        if acl is None:
            raise APIError(403, err or "permission denied")
        write = method in ("PUT", "POST", "DELETE")
        if head == "search":
            # prefix search mutates nothing — it is a READ carried over
            # PUT/POST for the request body (reference: Search.PrefixSearch
            # runs under read capabilities); classifying it as a write
            # would break the CLI's id-prefix resolution for read-only
            # tokens
            write = False
        if head == "acl":
            if not acl.is_management():
                raise APIError(403, "permission denied: management required")
            return acl
        if head == "operator" and p[1:2] in (["snapshot"], ["export"]):
            # a snapshot carries every token secret + all variables:
            # management only, both directions (reference gates snapshot
            # RPCs behind management tokens).  Exports inherit the rule —
            # a full export embeds the snapshot doc
            if not acl.is_management():
                raise APIError(403, "permission denied: management required")
            return acl
        if head in ("jobs", "job", "allocations", "allocation",
                    "evaluations", "evaluation", "eval", "deployments",
                    "deployment", "search", "services", "service",
                    "volumes", "volume"):
            cap = "submit-job" if write else "read-job"
            if head in ("allocations", "allocation") and write:
                cap = "alloc-lifecycle"
            if not acl.allow_namespace_operation(ns, cap):
                raise APIError(403, f"permission denied: needs {cap}")
            return acl
        if head in ("var", "vars"):
            cap = "variables-write" if write else "variables-read"
            if not acl.allow_namespace_operation(ns, cap):
                raise APIError(403, f"permission denied: needs {cap}")
            return acl
        if head in ("nodes", "node"):
            ok = acl.allow_node_write() if write else acl.allow_node_read()
            if not ok:
                raise APIError(403, "permission denied: node policy")
            return acl
        if head in ("operator", "system", "namespaces", "namespace",
                    "node_pools", "node_pool"):
            ok = (acl.allow_operator_write() if write
                  else acl.allow_operator_read())
            if not ok:
                raise APIError(403, "permission denied: operator policy")
            return acl
        if head == "regions":
            # listing regions is status-class; rewriting the federation
            # table is management-only (a poisoned table would hijack
            # every cross-region forward)
            if write and not acl.is_management():
                raise APIError(403,
                               "permission denied: management required")
            return acl
        if head in ("agent", "metrics", "status", "event",
                    "traces", "trace"):
            if not acl.allow_agent_read():
                raise APIError(403, "permission denied: agent policy")
            return acl
        if head == "client":
            # alloc fs/logs/stats need read-job; exec needs alloc-exec.
            # Accept EITHER here — the handler re-checks the exact
            # capability against the alloc's actual namespace, so a
            # least-privilege alloc-exec-only token is not rejected by
            # the coarse pre-check
            if not (acl.allow_namespace_operation(ns, "read-job")
                    or acl.allow_namespace_operation(ns, "alloc-exec")):
                raise APIError(403, "permission denied: needs read-job "
                                    "or alloc-exec")
            return acl
        return acl

    def _dispatch(self, method: str, p: List[str], ns: str,
                  qs: Dict[str, List[str]], body: Optional[Dict],
                  acl=None, token: str = "") -> Any:
        s = self.server
        head = p[0] if p else ""
        if head == "jobs":
            if method == "GET":
                self._block(qs, result_index=lambda: max(
                    (j.modify_index for j in s.state.snapshot().jobs()
                     if j.namespace == ns or ns == "*"), default=0),
                    shape=("jobs", ns))
                snap = s.state.snapshot()
                out = [_stub(j) for j in snap.jobs()
                       if j.namespace == ns or ns == "*"]
                return sorted(out, key=lambda j: j["ID"])
            if method in ("PUT", "POST"):
                wire = (body or {}).get("Job")
                if not wire or not wire.get("ID"):
                    raise APIError(400, "job must be specified")
                job = _decode_job(wire, ns)
                if job.namespace != ns:
                    self._check_ns(acl, job.namespace, "submit-job")
                if job.multiregion is not None and job.multiregion.regions:
                    return self._register_multiregion(job, token)
                ev = s.register_job(job)
                if ev is not None:
                    # the eval carries the LEADER's stored modify index —
                    # exact even when this server's local replica hasn't
                    # applied the write yet
                    return {"EvalID": ev.id,
                            "JobModifyIndex": ev.job_modify_index}
                # periodic/parameterized parents get no eval; poll the
                # local store for the replicated write (first sight only
                # — an update racing replication may briefly report the
                # prior index)
                stored = self._read_local(
                    lambda: s.state.job_by_id(job.namespace, job.id))
                if stored is None:
                    raise APIError(500, "registered job not yet visible")
                return {"EvalID": "",
                        "JobModifyIndex": stored.job_modify_index}
        elif head == "job":
            return self._job(method, p[1:], ns, qs, body, acl)
        elif head == "regions":
            fed = getattr(self.agent, "federation", None)
            if fed is None:
                return ["global"]
            if p[1:2] == ["federation"]:
                if method in ("PUT", "POST"):
                    fed.merge((body or {}).get("Regions", {}))
                return {"Regions": fed.table()}
            if method == "GET":
                return fed.regions()
        elif head == "nodes":
            if method == "GET":
                self._block(qs, result_index=lambda: max(
                    (n.modify_index
                     for n in s.state.snapshot().nodes()), default=0),
                    shape=("nodes",))
                return sorted((_node_stub(n)
                               for n in s.state.snapshot().nodes()),
                              key=lambda n: n["ID"])
            if method in ("PUT", "POST"):
                # reference: Node.Register RPC — a client (or the soak's
                # synthetic fleet) introduces itself over the real API;
                # re-registration of a known id is an upsert
                wire = (body or {}).get("Node")
                if not wire or not wire.get("ID"):
                    raise APIError(400, "Node with ID required")
                reg = codec.decode(Node, wire)
                s.register_node(reg)
                return {"NodeID": reg.id,
                        "HeartbeatTTL": s.heartbeats.ttl}
        elif head == "node":
            return self._node(method, p[1:], qs, body)
        elif head == "allocations":
            if method == "GET":
                self._block(qs)
                snap = s.state.snapshot()
                if (qs.get("columnar") or ["false"])[0] == "true":
                    return self._allocations_columnar(snap, ns)
                out = []
                for j in snap.jobs():
                    if not (j.namespace == ns or ns == "*"):
                        continue
                    out.extend(codec.encode(a) for a in
                               snap.allocs_by_job(j.namespace, j.id))
                return out
        elif head == "allocation":
            aid = p[1]
            a = s.state.alloc_by_id(aid)
            if a is None:
                raise APIError(404, "alloc not found")
            if method == "GET":
                self._check_ns(acl, a.namespace, "read-job")
                return codec.encode(a)
            if method in ("PUT", "POST") and len(p) > 2 \
                    and p[2] in ("signal", "restart"):
                # reference: Allocations.Signal / Restart client RPCs —
                # routed to the in-process client owning the alloc
                self._check_ns(acl, a.namespace, "alloc-lifecycle")
                for c in self.agent.clients:
                    ar = c.alloc_runners.get(aid)
                    if ar is None:
                        continue
                    if p[2] == "signal":
                        import signal as _sig
                        num = (body or {}).get("Signal", "SIGUSR1")
                        signum = None
                        if isinstance(num, str):
                            cand = getattr(_sig, num, None)
                            if isinstance(cand, (int, _sig.Signals)):
                                signum = int(cand)
                            elif num.isdigit():
                                signum = int(num)
                        elif isinstance(num, int):
                            signum = num
                        if signum is None:
                            raise APIError(400, f"unknown signal {num!r}")
                        for tr in ar.task_runners:
                            if tr.handle is not None:
                                tr.driver.signal_task(tr.handle, signum)
                    else:
                        # restart must be unconditional — it bypasses the
                        # restart-policy budget (reference: alloc restart
                        # always restarts; only real failures count)
                        for tr in ar.task_runners:
                            tr.restart()
                    return {}
                raise APIError(404, "alloc not running on this agent")
            if method in ("PUT", "POST") and len(p) > 2 and p[2] == "stop":
                self._check_ns(acl, a.namespace, "alloc-lifecycle")
                stop = a.copy_skip_job()
                stop.desired_status = "stop"
                stop.desired_description = "alloc stopped via api"
                s.state.upsert_allocs([stop])
                ev = Evaluation(namespace=a.namespace, type="service",
                                triggered_by="alloc-stop", job_id=a.job_id)
                job = s.state.job_by_id(a.namespace, a.job_id)
                if job is not None:
                    ev.type = job.type
                    ev.priority = job.priority
                s.apply_eval_update([ev])
                return {"EvalID": ev.id}
        elif head == "evaluations":
            if method == "GET":
                self._block(qs)
                return [codec.encode(e) for e in s.state.snapshot().evals()
                        if e.namespace == ns or ns == "*"]
        elif head in ("evaluation", "eval"):
            eid = p[1] if len(p) > 1 else ""
            ev = s.state.eval_by_id(eid)
            if ev is None:
                raise APIError(404, "eval not found")
            self._check_ns(acl, ev.namespace, "read-job")
            if len(p) > 2 and p[2] == "allocations":
                snap = s.state.snapshot()
                return [codec.encode(a) for a in
                        snap.allocs_by_job(ev.namespace, ev.job_id)
                        if a.eval_id == eid]
            if len(p) > 2 and p[2] == "explain":
                # /v1/eval/<id>/explain — the placement-explainability
                # surface: decision-ring record when this server still
                # holds it, else synthesized from the stored eval's
                # failure rollups (core/explain.py)
                from nomad_tpu_torch.core.explain import explain_doc
                get_dec = getattr(s.state, "eval_decision", None)
                dec = get_dec(eid) if get_dec is not None else None
                return explain_doc(ev, dec)
            return codec.encode(ev)
        elif head == "deployments":
            if method == "GET":
                self._block(qs)
                return [codec.encode(d)
                        for d in s.state.snapshot().deployments()
                        if d.namespace == ns or ns == "*"]
        elif head == "deployment":
            return self._deployment(method, p[1:], body, acl)
        elif head == "operator":
            if p[1:2] == ["scheduler"] and p[2:3] == ["configuration"]:
                if method == "GET":
                    return {"SchedulerConfig":
                            codec.encode(s.state.snapshot()
                                         .scheduler_config())}
                if method in ("PUT", "POST"):
                    cfg = codec.decode(SchedulerConfiguration, body or {})
                    s.state.set_scheduler_config(cfg)
                    return {"Updated": True}
            if p[1:2] == ["snapshot"]:
                if method == "GET":
                    return s.save_snapshot()
                if method in ("PUT", "POST"):
                    s.restore_snapshot(body or {})
                    return {"Restored": True}
            if p[1:2] == ["export"] and method == "GET":
                # the read-follower tail (core/fanout.ReadFollower):
                # journal deltas since ?since=, long-polled via ?wait=.
                # msgpack over core/wire (struct payloads; JSON can't
                # carry them) — management-only under ACLs, same rule as
                # operator/snapshot (a full export embeds the snapshot
                # doc: token secrets + variables)
                try:
                    since = int((qs.get("since") or ["0"])[0])
                    wait = min(float((qs.get("wait") or ["0"])[0]), 30.0)
                except ValueError:
                    raise APIError(400, "bad since/wait")
                if wait > 0 and s.state.latest_index() <= since:
                    s.state.wait_for_index(since + 1, timeout=wait)
                raise _cluster_plane("the journal export")
            if p[1:2] == ["raft"] and p[2:3] == ["configuration"]:
                # reference: Operator.RaftGetConfiguration /
                # `nomad operator raft list-peers`
                raft = getattr(s, "raft", None)
                if raft is None:
                    return {"Servers": [{
                        "Node": getattr(s, "region", "global") + ".dev",
                        "Leader": True, "Voter": True}]}
                servers = [{"Node": raft.name,
                            "Address": f"{raft.addr[0]}:{raft.addr[1]}",
                            "Leader": raft.is_leader(), "Voter": True}]
                for name, addr in sorted(raft.peers.items()):
                    servers.append({
                        "Node": name,
                        "Address": f"{addr[0]}:{addr[1]}",
                        "Leader": raft.leader_name == name,
                        "Voter": True})
                return {"Servers": servers}
            if p[1:2] == ["memory"] and method == "GET":
                # memory & footprint plane (core/memledger.py): fresh
                # per-plane byte ledger + process RSS.  ?cached=true
                # returns the last tick sample without re-scraping
                from nomad_tpu_torch.core.memledger import MEMLEDGER
                if (qs.get("cached") or ["false"])[0] == "true":
                    return MEMLEDGER.doc()
                return MEMLEDGER.scrape()
            if p[1:2] == ["health"] and method == "GET":
                # SLO verdicts, observed-vs-threshold (the health
                # watchdog re-evaluates on demand; ?dumps=true folds the
                # retained breach dump bundles in)
                doc = s.health.check()
                if (qs.get("dumps") or ["false"])[0] == "true":
                    doc["DumpBundles"] = s.health.dumps()
                return doc
            if p[1:2] == ["cluster-health"] and method == "GET":
                # cluster-scope rollup: the federation puller's
                # per-origin scrape ledger (scraping is a leader duty —
                # off-leader the ledger sits at zero scrapes; None in
                # standalone/dev mode) + the cluster_* subset of the SLO
                # verdicts from the local health watchdog
                # (core/flightrec.py)
                fed = getattr(s, "federation", None)
                doc = s.health.check()
                rules = [v for v in doc["Rules"]
                         if v["Rule"].startswith("cluster_")]
                return {"Schema": "nomad-tpu.cluster-health.v1",
                        "Healthy": all(v["Ok"] for v in rules),
                        "At": doc["At"],
                        "Rules": rules,
                        "Federation": (fed.doc()
                                       if fed is not None else None)}
            if p[1:2] == ["federation"] and p[2:3] == ["register"]:
                # read followers announce themselves here
                # (fanout.ReadFollower._announce_once) so the leader's
                # federation puller scrapes them alongside gossip peers.
                # Idempotent; dormant on non-leaders until they lead.
                if method in ("PUT", "POST"):
                    b = body or {}
                    origin, url = b.get("Origin"), b.get("Url")
                    if not origin or not url:
                        raise APIError(400, "Origin and Url required")
                    fed = getattr(s, "federation", None)
                    if fed is None:
                        return {"Registered": False}
                    fed.register_target(str(origin), str(url))
                    return {"Registered": True}
                if method == "DELETE":
                    b = body or {}
                    fed = getattr(s, "federation", None)
                    if fed is not None and b.get("Origin"):
                        fed.unregister_target(str(b["Origin"]))
                    return {}
            if p[1:2] == ["flight-recorder"] and method == "GET":
                # the bounded recent-history view of the wave hot path
                # (core/flightrec.py); ?n= caps each ring's tail
                from nomad_tpu_torch.core.flightrec import FLIGHT
                n = None
                if qs.get("n"):
                    try:
                        n = max(int(qs["n"][0]), 1)
                    except ValueError:
                        raise APIError(400, "bad n")
                return FLIGHT.snapshot(n_waves=n, n_evals=n, n_events=n)
            if p[1:2] == ["timeline"] and method == "GET":
                # retrospective timeline plane (core/timeline.py):
                #   ?start=&end=&step=&series=a,b  range aggregation
                #        (min/max/avg/last per step, annotations
                #        interleaved)
                #   ?dump=true                     full-resolution doc +
                #        post-mortem report, what `nomad report` reads
                from nomad_tpu_torch.core.timeline import TIMELINE, build_report

                def _qf(key: str) -> Optional[float]:
                    if not qs.get(key):
                        return None
                    try:
                        return float(qs[key][0])
                    except ValueError:
                        raise APIError(400, f"bad {key}")

                names = None
                if qs.get("series"):
                    names = [x for x in qs["series"][0].split(",") if x]
                try:
                    if (qs.get("dump") or ["false"])[0] == "true":
                        doc = TIMELINE.query()
                        doc["Report"] = build_report(doc)
                        return doc
                    return TIMELINE.query(start=_qf("start"),
                                          end=_qf("end"),
                                          step=_qf("step"),
                                          series=names)
                except ValueError as e:
                    raise APIError(400, str(e))
            if p[1:2] == ["profile"]:
                # continuous profiling plane (core/profiling.py).
                #   GET  /v1/operator/profile        live sampler snapshot
                #        (+folded stacks, retained capture ids)
                #   GET  /v1/operator/profile/<id>   one retained bundle
                #   POST /v1/operator/profile        timed capture; body
                #        {DurationS, Trace, TraceDir} — operator-write ACL
                #        (captures cost real wall time on the agent)
                from nomad_tpu_torch.core.profiling import PROFILER
                if p[2:3] and method == "GET":
                    cap = PROFILER.get_capture(p[2])
                    if cap is None:
                        raise APIError(404, f"no capture {p[2]!r}")
                    return cap
                if method == "GET":
                    doc = PROFILER.snapshot()
                    doc["folded"] = PROFILER.folded()
                    doc["captures"] = [c["id"]
                                       for c in PROFILER.captures()]
                    return doc
                if method in ("PUT", "POST"):
                    b = body or {}
                    try:
                        dur = float(b.get("DurationS", 2.0))
                    except (TypeError, ValueError):
                        raise APIError(400, "bad DurationS")
                    return PROFILER.capture(
                        duration_s=dur,
                        include_trace=bool(b.get("Trace", False)),
                        trace_dir=b.get("TraceDir"))
            if p[1:2] == ["debug"] and method == "GET":
                # debug bundle (reference: `nomad operator debug`
                # capture): stats + metrics + prometheus exposition +
                # recent traces/spans + LogRing tail + threads + the
                # health plane (verdicts, dump bundles, flight rings),
                # one doc
                import sys as _sys
                import threading as _threading
                from nomad_tpu_torch.core.flightrec import FLIGHT
                from nomad_tpu_torch.core.logging import RING
                from nomad_tpu_torch.core.memledger import MEMLEDGER
                from nomad_tpu_torch.core.profiling import PROFILER
                from nomad_tpu_torch.core.telemetry import TRACER
                from nomad_tpu_torch.core.timeline import TIMELINE
                tl_win = TIMELINE.window()
                mem_doc = MEMLEDGER.scrape()
                return {
                    "Stats": self.agent.stats(),
                    "Metrics": self.agent.metrics(),
                    "Prometheus": self.agent.metrics(
                        format="prometheus"),
                    "Traces": TRACER.traces()[-100:],
                    "Spans": TRACER.spans()[-500:],
                    "TracerDroppedSpans": TRACER.dropped,
                    "SchedulerConfig": codec.encode(
                        s.state.snapshot().scheduler_config()),
                    "Logs": RING.tail(500),
                    "Health": s.health.check(),
                    "HealthDumps": s.health.dumps(),
                    "FlightRecorder": FLIGHT.snapshot(
                        n_waves=100, n_evals=200, n_events=100),
                    # where the process spends its time (buckets + GIL
                    # fraction) and the device compile/HBM ledger — the
                    # profiling plane folded into the one-doc bundle
                    "Profiler": PROFILER.brief(),
                    # the timeline plane, bounded: retained window,
                    # sampler stats, and the most recent two minutes of
                    # clock-aligned history (not the full ring)
                    "Timeline": {
                        "Window": tl_win,
                        "Stats": TIMELINE.snapshot_stats(),
                        "Recent": (TIMELINE.slice(
                            max(tl_win[1] - 120.0, tl_win[0]),
                            tl_win[1]) if tl_win else None),
                    },
                    "DeviceLedger": s.executor.ledger(),
                    # read-path fanout plane (core/fanout.py): coalesced
                    # watch shapes, the event ring's cursor/drop ledger
                    # (nomad.stream.dropped per subscriber), and the
                    # follower tail when this agent is one
                    "WatchHub": (s.watch_hub.stats()
                                 if getattr(s, "watch_hub", None)
                                 is not None else None),
                    "EventBroker": s.events.stats(),
                    "Follower": (self.agent.follower.stats()
                                 if getattr(self.agent, "follower", None)
                                 is not None else None),
                    # cluster-scope federation plane (core/federation.py):
                    # the leader's per-origin scrape ledger — who answered
                    # the last pull, how far behind each origin's applied
                    # index sits.  None off-leader (the puller is a leader
                    # duty) and in standalone/dev mode
                    "Cluster": (s.federation.doc()
                                if getattr(s, "federation", None)
                                is not None else None),
                    # memory & footprint plane (core/memledger.py):
                    # per-plane byte ledger + RSS, and the unified
                    # eviction/drop counters — one key per plane, the
                    # single place to answer "who is dropping data"
                    "Memory": mem_doc,
                    "Evictions": MEMLEDGER.evictions(),
                    "Threads": [
                        {"Name": t.name, "Daemon": t.daemon,
                         "Alive": t.is_alive()}
                        for t in _threading.enumerate()],
                    "Python": _sys.version,
                }
        elif head == "acl":
            return self._acl(method, p[1:], body, token=token)
        elif head == "namespaces":
            if method == "GET":
                return [codec.encode(n)
                        for n in s.state.snapshot().namespaces()]
        elif head == "namespace":
            return self._namespace(method, p[1:], body)
        elif head == "node_pools":
            if method == "GET":
                return [codec.encode(n)
                        for n in s.state.snapshot().node_pools()]
        elif head == "node_pool":
            return self._node_pool(method, p[1:], body)
        elif head == "services":
            if method == "GET":
                regs = s.state.service_registrations(
                    None if ns == "*" else ns)
                by_name: Dict[str, set] = {}
                for r in regs:
                    by_name.setdefault(r.service_name, set()).update(r.tags)
                return [{"Namespace": ns, "Services": [
                    {"ServiceName": name, "Tags": sorted(tags)}
                    for name, tags in sorted(by_name.items())]}]
        elif head == "service":
            if method == "GET":
                regs = s.state.service_registrations(
                    None if ns == "*" else ns, p[1])
                if not regs:
                    raise APIError(404, "service not found")
                return [codec.encode(r) for r in regs]
        elif head == "volumes":
            if method == "GET":
                return [{"ID": v.id, "Namespace": v.namespace,
                         "PluginID": v.plugin_id,
                         "AccessMode": v.access_mode,
                         "Schedulable": v.schedulable,
                         "ReadAllocs": v.n_read_claims(),
                         "WriteAllocs": len(v.write_allocs)}
                        for v in s.state.csi_volumes(
                            None if ns == "*" else ns)]
        elif head == "volume":
            # /v1/volume/csi/<id> (reference path shape)
            if p[1:2] != ["csi"]:
                raise APIError(404, "only csi volumes")
            if len(p) < 3 or not p[2]:
                raise APIError(404, "volume id required")
            vol_id = p[2]
            if method == "GET":
                v = s.state.snapshot().csi_volume_by_id(ns, vol_id)
                if v is None:
                    raise APIError(404, "volume not found")
                # block claims are an in-memory representation (AllocBlock
                # holds numpy picks + the full job template) — the wire
                # form carries their member ids as ordinary read claims,
                # like the reference's per-alloc claim model
                import dataclasses
                wire_reads = dict(v.read_allocs)
                for b in v.read_blocks.values():
                    wire_reads.update(dict.fromkeys(b.ids, ""))
                return codec.encode(dataclasses.replace(
                    v, read_allocs=wire_reads, read_blocks={}))
            if method in ("PUT", "POST"):
                from nomad_tpu_torch.structs import CSIVolume
                wire = (body or {}).get("Volume") or body or {}
                vol = codec.decode(CSIVolume, wire)
                if vol.id and vol.id != vol_id:
                    raise APIError(
                        400, f"volume ID {vol.id!r} does not match "
                             f"request path {vol_id!r}")
                vol.id = vol.id or vol_id
                if "Namespace" not in wire:
                    vol.namespace = ns
                elif vol.namespace != ns:
                    self._check_ns(acl, vol.namespace, "submit-job")
                if not vol.plugin_id:
                    raise APIError(400, "PluginID required")
                s.state.upsert_csi_volume(vol)
                return {}
            if method == "DELETE":
                err = s.state.delete_csi_volume(ns, vol_id)
                if err == "volume not found":
                    raise APIError(404, err)
                if err:
                    raise APIError(400, err)
                return {}
        elif head == "vars":
            if method == "GET":
                prefix = (qs.get("prefix") or [""])[0]
                return [codec.encode(v)
                        for v in s.state.variables(ns, prefix)
                        if acl is None
                        or acl.allow_variable(ns, v.path, write=False)]
        elif head == "var":
            return self._var(method, p[1:], ns, body, acl)
        elif head == "system":
            if p[1:2] == ["gc"] and method in ("PUT", "POST"):
                s.force_gc()
                return {}
        elif head == "client":
            return self._client_fs(method, p[1:], ns, qs, acl,
                                   body=body)
        elif head == "status":
            if p[1:2] == ["leader"]:
                if hasattr(s, "leader_rpc_addr"):   # cluster mode
                    addr = s.leader_rpc_addr()
                    return f"{addr[0]}:{addr[1]}" if addr else ""
                return "local"           # single in-process server
            if p[1:2] == ["peers"]:
                if hasattr(s, "gossip"):
                    return [f"{m.meta['rpc'][0]}:{m.meta['rpc'][1]}"
                            for m in s.gossip.alive_members().values()
                            if m.meta.get("rpc")]
                return ["local"]
        elif head == "agent":
            if p[1:2] == ["self"]:
                if (qs.get("compact") or ["0"])[0] in ("1", "true"):
                    # the metric-federation scrape body
                    # (core/federation.py): registry summaries + flight
                    # occupancy + mem doc + follower tail + a timeline
                    # delta since ?since_seq=.  msgpack over core/wire —
                    # the leader's puller decodes it, not a human
                    raise _cluster_plane("the compact scrape")
                return {"config": {"Server": {"Enabled": True},
                                   "Client": {
                                       "Enabled": bool(self.agent.clients)}},
                        "stats": self.agent.stats()}
            if p[1:2] == ["members"]:
                if hasattr(s, "gossip"):
                    return {"Members": [
                        {"Name": m.name, "Status": m.status,
                         "Addr": list(m.addr)}
                        for m in s.gossip.members_snapshot().values()]}
                return {"Members": [{"Name": "local", "Status": "alive"}]}
        elif head == "metrics":
            fmt = (qs.get("format") or [""])[0]
            out = self.agent.metrics(format=fmt)
            return TextResponse(out) if fmt == "prometheus" else out
        elif head == "traces":
            from nomad_tpu_torch.core.telemetry import TRACER
            return TRACER.traces()
        elif head == "trace":
            from nomad_tpu_torch.core.telemetry import TRACER
            if len(p) < 2 or not p[1]:
                raise APIError(404, "trace id required")
            if (qs.get("cluster") or ["false"])[0] == "true":
                return self._cluster_trace(p[1], token)
            spans = TRACER.trace(p[1])
            if not spans:
                raise APIError(404, "trace not found")
            return {"TraceID": p[1], "Spans": spans}
        elif head == "search":
            if method in ("PUT", "POST"):
                return self._search(body or {}, ns)
        elif head == "event":
            # handled separately (streaming) — reaching here means the
            # handler did not intercept it
            raise APIError(400, "use GET /v1/event/stream")
        raise APIError(404, f"no handler for {method} /v1/{'/'.join(p)}")

    def _cluster_trace(self, trace_id: str, token: str = "") -> Dict:
        """`GET /v1/trace/<id>?cluster=true` — the reference scatter-gathers
        the trace from every gossip peer and stitches it
        (core/federation.stitch_trace); the port has neither yet."""
        raise _cluster_plane("the cluster trace")

    # ----------------------------------------------------------- sub-trees

    def _job(self, method: str, p: List[str], ns: str,
             qs: Dict[str, List[str]], body: Optional[Dict],
             acl=None) -> Any:
        s = self.server
        job_id = urllib.parse.unquote(p[0])
        sub = p[1] if len(p) > 1 else ""
        if method == "GET":
            # block BEFORE reading: a watcher polling ?index=N must see
            # the state as of the index that woke it, not the one before
            self._block(qs)
        job = s.state.job_by_id(ns, job_id)
        if method == "GET":
            if job is None:
                raise APIError(404, "job not found")
            if sub == "":
                return codec.encode(job)
            snap = s.state.snapshot()
            if sub == "allocations":
                return [codec.encode(a)
                        for a in snap.allocs_by_job(ns, job_id)]
            if sub == "evaluations":
                return [codec.encode(e)
                        for e in snap.evals_by_job(ns, job_id)]
            if sub == "versions":
                versions = []
                v = job.version
                while v >= 0:
                    jv = snap.job_by_id_and_version(ns, job_id, v)
                    if jv is not None:
                        versions.append(codec.encode(jv))
                    v -= 1
                return {"Versions": versions}
            if sub == "deployment":
                d = snap.latest_deployment_by_job(ns, job_id)
                return codec.encode(d) if d else None
            if sub == "deployments":
                return [codec.encode(d) for d in snap.deployments()
                        if d.namespace == ns and d.job_id == job_id]
            if sub == "placement-failures":
                # "why pending": the newest blocked eval's per-TG
                # NodesEvaluated/Filtered/DimensionExhausted rollups
                from nomad_tpu_torch.core.explain import placement_failures_doc
                return placement_failures_doc(
                    job_id, ns, snap.evals_by_job(ns, job_id))
        if method == "DELETE":
            purge = (qs.get("purge") or ["false"])[0] == "true"
            ev = s.deregister_job(ns, job_id, purge=purge)
            return {"EvalID": ev.id if ev else ""}
        if method in ("PUT", "POST"):
            if sub == "" and body and "Job" in body:
                j = _decode_job(body["Job"], ns)
                if j.namespace != ns:
                    self._check_ns(acl, j.namespace, "submit-job")
                ev = s.register_job(j)
                return {"EvalID": ev.id if ev else ""}
            if sub == "plan":
                # a plan dry-run works for not-yet-registered jobs too
                j = _decode_job((body or {}).get("Job") or {}, ns)
                if j.namespace != ns:
                    self._check_ns(acl, j.namespace, "submit-job")
                diff = (body or {}).get("Diff", False)
                return self._plan(j, diff)
            if job is None:
                raise APIError(404, "job not found")
            if sub == "dispatch":
                payload = base64.b64decode((body or {}).get("Payload") or "")
                child, err = s.dispatch_job(
                    ns, job_id, payload, (body or {}).get("Meta") or {})
                if err:
                    raise APIError(400, err)
                return {"DispatchedJobID": child.id}
            if sub == "revert":
                version = int((body or {}).get("JobVersion", 0))
                ev, err = s.revert_job(ns, job_id, version)
                if err:
                    raise APIError(400, err)
                return {"EvalID": ev.id if ev else ""}
            if sub == "periodic" and p[2:3] == ["force"]:
                child = s.periodic.force_run(ns, job_id)
                if child is None:
                    raise APIError(400, "job is not periodic")
                return {"DispatchedJobID": child.id}
            if sub == "evaluate":
                # reference: Job.Evaluate RPC / `nomad job eval` — force
                # a fresh evaluation without changing the job
                if job is None:
                    raise APIError(404, "job not found")
                from nomad_tpu_torch.structs import Evaluation
                ev = Evaluation(
                    namespace=ns, priority=job.priority, type=job.type,
                    triggered_by="job-eval", job_id=job.id,
                    job_modify_index=job.modify_index)
                s.apply_eval_update([ev])
                return {"EvalID": ev.id}
            if sub == "scale":
                # reference: Job.Scale RPC / `nomad job scale`
                group = (body or {}).get("Target", {}).get("Group", "")
                count = (body or {}).get("Count")
                if count is None or not group:
                    raise APIError(400, "Target.Group and Count required")
                tg = job.lookup_task_group(group)
                if tg is None:
                    raise APIError(400, f"unknown task group {group!r}")
                scaled = job.copy()
                scaled.lookup_task_group(group).count = int(count)
                ev = s.register_job(scaled)
                return {"EvalID": ev.id if ev else ""}
        raise APIError(404, f"no job handler for {method} {p}")

    def _node(self, method: str, p: List[str],
              qs: Dict[str, List[str]], body: Optional[Dict]) -> Any:
        s = self.server
        node_id = p[0]
        sub = p[1] if len(p) > 1 else ""
        node = s.state.node_by_id(node_id)
        if node is None:
            raise APIError(404, "node not found")
        if method == "GET":
            if sub == "allocations":
                return [codec.encode(a)
                        for a in s.state.snapshot().allocs_by_node(node_id)]
            return codec.encode(node)
        if method in ("PUT", "POST"):
            if sub == "drain":
                spec = (body or {}).get("DrainSpec")
                strategy = None
                if spec is not None:
                    strategy = DrainStrategy(
                        deadline_s=(spec.get("Deadline") or 0) / 1e9,
                        ignore_system_jobs=spec.get(
                            "IgnoreSystemJobs", False))
                s.drain_node(node_id, strategy)
                return {"NodeModifyIndex": s.state.latest_index()}
            if sub == "eligibility":
                elig = (body or {}).get("Eligibility", "eligible")
                s.set_node_eligibility(node_id, elig == "eligible")
                return {"NodeModifyIndex": s.state.latest_index()}
            if sub == "purge":
                s.state.delete_node(node_id)
                return {}
            if sub == "heartbeat":
                # reference: Node.UpdateStatus keepalive — resets the TTL
                # timer and revives a server-side "down" verdict
                s.heartbeat_node(node_id)
                return {"NodeID": node_id,
                        "HeartbeatTTL": s.heartbeats.ttl}
            if sub == "allocations":
                # reference: Node.UpdateAlloc — the client pushes alloc
                # status transitions (running/complete/failed) up; the
                # server merges them and reacts to terminal ones
                updates = [codec.decode(Allocation, w)
                           for w in (body or {}).get("Allocs", [])]
                s.update_allocs_from_client(updates)
                return {"Updated": len(updates)}
        raise APIError(404, f"no node handler for {method} {p}")

    def _deployment(self, method: str, p: List[str],
                    body: Optional[Dict], acl=None) -> Any:
        s = self.server
        if method in ("PUT", "POST") and len(p) == 2:
            op, dep_id = p
            cur = s.state.deployment_by_id(dep_id)
            if cur is not None:
                self._check_ns(acl, cur.namespace, "submit-job")
            if op == "promote":
                groups = (body or {}).get("Groups")
                err = s.deployments.promote(
                    dep_id, groups if not (body or {}).get("All") else None)
            elif op == "fail":
                err = s.deployments.fail(dep_id)
            elif op == "pause":
                err = s.deployments.pause(
                    dep_id, (body or {}).get("Pause", True))
            else:
                raise APIError(404, f"unknown deployment op {op}")
            if err:
                raise APIError(400, err)
            return {"DeploymentModifyIndex": s.state.latest_index()}
        dep = s.state.deployment_by_id(p[0])
        if dep is None:
            raise APIError(404, "deployment not found")
        self._check_ns(acl, dep.namespace, "read-job")
        if len(p) > 1 and p[1] == "allocations":
            snap = s.state.snapshot()
            return [codec.encode(a) for a in
                    snap.allocs_by_job(dep.namespace, dep.job_id)
                    if a.deployment_id == dep.id]
        return codec.encode(dep)

    def _acl(self, method: str, p: List[str], body: Optional[Dict],
             token: str = "") -> Any:
        from nomad_tpu_torch.acl import parse_policy
        from nomad_tpu_torch.structs import ACLPolicy, ACLToken
        s = self.server
        head = p[0] if p else ""
        if head == "token" and p[1:2] == ["self"] and method == "GET":
            # reference: `nomad acl token self` — introspect the caller
            t = s.state.acl_token_by_secret(token)
            if t is None:
                raise APIError(403, "token not found")
            return codec.encode(t)
        if head == "bootstrap" and method in ("PUT", "POST"):
            token, err = s.bootstrap_acl()
            if err:
                raise APIError(400, err)
            return codec.encode(token)
        if head == "policies" and method == "GET":
            return [{"Name": x.name, "Description": x.description}
                    for x in s.state.acl_policies()]
        if head == "policy":
            name = p[1]
            if method == "GET":
                pol = s.state.acl_policy_by_name(name)
                if pol is None:
                    raise APIError(404, "policy not found")
                return codec.encode(pol)
            if method in ("PUT", "POST"):
                rules = (body or {}).get("Rules", "")
                try:
                    parse_policy(rules)
                except Exception as e:  # noqa: BLE001 - surface parse error
                    raise APIError(400, f"invalid policy: {e}")
                s.state.upsert_acl_policy(ACLPolicy(
                    name=name,
                    description=(body or {}).get("Description", ""),
                    rules=rules))
                return {}
            if method == "DELETE":
                s.state.delete_acl_policy(name)
                return {}
        if head == "login" and method in ("PUT", "POST"):
            # token EXCHANGE: a third-party JWT in, an ACL token out
            # (reference: ACL.Login; unauthenticated by design — see
            # _enforce)
            from nomad_tpu_torch.acl.auth_methods import AuthError, login
            name = (body or {}).get("AuthMethodName", "")
            jwt = (body or {}).get("LoginToken", "")
            if not name or not jwt:
                raise APIError(400, "AuthMethodName and LoginToken "
                                    "required")
            try:
                tok, _ = login(s.state, name, jwt)
            except AuthError as e:
                raise APIError(403, str(e))
            s.state.upsert_acl_token(tok)
            return codec.encode(tok)
        if head == "auth-methods" and method == "GET":
            return [{"Name": m.name, "Type": m.type,
                     "Default": m.default,
                     "TokenLocality": m.token_locality}
                    for m in s.state.acl_auth_methods()]
        if head == "auth-method":
            from nomad_tpu_torch.acl.auth_methods import validate_method
            from nomad_tpu_torch.structs import ACLAuthMethod
            if method in ("PUT", "POST") and len(p) >= 2:
                b = body or {}
                # TTL: codec wire form "MaxTokenTTL" is nanoseconds (it
                # must round-trip through GET); "MaxTokenTTLS" seconds
                # accepted as the human-friendly alternative
                if "MaxTokenTTL" in b:
                    ttl_s = float(b["MaxTokenTTL"]) / 1e9
                else:
                    ttl_s = float(b.get("MaxTokenTTLS", 3600.0))
                m = ACLAuthMethod(
                    name=p[1],
                    type=b.get("Type", "JWT"),
                    token_locality=b.get("TokenLocality", "local"),
                    max_token_ttl_s=ttl_s,
                    default=bool(b.get("Default", False)),
                    config=dict(b.get("Config") or {}))
                err = validate_method(m)
                if err:
                    raise APIError(400, err)
                s.state.upsert_acl_auth_method(m)
                return codec.encode(m)
            if method == "GET" and len(p) >= 2:
                m = s.state.acl_auth_method_by_name(p[1])
                if m is None:
                    raise APIError(404, "auth method not found")
                return codec.encode(m)
            if method == "DELETE" and len(p) >= 2:
                s.state.delete_acl_auth_method(p[1])
                return {}
        if head == "binding-rules" and method == "GET":
            return [codec.encode(r) for r in s.state.acl_binding_rules()]
        if head == "binding-rule":
            from nomad_tpu_torch.structs import ACLBindingRule
            if method in ("PUT", "POST") and len(p) == 1:
                b = body or {}
                if s.state.acl_auth_method_by_name(
                        b.get("AuthMethod", "")) is None:
                    raise APIError(400, "unknown AuthMethod")
                if b.get("BindType", "policy") not in ("policy",
                                                       "management"):
                    raise APIError(400, "BindType must be policy or "
                                        "management")
                if (b.get("BindType", "policy") == "policy"
                        and not b.get("BindName")):
                    raise APIError(400, "policy binding rules need a "
                                        "BindName (reference rejects "
                                        "these at create time too)")
                r = ACLBindingRule(
                    auth_method=b["AuthMethod"],
                    selector=b.get("Selector", ""),
                    bind_type=b.get("BindType", "policy"),
                    bind_name=b.get("BindName", ""))
                s.state.upsert_acl_binding_rule(r)
                return codec.encode(r)
            if method == "GET" and len(p) >= 2:
                r = s.state.acl_binding_rule_by_id(p[1])
                if r is None:
                    raise APIError(404, "binding rule not found")
                return codec.encode(r)
            if method == "DELETE" and len(p) >= 2:
                s.state.delete_acl_binding_rule(p[1])
                return {}
        if head == "tokens" and method == "GET":
            return [_token_stub(t) for t in s.state.acl_tokens()]
        if head == "token":
            if method in ("PUT", "POST") and len(p) == 1:
                t = ACLToken(
                    name=(body or {}).get("Name", ""),
                    type=(body or {}).get("Type", "client"),
                    policies=list((body or {}).get("Policies", [])),
                    global_=(body or {}).get("Global", False),
                    create_time=s.clock.time())
                s.state.upsert_acl_token(t)
                return codec.encode(t)
            accessor = p[1]
            tok = s.state.acl_token_by_accessor(accessor)
            if tok is None:
                raise APIError(404, "token not found")
            if method == "GET":
                return codec.encode(tok)
            if method == "DELETE":
                s.state.delete_acl_token(accessor)
                return {}
        raise APIError(404, f"no acl handler for {method} {p}")

    def _namespace(self, method: str, p: List[str],
                   body: Optional[Dict]) -> Any:
        from nomad_tpu_torch.structs import Namespace
        s = self.server
        name = p[0]
        if method == "GET":
            for n in s.state.snapshot().namespaces():
                if n.name == name:
                    return codec.encode(n)
            raise APIError(404, "namespace not found")
        if method in ("PUT", "POST"):
            s.state.upsert_namespace(Namespace(
                name=(body or {}).get("Name", name),
                description=(body or {}).get("Description", "")))
            return {}
        if method == "DELETE":
            err = s.state.delete_namespace(name)
            if err:
                raise APIError(400, err)
            return {}
        raise APIError(404, "bad namespace request")

    def _node_pool(self, method: str, p: List[str],
                   body: Optional[Dict]) -> Any:
        from nomad_tpu_torch.structs import NodePool
        s = self.server
        name = p[0]
        if method == "GET":
            for n in s.state.snapshot().node_pools():
                if n.name == name:
                    return codec.encode(n)
            raise APIError(404, "node pool not found")
        if method in ("PUT", "POST"):
            s.state.upsert_node_pool(NodePool(
                name=(body or {}).get("Name", name),
                description=(body or {}).get("Description", ""),
                scheduler_algorithm=(body or {}).get(
                    "SchedulerAlgorithm", "")))
            return {}
        if method == "DELETE":
            err = s.state.delete_node_pool(name)
            if err:
                raise APIError(400, err)
            return {}
        raise APIError(404, "bad node pool request")

    def _client_fs(self, method: str, p: List[str], ns: str,
                   qs: Dict[str, List[str]], acl=None,
                   body: Optional[Dict] = None) -> Any:
        """/v1/client/* — alloc filesystem, task logs, alloc stats,
        served by the agent's in-process clients (reference:
        client/fs_endpoint.go + alloc stats, proxied by the HTTP agent).

        Shapes:
          GET /v1/client/fs/logs/<alloc>?task=T&type=stdout|stderr
              &offset=N&limit=N     -> {"Data": ..., "Offset": end}
          GET /v1/client/fs/ls/<alloc>?path=sub/dir  -> [entries]
          GET /v1/client/fs/cat/<alloc>?path=file    -> raw text
          GET /v1/client/allocation/<alloc>/stats    -> resource usage
        """
        import os
        s = self.server

        def find_runner(alloc_id):
            for c in self.agent.clients:
                ar = c.alloc_runners.get(alloc_id)
                if ar is not None:
                    return c, ar
            raise APIError(404, "alloc not running on this agent")

        def check_alloc_ns(alloc_id, cap="read-job"):
            a = s.state.alloc_by_id(alloc_id)
            if a is None:
                # fail CLOSED: a runner may outlive the server-side alloc
                # (GC), and serving its files on the caller-chosen
                # namespace's grant would leak across namespaces
                raise APIError(404, "alloc not found")
            self._check_ns(acl, a.namespace, cap)

        # ---- interactive exec session endpoints ------------------------
        #   GET  allocation/:id/exec/:sid/stream?offset=N   (long-poll)
        #   POST allocation/:id/exec/:sid/stdin  {"Data"|"Eof"}
        #   DELETE allocation/:id/exec/:sid
        if (len(p) >= 4 and p[0] == "allocation" and p[2] == "exec"):
            import base64 as _b64
            alloc_id, sid = p[1], p[3]
            check_alloc_ns(alloc_id, cap="alloc-exec")
            sess = self.exec_sessions.get(sid)
            if sess is None or sess.alloc_id != alloc_id:
                raise APIError(404, "exec session not found")
            if method == "GET" and p[4:5] == ["stream"]:
                import math
                try:
                    offset = int((qs.get("offset") or ["0"])[0])
                    timeout = min(float((qs.get("timeout") or ["25"])[0]),
                                  55.0)
                except ValueError as e:
                    raise APIError(400, f"bad offset/timeout: {e}")
                if not math.isfinite(timeout) or timeout < 0:
                    raise APIError(400, "bad timeout")
                data, off, exited, code = sess.wait_output(
                    offset, timeout=timeout)
                return {"Data": _b64.b64encode(data).decode(),
                        "Offset": off, "Exited": exited,
                        "ExitCode": code}
            if method in ("PUT", "POST") and p[4:5] == ["stdin"]:
                if (body or {}).get("Eof"):
                    sess.stdin_eof()
                    return {}
                try:
                    raw = _b64.b64decode((body or {}).get("Data") or "")
                except (ValueError, TypeError) as e:
                    raise APIError(400, f"bad Data: {e}")
                try:
                    sess.stdin(raw)
                except (OSError, ValueError) as e:
                    raise APIError(400, f"stdin closed: {e}")
                return {}
            if method == "DELETE":
                self.exec_sessions.remove(sid)
                return {}
            raise APIError(404, "bad exec session request")

        if (method in ("PUT", "POST") and len(p) >= 3
                and p[0] == "allocation" and p[2] == "exec"):
            # exec (reference: `nomad alloc exec`).  One-shot by default
            # (combined output in one response); {"Interactive": true}
            # opens a streaming SESSION instead — stdout via long-poll,
            # stdin via POSTs (see the session endpoints above; the
            # reference streams both over a websocket)
            import base64 as _b64
            alloc_id = p[1]
            check_alloc_ns(alloc_id, cap="alloc-exec")
            _, ar = find_runner(alloc_id)
            task = (body or {}).get("Task") or ""
            if not task:
                if len(ar.task_runners) != 1:
                    # never guess among multiple tasks (the reference CLI
                    # demands an explicit task name too)
                    raise APIError(
                        400, "alloc has multiple tasks; Task required")
                task = ar.task_runners[0].task.name
            cmd = (body or {}).get("Cmd") or []
            if not cmd:
                raise APIError(400, "Cmd required")
            tr = next((r for r in ar.task_runners
                       if r.task.name == task), None)
            if tr is None or tr.handle is None:
                raise APIError(404, f"task {task!r} not running")
            from nomad_tpu_torch.client.drivers.base import DriverError
            if (body or {}).get("Interactive"):
                from nomad_tpu_torch.client.exec_session import ExecSession
                try:
                    stream = tr.driver.open_exec(
                        tr.handle, [str(c) for c in cmd])
                except DriverError as e:
                    raise APIError(400, str(e))
                sess = ExecSession(stream, alloc_id=alloc_id, task=task)
                self.exec_sessions.add(sess)
                return {"SessionId": sess.id}
            timeout = min(float((body or {}).get("Timeout") or 30.0),
                          300.0)
            try:
                out, code = tr.driver.exec_task(
                    tr.handle, [str(c) for c in cmd], timeout=timeout)
            except DriverError as e:
                raise APIError(400, str(e))
            return {"Output": _b64.b64encode(out).decode(),
                    "ExitCode": code}

        if method != "GET" or len(p) < 2:
            raise APIError(404, "bad client request")

        if p[0] == "allocation" and p[2:3] == ["stats"]:
            alloc_id = p[1]
            check_alloc_ns(alloc_id)
            _, ar = find_runner(alloc_id)
            tasks = {}
            for tr in ar.task_runners:
                pid = tr.handle.pid if tr.handle else 0
                cpu_ticks = rss_kb = 0
                if pid:
                    try:
                        with open(f"/proc/{pid}/stat", "rb") as f:
                            st = f.read()
                        fl = st[st.rfind(b")") + 2:].split()
                        cpu_ticks = int(fl[11]) + int(fl[12])
                        with open(f"/proc/{pid}/statm") as f:
                            rss_kb = int(f.read().split()[1]) \
                                * (os.sysconf("SC_PAGE_SIZE") // 1024)
                    except (OSError, IndexError, ValueError):
                        pass
                tasks[tr.task.name] = {
                    "Pid": pid,
                    "State": tr.state.state,
                    "CPUTicks": cpu_ticks,
                    "MemoryRSSKB": rss_kb,
                    "Restarts": tr.state.restarts,
                }
            return {"AllocID": alloc_id, "Tasks": tasks}

        if p[0] != "fs" or len(p) < 3:
            raise APIError(404, "bad client request")
        op, alloc_id = p[1], p[2]
        check_alloc_ns(alloc_id)
        c, ar = find_runner(alloc_id)
        base = os.path.realpath(os.path.join(c.data_dir, alloc_id))
        if not os.path.isdir(base):
            raise APIError(404, "alloc filesystem not found")

        def safe(rel: str) -> str:
            # confine to the alloc sandbox (reference: fs_endpoint path
            # validation) — symlinks and .. must not escape
            full = os.path.realpath(os.path.join(base, rel.lstrip("/")))
            if full != base and not full.startswith(base + os.sep):
                raise APIError(403, "path escapes allocation directory")
            return full

        if op == "logs":
            task = (qs.get("task") or [""])[0]
            if not task and ar.task_runners:
                task = ar.task_runners[0].task.name
            kind = (qs.get("type") or ["stdout"])[0]
            if kind not in ("stdout", "stderr"):
                raise APIError(400, "type must be stdout|stderr")
            try:
                offset = int((qs.get("offset") or ["0"])[0])
                limit = min(int((qs.get("limit") or [str(1 << 20)])[0]),
                            1 << 22)
            except ValueError:
                raise APIError(400, "offset/limit must be integers")
            path = safe(os.path.join(task, f"{task}.{kind}"))
            try:
                size = os.path.getsize(path)
                if offset < 0:           # tail semantics
                    offset = max(0, size + offset)
                with open(path, "rb") as f:
                    f.seek(offset)
                    data = f.read(limit)
            except OSError:
                return {"Data": "", "Offset": 0, "Size": 0}
            return {"Data": data.decode(errors="replace"),
                    "Offset": offset + len(data), "Size": size}
        if op == "ls":
            rel = (qs.get("path") or [""])[0]
            full = safe(rel)
            try:
                out = []
                for name in sorted(os.listdir(full)):
                    fp = os.path.join(full, name)
                    st = os.stat(fp, follow_symlinks=False)
                    out.append({"Name": name,
                                "IsDir": os.path.isdir(fp),
                                "Size": st.st_size,
                                "ModTime": st.st_mtime})
                return out
            except OSError as e:
                raise APIError(404, f"ls: {e}")
        if op == "cat":
            rel = (qs.get("path") or [""])[0]
            if not rel:
                raise APIError(400, "path required")
            full = safe(rel)
            try:
                with open(full, "rb") as f:
                    return f.read(1 << 22).decode(errors="replace")
            except OSError as e:
                raise APIError(404, f"cat: {e}")
        raise APIError(404, "bad client fs request")

    def _var(self, method: str, p: List[str], ns: str,
             body: Optional[Dict], acl=None) -> Any:
        from nomad_tpu_torch.structs import VariableItem
        s = self.server
        path = "/".join(p)
        if not path:
            raise APIError(400, "variable path required")
        # path-level enforcement: workload identities only read their own
        # job's subtree (reference: the implicit workload policy)
        if acl is not None and not acl.allow_variable(
                ns, path, write=method != "GET"):
            raise APIError(403, f"permission denied for variable {path!r}")
        if method == "GET":
            v = s.state.variable_by_path(ns, path)
            if v is None:
                raise APIError(404, "variable not found")
            return codec.encode(v)
        if method in ("PUT", "POST"):
            items = (body or {}).get("Items") or {}
            if not isinstance(items, dict) or not all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in items.items()):
                raise APIError(400, "Items must be a string map")
            s.state.upsert_variable(VariableItem(
                path=path, namespace=ns, items=dict(items)))
            return codec.encode(s.state.variable_by_path(ns, path))
        if method == "DELETE":
            s.state.delete_variable(ns, path)
            return {}
        raise APIError(404, "bad variable request")

    # ------------------------------------------------------------ helpers

    def _read_local(self, read, timeout: float = 5.0):
        """Read-your-writes after a possibly-forwarded mutation: on a
        cluster follower the raft apply lands asynchronously, so a read
        issued right after a write can miss it — poll briefly for the
        local store to catch up (the reference achieves this with the
        write's raft index + blocking query; the forwarded result here
        doesn't carry the index).  Deadlines ride the injected clock
        with a perf_counter liveness cap: the HTTP connection is real
        even when the timebase is virtual."""
        import time as _time
        clock = self.server.clock
        deadline = clock.monotonic() + timeout
        cap = _time.perf_counter() + timeout
        while True:
            v = read()
            if v is not None or clock.monotonic() >= deadline \
                    or _time.perf_counter() >= cap:
                return v
            self.server.state.wait_for_index(
                self.server.state.latest_index() + 1, timeout=0.02)

    def _block(self, qs: Dict[str, List[str]],
               result_index=None, shape=None) -> None:
        """Minimal blocking-query support (reference: blockingRPC).
        With `result_index` — a callable returning the watched result
        set's max modify index — the wait re-arms until THAT passes the
        caller's index: a write to an unrelated table must not wake a
        jobs watcher with an unchanged jobs list (the reference blocks
        on the queried table's index, not the global one).  A deletion
        can't raise the result's max index, so pure-removal changes ride
        the wait timeout; blocking clients re-poll on timeout anyway.

        `shape` fingerprints the watched set (table + key filter): all
        clients sharing a shape park on ONE store wait in the server's
        WatchHub (core/fanout.py), and one result-index evaluation per
        commit batch wakes them together.  Without a shape the request
        gets a private one.  When the hub is disabled (bench A/B
        baseline: server.watch_hub = None) the legacy per-client re-arm
        loop runs instead, now routed through the Clock seam."""
        idx = qs.get("index")
        if not idx:
            return
        n = int(idx[0])
        # 300s cap mirrors the reference's max_query_time default (5min
        # blocking queries); clients re-poll on timeout
        wait = min(float((qs.get("wait") or ["5"])[0]), 300.0)
        state = self.server.state
        if result_index is None:
            # plain store-index wait: still a shape ("any write"), so N
            # idle list watchers share one store wait too
            result_index = state.latest_index
            shape = ("__index__",)
        hub = getattr(self.server, "watch_hub", None)
        if hub is not None:
            hub.block(shape if shape is not None
                      else ("__request__", id(result_index)),
                      result_index, n, wait)
            return
        import time as _time
        clock = self.server.clock
        deadline = clock.monotonic() + wait
        cap = _time.perf_counter() + wait
        while result_index() <= n:
            remaining = min(deadline - clock.monotonic(),
                            cap - _time.perf_counter())
            if remaining <= 0:
                return
            # wake on the next store write, re-check the RESULT's index
            # (1s re-arm slice bounds the unrelated-write wakeup churn)
            state.wait_for_index(state.latest_index() + 1,
                                 timeout=min(remaining, 1.0))

    @staticmethod
    def _allocations_columnar(snap, ns: str) -> Dict[str, Any]:
        """/v1/allocations?columnar=true — parallel column arrays served
        straight off AllocBlock storage (ids / picks / node_table /
        indexes) plus the loose per-alloc rows; no per-row wire dict is
        built (the follower-dashboard list path at 100k allocs).  Rows
        are filtered to live jobs so the columnar and per-row modes
        return the same answer (the per-row path walks jobs; allocs
        orphaned by a purge must not appear in one mode only)."""
        live = {(j.namespace, j.id) for j in snap.jobs()}
        ids: List[str] = []
        names: List[str] = []
        jobs_: List[str] = []
        nodes_: List[str] = []
        status: List[str] = []
        indexes: List[int] = []
        blocks = 0
        for b in snap.alloc_blocks():
            t = b.template
            if not (ns == "*" or t.namespace == ns):
                continue
            if (t.namespace, t.job_id) not in live:
                continue
            blocks += 1
            ids.extend(b.ids)
            prefix = b.name_prefix
            names.extend(prefix + str(i) + "]" for i in b.indexes)
            nt = b.node_table
            if b.picks is not None:
                nodes_.extend(nt[p] for p in b.picks.tolist())
            jobs_.extend([t.job_id] * b.count)
            status.extend([t.client_status] * b.count)
            indexes.extend([b.modify_index] * b.count)
        for a in snap.allocs():
            if not (ns == "*" or a.namespace == ns):
                continue
            if (a.namespace, a.job_id) not in live:
                continue
            ids.append(a.id)
            names.append(a.name)
            jobs_.append(a.job_id)
            nodes_.append(a.node_id)
            status.append(a.client_status)
            indexes.append(a.modify_index)
        return {"Columnar": True, "Count": len(ids), "Blocks": blocks,
                "Columns": {"ID": ids, "Name": names, "JobID": jobs_,
                            "NodeID": nodes_, "ClientStatus": status,
                            "ModifyIndex": indexes}}

    def _plan(self, job: Job, diff: bool) -> Dict[str, Any]:
        """Dry-run the scheduler on a snapshot with a no-op planner
        (reference: Job.Plan + scheduler/annotate.go)."""
        from nomad_tpu_torch.scheduler import new_scheduler

        s = self.server
        snap = s.state.snapshot()

        class _PlanPlanner:
            plan = None

            def submit_plan(self, p):
                self.plan = p
                return None, None, None

            def update_eval(self, e):
                pass

            def create_eval(self, e):
                pass

            def reblock_eval(self, e):
                pass

        planner = _PlanPlanner()
        ev = Evaluation(namespace=job.namespace, type=job.type,
                        triggered_by="job-register", job_id=job.id,
                        annotate_plan=True)
        # plan against a state view with the submitted job in place
        import copy as _copy
        staged = _copy.copy(job)
        staged.version = (s.state.job_by_id(job.namespace, job.id).version + 1
                          if s.state.job_by_id(job.namespace, job.id)
                          else 0)
        # `now` from the server's injected clock: a dry-run plan under a
        # virtual-time soak must reason about reschedule/drain windows
        # in virtual time, not the host wall
        sched = new_scheduler(job.type, _StagedState(snap, staged), planner,
                              engine=s.engine, now=s.clock.time())
        sched.process(ev)
        plan = planner.plan
        out: Dict[str, Any] = {
            "JobModifyIndex": staged.version,
            "FailedTGAllocs": {k: codec.encode(m) for k, m in
                               sched.failed_tg_allocs.items()},
            "Annotations": codec.encode(plan.annotations)
            if plan is not None and plan.annotations else None,
        }
        if plan is not None:
            n_alloc = (sum(len(v) for v in plan.node_allocation.values())
                       + sum(b.count for b in plan.alloc_blocks))
            out["CreatedAllocs"] = n_alloc
        return out

    def _search(self, body: Dict, ns: str) -> Dict[str, Any]:
        """Prefix search over ids (reference: Search.PrefixSearch)."""
        prefix = body.get("Prefix", "")
        context = body.get("Context", "all")
        snap = self.server.state.snapshot()
        out: Dict[str, List[str]] = {}
        if context in ("all", "jobs"):
            out["jobs"] = [j.id for j in snap.jobs()
                           if j.id.startswith(prefix)][:20]
        if context in ("all", "nodes"):
            out["nodes"] = [n.id for n in snap.nodes()
                            if n.id.startswith(prefix)][:20]
        if context in ("all", "allocs"):
            out["allocs"] = [a.id for j in snap.jobs() for a in
                             snap.allocs_by_job(j.namespace, j.id)
                             if a.id.startswith(prefix)][:20]
        if context in ("all", "evals"):
            out["evals"] = [e.id for e in snap.evals()
                            if e.id.startswith(prefix)][:20]
        if context in ("all", "deployment"):
            out["deployment"] = [d.id for d in snap.deployments()
                                 if d.id.startswith(prefix)][:20]
        return {"Matches": out, "Truncations": {}}


class _StagedState:
    """Snapshot wrapper that overlays one not-yet-registered job (the
    `nomad job plan` dry-run view)."""

    def __init__(self, snap, job: Job) -> None:
        self._snap = snap
        self._job = job

    def job_by_id(self, namespace: str, job_id: str):
        if (namespace, job_id) == (self._job.namespace, self._job.id):
            return self._job
        return self._snap.job_by_id(namespace, job_id)

    def __getattr__(self, name):
        return getattr(self._snap, name)


class HTTPAPIServer:
    """Threaded HTTP server bound to an agent."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 0) -> None:
        self.agent = agent
        router = Router(agent)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # quiet
                pass

            def _respond(self, status: int, payload: Any,
                         index: Optional[int] = None) -> None:
                if isinstance(payload, BytesResponse):
                    data = bytes(payload)
                    ctype = payload.content_type
                elif isinstance(payload, TextResponse):
                    data = str(payload).encode()
                    ctype = payload.content_type
                else:
                    data = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Nomad-Index", str(
                    index if index is not None
                    else router.server.state.latest_index()))
                # consistency headers (reference: setMeta): a leader
                # always knows itself; a follower reports its tail
                # health so clients can bound staleness
                follower = getattr(router.agent, "follower", None)
                if follower is None:
                    known, contact_ms = "true", "0"
                else:
                    known = ("true" if follower.known_leader
                             else "false")
                    age = follower.last_contact_s()
                    contact_ms = str(int((age if age is not None
                                          else -1) * 1000))
                self.send_header("X-Nomad-KnownLeader", known)
                self.send_header("X-Nomad-LastContact", contact_ms)
                self.end_headers()
                self.wfile.write(data)

            def _handle(self, method: str) -> None:
                parsed = urllib.parse.urlparse(self.path)
                qs = urllib.parse.parse_qs(parsed.query)
                if parsed.path in ("/", "/ui", "/ui/") and method == "GET":
                    from .ui import UI_HTML
                    data = UI_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if parsed.path in ("/v1/event/stream",
                                   "/v1/agent/monitor") and method == "GET":
                    # streaming endpoints bypass route(), but NOT the ACL
                    token = self.headers.get("X-Nomad-Token", "")
                    ns = (qs.get("namespace") or [DEFAULT_NAMESPACE])[0]
                    try:
                        router._enforce(
                            "GET", parsed.path.split("/")[2:], ns, token)
                    except APIError as e:
                        return self._respond(e.status, {"Error": str(e)})
                    if parsed.path == "/v1/event/stream":
                        return self._stream(qs)
                    return self._monitor(qs)
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        return self._respond(400, {"Error": "bad json"})
                token = self.headers.get("X-Nomad-Token", "")
                try:
                    status, payload = router.route(
                        method, parsed.path, qs, body, token=token)
                    self._respond(status, payload)
                except APIError as e:
                    self._respond(e.status, {"Error": str(e)})
                except Exception as e:  # noqa: BLE001 - endpoint isolation
                    self._respond(
                        500, {"Error": f"{type(e).__name__}: {e}"})

            def _chunked_loop(self, pull, cleanup) -> None:
                """Shared chunked-streaming scaffold for the event and
                monitor streams.  `pull(timeout) -> (line_bytes|None,
                ended)`; 10s idle heartbeats detect dead clients; a
                graceful end terminates the chunked body; `cleanup` always
                runs (including on pre-body write failures).  Heartbeat
                pacing is an interval measurement on a real TCP
                connection — perf_counter, the sanctioned raw
                primitive, not the injected timebase."""
                import time as _time

                def chunk(data: bytes) -> None:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    last_write = _time.perf_counter()
                    while True:
                        line, ended = pull(0.5)
                        if ended:
                            self.wfile.write(b"0\r\n\r\n")
                            self.wfile.flush()
                            break
                        if line is not None:
                            chunk(line)
                            last_write = _time.perf_counter()
                        elif _time.perf_counter() - last_write > 10:
                            chunk(b"{}\n")   # idle: detect disconnects
                            last_write = _time.perf_counter()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    self.close_connection = True
                    cleanup()

            def _stream(self, qs: Dict[str, List[str]]) -> None:
                topics: Dict[str, List[str]] = {}
                for t in qs.get("topic", []):
                    topic, _, key = t.partition(":")
                    topics.setdefault(topic, []).append(key or "*")
                try:
                    from_index = int((qs.get("index") or ["0"])[0])
                except ValueError:
                    return self._respond(400, {"Error": "bad index"})
                sub = router.server.events.subscribe(
                    topics or None, from_index=from_index)

                def pull(timeout):
                    if sub.closed:
                        return None, True
                    ev = sub.next(timeout=timeout)
                    if ev is None:
                        return (None, sub.closed)
                    return (json.dumps(
                        {"Index": ev.index,
                         "Events": [ev.wire()]}).encode() + b"\n", False)

                self._chunked_loop(
                    pull, lambda: router.server.events.unsubscribe(sub))

            def _monitor(self, qs: Dict[str, List[str]]) -> None:
                """Stream the structured log ring (reference: the
                `nomad monitor` RPC): backlog first, then live records,
                as newline-delimited JSON."""
                import queue as _queue
                from nomad_tpu_torch.core.logging import LEVELS, RING
                min_level = (qs.get("log_level") or ["info"])[0]
                lvl = LEVELS.get(min_level, 2)
                # snapshot the backlog BEFORE subscribing: the reverse
                # order delivers records landing in between twice
                backlog = list(RING.tail(100, min_level))
                sub = RING.subscribe()

                def pull(timeout):
                    if backlog:
                        return json.dumps(backlog.pop(0)).encode() + b"\n", \
                            False
                    try:
                        rec = sub.get(timeout=timeout)
                    except _queue.Empty:
                        return None, False
                    if rec is None:
                        return None, True
                    if LEVELS.get(rec["level"], 2) < lvl:
                        return None, False
                    return json.dumps(rec).encode() + b"\n", False

                self._chunked_loop(pull, lambda: RING.unsubscribe(sub))

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_POST(self):
                self._handle("POST")

            def do_DELETE(self):
                self._handle("DELETE")

        class _FanoutHTTPServer(ThreadingHTTPServer):
            # the socketserver default backlog (5) refuses connections
            # when a watcher fleet connects in a burst (bench --watchers
            # arms hundreds of blocking queries at once); size the
            # accept queue for the read-path fanout plane instead
            request_queue_size = 1024

        self.httpd = _FanoutHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.addr = f"http://{host}:{self.httpd.server_port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http-api", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
