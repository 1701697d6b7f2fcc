"""Python API SDK (reference: api/ — api.Client with Jobs, Nodes,
Allocations, Evaluations, Deployments, Operator, System, Search, Events).

Stdlib urllib only; JSON wire shapes match the HTTP API (and the
reference's CamelCase forms).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Iterator, List, Optional


class APIException(Exception):
    def __init__(self, status: int, msg: str) -> None:
        super().__init__(f"{status}: {msg}")
        self.status = status


class APIClient:
    def __init__(self, address: str = "http://127.0.0.1:4646",
                 namespace: str = "default", timeout: float = 35.0,
                 token: str = "", region: str = "") -> None:
        self.address = address.rstrip("/")
        self.namespace = namespace
        self.timeout = timeout
        self.token = token
        # non-empty: every request targets this region (the contacted
        # agent forwards foreign regions through its federation table)
        self.region = region
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.operator = Operator(self)
        self.system = System(self)
        self.agent = Agent(self)
        self.events = Events(self)
        self.acl = ACLEndpoint(self)
        self.services = Services(self)
        self.volumes = Volumes(self)
        self.namespaces = Namespaces(self)
        self.node_pools = NodePools(self)
        self.variables = Variables(self)

    # ---------------------------------------------------------- transport

    def request(self, method: str, path: str,
                params: Optional[Dict[str, Any]] = None,
                body: Optional[Any] = None) -> Any:
        params = dict(params or {})
        params.setdefault("namespace", self.namespace)
        if self.region:
            params.setdefault("region", self.region)
        url = f"{self.address}{path}?{urllib.parse.urlencode(params, doseq=True)}"
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("Error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise APIException(e.code, msg) from None

    def request_text(self, path: str,
                     params: Optional[Dict[str, Any]] = None) -> str:
        """GET returning the raw response body as text (the Prometheus
        exposition format is not JSON)."""
        params = dict(params or {})
        params.setdefault("namespace", self.namespace)
        url = (f"{self.address}{path}?"
               f"{urllib.parse.urlencode(params, doseq=True)}")
        headers = {"X-Nomad-Token": self.token} if self.token else {}
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            raise APIException(e.code, str(e)) from None

    def get(self, path, **params):
        return self.request("GET", path, params=params)

    def put(self, path, body=None, **params):
        return self.request("PUT", path, params=params, body=body)

    def delete(self, path, **params):
        return self.request("DELETE", path, params=params)

    def search(self, prefix: str, context: str = "all") -> Dict:
        """Prefix search over ids (reference: api/search.go
        Search.PrefixSearch; backs the CLI's unique-prefix resolution)."""
        return self.put("/v1/search",
                        body={"Prefix": prefix, "Context": context})


class _Endpoint:
    def __init__(self, client: APIClient) -> None:
        self.c = client


class Jobs(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/jobs")

    def register(self, job_wire: Dict) -> Dict:
        return self.c.put("/v1/jobs", body={"Job": job_wire})

    def info(self, job_id: str) -> Dict:
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id, safe='')}")

    def deregister(self, job_id: str, purge: bool = False) -> Dict:
        return self.c.delete(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}",
            purge=str(purge).lower())

    def allocations(self, job_id: str) -> List[Dict]:
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}/allocations")

    def evaluations(self, job_id: str) -> List[Dict]:
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}/evaluations")

    def versions(self, job_id: str) -> Dict:
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}/versions")

    def deployments(self, job_id: str) -> List[Dict]:
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}/deployments")

    def latest_deployment(self, job_id: str) -> Optional[Dict]:
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id, safe='')}/deployment")

    def plan(self, job_wire: Dict, diff: bool = False) -> Dict:
        jid = urllib.parse.quote(job_wire["ID"], safe="")
        return self.c.put(f"/v1/job/{jid}/plan",
                          body={"Job": job_wire, "Diff": diff})

    def dispatch(self, job_id: str, payload: bytes = b"",
                 meta: Optional[Dict[str, str]] = None) -> Dict:
        jid = urllib.parse.quote(job_id, safe="")
        return self.c.put(
            f"/v1/job/{jid}/dispatch",
            body={"Payload": base64.b64encode(payload).decode(),
                  "Meta": meta or {}})

    def revert(self, job_id: str, version: int) -> Dict:
        jid = urllib.parse.quote(job_id, safe="")
        return self.c.put(f"/v1/job/{jid}/revert",
                          body={"JobVersion": version})

    def periodic_force(self, job_id: str) -> Dict:
        jid = urllib.parse.quote(job_id, safe="")
        return self.c.put(f"/v1/job/{jid}/periodic/force")

    def scale(self, job_id: str, group: str, count: int) -> Dict:
        jid = urllib.parse.quote(job_id, safe="")
        return self.c.put(f"/v1/job/{jid}/scale",
                          body={"Target": {"Group": group},
                                "Count": count})

    def placement_failures(self, job_id: str) -> Dict:
        """The "why pending" rollup: the newest blocked eval's per-task-
        group NodesEvaluated/Filtered/DimensionExhausted breakdown."""
        jid = urllib.parse.quote(job_id, safe="")
        return self.c.get(f"/v1/job/{jid}/placement-failures")


class Nodes(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/nodes")

    def info(self, node_id: str) -> Dict:
        return self.c.get(f"/v1/node/{node_id}")

    def allocations(self, node_id: str) -> List[Dict]:
        return self.c.get(f"/v1/node/{node_id}/allocations")

    def drain(self, node_id: str, deadline_s: float = 3600,
              ignore_system_jobs: bool = False,
              disable: bool = False) -> Dict:
        spec = None if disable else {
            "Deadline": int(deadline_s * 1e9),
            "IgnoreSystemJobs": ignore_system_jobs}
        return self.c.put(f"/v1/node/{node_id}/drain",
                          body={"DrainSpec": spec})

    def eligibility(self, node_id: str, eligible: bool) -> Dict:
        return self.c.put(
            f"/v1/node/{node_id}/eligibility",
            body={"Eligibility":
                  "eligible" if eligible else "ineligible"})

    def register(self, node_wire: Dict) -> Dict:
        """reference: Node.Register — introduce (or re-upsert) a node;
        returns the server's heartbeat TTL for the keepalive loop."""
        return self.c.put("/v1/nodes", body={"Node": node_wire})

    def heartbeat(self, node_id: str) -> Dict:
        """reference: Node.UpdateStatus keepalive."""
        return self.c.put(f"/v1/node/{node_id}/heartbeat")

    def update_allocs(self, node_id: str,
                      allocs: List[Dict]) -> Dict:
        """reference: Node.UpdateAlloc — push client-side alloc status
        transitions (wire-encoded Allocations) up to the server."""
        return self.c.put(f"/v1/node/{node_id}/allocations",
                          body={"Allocs": allocs})


class Allocations(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/allocations")

    def info(self, alloc_id: str) -> Dict:
        return self.c.get(f"/v1/allocation/{alloc_id}")

    def stop(self, alloc_id: str) -> Dict:
        return self.c.put(f"/v1/allocation/{alloc_id}/stop")

    def restart(self, alloc_id: str) -> Dict:
        return self.c.put(f"/v1/allocation/{alloc_id}/restart")

    def signal(self, alloc_id: str, signal: str) -> Dict:
        return self.c.put(f"/v1/allocation/{alloc_id}/signal",
                          body={"Signal": signal})

    def logs(self, alloc_id: str, task: str = "", type: str = "stdout",
             offset: int = 0, limit: int = 1 << 20) -> Dict:
        return self.c.get(
            f"/v1/client/fs/logs/{alloc_id}", task=task, type=type,
            offset=str(offset), limit=str(limit))

    def fs_ls(self, alloc_id: str, path: str = "") -> List[Dict]:
        return self.c.request("GET", f"/v1/client/fs/ls/{alloc_id}",
                              params={"path": path})

    def fs_cat(self, alloc_id: str, path: str) -> str:
        return self.c.request("GET", f"/v1/client/fs/cat/{alloc_id}",
                              params={"path": path})

    def stats(self, alloc_id: str) -> Dict:
        return self.c.get(f"/v1/client/allocation/{alloc_id}/stats")


class Evaluations(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/evaluations")

    def info(self, eval_id: str) -> Dict:
        return self.c.get(f"/v1/evaluation/{eval_id}")

    def allocations(self, eval_id: str) -> List[Dict]:
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations")

    def explain(self, eval_id: str) -> Dict:
        """The eval's placement-decision record: per-task-group score
        tables, filter/exhaustion breakdowns, and the blocked cause."""
        return self.c.get(f"/v1/eval/{eval_id}/explain")


class Deployments(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/deployments")

    def info(self, dep_id: str) -> Dict:
        return self.c.get(f"/v1/deployment/{dep_id}")

    def allocations(self, dep_id: str) -> List[Dict]:
        return self.c.get(f"/v1/deployment/{dep_id}/allocations")

    def promote(self, dep_id: str,
                groups: Optional[List[str]] = None) -> Dict:
        body = {"All": groups is None}
        if groups is not None:
            body["Groups"] = groups
        return self.c.put(f"/v1/deployment/promote/{dep_id}", body=body)

    def fail(self, dep_id: str) -> Dict:
        return self.c.put(f"/v1/deployment/fail/{dep_id}")

    def pause(self, dep_id: str, pause: bool = True) -> Dict:
        return self.c.put(f"/v1/deployment/pause/{dep_id}",
                          body={"Pause": pause})


class Operator(_Endpoint):
    def scheduler_config(self) -> Dict:
        return self.c.get("/v1/operator/scheduler/configuration")

    def set_scheduler_config(self, cfg_wire: Dict) -> Dict:
        return self.c.put("/v1/operator/scheduler/configuration",
                          body=cfg_wire)

    def snapshot_save(self) -> Dict:
        return self.c.get("/v1/operator/snapshot")

    def snapshot_restore(self, doc: Dict) -> Dict:
        return self.c.put("/v1/operator/snapshot", body=doc)

    def debug(self) -> Dict:
        """The `operator debug` bundle: stats + metrics + traces +
        log tail + health plane + threads in one document."""
        return self.c.get("/v1/operator/debug")

    def health(self, dumps: bool = False) -> Dict:
        """SLO verdicts (observed vs threshold per rule); `dumps=True`
        folds the retained breach dump bundles in."""
        params = {"dumps": "true"} if dumps else {}
        return self.c.request("GET", "/v1/operator/health",
                              params=params)

    def memory(self, cached: bool = False) -> Dict:
        """The memory ledger document (core/memledger.py): per-plane
        byte/entry/eviction table + process RSS.  `cached=True` returns
        the last tick sample instead of forcing a fresh scrape."""
        params = {"cached": "true"} if cached else {}
        return self.c.request("GET", "/v1/operator/memory",
                              params=params)

    def flight_recorder(self, n: Optional[int] = None) -> Dict:
        """The flight recorder's recent per-wave / per-eval / event
        rings; `n` caps each ring's tail."""
        params = {"n": n} if n else {}
        return self.c.request("GET", "/v1/operator/flight-recorder",
                              params=params)

    def profile(self, duration_s: float = 2.0, trace: bool = False,
                trace_dir: Optional[str] = None) -> Dict:
        """Timed on-demand profile capture (blocks ~duration_s): folded
        host stacks, bucket breakdown, device compile/HBM ledger,
        flight rings — one "nomad-tpu.profile.v1" bundle.  `trace=True`
        additionally records a `jax.profiler` trace into `trace_dir`."""
        body: Dict = {"DurationS": duration_s, "Trace": trace}
        if trace_dir:
            body["TraceDir"] = trace_dir
        return self.c.request("POST", "/v1/operator/profile", body=body)

    def profile_status(self) -> Dict:
        """Live sampler snapshot (no capture): buckets, GIL fractions,
        folded stacks, retained capture ids."""
        return self.c.get("/v1/operator/profile")

    def profile_capture(self, capture_id: str) -> Dict:
        """One retained capture bundle by id (`prof-0001`)."""
        return self.c.get(f"/v1/operator/profile/{capture_id}")

    def timeline(self, start: Optional[float] = None,
                 end: Optional[float] = None,
                 step: Optional[float] = None,
                 series: Optional[List[str]] = None) -> Dict:
        """Clock-aligned metric history (core/timeline.py): min/max/avg/
        last per query step with cross-plane annotations interleaved.
        All args optional — the default query spans the retained
        window at native resolution."""
        params: Dict = {}
        if start is not None:
            params["start"] = start
        if end is not None:
            params["end"] = end
        if step is not None:
            params["step"] = step
        if series:
            params["series"] = ",".join(series)
        return self.c.request("GET", "/v1/operator/timeline",
                              params=params)

    def timeline_dump(self) -> Dict:
        """Full-resolution timeline doc plus the breach/spike
        post-mortem report — what `nomad report` renders."""
        return self.c.request("GET", "/v1/operator/timeline",
                              params={"dump": "true"})

    def cluster_health(self) -> Dict:
        """Cluster-scope rollup (core/federation.py): the leader's
        per-origin federation scrape ledger plus the cluster_* subset
        of the SLO verdicts — what `nomad cluster status` renders."""
        return self.c.get("/v1/operator/cluster-health")


class System(_Endpoint):
    def gc(self) -> Dict:
        return self.c.put("/v1/system/gc")


class Agent(_Endpoint):
    def self(self) -> Dict:
        return self.c.get("/v1/agent/self")

    def members(self) -> Dict:
        return self.c.get("/v1/agent/members")

    def metrics(self, format: str = ""):
        """JSON metric dict; `format="prometheus"` returns the text
        exposition instead."""
        if format == "prometheus":
            return self.c.request_text("/v1/metrics",
                                       params={"format": "prometheus"})
        return self.c.get("/v1/metrics")

    def traces(self) -> List[Dict]:
        """Recent eval-lifecycle trace summaries."""
        return self.c.get("/v1/traces")

    def trace(self, trace_id: str, cluster: bool = False) -> Dict:
        """One trace's full span tree.  `cluster=True` asks the agent
        to scatter-gather the id from every gossip peer and stitch one
        joined cross-origin tree (core/federation.stitch_trace)."""
        params = {"cluster": "true"} if cluster else {}
        return self.c.request("GET", f"/v1/trace/{trace_id}",
                              params=params)


class Volumes(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/volumes")

    def info(self, vol_id: str) -> Dict:
        q = urllib.parse.quote(vol_id, safe="")
        return self.c.get(f"/v1/volume/csi/{q}")

    def register(self, vol_id: str, plugin_id: str, **fields) -> Dict:
        body = {"ID": vol_id, "PluginID": plugin_id}
        body.update(fields)
        q = urllib.parse.quote(vol_id, safe="")
        return self.c.put(f"/v1/volume/csi/{q}",
                          body={"Volume": body})

    def deregister(self, vol_id: str) -> Dict:
        q = urllib.parse.quote(vol_id, safe="")
        return self.c.delete(f"/v1/volume/csi/{q}")


class Services(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/services")

    def info(self, name: str) -> List[Dict]:
        return self.c.get(f"/v1/service/{name}")


class ACLEndpoint(_Endpoint):
    def bootstrap(self) -> Dict:
        return self.c.put("/v1/acl/bootstrap")

    def policies(self) -> List[Dict]:
        return self.c.get("/v1/acl/policies")

    def policy(self, name: str) -> Dict:
        return self.c.get(f"/v1/acl/policy/{name}")

    def upsert_policy(self, name: str, rules: str,
                      description: str = "") -> Dict:
        return self.c.put(f"/v1/acl/policy/{name}",
                          body={"Rules": rules,
                                "Description": description})

    def delete_policy(self, name: str) -> Dict:
        return self.c.delete(f"/v1/acl/policy/{name}")

    def tokens(self) -> List[Dict]:
        return self.c.get("/v1/acl/tokens")

    def create_token(self, name: str = "", type: str = "client",
                     policies: Optional[List[str]] = None,
                     global_: bool = False) -> Dict:
        return self.c.put("/v1/acl/token",
                          body={"Name": name, "Type": type,
                                "Policies": policies or [],
                                "Global": global_})

    def token(self, accessor_id: str) -> Dict:
        return self.c.get(f"/v1/acl/token/{accessor_id}")

    def delete_token(self, accessor_id: str) -> Dict:
        return self.c.delete(f"/v1/acl/token/{accessor_id}")


class Namespaces(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/namespaces")

    def apply(self, name: str, description: str = "") -> Dict:
        return self.c.put(f"/v1/namespace/{name}",
                          body={"Name": name, "Description": description})

    def delete(self, name: str) -> Dict:
        return self.c.delete(f"/v1/namespace/{name}")


class NodePools(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/node_pools")

    def apply(self, name: str, description: str = "",
              scheduler_algorithm: str = "") -> Dict:
        return self.c.put(f"/v1/node_pool/{name}",
                          body={"Name": name, "Description": description,
                                "SchedulerAlgorithm": scheduler_algorithm})

    def delete(self, name: str) -> Dict:
        return self.c.delete(f"/v1/node_pool/{name}")


class Variables(_Endpoint):
    def list(self, prefix: str = "") -> List[Dict]:
        return self.c.get("/v1/vars", prefix=prefix)

    def read(self, path: str) -> Dict:
        return self.c.get(f"/v1/var/{path}")

    def write(self, path: str, items: Dict[str, str]) -> Dict:
        return self.c.put(f"/v1/var/{path}", body={"Items": items})

    def delete(self, path: str) -> Dict:
        return self.c.delete(f"/v1/var/{path}")


class Events(_Endpoint):
    def stream(self, topics: Optional[List[str]] = None,
               index: int = 0) -> Iterator[Dict]:
        """Yields {"Index": N, "Events": [...]} batches until closed."""
        params: Dict[str, Any] = {"namespace": self.c.namespace,
                                  "index": index}
        if topics:
            params["topic"] = topics
        url = (f"{self.c.address}/v1/event/stream?"
               f"{urllib.parse.urlencode(params, doseq=True)}")
        req = urllib.request.Request(url)
        with urllib.request.urlopen(req) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                batch = json.loads(line)
                if batch.get("Events"):      # skip idle heartbeats ({})
                    yield batch
