"""CLI (reference: command/ — `nomad <subcommand>` over the HTTP API).

Subcommands mirror the reference's surface: job run/status/stop/plan/
dispatch/revert/periodic-force/history, node status/drain/eligibility,
alloc status, eval status/list, deployment status/list/promote/fail/pause,
operator scheduler get-config/set-config, system gc, server members,
status, and `agent -dev` (in-process server + client + HTTP API).

Entry point: `python -m nomad_tpu_torch <subcommand> ...`.

Differences from the reference (nomad_tpu/cli.py): `agent` builds the
port's Agent, which runs on CUDA and raises without it (no `-device`
flag); its plugin, cluster-mode, follower and encrypt flags work as the
reference's.  `soak` runs the port's `chaos.soak`, whose agent runs on
CUDA too and raises without it (no `-device` flag either).  Every other
command is the reference's.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.api.client import APIClient, APIException

DEFAULT_ADDR = "http://127.0.0.1:4646"


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "on"):
        return True
    if v.lower() in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def _client(args) -> APIClient:
    import os
    token = getattr(args, "token", "") or os.environ.get("NOMAD_TOKEN", "")
    region = getattr(args, "region", "") or os.environ.get(
        "NOMAD_REGION", "")
    return APIClient(address=args.address, namespace=args.namespace,
                     token=token, region=region)


def _resolve(c: APIClient, context: str, ident: str) -> str:
    """Unique-id-prefix resolution via /v1/search (reference: every
    id-taking command accepts a unique prefix — the CLI itself prints
    8-char ids, so its own output must round-trip).  Full-length ids
    pass through untouched; an unknown prefix is left for the endpoint's
    own 404; an ambiguous one is a hard error listing the count."""
    if not ident or len(ident) >= 36:
        return ident
    try:
        matches = (c.search(ident, context).get("Matches", {})
                   .get(context, []))
    except Exception:  # noqa: BLE001 - resolution is best-effort
        return ident
    if len(matches) == 1:
        return matches[0]
    if ident in matches:
        # an exact id that is also a prefix of others (node-1 next to
        # node-10) resolves to itself, never to an ambiguity error
        return ident
    if len(matches) > 1:
        raise SystemExit(
            f"Error: id prefix {ident!r} is ambiguous "
            f"({len(matches)} matches)")
    return ident


def _out(data) -> None:
    print(json.dumps(data, indent=2, sort_keys=True))


def _load_jobspec(path: str) -> dict:
    """HCL2 or API-JSON jobspec -> wire Job dict."""
    from nomad_tpu_torch.jobspec import parse_file
    from nomad_tpu_torch.structs import codec
    return codec.encode(parse_file(path))


# ---------------------------------------------------------------- commands

def cmd_agent(args) -> int:
    from nomad_tpu_torch.agent import Agent
    from nomad_tpu_torch.agent_config import AgentConfig, load_agent_config
    from nomad_tpu_torch.structs import Node

    cfg = (load_agent_config(args.config) if args.config
           else AgentConfig())
    # CLI flags win over config files (reference merge order)
    host, _, port = args.bind.partition(":") if args.bind else ("", "", "")
    if host:
        cfg.bind_addr = host
    if port:
        cfg.http_port = int(port)
    if args.clients is not None:
        cfg.client_count = args.clients
    if args.workers is not None:
        cfg.num_workers = args.workers
    if getattr(args, "worker_mode", None):
        cfg.worker_mode = args.worker_mode
    if getattr(args, "follow", None):
        cfg.follow = args.follow

    if not cfg.server_enabled:
        print("Error: client-only agents need a remote RPC transport; "
              "in-process agents always embed the server "
              "(server { enabled = false } is not supported)",
              file=sys.stderr)
        return 1
    nodes = [Node(node_class=cfg.node_class,
                  datacenter=cfg.datacenter,
                  meta=dict(cfg.client_meta))
             for _ in range(cfg.client_count)]
    agent = Agent(num_clients=cfg.client_count if cfg.client_enabled else 0,
                  num_workers=cfg.num_workers,
                  http_host=cfg.bind_addr,
                  http_port=cfg.http_port,
                  heartbeat_ttl=cfg.heartbeat_ttl,
                  acl_enabled=cfg.acl_enabled,
                  nodes=nodes,
                  server_name=getattr(args, "server_name", ""),
                  bootstrap_expect=getattr(args, "bootstrap_expect", 1),
                  join=getattr(args, "join", []) or [],
                  rpc_port=getattr(args, "rpc_port", 0),
                  raft_port=getattr(args, "raft_port", 0),
                  serf_port=getattr(args, "serf_port", 0),
                  data_dir=getattr(args, "data_dir", "") or None,
                  plugin_dir=getattr(args, "plugin_dir", ""),
                  encrypt=cfg.encrypt,
                  region=(getattr(args, "agent_region", "")
                          or cfg.region or "global"),
                  join_wan=getattr(args, "join_wan", []) or [],
                  join_wan_token=getattr(args, "join_wan_token", ""),
                  transport=cfg.transport,
                  clock=cfg.clock,
                  log_level=cfg.log_level,
                  device_executor=cfg.device_executor,
                  slo=cfg.slo or None,
                  profile_hz=cfg.profile_hz,
                  worker_mode=cfg.worker_mode,
                  follow=cfg.follow)
    agent.start()
    print(f"==> agent started; HTTP API at {agent.address} "
          f"(region {agent.federation.region})")
    if agent.follower is not None:
        print(f"==> read follower tailing {', '.join(agent.follow)}")
    srv = agent.server
    if hasattr(srv, "gossip"):
        print(f"==> cluster server {srv.name}: rpc={srv.rpc.addr} "
              f"raft={srv.raft.addr} serf={srv.gossip.addr}")
    print(f"==> {len(agent.clients)} in-process client node(s)"
          + ("  [ACL enabled]" if cfg.acl_enabled else ""))
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.5)
    finally:
        print("==> shutting down")
        agent.shutdown()
    return 0


def cmd_job_run(args) -> int:
    wire = _load_jobspec(args.file)
    resp = _client(args).jobs.register(wire)
    print(f"job {wire['ID']!r} registered; eval {resp.get('EvalID', '')}")
    return 0


def cmd_job_status(args) -> int:
    c = _client(args)
    if not args.job_id:
        for stub in c.jobs.list():
            print(f"{stub['ID']:<40} {stub['Type']:<8} "
                  f"{stub['Priority']:<4} {stub['Status']}")
        return 0
    _out(c.jobs.info(args.job_id))
    allocs = c.jobs.allocations(args.job_id)
    if allocs:
        print(f"\nAllocations ({len(allocs)}):")
        for a in allocs:
            print(f"  {a['ID'][:8]}  {a.get('NodeID', '')[:8]}  "
                  f"{a.get('TaskGroup', '')}  "
                  f"{a.get('DesiredStatus', '')}/{a.get('ClientStatus', '')}")
    try:
        failures = c.jobs.placement_failures(args.job_id)
    except APIException:
        failures = None      # older server without the endpoint
    if failures and failures.get("TaskGroups"):
        print("\nPlacement Failures:")
        for name, tg in sorted(failures["TaskGroups"].items()):
            print(f"  Task Group {name!r}: {tg.get('Failed', 0)} "
                  "unplaced")
            _print_metric_rollup(tg, indent="    ")
            if tg.get("Cause"):
                print(f"    Why pending: {tg['Cause']}")
        if failures.get("Blocked"):
            print(f"  Evaluation {failures.get('EvalID', '')[:8]} is "
                  "blocked waiting for capacity")
    return 0


def cmd_job_stop(args) -> int:
    resp = _client(args).jobs.deregister(args.job_id, purge=args.purge)
    print(f"job {args.job_id!r} stopped; eval {resp.get('EvalID', '')}")
    return 0


def cmd_job_plan(args) -> int:
    wire = _load_jobspec(args.file)
    _out(_client(args).jobs.plan(wire, diff=True))
    return 0


def cmd_job_dispatch(args) -> int:
    payload = b""
    if args.payload_file:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    meta = {}
    for kv in args.meta or []:
        if "=" not in kv:
            print(f"Error: -meta expects key=value, got {kv!r}",
                  file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        meta[k] = v
    resp = _client(args).jobs.dispatch(args.job_id, payload, meta)
    print(f"dispatched {resp['DispatchedJobID']}")
    return 0


def cmd_job_revert(args) -> int:
    resp = _client(args).jobs.revert(args.job_id, args.version)
    print(f"reverted; eval {resp.get('EvalID', '')}")
    return 0


def cmd_job_scale(args) -> int:
    resp = _client(args).jobs.scale(args.job_id, args.group, args.count)
    print(f"scaled {args.job_id}/{args.group} to {args.count}; "
          f"eval {resp.get('EvalID', '')}")
    return 0


def cmd_volume_register(args) -> int:
    _client(args).volumes.register(args.volume_id, args.plugin)
    print(f"volume {args.volume_id!r} registered")
    return 0


def cmd_volume_status(args) -> int:
    c = _client(args)
    if args.volume_id:
        _out(c.volumes.info(args.volume_id))
    else:
        for v in c.volumes.list():
            print(f"{v['ID']:<28} {v['PluginID']:<16} "
                  f"{v['AccessMode']:<26} r{v['ReadAllocs']}/w"
                  f"{v['WriteAllocs']}")
    return 0


def cmd_volume_deregister(args) -> int:
    _client(args).volumes.deregister(args.volume_id)
    print(f"volume {args.volume_id!r} deregistered")
    return 0


def cmd_job_history(args) -> int:
    _out(_client(args).jobs.versions(args.job_id))
    return 0


def cmd_job_inspect(args) -> int:
    """reference: `nomad job inspect` — the stored job definition."""
    _out(_client(args).get(f"/v1/job/{args.job_id}"))
    return 0


def cmd_job_validate(args) -> int:
    """reference: `nomad job validate` — parse + static checks, no
    submission."""
    from nomad_tpu_torch.jobspec import parse_file
    try:
        job = parse_file(args.path)
    except Exception as e:  # noqa: BLE001 - the error IS the output
        print(f"Error: {e}", file=sys.stderr)
        return 1
    problems = []
    if not job.task_groups:
        problems.append("job has no task groups")
    for tg in job.task_groups:
        if not tg.tasks:
            problems.append(f"group {tg.name!r} has no tasks")
        for t in tg.tasks:
            if not t.driver:
                problems.append(f"task {t.name!r} has no driver")
    if problems:
        for p in problems:
            print(f"Error: {p}", file=sys.stderr)
        return 1
    print(f"job {job.id!r} is valid")
    return 0


def cmd_job_eval(args) -> int:
    """reference: `nomad job eval` — force a fresh evaluation."""
    out = _client(args).put(f"/v1/job/{args.job_id}/evaluate")
    print(f"created evaluation {out['EvalID']}")
    return 0


def cmd_job_deployments(args) -> int:
    _out(_client(args).get(f"/v1/job/{args.job_id}/deployments"))
    return 0


def cmd_job_allocs(args) -> int:
    _out(_client(args).get(f"/v1/job/{args.job_id}/allocations"))
    return 0


def cmd_job_promote(args) -> int:
    """reference: `nomad job promote` — promote the job's latest
    deployment's canaries."""
    c = _client(args)
    deps = c.get(f"/v1/job/{args.job_id}/deployments")
    if not deps:
        print("Error: job has no deployments", file=sys.stderr)
        return 1
    latest = max(deps, key=lambda d: d.get("CreateIndex", 0))
    out = c.deployments.promote(latest["ID"])
    print(f"deployment {latest['ID'][:8]} promoted "
          f"(modify index {out.get('DeploymentModifyIndex', '?')})")
    return 0


def cmd_operator_raft_list_peers(args) -> int:
    out = _client(args).get("/v1/operator/raft/configuration")
    for srv in out.get("Servers", []):
        mark = "leader" if srv.get("Leader") else "follower"
        print(f"{srv.get('Node', '?'):24} {srv.get('Address', ''):22} "
              f"{mark}")
    return 0


def cmd_acl_token_self(args) -> int:
    _out(_client(args).get("/v1/acl/token/self"))
    return 0


def cmd_regions_list(args) -> int:
    for r in _client(args).get("/v1/regions"):
        print(r)
    return 0


def cmd_version(args) -> int:
    from nomad_tpu_torch import __version__
    print(f"nomad-tpu v{__version__}")
    return 0


def cmd_job_periodic_force(args) -> int:
    resp = _client(args).jobs.periodic_force(args.job_id)
    print(f"forced launch {resp['DispatchedJobID']}")
    return 0


def cmd_node_status(args) -> int:
    c = _client(args)
    if not args.node_id:
        for n in c.nodes.list():
            print(f"{n['ID'][:8]}  {n['Name']:<16} {n['Datacenter']:<8} "
                  f"{n['Status']:<6} {n['SchedulingEligibility']}"
                  f"{'  (draining)' if n['Drain'] else ''}")
        return 0
    _out(c.nodes.info(args.node_id))
    return 0


def cmd_node_drain(args) -> int:
    c = _client(args)
    if args.disable:
        c.nodes.drain(args.node_id, disable=True)
        print("drain cancelled")
    else:
        c.nodes.drain(args.node_id, deadline_s=args.deadline,
                      ignore_system_jobs=args.ignore_system)
        print(f"draining node {args.node_id[:8]}")
    return 0


def cmd_node_eligibility(args) -> int:
    _client(args).nodes.eligibility(args.node_id, args.enable)
    print(f"node {args.node_id[:8]} "
          f"{'eligible' if args.enable else 'ineligible'}")
    return 0


def cmd_alloc_status(args) -> int:
    info = _client(args).allocations.info(args.alloc_id)
    _out(info)
    if getattr(args, "verbose", False):
        # the winning node's score breakdown (the kernel's top-k table
        # travels on every alloc's AllocMetric — ops/engine.py)
        m = info.get("Metrics") or {}
        print("\nPlacement Metrics:")
        _print_metric_rollup(m)
        if m.get("AllocationTimeNS"):
            print("  Allocation Time = "
                  f"{m['AllocationTimeNS'] / 1e6:.3f}ms")
        rows = m.get("ScoreMetaData") or []
        if rows:
            print("  Score breakdown (top candidates, * = placed here):")
            _print_score_table(rows, winner=info.get("NodeID", ""),
                               indent="    ")
    return 0


def cmd_alloc_logs(args) -> int:
    c = _client(args)
    kind = "stderr" if args.stderr else "stdout"
    r = c.allocations.logs(args.alloc_id, task=args.task, type=kind,
                           offset=-args.tail if args.tail else 0)
    sys.stdout.write(r.get("Data", ""))
    return 0


def cmd_alloc_fs(args) -> int:
    c = _client(args)
    path = args.path or ""
    if args.cat:
        sys.stdout.write(c.allocations.fs_cat(args.alloc_id, path))
        return 0
    for e in c.allocations.fs_ls(args.alloc_id, path):
        kind = "d" if e.get("IsDir") else "-"
        print(f"{kind} {e.get('Size', 0):>10}  {e.get('Name')}")
    return 0


def cmd_alloc_exec(args) -> int:
    """reference: `nomad alloc exec`.  Default: one-shot, combined
    output in one response.  `-i`: INTERACTIVE session — stdout streams
    via long-poll while a reader thread forwards this terminal's stdin
    (the reference's websocket stream, as chunked long-poll)."""
    import base64
    body = {"Cmd": args.cmd}
    if args.task:
        body["Task"] = args.task
    c = _client(args)
    base = f"/v1/client/allocation/{args.alloc_id}/exec"
    if not getattr(args, "interactive", False):
        out = c.put(base, body=body)
        # raw bytes to stdout: decode-with-replace would corrupt binary
        # output (e.g. `alloc exec <id> cat binary > out`)
        sys.stdout.buffer.write(base64.b64decode(out.get("Output", "")))
        sys.stdout.buffer.flush()
        return int(out.get("ExitCode", 0))

    import threading
    body["Interactive"] = True
    sid = c.put(base, body=body)["SessionId"]
    done = threading.Event()

    # stdin runs in a DAEMON thread: the main thread must own the
    # stream loop, or the process hangs in readline() after the remote
    # session exits (the daemon dies with the process)
    def pump_stdin():
        try:
            while not done.is_set():
                line = sys.stdin.readline()
                if line == "":                   # terminal EOF (^D)
                    c.put(f"{base}/{sid}/stdin", body={"Eof": True})
                    return
                c.put(f"{base}/{sid}/stdin", body={
                    "Data": base64.b64encode(line.encode()).decode()})
        except Exception:  # noqa: BLE001 - session gone: stop feeding
            pass

    threading.Thread(target=pump_stdin, daemon=True).start()
    code = 0
    try:
        offset = 0
        while True:
            out = c.get(f"{base}/{sid}/stream", offset=offset)
            data = base64.b64decode(out.get("Data", ""))
            if data:
                sys.stdout.buffer.write(data)
                sys.stdout.buffer.flush()
            offset = out.get("Offset", offset)
            if out.get("Exited"):
                code = int(out.get("ExitCode") or 0)
                break
    except (KeyboardInterrupt, BrokenPipeError):
        code = 130
    finally:
        done.set()
        try:
            c.delete(f"{base}/{sid}")
        except Exception:  # noqa: BLE001 - session may have been reaped
            pass
    return code


def cmd_alloc_restart(args) -> int:
    _client(args).allocations.restart(args.alloc_id)
    print(f"restarted tasks of allocation {args.alloc_id}")
    return 0


def cmd_alloc_signal(args) -> int:
    _client(args).allocations.signal(args.alloc_id, args.signal)
    print(f"sent {args.signal} to allocation {args.alloc_id}")
    return 0


def cmd_alloc_stop(args) -> int:
    resp = _client(args).allocations.stop(args.alloc_id)
    print(f"stopping; eval {resp.get('EvalID', '')}")
    return 0


def cmd_eval_list(args) -> int:
    for e in _client(args).evaluations.list():
        print(f"{e['ID'][:8]}  {e.get('Type', ''):<8} "
              f"{e.get('TriggeredBy', ''):<18} {e.get('JobID', '')[:24]:<24} "
              f"{e.get('Status', '')}")
    return 0


def cmd_eval_status(args) -> int:
    _out(_client(args).evaluations.info(args.eval_id))
    return 0


def _print_metric_rollup(m: dict, indent: str = "  ") -> None:
    """NodesEvaluated/Filtered/Exhausted breakdown of one encoded
    AllocMetric (the SURVEY §4.5 eval-status contract)."""
    print(f"{indent}Nodes Evaluated = {m.get('NodesEvaluated', 0)}")
    print(f"{indent}Nodes Filtered  = {m.get('NodesFiltered', 0)}")
    print(f"{indent}Nodes Exhausted = {m.get('NodesExhausted', 0)}")
    for key, label in (("DimensionExhausted", "Dimensions Exhausted"),
                       ("ConstraintFiltered", "Constraints Filtered"),
                       ("ClassFiltered", "Classes Filtered"),
                       ("ClassExhausted", "Classes Exhausted")):
        d = m.get(key)
        if d:
            inner = ", ".join(f"{k}: {v}" for k, v in sorted(d.items()))
            print(f"{indent}{label} = {inner}")
    if m.get("QuotaExhausted"):
        print(f"{indent}Quota Exhausted = "
              f"{', '.join(m['QuotaExhausted'])}")


def _print_score_table(rows, winner: str = "", indent: str = "  ") -> None:
    print(f"{indent}{'':1}{'Node':<36} {'Score':>10}")
    for r in rows:
        nid = r.get("NodeID", "")
        mark = "*" if winner and nid == winner else " "
        extra = ""
        scores = r.get("Scores") or {}
        if len(scores) > 1 or (scores and "final" not in scores):
            extra = "  " + ", ".join(f"{k}={v:.4f}"
                                     for k, v in sorted(scores.items()))
        print(f"{indent}{mark}{nid[:36]:<36} "
              f"{r.get('NormScore', 0):>10.4f}{extra}")


def cmd_eval_explain(args) -> int:
    """Human-readable placement decision for one eval: per-task-group
    score tables plus the filter/exhaustion breakdown that names the
    blocking dimension of a pending job."""
    doc = _client(args).evaluations.explain(args.eval_id)
    print(f"ID           = {doc.get('EvalID', '')[:8]}")
    print(f"Job          = {doc.get('JobID', '')}")
    print(f"Namespace    = {doc.get('Namespace', '')}")
    print(f"Type         = {doc.get('Type', '')}")
    print(f"Triggered By = {doc.get('TriggeredBy', '')}")
    print(f"Status       = {doc.get('Status', '')}")
    if doc.get("StatusDescription"):
        print(f"Description  = {doc['StatusDescription']}")
    if doc.get("BlockedEval"):
        print(f"Blocked Eval = {doc['BlockedEval'][:8]}")
    if doc.get("BlockedCause"):
        print(f"Cause        = {doc['BlockedCause']}")
    for name, tg in sorted((doc.get("TaskGroups") or {}).items()):
        head = (f"{tg.get('Placed', 0)} placed, "
                f"{tg.get('Failed', 0)} failed")
        if tg.get("Preempted"):
            head += f", {tg['Preempted']} preempted"
        print(f"\nTask Group {name!r} ({head})")
        m = tg.get("Metric")
        if m:
            _print_metric_rollup(m)
        if tg.get("Cause"):
            print(f"  Why pending     : {tg['Cause']}")
        if tg.get("PreemptedAllocs"):
            short = ", ".join(a[:8] for a in tg["PreemptedAllocs"])
            print(f"  Preempted Allocs: {short}")
        if tg.get("ScoreTable"):
            print("  Top candidates:")
            _print_score_table(tg["ScoreTable"], indent="    ")
    return 0


def cmd_deployment_list(args) -> int:
    for d in _client(args).deployments.list():
        print(f"{d['ID'][:8]}  {d.get('JobID', '')[:32]:<32} "
              f"v{d.get('JobVersion', 0):<4} {d.get('Status', '')}")
    return 0


def cmd_deployment_status(args) -> int:
    _out(_client(args).deployments.info(args.deployment_id))
    return 0


def cmd_deployment_promote(args) -> int:
    _client(args).deployments.promote(
        args.deployment_id, args.group or None)
    print("promoted")
    return 0


def cmd_deployment_fail(args) -> int:
    _client(args).deployments.fail(args.deployment_id)
    print("failed")
    return 0


def cmd_deployment_pause(args) -> int:
    _client(args).deployments.pause(args.deployment_id,
                                    not args.resume)
    print("resumed" if args.resume else "paused")
    return 0


def cmd_operator_scheduler_get(args) -> int:
    _out(_client(args).operator.scheduler_config())
    return 0


def cmd_operator_scheduler_set(args) -> int:
    c = _client(args)
    cfg = c.operator.scheduler_config()["SchedulerConfig"]
    if args.scheduler_algorithm:
        cfg["SchedulerAlgorithm"] = args.scheduler_algorithm
    if args.memory_oversubscription is not None:
        cfg["MemoryOversubscriptionEnabled"] = args.memory_oversubscription
    c.operator.set_scheduler_config(cfg)
    print("scheduler configuration updated")
    return 0


def cmd_acl_bootstrap(args) -> int:
    tok = _client(args).acl.bootstrap()
    print(f"Accessor ID: {tok['AccessorID']}")
    print(f"Secret  ID: {tok['SecretID']}")
    return 0


def cmd_acl_policy_apply(args) -> int:
    with open(args.file) as f:
        rules = f.read()
    _client(args).acl.upsert_policy(args.name, rules,
                                    description=args.description)
    print(f"policy {args.name!r} applied")
    return 0


def cmd_acl_policy_list(args) -> int:
    for p in _client(args).acl.policies():
        print(f"{p['Name']:<24} {p['Description']}")
    return 0


def cmd_acl_policy_delete(args) -> int:
    _client(args).acl.delete_policy(args.name)
    print(f"policy {args.name!r} deleted")
    return 0


def cmd_acl_token_create(args) -> int:
    tok = _client(args).acl.create_token(
        name=args.name, type=args.type, policies=args.policy or [])
    print(f"Accessor ID: {tok['AccessorID']}")
    print(f"Secret  ID: {tok['SecretID']}")
    return 0


def cmd_acl_token_list(args) -> int:
    for t in _client(args).acl.tokens():
        print(f"{t['AccessorID'][:8]}  {t['Type']:<11} "
              f"{t['Name']:<24} {','.join(t['Policies'])}")
    return 0


def cmd_acl_token_delete(args) -> int:
    _client(args).acl.delete_token(args.accessor_id)
    print("token deleted")
    return 0


def cmd_acl_auth_method_create(args) -> int:
    import json as _json
    cfg = _json.loads(args.config) if args.config else {}
    out = _client(args).request(
        "POST", f"/v1/acl/auth-method/{args.name}",
        body={"Type": args.type, "TokenLocality": args.token_locality,
              "MaxTokenTTLS": args.max_token_ttl,
              "Default": args.default, "Config": cfg})
    print(f"auth method {out['Name']!r} ({out['Type']}) created")
    return 0


def cmd_acl_auth_method_list(args) -> int:
    for m in _client(args).request("GET", "/v1/acl/auth-methods"):
        print(f"{m['Name']:<24} {m['Type']:<6} {m['TokenLocality']}"
              + ("  (default)" if m["Default"] else ""))
    return 0


def cmd_acl_auth_method_delete(args) -> int:
    _client(args).request("DELETE", f"/v1/acl/auth-method/{args.name}")
    print(f"auth method {args.name!r} deleted")
    return 0


def cmd_acl_binding_rule_create(args) -> int:
    out = _client(args).request(
        "POST", "/v1/acl/binding-rule",
        body={"AuthMethod": args.auth_method,
              "Selector": args.selector,
              "BindType": args.bind_type, "BindName": args.bind_name})
    print(f"binding rule {out['ID'][:8]} created")
    return 0


def cmd_acl_binding_rule_list(args) -> int:
    for r in _client(args).request("GET", "/v1/acl/binding-rules"):
        print(f"{r['ID'][:8]}  {r['AuthMethod']:<16} "
              f"{r['BindType']:<11} {r['BindName']:<20} "
              f"{r['Selector']}")
    return 0


def cmd_acl_login(args) -> int:
    jwt = args.token
    if jwt == "-":
        import sys as _sys
        jwt = _sys.stdin.read().strip()
    tok = _client(args).request(
        "POST", "/v1/acl/login",
        body={"AuthMethodName": args.method, "LoginToken": jwt})
    print(f"Accessor ID: {tok['AccessorID']}")
    print(f"Secret  ID: {tok['SecretID']}")
    print(f"Policies:   {', '.join(tok['Policies']) or '(management)'}")
    return 0


def cmd_namespace_list(args) -> int:
    for n in _client(args).namespaces.list():
        print(f"{n['Name']:<24} {n.get('Description', '')}")
    return 0


def cmd_namespace_apply(args) -> int:
    _client(args).namespaces.apply(args.name,
                                   description=args.description)
    print(f"namespace {args.name!r} applied")
    return 0


def cmd_namespace_delete(args) -> int:
    _client(args).namespaces.delete(args.name)
    print(f"namespace {args.name!r} deleted")
    return 0


def cmd_node_pool_list(args) -> int:
    for n in _client(args).node_pools.list():
        print(f"{n['Name']:<24} {n.get('Description', '')}")
    return 0


def cmd_node_pool_apply(args) -> int:
    _client(args).node_pools.apply(args.name,
                                   description=args.description)
    print(f"node pool {args.name!r} applied")
    return 0


def cmd_node_pool_delete(args) -> int:
    _client(args).node_pools.delete(args.name)
    print(f"node pool {args.name!r} deleted")
    return 0


def cmd_var_put(args) -> int:
    items = {}
    for kv in args.items:
        if "=" not in kv:
            print(f"Error: expected key=value, got {kv!r}", file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        items[k] = v
    _client(args).variables.write(args.path, items)
    print(f"wrote {len(items)} item(s) to {args.path}")
    return 0


def cmd_var_get(args) -> int:
    _out(_client(args).variables.read(args.path))
    return 0


def cmd_var_list(args) -> int:
    for v in _client(args).variables.list(prefix=args.prefix):
        print(f"{v['Path']:<40} {len(v.get('Items', {}))} item(s)")
    return 0


def cmd_var_purge(args) -> int:
    _client(args).variables.delete(args.path)
    print(f"purged {args.path}")
    return 0


def cmd_snapshot_save(args) -> int:
    doc = _client(args).operator.snapshot_save()
    with open(args.file, "w") as f:
        json.dump(doc, f)
    print(f"snapshot saved to {args.file} (index {doc.get('Index')})")
    return 0


def cmd_snapshot_restore(args) -> int:
    with open(args.file) as f:
        doc = json.load(f)
    _client(args).operator.snapshot_restore(doc)
    print(f"state restored from {args.file}")
    return 0


def cmd_monitor(args) -> int:
    """Stream agent logs (reference: `nomad monitor`)."""
    import datetime
    import os
    import urllib.request
    url = (f"{args.address}/v1/agent/monitor?"
           f"log_level={args.log_level}")
    token = args.token or os.environ.get("NOMAD_TOKEN", "")
    req = urllib.request.Request(
        url, headers={"X-Nomad-Token": token} if token else {})
    with urllib.request.urlopen(req) as resp:
        for line in resp:
            line = line.strip()
            if not line or line == b"{}":
                continue
            rec = json.loads(line)
            ts = datetime.datetime.fromtimestamp(
                rec.get("ts", 0)).strftime("%H:%M:%S")
            extra = {k: v for k, v in rec.items()
                     if k not in ("ts", "level", "component", "msg")}
            print(f"{ts} [{rec.get('level', ''):<5}] "
                  f"{rec.get('component', '')}: {rec.get('msg', '')}"
                  + (f"  {extra}" if extra else ""))
    return 0


def cmd_operator_debug(args) -> int:
    bundle = _client(args).request("GET", "/v1/operator/debug")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(bundle, f, indent=2)
        print(f"debug bundle written to {args.output} "
              f"({len(bundle.get('Logs', []))} log records, "
              f"{len(bundle.get('Traces', []))} traces, "
              f"{len(bundle.get('Threads', []))} threads)")
    else:
        _out(bundle)
    return 0


def cmd_health(args) -> int:
    """SLO verdicts from the health watchdog (core/flightrec.py):
    one row per rule, observed vs threshold.  Exit 0 healthy, 1 when
    any rule is breached (scriptable, like a health check)."""
    doc = _client(args).operator.health()
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if doc.get("Healthy") else 1
    print(f"Healthy      = {doc.get('Healthy')}")
    print(f"Breaches     = {doc.get('Breaches', 0)} "
          f"(checks {doc.get('Checks', 0)}, "
          f"dump bundles {doc.get('Dumps', 0)})")
    print(f"Window       = {doc.get('WindowS', 0):.0f}s")
    print(f"{'Rule':<22} {'Kind':<8} {'Observed':>12} "
          f"{'Threshold':>12}  {'Status'}")
    for r in doc.get("Rules", []):
        obs = r.get("Observed")
        obs_s = "-" if obs is None else f"{obs:g}"
        thr = r.get("Threshold", 0)
        thr_s = "off" if thr < 0 else f"{thr:g}"
        status = "OK" if r.get("Ok") else "BREACH"
        print(f"{r.get('Rule', ''):<22} {r.get('Kind', ''):<8} "
              f"{obs_s:>12} {thr_s:>12}  {status} "
              f"({r.get('Unit', '')})")
    return 0 if doc.get("Healthy") else 1


def cmd_mem(args) -> int:
    """The memory ledger (`nomad mem`): per-plane byte/entry/eviction
    table + process RSS from core/memledger.py.  `-cached` reads the
    last tick sample instead of forcing a scrape; `-json` dumps the
    raw operator document."""
    doc = _client(args).operator.memory(cached=args.cached)
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0

    def _mb(n: float) -> str:
        return f"{n / (1024.0 * 1024.0):.1f}M"

    print(f"rss          = {_mb(doc.get('RSSBytes', 0))} "
          f"(peak {_mb(doc.get('RSSPeakBytes', 0))})")
    print(f"tracked      = {_mb(doc.get('TrackedBytes', 0))} across "
          f"{len(doc.get('Planes', {}))} planes")
    print(f"scrape       = {doc.get('ScrapeMicros', 0):g}µs last, "
          f"{doc.get('ScrapeMeanMicros', 0):g}µs mean "
          f"({doc.get('Scrapes', 0)} scrapes)")
    print(f"{'Plane':<12} {'Bytes':>10} {'Entries':>9} {'Cap':>7} "
          f"{'Occ':>6} {'Evictions':>10}")
    for name, p in sorted(doc.get("Planes", {}).items()):
        cap = int(p.get("cap", 0) or 0)
        entries = int(p.get("entries", 0) or 0)
        occ = f"{entries / cap:.0%}" if cap else "-"
        print(f"{name:<12} {int(p.get('bytes', 0)):>10} "
              f"{entries:>9} {cap if cap else '-':>7} {occ:>6} "
              f"{int(p.get('evictions', 0)):>10}")
        if p.get("error"):
            print(f"  ! sizer error: {p['error']}")
    return 0


def cmd_profile(args) -> int:
    """On-demand profile capture (`nomad profile`): ask the agent for a
    timed capture — folded host stacks, time-bucket breakdown, GIL-wait
    fractions, the device compile/HBM ledger — and summarize it.
    `-output` keeps the full bundle JSON; `-folded` writes just the
    folded stacks (pipe into flamegraph.pl / load into speedscope).
    `-status` prints the live sampler view without capturing."""
    c = _client(args)
    # a capture blocks server-side for its whole window
    c.timeout = max(c.timeout, args.duration + 30.0)
    if args.status:
        doc = c.operator.profile_status()
        print(f"sampler   = "
              f"{'running' if doc.get('running') else 'stopped'} "
              f"@ {doc.get('hz', 0):g} Hz "
              f"({doc.get('samples', 0)} samples, "
              f"overhead {doc.get('overhead_fraction', 0):.4f})")
        for b, v in sorted(doc.get("buckets", {}).items(),
                           key=lambda kv: -kv[1]):
            print(f"  {b:<12} {v:10.1f}")
        print(f"captures  = {doc.get('captures', [])}")
        return 0
    bundle = c.operator.profile(
        duration_s=args.duration,
        trace=bool(args.trace or args.trace_dir),
        trace_dir=args.trace_dir or None)
    print(f"capture {bundle['id']} ({bundle['schema']}): "
          f"{bundle['samples']} samples over "
          f"{bundle['duration_s']:g}s @ {bundle['hz']:g} Hz")
    ts = bundle.get("thread_samples", 0) or 1
    print(f"\n{'Bucket':<12} {'Weight':>10} {'Share':>8}")
    for b, v in sorted(bundle.get("buckets", {}).items(),
                       key=lambda kv: -kv[1]):
        print(f"{b:<12} {v:>10.1f} {v / ts:>8.1%}")
    print(f"attributed   = {bundle.get('attributed_fraction', 0):.1%} "
          f"of {ts} thread-samples")
    gil = bundle.get("gil_wait_fraction_by_role", {})
    if gil:
        print("gil-wait     = "
              + "  ".join(f"{r}:{f:.1%}" for r, f in sorted(gil.items())))
    comp = bundle.get("compile_ledger", {})
    print(f"compiles     = {comp.get('misses', 0)} "
          f"(hit rate {comp.get('hit_rate', 0):.1%}, "
          f"first-launch {comp.get('first_launch_s', 0):.2f}s, "
          f"steady {comp.get('steady_s', 0):.2f}s)")
    led = bundle.get("device_ledger") or {}
    if led:
        print(f"hbm resident = {led.get('hbm_resident_bytes', 0)} B "
              f"(high watermark "
              f"{led.get('hbm_high_watermark_bytes', 0)} B)")
        by_cause = led.get("upload_bytes_by_cause", {})
        if by_cause:
            print("h2d by cause = "
                  + "  ".join(f"{k}:{v}"
                              for k, v in sorted(by_cause.items())))
    tr = bundle.get("jax_trace")
    if tr:
        print(f"jax trace    = "
              + (tr.get("dir", "") if tr.get("ok")
                 else f"unavailable ({tr.get('error', '')})"))
    if args.folded:
        with open(args.folded, "w") as f:
            f.write("\n".join(bundle.get("folded", [])) + "\n")
        print(f"{len(bundle.get('folded', []))} folded stacks written "
              f"to {args.folded} (flamegraph.pl {args.folded} > "
              f"flame.svg, or load into speedscope)")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(bundle, f, indent=2)
        print(f"profile bundle written to {args.output}")
    return 0


def cmd_soak(args) -> int:
    """Virtual-time production soak (`nomad soak`): boot an in-process
    agent on a VirtualClock, replay a seeded day of cluster life
    through the real API, and gate on chaos invariants + live SLOs.
    Needs no running agent — it owns its own.  Exit 0 green (and, with
    -check-determinism, byte-identical across both runs), 1 otherwise."""
    from nomad_tpu_torch.chaos.soak import run_soak
    from nomad_tpu_torch.chaos.traffic import TrafficProfile

    kw = dict(hours=args.hours, n_nodes=args.nodes, n_zones=args.zones)
    if args.quick:
        kw.update(hours=min(args.hours, 0.1), n_nodes=min(args.nodes, 4),
                  n_zones=min(args.zones, 2), service_per_hour=30,
                  batch_per_hour=30, drains_per_hour=10,
                  flap_storms_per_hour=10, flap_storm_nodes=2,
                  preempt_storms_per_hour=10)
    if args.no_chaos:
        kw["chaos_scenarios"] = ()
    profile = TrafficProfile(**kw)
    runs = 2 if args.check_determinism else 1
    results = []
    for i in range(runs):
        if runs > 1:
            print(f"== soak run {i + 1}/{runs} (seed {args.seed}) ==")
        results.append(run_soak(seed=args.seed, profile=profile,
                                rss_ceiling_mb=args.rss_ceiling_mb))
    r = results[0]
    s = r.summary
    print(f"seed                  = {s['seed']}")
    print(f"virtual hours         = {s['soak_virtual_hours']:g} "
          f"({s['schedule_events']} schedule events)")
    print(f"wall seconds          = {s['wall_s']:g} "
          f"(compression {s['compression_x']:g}x)")
    print(f"evals                 = {s['soak_evals']}")
    print(f"watchdog breaches     = {s['soak_breaches']}")
    print(f"p99 plan-queue        = {s['p99_plan_queue_ms']:g} ms")
    q = s["quality"]
    print(f"zone balance max/min  = {q['zone_balance_max_over_min']:g} "
          f"({q['nodes_in_use']} nodes in use)")
    print(f"fill cpu/mem          = {q['fill_cpu']:.3f} / "
          f"{q['fill_memory']:.3f}")
    print(f"converged fingerprint = {s['converged_fingerprint'][:16]}…")
    print(f"trace digest          = {s['trace_digest'][:16]}…")
    print(f"timeline              = {s['timeline_points']} points, "
          f"{s['timeline_annotations']} annotations "
          f"(overhead {s['timeline_overhead_fraction']:.4f}, "
          f"digest {s['timeline_digest'][:16]}…)")
    print(f"memory                = rss peak "
          f"{s['rss_peak_bytes'] / 1048576.0:.1f}M, journal "
          f"{s['journal_bytes']} B "
          f"({s['journal_compactions']} compactions, "
          f"{s['journal_floor_fallbacks']} floor fallbacks), "
          f"{s['ring_evictions']} ring evictions, ledger overhead "
          f"{s['mem_overhead_fraction']:.4f}")
    ok = all(x.ok for x in results)
    for x in results:
        for v in x.violations:
            print(f"VIOLATION: {v}")
    if runs > 1:
        match = (results[0].digest == results[1].digest
                 and results[0].fingerprint == results[1].fingerprint)
        print("determinism           = "
              + ("byte-identical" if match else "DIVERGED"))
        ok = ok and match
    print(f"verdict               = {'PASS' if ok else 'FAIL'}")
    if args.json:
        doc = dict(s)
        doc["violations"] = sorted(r.violations)
        if runs > 1:
            doc["determinism_ok"] = bool(match)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"summary written to {args.json}")
        # the retrospective rides along next to the canonical trace:
        # full-resolution timeline dump + rendered post-mortem
        from nomad_tpu_torch.core.timeline import render_report_md
        base = (args.json[:-5] if args.json.endswith(".json")
                else args.json)
        with open(base + ".timeline.json", "w") as f:
            json.dump(r.timeline, f, indent=2, sort_keys=True)
        with open(base + ".report.md", "w") as f:
            f.write(render_report_md(r.report))
        print(f"timeline written to {base}.timeline.json, "
              f"report to {base}.report.md")
    return 0 if ok else 1


def cmd_timeline(args) -> int:
    """Clock-aligned metric history (`nomad timeline`): one sparkline
    row per series over the retained window, recent annotations below.
    Reads the live agent, or `-input` replays a dump written by
    `nomad soak -json` / the timeline endpoint's ?dump=true."""
    from nomad_tpu_torch.core.timeline import sparkline
    if args.input:
        with open(args.input) as f:
            doc = json.load(f)
    else:
        names = ([x for x in args.series.split(",") if x]
                 if args.series else None)
        doc = _client(args).operator.timeline(
            start=args.start, end=args.end,
            step=args.step or None, series=names)
    print(f"window      = [{doc.get('Start')}, {doc.get('End')}] "
          f"step {doc.get('Step')}s "
          f"({doc.get('Points', 0)} native points)")
    series = doc.get("Series", {})
    width = max(args.width, 8)
    namew = max([len(n) for n in series] + [6])
    print(f"\n{'Series':<{namew}} {'':{width}}  "
          f"{'Min':>10} {'Avg':>10} {'Max':>10} {'Last':>10}")
    for name in sorted(series):
        pts = series[name]
        vals = [p["Avg"] for p in pts]
        if not pts:
            print(f"{name:<{namew}} {'·' * width}  "
                  f"{'-':>10} {'-':>10} {'-':>10} {'-':>10}")
            continue
        print(f"{name:<{namew}} "
              f"{sparkline(vals, width=width):{width}}  "
              f"{min(p['Min'] for p in pts):>10g} "
              f"{sum(vals) / len(vals):>10.4g} "
              f"{max(p['Max'] for p in pts):>10g} "
              f"{pts[-1]['Last']:>10g}")
    anns = doc.get("Annotations", [])
    print(f"\nannotations = {len(anns)}")
    for a in anns[-args.n:]:
        fields = ", ".join(f"{k}={v}" for k, v in sorted(a.items())
                           if k not in ("T", "Kind"))
        print(f"  t={a['T']:<12g} {a['Kind']:<24} {fields}")
    return 0


def cmd_report(args) -> int:
    """Breach/spike post-mortem (`nomad report`): attributes every
    health breach and metric spike in the timeline to its nearest-in-
    time cluster annotations (traffic, chaos, deploys, leadership,
    drains).  Markdown by default, `-json` for the raw report doc;
    reads the live agent or an `-input` timeline dump."""
    from nomad_tpu_torch.core.timeline import build_report, render_report_md
    if args.input:
        with open(args.input) as f:
            doc = json.load(f)
        report = doc.get("Report") or build_report(
            doc, attribution_window_s=args.window)
    else:
        doc = _client(args).operator.timeline_dump()
        report = (doc.get("Report")
                  if args.window == 60.0 and doc.get("Report")
                  else build_report(doc,
                                    attribution_window_s=args.window))
    out = (json.dumps(report, indent=2, sort_keys=True) + "\n"
           if args.json else render_report_md(report))
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"report written to {args.output} "
              f"({len(report.get('Incidents', []))} incident(s))")
    else:
        sys.stdout.write(out)
    return 0


def cmd_debug_record(args) -> int:
    """Flight-recorder tail (`nomad debug record`): recent per-wave and
    per-eval records; `-dump` fetches the health watchdog's retained
    breach dump bundles instead."""
    c = _client(args)
    if args.dump:
        doc = c.operator.health(dumps=True)
        bundles = doc.get("DumpBundles", [])
        if args.output:
            with open(args.output, "w") as f:
                json.dump(bundles, f, indent=2)
            print(f"{len(bundles)} dump bundle(s) written to "
                  f"{args.output}")
        else:
            _out(bundles)
        return 0
    rec = c.operator.flight_recorder(n=args.n or None)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"flight recorder written to {args.output} "
              f"({len(rec.get('Waves', []))} waves, "
              f"{len(rec.get('Evals', []))} evals)")
        return 0
    stats = rec.get("Stats", {})
    cap = rec.get("Capacity", {})
    print(f"Waves  = {len(rec.get('Waves', []))} "
          f"(ring {cap.get('waves', '?')}, "
          f"evicted {stats.get('wave_evictions', 0)})")
    print(f"Evals  = {len(rec.get('Evals', []))} "
          f"(ring {cap.get('evals', '?')}, "
          f"evicted {stats.get('eval_evictions', 0)})")
    print(f"Events = {len(rec.get('Events', []))}")
    waves = rec.get("Waves", [])[-10:]
    if waves:
        print(f"\n{'Wave':>6} {'Items':>6} {'Chain':>6} "
              f"{'Device(ms)':>11} {'Commit(ms)':>11} {'Refuted':>8}")
        for w in waves:
            print(f"{w.get('Wave', 0):>6} {w.get('items', 0):>6} "
                  f"{'res' if w.get('resident') else '-':>6} "
                  f"{w.get('device_s', 0) * 1000:>11.2f} "
                  f"{w.get('commit_s', 0) * 1000:>11.2f} "
                  f"{w.get('refuted_nodes', 0):>8}")
    evals = rec.get("Evals", [])[-10:]
    if evals:
        print(f"\n{'Eval':<10} {'Type':<9} {'Outcome':<8} "
              f"{'Sched(ms)':>10} {'Queue(ms)':>10}")
        for e in evals:
            print(f"{e.get('EvalID', '')[:8]:<10} "
                  f"{e.get('type', ''):<9} {e.get('outcome', ''):<8} "
                  f"{e.get('schedule_s', 0) * 1000:>10.2f} "
                  f"{e.get('queue_wait_s', 0) * 1000:>10.2f}")
    return 0


def cmd_metrics(args) -> int:
    """reference: `nomad operator metrics [-format prometheus]`."""
    c = _client(args)
    if args.format == "prometheus":
        sys.stdout.write(c.agent.metrics(format="prometheus"))
        return 0
    _out(c.agent.metrics())
    return 0


def cmd_trace_list(args) -> int:
    for t in _client(args).agent.traces():
        dur = t.get("End", 0) - t.get("Start", 0)
        print(f"{t['TraceID'][:8]}  {t.get('Root', '') or '-':<10} "
              f"{t['Spans']:>3} span(s)  {dur * 1000:8.2f}ms")
    return 0


def cmd_trace_status(args) -> int:
    if not args.cluster:
        _out(_client(args).agent.trace(args.trace_id))
        return 0
    # -cluster: the stitched cross-origin tree (core/federation.py) —
    # render it as an indented span tree, one line per span, with the
    # serving origin on every line so the forwarded-RPC → leader-commit
    # → follower-serve hops read top-to-bottom
    doc = _client(args).agent.trace(args.trace_id, cluster=True)
    print(f"Trace    = {doc.get('TraceID', '')}")
    print(f"Origins  = {', '.join(doc.get('Origins', []))}")
    print(f"Spans    = {doc.get('SpanCount', 0)}")

    def walk(node: Dict, depth: int) -> None:
        s = node.get("Span", {})
        dur = (s.get("Duration") or 0.0) * 1000.0
        print(f"{'  ' * depth}{s.get('Name', ''):<{32 - 2 * depth}} "
              f"@{s.get('Origin', ''):<12} {dur:8.2f}ms")
        for kid in node.get("Children", []):
            walk(kid, depth + 1)

    for root in doc.get("Tree", []):
        walk(root, 0)
    return 0


def cmd_service_list(args) -> int:
    for nsrow in _client(args).services.list():
        for svc in nsrow.get("Services", []):
            print(f"{svc['ServiceName']:<32} "
                  f"{','.join(svc.get('Tags', []))}")
    return 0


def cmd_service_info(args) -> int:
    for r in _client(args).services.info(args.name):
        print(f"{r['ID'][:40]:<42} {r.get('Address', '')}:"
              f"{r.get('Port', 0):<6} {r.get('Status', ''):<9} "
              f"node {r.get('NodeID', '')[:8]}")
    return 0


def cmd_system_gc(args) -> int:
    _client(args).system.gc()
    print("gc forced")
    return 0


def cmd_server_members(args) -> int:
    _out(_client(args).agent.members())
    return 0


def cmd_cluster_status(args) -> int:
    """Cluster-scope health (`nomad cluster status`): the contacted
    agent's federation scrape ledger — one row per origin it pulled —
    plus the cluster_* SLO verdicts.  Exit 0 healthy, 1 breached.
    Point -address at the leader; off-leader the ledger is empty (the
    puller is a leader duty)."""
    doc = _client(args).operator.cluster_health()
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if doc.get("Healthy") else 1
    fed = doc.get("Federation") or {}
    origins = fed.get("Origins") or {}
    print(f"Healthy      = {doc.get('Healthy')}")
    print(f"Origin       = {fed.get('Origin', '-')} "
          f"(scrapes {fed.get('Scrapes', 0)}, "
          f"failures {fed.get('Failures', 0)}, "
          f"last {fed.get('ScrapeMicros', 0):g}µs)")
    print(f"FollowerLag  = {fed.get('FollowerLagMax', 0):g} "
          f"(max applied-index lag behind this node)")
    if origins:
        print(f"{'Origin':<16} {'Ok':<4} {'Healthy':<8} "
              f"{'AppliedIdx':>10} {'HBMiss':>7} {'RSS':>9}")
        for name, row in sorted(origins.items()):
            if not row.get("Ok"):
                print(f"{name:<16} {'no':<4} {'-':<8} {'-':>10} "
                      f"{'-':>7} {'-':>9}  {row.get('Error', '')}")
                continue
            fol = row.get("Follower")
            idx = (fol.get("AppliedIndex") if fol
                   else row.get("AppliedIndex", 0))
            rss = row.get("RSSBytes", 0) / (1024.0 * 1024.0)
            print(f"{name:<16} {'yes':<4} "
                  f"{'yes' if row.get('Healthy') else 'NO':<8} "
                  f"{idx if idx is not None else '-':>10} "
                  f"{row.get('HeartbeatMisses', 0):>7} "
                  f"{rss:>8.1f}M")
    else:
        print("(no origins scraped yet — not the leader, or the "
              "first federation interval hasn't elapsed)")
    print(f"{'Rule':<28} {'Observed':>12} {'Threshold':>12}  Status")
    for r in doc.get("Rules", []):
        obs = r.get("Observed")
        obs_s = "-" if obs is None else f"{obs:g}"
        print(f"{r.get('Rule', ''):<28} {obs_s:>12} "
              f"{r.get('Threshold', 0):>12g}  "
              f"{'OK' if r.get('Ok') else 'BREACH'}")
    return 0 if doc.get("Healthy") else 1


def cmd_status(args) -> int:
    c = _client(args)
    jobs = c.jobs.list()
    if not jobs:
        print("No running jobs")
        return 0
    for stub in jobs:
        print(f"{stub['ID']:<40} {stub['Type']:<8} {stub['Status']}")
    return 0


# ------------------------------------------------------------------ parser

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nomad-tpu", description="TPU-native cluster scheduler CLI")
    p.add_argument("-address", default=DEFAULT_ADDR)
    p.add_argument("-namespace", default="default")
    p.add_argument("-token", default="",
                   help="ACL secret (or NOMAD_TOKEN env)")
    p.add_argument("-region", default="",
                   help="target region; foreign regions are forwarded "
                        "through the contacted agent's federation table "
                        "(or NOMAD_REGION env)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent", help="run an agent (server+client+http)")
    ag.add_argument("-dev", action="store_true", default=True)
    ag.add_argument("-config", action="append",
                    help="agent HCL config file (repeatable; merged in "
                         "order, flags win)")
    ag.add_argument("-bind", default="")
    ag.add_argument("-clients", type=int, default=None)
    ag.add_argument("-workers", type=int, default=None)
    ag.add_argument("-worker-mode", dest="worker_mode", default=None,
                    choices=("thread", "process"),
                    help="scheduler worker plane: in-process threads "
                         "(default) or a multi-process pool")
    # multi-server cluster mode (reference: -server, -bootstrap-expect,
    # -join / server_join)
    ag.add_argument("-server-name", dest="server_name", default="")
    ag.add_argument("-bootstrap-expect", dest="bootstrap_expect",
                    type=int, default=1)
    ag.add_argument("-join", action="append", default=[],
                    help="host:port of an existing server's serf endpoint")
    ag.add_argument("-rpc-port", dest="rpc_port", type=int, default=0)
    ag.add_argument("-raft-port", dest="raft_port", type=int, default=0)
    ag.add_argument("-serf-port", dest="serf_port", type=int, default=0)
    ag.add_argument("-data-dir", dest="data_dir", default="")
    ag.add_argument("-plugin-dir", dest="plugin_dir", default="",
                    help="directory of external driver/device plugins")
    ag.add_argument("-agent-region", dest="agent_region", default="",
                    help="this agent's region (default: config or global)")
    ag.add_argument("-join-wan", dest="join_wan", action="append",
                    default=[],
                    help="URL of an agent in another region to federate "
                         "with (repeatable).  Use https on untrusted "
                         "networks: cross-region forwarding carries ACL "
                         "tokens and variable contents, and the cluster "
                         "wire encryption does NOT cover federation "
                         "HTTP (plaintext URLs are adopted with a "
                         "loud warning)")
    ag.add_argument("-join-wan-token", dest="join_wan_token", default="",
                    help="management token for the -join-wan peer "
                         "(required when the peer enforces ACLs)")
    ag.add_argument("-follow", dest="follow", default="",
                    help="comma-separated upstream HTTP addresses: run "
                         "as a read follower tailing the leader journal "
                         "and serving stale-bounded reads locally "
                         "(exclusive with cluster mode)")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="job_cmd", required=True)
    jr = job.add_parser("run")
    jr.add_argument("file")
    jr.set_defaults(fn=cmd_job_run)
    js = job.add_parser("status")
    js.add_argument("job_id", nargs="?", default="")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    jp = job.add_parser("plan")
    jp.add_argument("file")
    jp.set_defaults(fn=cmd_job_plan)
    jd = job.add_parser("dispatch")
    jd.add_argument("job_id")
    jd.add_argument("-payload-file", dest="payload_file", default="")
    jd.add_argument("-meta", action="append")
    jd.set_defaults(fn=cmd_job_dispatch)
    jv = job.add_parser("revert")
    jv.add_argument("job_id")
    jv.add_argument("version", type=int)
    jv.set_defaults(fn=cmd_job_revert)
    jh = job.add_parser("history")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    jsc = job.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.set_defaults(fn=cmd_job_scale)
    jpf = job.add_parser("periodic-force")
    jpf.add_argument("job_id")
    jpf.set_defaults(fn=cmd_job_periodic_force)
    ji = job.add_parser("inspect")
    ji.add_argument("job_id")
    ji.set_defaults(fn=cmd_job_inspect)
    jva = job.add_parser("validate")
    jva.add_argument("path")
    jva.set_defaults(fn=cmd_job_validate)
    jev = job.add_parser("eval")
    jev.add_argument("job_id")
    jev.set_defaults(fn=cmd_job_eval)
    jde = job.add_parser("deployments")
    jde.add_argument("job_id")
    jde.set_defaults(fn=cmd_job_deployments)
    jal = job.add_parser("allocs")
    jal.add_argument("job_id")
    jal.set_defaults(fn=cmd_job_allocs)
    jpr = job.add_parser("promote")
    jpr.add_argument("job_id")
    jpr.set_defaults(fn=cmd_job_promote)

    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="node_cmd", required=True)
    ns_ = node.add_parser("status")
    ns_.add_argument("node_id", nargs="?", default="")
    ns_.set_defaults(fn=cmd_node_status)
    nd = node.add_parser("drain")
    nd.add_argument("node_id")
    # reference muscle memory: `nomad node drain -enable <id>` — enabling
    # is this command's default, so the flag is accepted and redundant;
    # contradictory -enable -disable is a parse error
    nd_mode = nd.add_mutually_exclusive_group()
    nd_mode.add_argument("-enable", action="store_true")
    nd_mode.add_argument("-disable", action="store_true")
    nd.add_argument("-deadline", type=float, default=3600)
    nd.add_argument("-ignore-system", dest="ignore_system",
                    action="store_true")
    nd.set_defaults(fn=cmd_node_drain)
    ne = node.add_parser("eligibility")
    ne.add_argument("node_id")
    grp = ne.add_mutually_exclusive_group(required=True)
    grp.add_argument("-enable", dest="enable", action="store_true")
    grp.add_argument("-disable", dest="enable", action="store_false")
    ne.set_defaults(fn=cmd_node_eligibility)

    alloc = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="alloc_cmd", required=True)
    als = alloc.add_parser("status")
    als.add_argument("alloc_id")
    als.add_argument("-verbose", action="store_true",
                     help="show the placement score breakdown")
    als.set_defaults(fn=cmd_alloc_status)
    alst = alloc.add_parser("stop")
    alst.add_argument("alloc_id")
    alst.set_defaults(fn=cmd_alloc_stop)
    allg = alloc.add_parser("logs")
    allg.add_argument("alloc_id")
    allg.add_argument("task", nargs="?", default="")
    allg.add_argument("-stderr", action="store_true")
    allg.add_argument("-tail", type=int, default=0,
                      help="show the last N bytes")
    allg.set_defaults(fn=cmd_alloc_logs)
    alfs = alloc.add_parser("fs")
    alfs.add_argument("alloc_id")
    alfs.add_argument("path", nargs="?", default="")
    alfs.add_argument("-cat", action="store_true",
                      help="print the file instead of listing")
    alfs.set_defaults(fn=cmd_alloc_fs)
    alx = alloc.add_parser("exec")
    alx.add_argument("alloc_id")
    alx.add_argument("-task", default="")
    alx.add_argument("-i", dest="interactive", action="store_true",
                     help="interactive session: stream output, forward "
                          "stdin (reference: nomad alloc exec -i)")
    # REMAINDER: the command's own flags (ls -l, sh -c ...) must pass
    # through untouched
    alx.add_argument("cmd", nargs=argparse.REMAINDER)
    alx.set_defaults(fn=cmd_alloc_exec)
    alrs = alloc.add_parser("restart")
    alrs.add_argument("alloc_id")
    alrs.set_defaults(fn=cmd_alloc_restart)
    alsg = alloc.add_parser("signal")
    alsg.add_argument("alloc_id")
    alsg.add_argument("signal", nargs="?", default="SIGUSR1")
    alsg.set_defaults(fn=cmd_alloc_signal)

    ev = sub.add_parser("eval", help="eval commands").add_subparsers(
        dest="eval_cmd", required=True)
    evl = ev.add_parser("list")
    evl.set_defaults(fn=cmd_eval_list)
    evs = ev.add_parser("status")
    evs.add_argument("eval_id")
    evs.set_defaults(fn=cmd_eval_status)
    evx = ev.add_parser("explain",
                        help="why an eval placed (or failed to place) "
                             "where it did")
    evx.add_argument("eval_id")
    evx.set_defaults(fn=cmd_eval_explain)

    dep = sub.add_parser("deployment",
                         help="deployment commands").add_subparsers(
        dest="dep_cmd", required=True)
    dl = dep.add_parser("list")
    dl.set_defaults(fn=cmd_deployment_list)
    ds = dep.add_parser("status")
    ds.add_argument("deployment_id")
    ds.set_defaults(fn=cmd_deployment_status)
    dp = dep.add_parser("promote")
    dp.add_argument("deployment_id")
    dp.add_argument("-group", action="append")
    dp.set_defaults(fn=cmd_deployment_promote)
    df = dep.add_parser("fail")
    df.add_argument("deployment_id")
    df.set_defaults(fn=cmd_deployment_fail)
    dpa = dep.add_parser("pause")
    dpa.add_argument("deployment_id")
    dpa.add_argument("-resume", action="store_true")
    dpa.set_defaults(fn=cmd_deployment_pause)

    op = sub.add_parser("operator",
                        help="operator commands").add_subparsers(
        dest="op_cmd", required=True)
    osch = op.add_parser("scheduler").add_subparsers(dest="sched_cmd",
                                                     required=True)
    og = osch.add_parser("get-config")
    og.set_defaults(fn=cmd_operator_scheduler_get)
    os_ = osch.add_parser("set-config")
    os_.add_argument("-scheduler-algorithm", dest="scheduler_algorithm",
                     choices=["binpack", "spread"], default="")
    os_.add_argument("-memory-oversubscription",
                     dest="memory_oversubscription", type=_str2bool,
                     default=None)
    os_.set_defaults(fn=cmd_operator_scheduler_set)

    odbg = op.add_parser("debug")
    odbg.add_argument("-output", default="")
    odbg.set_defaults(fn=cmd_operator_debug)
    oraft = op.add_parser("raft").add_subparsers(dest="raft_cmd",
                                                 required=True)
    orl = oraft.add_parser("list-peers")
    orl.set_defaults(fn=cmd_operator_raft_list_peers)
    osnap = op.add_parser("snapshot").add_subparsers(dest="snap_cmd",
                                                     required=True)
    osv = osnap.add_parser("save")
    osv.add_argument("file")
    osv.set_defaults(fn=cmd_snapshot_save)
    ors = osnap.add_parser("restore")
    ors.add_argument("file")
    ors.set_defaults(fn=cmd_snapshot_restore)

    acl = sub.add_parser("acl", help="ACL management").add_subparsers(
        dest="acl_cmd", required=True)
    ab = acl.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl_bootstrap)
    apol = acl.add_parser("policy").add_subparsers(dest="pol_cmd",
                                                   required=True)
    apa = apol.add_parser("apply")
    apa.add_argument("name")
    apa.add_argument("file")
    apa.add_argument("-description", default="")
    apa.set_defaults(fn=cmd_acl_policy_apply)
    apl = apol.add_parser("list")
    apl.set_defaults(fn=cmd_acl_policy_list)
    apd = apol.add_parser("delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl_policy_delete)
    atok = acl.add_parser("token").add_subparsers(dest="tok_cmd",
                                                  required=True)
    atc = atok.add_parser("create")
    atc.add_argument("-name", default="")
    atc.add_argument("-type", default="client",
                     choices=["client", "management"])
    atc.add_argument("-policy", action="append")
    atc.set_defaults(fn=cmd_acl_token_create)
    atl = atok.add_parser("list")
    atl.set_defaults(fn=cmd_acl_token_list)
    atd = atok.add_parser("delete")
    atd.add_argument("accessor_id")
    atd.set_defaults(fn=cmd_acl_token_delete)
    ats = atok.add_parser("self")
    ats.set_defaults(fn=cmd_acl_token_self)
    am = acl.add_parser("auth-method").add_subparsers(dest="am_cmd",
                                                     required=True)
    amc = am.add_parser("create")
    amc.add_argument("name")
    amc.add_argument("-type", default="JWT")
    amc.add_argument("-token-locality", dest="token_locality",
                     default="local", choices=["local", "global"])
    amc.add_argument("-max-token-ttl", dest="max_token_ttl",
                     type=float, default=3600.0)
    amc.add_argument("-default", action="store_true")
    amc.add_argument("-config", default="",
                     help='JSON config: {"JWTValidationPubKeys": [...] '
                          'or "JWTValidationSecrets": [...], '
                          '"BoundIssuer": ..., "BoundAudiences": [...]}')
    amc.set_defaults(fn=cmd_acl_auth_method_create)
    aml = am.add_parser("list")
    aml.set_defaults(fn=cmd_acl_auth_method_list)
    amd = am.add_parser("delete")
    amd.add_argument("name")
    amd.set_defaults(fn=cmd_acl_auth_method_delete)
    br = acl.add_parser("binding-rule").add_subparsers(dest="br_cmd",
                                                      required=True)
    brc = br.add_parser("create")
    brc.add_argument("-auth-method", dest="auth_method", required=True)
    brc.add_argument("-selector", default="")
    brc.add_argument("-bind-type", dest="bind_type", default="policy",
                     choices=["policy", "management"])
    brc.add_argument("-bind-name", dest="bind_name", default="")
    brc.set_defaults(fn=cmd_acl_binding_rule_create)
    brl = br.add_parser("list")
    brl.set_defaults(fn=cmd_acl_binding_rule_list)
    alog = acl.add_parser("login")
    alog.add_argument("-method", default="",
                      help="auth method (default: the method marked "
                           "-default)")
    alog.add_argument("token", help="the JWT ('-' reads stdin)")
    alog.set_defaults(fn=cmd_acl_login)

    nsp = sub.add_parser("namespace",
                         help="namespace management").add_subparsers(
        dest="ns_cmd", required=True)
    nsl = nsp.add_parser("list")
    nsl.set_defaults(fn=cmd_namespace_list)
    nsa = nsp.add_parser("apply")
    nsa.add_argument("name")
    nsa.add_argument("-description", default="")
    nsa.set_defaults(fn=cmd_namespace_apply)
    nsd = nsp.add_parser("delete")
    nsd.add_argument("name")
    nsd.set_defaults(fn=cmd_namespace_delete)

    npp = node.add_parser("pool").add_subparsers(dest="pool_cmd",
                                                 required=True)
    npl = npp.add_parser("list")
    npl.set_defaults(fn=cmd_node_pool_list)
    npa = npp.add_parser("apply")
    npa.add_argument("name")
    npa.add_argument("-description", default="")
    npa.set_defaults(fn=cmd_node_pool_apply)
    npd = npp.add_parser("delete")
    npd.add_argument("name")
    npd.set_defaults(fn=cmd_node_pool_delete)

    vol = sub.add_parser("volume", help="CSI volumes").add_subparsers(
        dest="vol_cmd", required=True)
    vr = vol.add_parser("register")
    vr.add_argument("volume_id")
    vr.add_argument("-plugin", required=True)
    vr.set_defaults(fn=cmd_volume_register)
    vs = vol.add_parser("status")
    vs.add_argument("volume_id", nargs="?", default="")
    vs.set_defaults(fn=cmd_volume_status)
    vd = vol.add_parser("deregister")
    vd.add_argument("volume_id")
    vd.set_defaults(fn=cmd_volume_deregister)

    var = sub.add_parser("var", help="variables").add_subparsers(
        dest="var_cmd", required=True)
    vp = var.add_parser("put")
    vp.add_argument("path")
    vp.add_argument("items", nargs="+")
    vp.set_defaults(fn=cmd_var_put)
    vg = var.add_parser("get")
    vg.add_argument("path")
    vg.set_defaults(fn=cmd_var_get)
    vl = var.add_parser("list")
    vl.add_argument("-prefix", default="")
    vl.set_defaults(fn=cmd_var_list)
    vpu = var.add_parser("purge")
    vpu.add_argument("path")
    vpu.set_defaults(fn=cmd_var_purge)

    svc = sub.add_parser("service",
                         help="service discovery").add_subparsers(
        dest="svc_cmd", required=True)
    svl = svc.add_parser("list")
    svl.set_defaults(fn=cmd_service_list)
    svi = svc.add_parser("info")
    svi.add_argument("name")
    svi.set_defaults(fn=cmd_service_info)

    system = sub.add_parser("system").add_subparsers(dest="sys_cmd",
                                                     required=True)
    sgc = system.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)

    srv = sub.add_parser("server").add_subparsers(dest="srv_cmd",
                                                  required=True)
    sm = srv.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)

    rg = sub.add_parser("regions", help="list federated regions")
    rg.set_defaults(fn=cmd_regions_list)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", dest="log_level", default="debug",
                     choices=["trace", "debug", "info", "warn", "error"])
    mon.set_defaults(fn=cmd_monitor)

    met = sub.add_parser("metrics", help="agent metrics")
    met.add_argument("-format", default="json",
                     choices=["json", "prometheus"])
    met.set_defaults(fn=cmd_metrics)

    hl = sub.add_parser("health",
                        help="SLO verdicts (observed vs threshold)")
    hl.add_argument("-json", action="store_true",
                    help="raw operator document as JSON")
    hl.set_defaults(fn=cmd_health)

    cl = sub.add_parser("cluster",
                        help="cluster-scope observability"
                        ).add_subparsers(dest="cluster_cmd", required=True)
    cls_ = cl.add_parser("status",
                         help="federation ledger (one row per origin) "
                              "+ cluster SLO verdicts")
    cls_.add_argument("-json", action="store_true",
                      help="raw cluster-health document as JSON")
    cls_.set_defaults(fn=cmd_cluster_status)

    mm = sub.add_parser("mem",
                        help="memory ledger (per-plane bytes, RSS, "
                             "evictions)")
    mm.add_argument("-cached", action="store_true",
                    help="last tick sample; don't force a scrape")
    mm.add_argument("-json", action="store_true",
                    help="raw operator document as JSON")
    mm.set_defaults(fn=cmd_mem)

    prof = sub.add_parser("profile",
                          help="on-demand profile capture (folded "
                               "stacks, buckets, device ledger)")
    prof.add_argument("-duration", type=float, default=2.0,
                      help="capture window seconds (default 2)")
    prof.add_argument("-output", default="",
                      help="write the full bundle JSON to this path")
    prof.add_argument("-folded", default="",
                      help="write the folded stacks to this path "
                           "(flamegraph.pl / speedscope input)")
    prof.add_argument("-trace", action="store_true",
                      help="also record a jax.profiler trace")
    prof.add_argument("-trace-dir", dest="trace_dir", default="",
                      help="directory for the jax.profiler trace "
                           "(implies -trace)")
    prof.add_argument("-status", action="store_true",
                      help="print the live sampler view; no capture")
    prof.set_defaults(fn=cmd_profile)

    dbg = sub.add_parser("debug",
                         help="flight recorder & dump bundles"
                         ).add_subparsers(dest="debug_cmd", required=True)
    dr = dbg.add_parser("record")
    dr.add_argument("-dump", action="store_true",
                    help="fetch the retained breach dump bundles")
    dr.add_argument("-n", type=int, default=0,
                    help="cap each ring's tail")
    dr.add_argument("-output", default="")
    dr.set_defaults(fn=cmd_debug_record)

    trc = sub.add_parser("trace",
                         help="eval-lifecycle traces").add_subparsers(
        dest="trace_cmd", required=True)
    trl = trc.add_parser("list")
    trl.set_defaults(fn=cmd_trace_list)
    trs = trc.add_parser("status")
    trs.add_argument("trace_id")
    trs.add_argument("-cluster", action="store_true",
                     help="stitch the trace across every gossip peer "
                          "into one cross-origin tree")
    trs.set_defaults(fn=cmd_trace_status)

    sk = sub.add_parser("soak",
                        help="virtual-time production soak (seeded "
                             "cluster-day replay, gated on live SLOs)")
    sk.add_argument("-seed", type=int, default=0)
    sk.add_argument("-hours", type=float, default=2.0,
                    help="virtual horizon (default 2h)")
    sk.add_argument("-nodes", type=int, default=12)
    sk.add_argument("-zones", type=int, default=3)
    sk.add_argument("-quick", action="store_true",
                    help="shrunk churn-heavy profile (~0.1 virtual "
                         "hours; CI smoke)")
    sk.add_argument("-no-chaos", dest="no_chaos", action="store_true",
                    help="skip the interleaved chaos scenarios")
    sk.add_argument("-check-determinism", dest="check_determinism",
                    action="store_true",
                    help="run twice, require byte-identical traces")
    sk.add_argument("-json", default="",
                    help="write the summary JSON to this path")
    sk.add_argument("-rss-ceiling-mb", dest="rss_ceiling_mb",
                    type=float, default=-1.0,
                    help="fail if process RSS high-water exceeds this "
                         "many MiB (default: disabled)")
    sk.set_defaults(fn=cmd_soak)

    tl = sub.add_parser("timeline",
                        help="clock-aligned metric history "
                             "(sparklines + annotations)")
    tl.add_argument("-start", type=float, default=None)
    tl.add_argument("-end", type=float, default=None)
    tl.add_argument("-step", type=float, default=0.0,
                    help="aggregation step seconds (default: native)")
    tl.add_argument("-series", default="",
                    help="comma-separated series names (default: all)")
    tl.add_argument("-input", default="",
                    help="render a timeline dump file instead of "
                         "querying the agent")
    tl.add_argument("-width", type=int, default=40,
                    help="sparkline width (default 40)")
    tl.add_argument("-n", type=int, default=12,
                    help="annotation tail length (default 12)")
    tl.set_defaults(fn=cmd_timeline)

    rp = sub.add_parser("report",
                        help="breach/spike post-mortem attributed to "
                             "nearest-in-time annotations")
    rp.add_argument("-input", default="",
                    help="timeline dump file (default: live agent)")
    rp.add_argument("-json", action="store_true",
                    help="emit the raw report doc instead of Markdown")
    rp.add_argument("-output", default="",
                    help="write the report to this path")
    rp.add_argument("-window", type=float, default=60.0,
                    help="attribution window seconds (default 60)")
    rp.set_defaults(fn=cmd_report)

    st = sub.add_parser("status")
    st.set_defaults(fn=cmd_status)
    return p


_RESOLVE_ATTRS = (("node_id", "nodes"), ("alloc_id", "allocs"),
                  ("eval_id", "evals"), ("deployment_id", "deployment"),
                  # trace ids ARE eval ids (stamped at the FSM boundary),
                  # so eval-prefix search resolves them too
                  ("trace_id", "evals"))


def main(argv: Optional[List[str]] = None) -> int:
    import urllib.error
    args = build_parser().parse_args(argv)
    try:
        # unique-prefix resolution for every id-taking command, once,
        # here — the CLI prints 8-char ids and they must round-trip
        for attr, ctx in _RESOLVE_ATTRS:
            val = getattr(args, attr, "")
            if val:
                setattr(args, attr, _resolve(_client(args), ctx, val))
        return args.fn(args)
    except APIException as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"Error connecting to {args.address}: {e.reason}",
              file=sys.stderr)
        return 1
    except BrokenPipeError:
        # output piped into a pager/head that exited — not an error
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        return 0
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
