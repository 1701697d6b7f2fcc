"""Run one chaos scenario many times in one process and count its failures.

A named scenario at a fixed seed is meant to give one verdict.  This
script runs it `--runs` times in a row (the state a run leaves behind,
threads and garbage, stays for the next, as in `chip_smoke.py`'s
`scenarios` phase after the soaks) and prints one JSON line a run (the
verdict, the first violation, the trace digest's first 8 hex digits,
the wall seconds), then a summary line with the failure count.

    JAX_PLATFORMS=cpu python scenario_repeat.py lossy_link_raft_append \\
        --runs 30 [--package nomad_tpu_torch|nomad_tpu] [--tree DIR]

`--package nomad_tpu_torch` (the default) runs the port on the CPU
(`device="cpu"`); `--package nomad_tpu` runs the JAX reference (keep
`JAX_PLATFORMS=cpu`).  `--tree` puts another checkout (an unpacked
`git archive` of an earlier commit) first on the import path.
"""

import argparse
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--package", default="nomad_tpu_torch",
                    choices=("nomad_tpu_torch", "nomad_tpu"))
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    mod = importlib.import_module(f"{args.package}.chaos.scenarios")
    kw = {"device": "cpu"} if args.package == "nomad_tpu_torch" else {}
    failed = 0
    for i in range(args.runs):
        t0 = time.perf_counter()
        r = mod.run_scenario(args.scenario, seed=args.seed, **kw)
        failed += bool(r.violations)
        print(json.dumps({"run": i, "ok": not r.violations,
                          "violation": r.violations[0] if r.violations
                          else None,
                          "trace_digest": r.trace.digest()[:8],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"scenario": args.scenario, "seed": args.seed,
                      "package": args.package, "tree": args.tree,
                      "runs": args.runs, "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
