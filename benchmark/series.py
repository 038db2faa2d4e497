"""Runs of one cell in a row, one process at a time, and their spread.

    python3 benchmark/series.py --workload <name> --seeds 11 12 13 --seconds 10 [--trace 1] [--sample-seed N] [--out DIR]

Each run is ``run.py`` in a process of its own, as the check runs it; its
last line of standard output and the end of its standard error go to
``DIR/<workload>.<seed>.<trace>.s<sample seed>.{json,err}``.  Prints one line a run
(seconds, correct, metrics, checks) and, over the runs, each metric's
median and spread (quartiles by ``statistics.quantiles``, over the
median)."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.lib import measure  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sample-seed", type=int, default=0)
    p.add_argument("--out", default="chiprun_out/series")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    values, bad = {}, 0
    for seed in args.seeds:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace), "--sample-seed", str(args.sample_seed)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        stem = os.path.join(args.out, f"{args.workload}.{seed}.{args.trace}.s{args.sample_seed}")
        with open(stem + ".err", "w") as f:
            f.write(proc.stderr[-20000:])
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            bad += 1
            print(f"seed {seed}: rc {proc.returncode}, no result ({wall:.1f} s)\n{proc.stderr[-3000:]}", flush=True)
            continue
        with open(stem + ".json", "w") as f:
            f.write(lines[-1] + "\n")
        bad += not res["correct"]
        for k, m in res["metrics"].items():
            values.setdefault(k, []).append(m["value"])
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 2), "correct": res["correct"],
                          "attempted": res["attempted"], "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                          "device": res["device"], "checks": res["checks"],
                          **({"breakdown": res["breakdown"]} if "breakdown" in res else {})}), flush=True)
    for k, vs in values.items():
        line = {"metric": k, "runs": len(vs), "median": statistics.median(vs), "min": min(vs), "max": max(vs)}
        if len(vs) >= 2:
            line["spread"] = measure.spread(vs)
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
