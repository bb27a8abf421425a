"""Run cells of the benchmark again and again, each run in a process of its
own, and print each run's result line and every metric's spread.

    python3 -m portbench.spread --out DIR [--seconds S] CELL:SEED[:TRACE] ...

Runs go one after another in the order given. Each run's result line and
the end of its standard error are appended to ``DIR/runs.jsonl``. At the end,
per cell and per metric, over the untraced runs: the median and the spread
of them all (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median), and, for
each set of ``--set-size`` runs in the order given, the gate's spread: the
range of the set once its run farthest from the median is left out. The
mean of the sets' gate spreads, as a share of the median of all the runs,
may be at most half the metric's bound.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def gate_spread(values):
    """The range of ``values`` once the one farthest from their median is left
    out (in the metric's unit)."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return max(rest) - min(rest)


def gate_share(values, set_size: int):
    """The mean of the gate spreads of the consecutive sets of ``set_size``
    runs (a short last set counts if it holds three or more), as a share of
    the median of all the runs; None below one such set."""
    sets = [values[i:i + set_size] for i in range(0, len(values), set_size)]
    spreads = [gate_spread(s) for s in sets if len(s) >= 3]
    if not spreads:
        return None, []
    return sum(spreads) / len(spreads) / statistics.median(values), spreads


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--set-size", type=int, default=6)
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    results = []
    for spec in args.runs:
        cell, seed, *rest = spec.split(":")
        trace = rest[0] if rest else "0"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", seed,
             "--seconds", str(args.seconds), "--trace", trace],
            capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        host = next((ln[len("# host "):] for ln in lines if ln.startswith("# host ")), None)
        record = {"cell": cell, "seed": int(seed), "trace": int(trace), "rc": proc.returncode,
                  "wall_s": wall, "result": result, "host": host,
                  "stderr_tail": proc.stderr[-3000:]}
        results.append(record)
        with open(os.path.join(args.out, "runs.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        summary = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
        print(f"{cell} seed {seed} trace {trace} rc {proc.returncode} wall {wall:.1f} "
              f"correct {(result or {}).get('correct')} {json.dumps(summary)} "
              f"checks {json.dumps(checks)}", flush=True)
        if result is None:
            print(proc.stderr[-2000:], flush=True)
    for cell in dict.fromkeys(r["cell"] for r in results):
        runs = [r for r in results if r["cell"] == cell and r["trace"] == 0 and r["result"]]
        names = {k for r in runs for k in r["result"]["metrics"]}
        for name in sorted(names):
            values = [r["result"]["metrics"][name]["value"] for r in runs
                      if name in r["result"]["metrics"]]
            share, sets = gate_share(values, args.set_size)
            print(f"{cell} {name}: n {len(values)} median {statistics.median(values)!r} "
                  f"spread {spread(values)!r} gate {share!r} sets {sets} values {values}",
                  flush=True)


if __name__ == "__main__":
    main()
