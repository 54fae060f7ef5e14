"""How widely a cell's end-to-end metrics spread from run to run: sets of
runs of one cell, each run a fresh process, every set on the same seeds.

    python3 -m stereo_bench.spread --workload <cell> --runs 7 --sets 2 \
        [--seconds S] [--seed0 N] [--root DIR] [--out FILE]

Each run is ``python3 -m stereo_bench --workload <cell> --seed <n>
--seconds <S> --trace 0`` from ``--root`` (default: this checkout), as a
check runs it; ``--seconds`` defaults to ``run_seconds``.  Run r of every
set takes seed ``seed0 + r``.  For each run it keeps the result line,
the requests that ended in each second of the window (the harness's
``requests_per_s`` line) and the harness's account of its set-up
(imports, pool, first call).  It prints one JSON line a run and, last,
one with every metric's values and spreads by set:

* ``range``: (largest - smallest) / median, leaving out the run farthest
  from the median where that narrows it, as a check judges a set
  against a bound;
* ``iqr``: (third quartile - first quartile) / median, the quartiles of
  ``statistics.quantiles(values, n=4)``, which a bound is set from.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Sequence

from stereo_bench import spec

RATES = "requests_per_s "
SETUP = "setup: "


def range_spread(values: Sequence[float]) -> float:
    """(max - min) / median, leaving out the value farthest from the
    median where that narrows it."""
    med = statistics.median(values)
    xs = list(values)
    best = max(xs) - min(xs)
    if len(xs) >= 3:
        far = max(range(len(xs)), key=lambda i: abs(xs[i] - med))
        rest = xs[:far] + xs[far + 1:]
        best = min(best, max(rest) - min(rest))
    return best / med


def iqr_spread(values: Sequence[float]) -> float:
    """(q3 - q1) / median, by ``statistics.quantiles(values, n=4)``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summarise(runs: Sequence[dict]) -> Dict[str, dict]:
    """Per metric and set: the values, the median and both spreads."""
    out: Dict[str, dict] = {}
    sets = sorted({r["set"] for r in runs})
    names = sorted({m for r in runs for m in r.get("metrics", {})})
    for name in names:
        per = {}
        for s in sets:
            vals = [r["metrics"][name] for r in runs
                    if r["set"] == s and name in r.get("metrics", {})]
            if len(vals) < 2:
                continue
            per[str(s)] = {"values": vals, "median": statistics.median(vals),
                           "range": range_spread(vals),
                           "iqr": iqr_spread(vals)}
        out[name] = per
    return out


def one_run(root: Path, workload: str, seed: int, seconds: float,
            timeout: float) -> dict:
    t0, started = time.perf_counter(), time.time()
    p = subprocess.run(
        [sys.executable, "-m", spec.PACKAGE, "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=timeout)
    rec: dict = {"seed": seed, "rc": p.returncode, "started": started,
                 "wall_s": time.perf_counter() - t0}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        res = json.loads(lines[-1])
        rec["correct"] = res["correct"]
        rec["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
        rec["check"] = res.get("check")
    else:
        rec["stderr_tail"] = p.stderr[-2000:]
    for line in p.stderr.splitlines():
        if line.startswith(RATES):
            rec["requests_per_s"] = json.loads(line[len(RATES):])
        elif line.startswith(SETUP):
            rec["setup"] = line[len(SETUP):]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stereo_bench.spread")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--seed0", type=int, default=3 * 2 ** 31 + 17)
    ap.add_argument("--root", default=str(spec.ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    seconds = args.seconds or spec.benchmark(root)["run_seconds"]
    runs = []
    out = open(args.out, "a") if args.out else None
    try:
        for s in range(args.sets):
            for r in range(args.runs):
                rec = one_run(root, args.workload, args.seed0 + r, seconds,
                              timeout=seconds + 600)
                rec.update(workload=args.workload, set=s, run=r)
                runs.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
        line = json.dumps({"workload": args.workload, "seconds": seconds,
                           "spreads": summarise(runs)})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
