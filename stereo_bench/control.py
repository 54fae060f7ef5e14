"""The readings that the check's limits are set from, many seeds in one
process (no window).

    python3 -m stereo_bench.control --workload <cell> --seeds 1,2,3 \
        [--judged bfloat16,taps_reversed,stencil_reversed] \
        [--program early_exit_delta=0.04 --seconds 5]

For each seed it makes the cell's pool as a run does, takes the pairs
that a run with that seed samples (``harness.sampled``), and judges each
of ``--judged`` against the float32 reference on card 0, as ``check``
judges a run: ``bfloat16``, the control (the reference computed in
bfloat16, put in the program's place: the upper reading), and the sound
float32 variants of ``sound`` (the lower reading); in an early-exit
configuration each also reads ``iterations_gap`` from the iterations
that it and the reference ran.  ``--program`` instead runs the cell
itself (``harness.run``, a window of ``--seconds``) with the program's
matcher fields changed, and reads the run's check: the program with a
looser exit is the control of ``iterations_gap``.  One JSON line a seed
and judged, with every number of ``check.NUMBERS``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stereo_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--judged", default="bfloat16")
    ap.add_argument("--program", default=None,
                    help="field=value: run the program so changed "
                         "('none': as the cell states)")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.program:
        return _program(args)
    import torch

    from stereo_bench import check, harness, scene, sound, spec
    from stereo_bench.reference import match_pair

    cell = spec.load(args.workload)
    traffic, cfg = cell.traffic, cell.config
    m = cfg["matcher"]
    dev = torch.device("cuda", 0)
    batch = traffic["entry"] == "match_batch"
    n_pool = int(traffic["pool"])
    judged = args.judged.split(",")
    gate = cfg["guarantees"].get("exit_levels_above_px")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        pool = scene.make_pool(
            n_pool, int(traffic["pairs_per_call"]) if batch else 1,
            cell.frame, seed, traffic["disparity"], dev, traffic["inputs"])
        readings = {j: [] for j in judged}
        for i, picks in harness.sampled(traffic, seed).items():
            pairs = harness._pairs_of(pool[i % n_pool], batch)
            for p in picks:
                ins = [harness._chw(x, dev) for x in pairs[p]]
                ref = match_pair(*ins, m, cell.foveated, exit_above_px=gate)
                for j in judged:
                    low = j == "bfloat16"
                    with (contextlib.nullcontext() if low
                          else sound.variant(j)):
                        got = match_pair(*ins, m, cell.foveated,
                                         torch.bfloat16 if low
                                         else torch.float32,
                                         exit_above_px=gate)
                    reading = check.compare(got, ref, m["fovea_level"])
                    if ref["exit_levels"]:
                        reading[check.ITERATIONS_GAP] = check.iterations_gap(
                            check.iterations_of(got), check.iterations_of(ref))
                        reading["iterations"] = got["iterations"]
                        reading["reference_iterations"] = ref["iterations"]
                    readings[j].append(reading)
        for j in judged:
            ok, numbers = check.judge(readings[j], cfg["limits"])
            print(json.dumps({
                "workload": args.workload, "seed": seed, "judged": j,
                "answers": len(readings[j]), "correct": ok,
                "numbers": {n: check._worst([r[n] for r in readings[j]
                                             if n in r])
                            for n in check.NUMBERS
                            + (check.ITERATIONS_GAP,)},
                "per_answer": readings[j],
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _program(args) -> int:
    """The cell run with the program's matcher fields changed, a seed at
    a time, in this process."""
    from stereo_bench import harness

    fields = {}
    if args.program != "none":
        field, value = args.program.split("=", 1)
        fields[field] = json.loads(value)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          program_fields=fields,
                          log=lambda *a, **k: None)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "judged": f"program {args.program}", "correct": res["correct"],
            "attempted": res["attempted"],
            "numbers": {n: v["value"] for n, v in res["check"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
