"""The readings that the check's limits are set from, many seeds in one
process (no window).

    python3 -m stereo_bench.control --workload <cell> --seeds 1,2,3 \
        [--judged bfloat16,taps_reversed,stencil_reversed]

For each seed it makes the cell's pool as a run does, takes the pairs
that a run with that seed samples (``harness.sampled``), and judges each
of ``--judged`` against the float32 reference on card 0, as ``check``
judges a run: ``bfloat16``, the control (the reference computed in
bfloat16, put in the program's place: the upper reading), and the sound
float32 variants of ``sound`` (the lower reading).  One JSON line a seed
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
    args = ap.parse_args(argv)
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
                ref = match_pair(*ins, m, cell.foveated)
                for j in judged:
                    low = j == "bfloat16"
                    with (contextlib.nullcontext() if low
                          else sound.variant(j)):
                        got = match_pair(*ins, m, cell.foveated,
                                         torch.bfloat16 if low
                                         else torch.float32)
                    readings[j].append(check.compare(got, ref,
                                                     m["fovea_level"]))
        for j in judged:
            ok, numbers = check.judge(readings[j], cfg["limits"])
            print(json.dumps({
                "workload": args.workload, "seed": seed, "judged": j,
                "answers": len(readings[j]), "correct": ok,
                "numbers": {n: check._worst([r[n] for r in readings[j]])
                            for n in check.NUMBERS},
                "per_answer": readings[j],
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
