"""How fast a 16 MP uint8 pair reaches the card by each upload route.

Measures, on one card: the pageable ``torch.from_numpy(a).to(card)``
(the route before the staging ring), one DMA from pinned memory, the
host copy into pinned memory by torch's CPU ``copy_`` at several chunk
sizes and intra-op thread counts (``torch.set_num_threads``, in this
process only), a ring of three 8 MiB slots filled by torch's CPU copy
on every intra-op thread (``torch_ring``), and the staging ring
(staging.StagingRing) over a grid of slot sizes and copy threads.
Every route is timed from the call to the end of a synchronise of the
card, over both images of the pair, after ``--gap`` seconds of sleep
(the threads idle between requests, as they do while the card
matches); the ring also reports when the host got back.  The routes
run in turn, round after round, so drift spreads over all of them.
Then a closed loop of pair uploads with the same gap, one route after
another, gives the tails.  Prints a table, and writes the numbers as
one JSON line to ``--out`` if given:

    python tools/staging_probe.py [--rounds 20] [--loop 150] [--gap 0.02]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ug_stereomatcher_tpu_torch.staging import StagingRing  # noqa: E402

H, W = 3264, 4928
MIB = 1 << 20
SLOT_MIB = (4, 8, 16)
COPIERS = (4, 8, 16)
THREADS = (1, 8)


def _card_name() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return torch.cuda.get_device_name()


def _timed(fn, card, threads: int, gap: float) -> float:
    torch.set_num_threads(threads)
    torch.cuda.synchronize(card)
    time.sleep(gap)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(card)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--loop", type=int, default=150)
    ap.add_argument("--gap", type=float, default=0.02)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("staging_probe: needs a CUDA card")
    card = torch.device("cuda", 0)
    full = torch.get_num_threads()
    rng = np.random.default_rng(0)
    pair = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(2)]
    nbytes = sum(a.nbytes for a in pair)
    pinned = [torch.from_numpy(a).pin_memory() for a in pair]
    host_dst = [torch.empty(a.nbytes, dtype=torch.uint8, pin_memory=True)
                for a in pair]
    cores = len(os.sched_getaffinity(0))
    rings = {(m, c): StagingRing(card, m * MIB, c)
             for m in SLOT_MIB for c in COPIERS if c <= cores}
    returned = {}

    def pageable():
        for a in pair:
            torch.from_numpy(a).to(card)

    def pinned_dma():
        for p in pinned:
            p.to(card, non_blocking=True)

    def host_copy(chunk):
        def run():
            for a, d in zip(pair, host_dst):
                src = torch.from_numpy(a).view(-1)
                for s in range(0, a.nbytes, chunk):
                    d[s:s + chunk].copy_(src[s:s + chunk])
        return run

    torch_slots = [torch.empty(8 * MIB, dtype=torch.uint8, pin_memory=True)
                   for _ in range(3)]
    torch_events = [torch.cuda.Event() for _ in range(3)]

    def torch_ring():
        i = 0
        for a in pair:
            src = torch.from_numpy(a).view(-1)
            dst = torch.empty(a.nbytes, dtype=torch.uint8, device=card)
            for s in range(0, a.nbytes, 8 * MIB):
                e = min(s + 8 * MIB, a.nbytes)
                k, i = i % 3, i + 1
                torch_events[k].synchronize()
                torch_slots[k][:e - s].copy_(src[s:e])
                dst[s:e].copy_(torch_slots[k][:e - s], non_blocking=True)
                torch_events[k].record()

    def ring_upload(name, key):
        ring = rings[key]

        def run():
            t0 = time.perf_counter()
            for a in pair:
                ring.upload(torch.from_numpy(a))
            returned.setdefault(name, []).append(time.perf_counter() - t0)
        return run

    # name -> (fn, threads)
    routes = {"pageable": (pageable, full), "pinned_dma": (pinned_dma, full),
              "torch_ring": (torch_ring, full)}
    for t in sorted(set(THREADS + (full,))):
        for m in (8, 16):
            routes[f"host_copy_{m}MiB_t{t}"] = (host_copy(m * MIB), t)
    for m, c in rings:
        name = f"ring_{m}MiB_c{c}"
        routes[name] = (ring_upload(name, (m, c)), full)
    times = {name: [] for name in routes}
    for fn, t in routes.values():   # warm: pins the slots, starts threads
        _timed(fn, card, t, args.gap)
    returned.clear()
    for _ in range(args.rounds):
        for name, (fn, t) in routes.items():
            times[name].append(_timed(fn, card, t, args.gap))

    ring_names = [n for n in routes if n.startswith("ring_")]
    best = sorted(ring_names, key=lambda n: statistics.median(times[n]))[:3]
    loops = ["pageable", "torch_ring", "ring_8MiB_c8"] + [
        n for n in best if n != "ring_8MiB_c8"]
    tails = {}
    for name in loops:   # a closed loop: upload, synchronise, again
        fn, t = routes[name]
        xs = [_timed(fn, card, t, args.gap) for _ in range(args.loop)]
        q = statistics.quantiles(xs, n=100)
        tails[name] = {"p50_ms": 1e3 * statistics.median(xs),
                       "p95_ms": 1e3 * q[94], "p99_ms": 1e3 * q[98],
                       "max_ms": 1e3 * max(xs)}
    torch.set_num_threads(full)

    def summary(name, xs):
        q = statistics.quantiles(xs, n=4)
        med = statistics.median(xs)
        row = {"ms": 1e3 * med, "q1_ms": 1e3 * q[0], "q3_ms": 1e3 * q[2],
               "gb_s": nbytes / med / 1e9}
        if name in returned:
            row["host_return_ms"] = 1e3 * statistics.median(returned[name])
        return row

    out = {"card": _card_name(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "num_threads": full,
           "cpu_count": os.cpu_count(), "pair_bytes": nbytes,
           "rounds": args.rounds, "loop": args.loop, "gap_s": args.gap,
           "routes": {name: summary(name, xs) for name, xs in times.items()},
           "tails": tails}
    print({k: out[k] for k in ("card", "torch", "cuda", "num_threads",
                               "cpu_count", "pair_bytes")})
    for name, r in out["routes"].items():
        print(f"{name:24s} {r['ms']:8.3f} ms [{r['q1_ms']:.3f}, "
              f"{r['q3_ms']:.3f}] {r['gb_s']:6.2f} GB/s"
              + (f"  host back {r['host_return_ms']:.3f} ms"
                 if "host_return_ms" in r else ""))
    for name, r in tails.items():
        print(f"loop {name:20s} " + " ".join(f"{k} {v:.3f}"
                                             for k, v in r.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
