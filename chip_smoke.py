#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: modes 1 and 2 at 16 MP
through the hand-written Hopper kernels, nearest and bilinear, whole and
row-sharded.

Phases (any failure exits non-zero before the last line is printed):

1. device: nvidia-smi name and power limit, torch and CUDA versions, and
   the nvcc build of the kernel library from the sources in csrc/;
2. kernels: each kernel against its plain PyTorch version on the card,
   with the median time of each beside the other (CUDA events):
   blur, resample (nearest and bilinear), warp (nearest and bilinear, on
   a random field and on a smooth one like the matcher's: the scene's
   3 px shift plus a sinusoid of a few pixels, from --seed), direction
   and smooth at the 16 MP level-0 shape and at pyramid level 8
   (202 x 306; smooth also with 40 passes, several launches), the
   row-sharded forms of warp (both methods and
   fields), direction and smooth on the middle (timed) and bottom shard
   of four at those levels (816 and 51 rows), and the level-resident
   kernel at levels 8 and 13 in both methods with replace_first on and
   off, with the grid barriers each timed launch passed and its time by
   phase (counted by block 0 on the card; more than 3 barriers per
   iteration fails); mode 2's cases: the level kernel at the fovea size
   (407 x 615) with the schedules of levels 0 and 1 (10 passes, 2 and 4
   iterations) in both methods, and the windowed resample of a fovea
   transition (onto the centred window of the 576 x 870 grid) in both;
   early exit's: warp, direction and smooth guarded by a set flag (the
   output untouched) and a clear one (bit-equal to the unguarded launch)
   at 16 MP and level 8, and the convergence kernel at levels 0 and 5
   (3264 x 4928, 576 x 870) against its plain version (1e-5 relative)
   and a float64 sum (2e-6), with its flag;
   each kernel's least possible time on the card (bound) and, where one
   PyTorch call computes the same function, that call's time; every
   case also prints its device time alone (device_ms, and
   library_device_ms for the PyTorch call: CUDA events around the
   replay of a CUDA graph of 20 calls, over 20; the level kernel's
   cooperative launch included), beside ms, the call as a caller sees
   it (3 back-to-back calls: where the host's work is the longer, ms is
   the host's);
3. slices: StereoEngine.match on the 1/f octave scene with a known 3 px
   shift at 3264 x 4928, (a) nearest with the level-resident gate, (b)
   nearest with every level per iteration, (c) bilinear; then
   StereoEngine.match_batch of the same pair on a 1 x 4 mesh of this one
   card (four row shards), (d) nearest and (e) bilinear, each equal to
   (a) or (c) bit for bit.  For each: the value gates of the JAX
   package's on-chip check on [64:-64, 64:-64], the launch count of every
   kernel against the count the config implies (for the mesh), first-call
   and warm latency, peak device memory, and the kernel time by name over
   one warm match (torch.profiler) with the device's busy share; then two
   816 x 1232 pairs on a 2 x 2 mesh of this card against match per pair,
   then, where there are several cards, the 1 x N mesh across them, the
   1 x 2 and the 2 x 2 hybrid (one CUDA graph a rows-group across its
   cards) and the N x 1 mesh (a graph a card), each against the eager
   matcher (with one card a line says this did not run); mode 2 on
   the same pair: match_foveated (f) nearest, (g) nearest per iteration,
   (h) bilinear, (i) match_hierarchical nearest and (j)
   match_batch(foveated=True) on the 1 x 4 mesh, each with its launch
   counts against the config's, the value gates on stack level 0 (the
   fovea at full resolution, inside 32 px; the coarser levels printed
   against the shift at their scale), latency, peak memory and profile,
   then (g) within the quantile rule of (f), (j) and the hierarchical
   map's centred fovea window equal to (f) bit for bit; and levels 4-13
   of the nearest mode-1 match timed level-resident against per
   iteration; the extras and the geometry on the same pair: early exit,
   decided on the card, (k) nearest at 0.1 px and (l) bilinear at 0.02
   px (no host read, the fixed schedule's launches and 42 convergence
   tests, the iterations that did work by iterations_run(), each
   per-iteration level alone equal to the host-read loop on the card in
   iterations and bits, the value gates, latency, spread, busy share
   and the host's enqueue time beside (a) and (c)), the convergence
   trace at level 4, match_with_consistency (the consistent
   share on [64:-64, 64:-64] > 0.9, one warp launch beyond the two
   matches), profile_match equal to (a) with its per-level breakdown,
   warmup and get_disparities equal to match and match_foveated, and on
   the verged rig of tests/test_geom.py scaled to 4928 x 3264 the
   full-resolution point cloud of (a) (finite share; a float64
   least-squares gold on 4096 seeded pixels, q99 <= 1e-3), the resized
   clouds at 0.2 (bilinear through the resample kernel, which is held
   against its plain version on that range map, and cubic) and the
   foveated cloud of (f), each timed with its device part; phase 3h,
   the compile-once cache (graphs_phase): every entry point the engine
   captures as a CUDA graph (match nearest and bilinear, with and
   without early exit; match_foveated nearest and bilinear;
   match_hierarchical; match_batch of 8 pairs at 815 x 1231, mode 1 and
   foveated), the batch matcher's mesh graphs (the sharded slices (d),
   (e) and (j), the 2 x 2 pair batch, measure_throughput's dp, sp,
   hybrid and dp_fov points at 408 x 616 on 4 entries of this card) and
   profile_match's stage graphs, each bit-equal to its eager path on
   the capture and on a replay with a second scene, the first result
   unchanged, launch counts, replays and early-exit iterations equal and
   no host read, with the warm latency and busy share of graph and
   eager in turns, the capture time, the peak memory and the memory the
   graphs hold (profile_match: its stage sums too); then phase
   3e, the host layers, writing only .npy, .txt, .json, .xml and .pcd
   files into a temporary directory: BatchRunner over a 3-pair .npy
   manifest with the verged rig as two XML files and clouds, with and
   without prefetch (each pair's launches those of a match, pair 0's
   dumps equal to (a) bit for bit, each PCD of 16.1 M points, a rerun
   from the checkpoint skipping all three), pairs per second, the busy
   share and pair 0's seconds by stage (load, H2D, match, dump, cloud,
   native PCD write against geom.save_pcd, whose bytes it must equal);
   DisparityService planes equal to (a) and to match_foveated, the
   default EngineSupervisor in all three modes; ``python -m
   ug_stereomatcher_tpu_torch match`` and ``cloud`` in subprocesses
   (rc 0, outputs checked, wall time); and accuracy_table(192, 256) on
   the card against the per-scene gates of tests/test_eval_cli.py and
   the same table on the CPU, with evaluate_occlusion in both modes;
   phase 3f, batches, scaling and processes (see scaling_phase); phase
   3g, ``python -m ug_stereomatcher_tpu_torch bench`` with BENCH_MODE=all
   at 16 MP in a subprocess: rc 0, the JAX bench's metric order, every
   line's values within the gates and naming this card, and the mode-1
   value within 0.5-1.5x of (a)'s warm median;
4. lockstep: pyramid level 4 (815 x 1231) refined from one input state
   by the kernels and by the plain versions on the card, held to the
   repo's quantile rule (q99 <= 2e-3, max <= 0.05);
5. a JSON line of the kernels, the nvidia-smi line, and the last line
   {"ok": true, "device": {...}}.

Four shards on one card do the pixel work of one match plus the halo
copies and the launches of four: they show that the sharded path is
right and what it costs, not how it scales.

It imports torch, numpy and the port, never jax.  Usage:
    python3 chip_smoke.py [--out FILE.json] [--seed N]

With ``--ab NAME=PATH`` given twice or more, it runs none of the phases
above and compares source trees instead (for example a parent commit
unpacked by ``git archive`` against this checkout): each round runs
every tree once, in its own process that imports the port from that
tree and builds its kernels there, in an order reversed every other
round (parent, change, change, parent, ...).  A process times
StereoEngine.match nearest and bilinear, match_foveated nearest (where
the tree has it) and, last, early exit (nearest at 0.1 px, bilinear at
0.02) on the bench scene, warm (host clock around a
synchronised call, median of ``--matches`` after one warm-up), each with
the device's busy share of one profiled match; the
whole-image blur, warp (nearest and bilinear, on the random and the
smooth field), direction and smooth (n = 0, 5 and 10) kernels at 16
MP (warp, direction and smooth n = 10 also alone, from a CUDA graph),
the 6-plane zero-boundary blur of the stacked pyramid level, and
the row-sharded direction and smooth (n = 10) on the middle shard of
four; the level-resident kernel at levels 8 and 13 (nearest,
replace_first off), blur, warp, direction and smooth at level 8 (call
and device ms), and the nearest and bilinear resample at the 16 MP
sqrt(2) and x2 subsamples of six stacked planes, the value-scaled
upsample of three, the level-8 subsample, a point cloud's range map
(x0.2) and the fovea window (resample_cases: call ms, device ms, the
whole resample_tex call, the bound and F.interpolate), and the host µs
of each step of the range-map call (host_costs).  It prints the
nvidia-smi line and one line a number with each tree's median, least
and greatest (the runs in full go to --out):
    python3 chip_smoke.py --ab parent=_smoke_checkout/parent --ab change=. \\
        [--rounds 2] [--matches 7] [--out FILE.json]

With ``--gates G1,G2,...`` (level-resident gates in pixels) it runs none
of the phases either: it prints the level table of phase 3 (levels
4-13, resident against per iteration) and then times StereoEngine.match
nearest warm at each gate (``resident_max_pixels``), one match per gate
per round, the order of the gates reversed every other round:
    python3 chip_smoke.py --gates 65536,131072,262144 [--rounds 8] \\
        [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 3264, 4928          # the published 16 MP frame
COARSE_LEVEL = 8           # 202 x 306 on the 16 MP chain
SMALL_LEVEL = 13           # 34 x 53, the coarsest
LOCKSTEP_LEVEL = 4         # 815 x 1231
TABLE_LEVELS = range(4, 14)
MANY_PASSES = 40           # more smoothing passes than one launch runs
SEED = 0

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Float operations per pixel, counted from the plain versions' arithmetic:
# one 5-tap pass is 5 products and 4 sums; the direction step is, per
# channel, the squared warped image and its blur (1 + 18) plus, per move,
# the cross product, its blur, numerator, denominator, ratio and the
# accumulation (1 + 18 + 4), then two parabola fits (14 each) and the
# update and blend (6); a smoothing pass is 4 sums for the weights and
# 5 products, 4 sums and a division per plane; the average is two 3-tap
# passes per plane.
PASS5_OPS = 9
DIRECTION_OPS = 3 * (1 + 2 * PASS5_OPS + 5 * (1 + 2 * PASS5_OPS + 4)) + 34
SMOOTH_PASS_OPS = 4 + 3 * 10
AVERAGE_OPS = 3 * 2 * 5
WARP_OPS = {"nearest": 6, "bilinear": 10 + 3 * 12}
# the convergence test: two differences, two absolute values, two
# products and three sums a pixel; it reads five planes
CONVERGENCE_OPS = 9
CONVERGENCE_BYTES = 5 * 4
CONVERGENCE_LEVELS = (0, 5)   # 3264 x 4928 and 576 x 870


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, samples: int = 5, per_sample: int = 3) -> float:
    """Median device time of one ``fn()`` call in ms: CUDA events around
    ``per_sample`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def graph_ms(fn, n: int = 20) -> float:
    """Device time of one ``fn()`` call in ms with the host out of the way:
    CUDA events around the replay of a CUDA graph of ``n`` back-to-back
    calls, over ``n`` (each launch's gap on the card included)."""
    def calls():
        for _ in range(n):
            fn()
    return cuda_ms(graph_replay(calls)) / n


def bound(nbytes: float, ops: float):
    """The least time (ms) the card needs to move ``nbytes`` and do
    ``ops`` float32 operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def expected_launches(cfg, h: int, w: int, resident_max_pixels=None,
                      foveated: bool = False,
                      hierarchical: bool = False) -> dict:
    """Kernel launches of one StereoEngine.match (match_foveated with
    ``foveated``, match_hierarchical with ``hierarchical`` too), derived
    from the config: one level-resident launch per gated level (at its
    match dims: the fovea size below fovea_level - 1 in mode 2); warp,
    direction and smooth once per iteration of every other level, each
    with one G(L^2) blur; the pyramid blurs that feed a resample (levels
    0 .. n-3); n-1 subsamples and n-1 upsamples (fovea-to-fovea ones
    windowed; 2(n-1) when confidence is resampled on its own); the
    hierarchical map's fovea_level - 1 upsamples.  Bilinear forms count
    under their own names."""
    from ug_stereomatcher_tpu_torch.match import (
        level_dims_for_matching, uses_level_resident)

    n = cfg.num_levels(h, w)
    dims = level_dims_for_matching(cfg, h, w, n, foveated or hierarchical)
    resident = [i for i in range(n)
                if uses_level_resident(*dims[i], resident_max_pixels,
                                       cfg.smooth_passes_for_level(i),
                                       cfg.iters_for_level(i), cfg.interp,
                                       torch.device("cuda"))]
    iters = sum(cfg.iters_for_level(i) for i in range(n) if i not in resident)
    pyramid_blurs = (1 + max(0, n - 3)) if n > 1 else 0
    upsamples = (n - 1) * (1 if cfg.scale_conf_on_upsample else 2)
    if hierarchical:
        upsamples += cfg.fovea_level - 1
    form = "" if cfg.interp == "nearest" else f"_{cfg.interp}"
    counts = {f"warp{form}": iters, "direction": iters, "smooth": iters,
              "blur": (n - len(resident)) + pyramid_blurs,
              f"resample{form}": (n - 1) + upsamples,
              "level": len(resident)}
    return {k: v for k, v in counts.items() if v}


def expected_mesh_launches(cfg, h: int, w: int, devices,
                           foveated: bool = False) -> dict:
    """Kernel launches of one pair through StereoEngine.match_batch on a
    mesh whose rows axis is ``devices`` (``foveated``: mode 2), derived
    from the config: a stage with rows enough to shard (spatial._row_ok)
    launches once per shard, any other once per distinct device (a
    sharded level: the row-sharded warp, direction and smooth once per
    shard and iteration, and one G(L^2) blur per shard; a whole level: as
    in expected_launches).  The pyramid is built at full size; a
    fovea-to-fovea transition runs whole."""
    from ug_stereomatcher_tpu_torch.match import (
        level_dims_for_matching, uses_level_resident)
    from ug_stereomatcher_tpu_torch.parallel.spatial import (
        MIN_ROWS_PER_SHARD, _row_ok)

    n = cfg.num_levels(h, w)
    full = cfg.dims_chain(h, w)[:n]
    dims = level_dims_for_matching(cfg, h, w, n, foveated)
    shards, copies = len(devices), len(set(devices))
    form = "" if cfg.interp == "nearest" else f"_{cfg.interp}"
    per_up = 1 if cfg.scale_conf_on_upsample else 2
    counts: dict = {}

    def add(name, k):
        counts[name] = counts.get(name, 0) + k

    def per(rows):
        return shards if _row_ok(rows, shards, MIN_ROWS_PER_SHARD) else copies

    for i in range(n):
        targets = ([1] if i == 0 and n > 1 else []) + (
            [i + 2] if i + 2 < n else [])
        if targets:
            add("blur", per(full[i][0]))
        for j in targets:
            add(f"resample{form}", per(full[j][0]))
        it = cfg.iters_for_level(i)
        if _row_ok(dims[i][0], shards, MIN_ROWS_PER_SHARD):
            for name in (f"warp{form}_row_halo", "direction_row_halo",
                         "smooth_row_halo"):
                add(name, it * shards)
            add("blur", shards)
        elif uses_level_resident(*dims[i], None,
                                 cfg.smooth_passes_for_level(i), it,
                                 cfg.interp, torch.device("cuda")):
            add("level", copies)
        else:
            for name in (f"warp{form}", "direction", "smooth"):
                add(name, it * copies)
            add("blur", copies)
        if i > 0:
            fovea_step = foveated and i < cfg.fovea_level
            add(f"resample{form}",
                (copies if fovea_step else per(dims[i - 1][0])) * per_up)
    return counts


def grid_sample_warp(img, dh, dv, mode, row0: int = 0):
    """F.grid_sample of the same backward warp (texel centres at x + 0.5,
    clamp addressing as padding_mode="border"), one PyTorch call; dh and
    dv are the destination rows from ``row0`` on."""
    import torch.nn.functional as F

    _, h, w = img.shape
    ys = torch.arange(row0, row0 + dh.shape[0], device=img.device,
                      dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    grid = torch.stack([(2.0 * (xs + dh) + 1.0) / w - 1.0,
                        (2.0 * (ys + dv) + 1.0) / h - 1.0], dim=-1)[None]
    x = img[None]
    return lambda: F.grid_sample(x, grid, mode=mode, padding_mode="border",
                                 align_corners=False)


def smooth_field(dev, h: int, w: int, row0: int = 0, image_h=None):
    """A field like the matcher's on the bench scene: its 3 px shift plus
    a low-frequency sinusoid of a few pixels in dh (amplitude 2-4 px) and
    dv (1-2 px), phases and amplitudes from the seed.  (dh, dv) of rows
    row0 .. row0 + h of an image_h-row image (default h)."""
    from ug_stereomatcher_tpu_torch import scene

    rng = np.random.RandomState(SEED)
    a_h, a_v = rng.uniform(2.0, 4.0), rng.uniform(1.0, 2.0)
    p_h, p_v = rng.uniform(0.0, 2.0 * np.pi, 2)
    image_h = image_h or h
    ys = torch.arange(row0, row0 + h, device=dev,
                      dtype=torch.float32)[:, None] / image_h
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] / w
    t = 2.0 * np.pi * (1.5 * xs + ys)
    dh = scene.SHIFT_PX + a_h * torch.sin(t + p_h)
    dv = a_v * torch.cos(2.0 * np.pi * (xs - 2.0 * ys) + p_v)
    return dh.contiguous(), dv.contiguous()


def conv2d_blur(x):
    """The zero-boundary Gaussian as one depthwise F.conv2d with the 5x5
    outer product of the taps (TF32 off: device.resolve_device)."""
    import torch.nn.functional as F
    from ug_stereomatcher_tpu_torch.config import gaussian_kernel

    k = torch.from_numpy(gaussian_kernel()).to(x.device)
    c = x.shape[0]
    weight = torch.outer(k, k).expand(c, 1, 5, 5).contiguous()
    xb = x[None]
    return lambda: F.conv2d(xb, weight, padding=2, groups=c)


def interpolate_resample(src, scale: float, out_hw, method: str):
    """F.interpolate of the same subsample by ``scale`` (texel centres,
    clamp addressing: "nearest-exact" floors (j + 0.5) * scale as the
    nearest taps do; "bilinear" without align_corners takes the same
    taps, its coordinates rounded in float32), one PyTorch call; None
    where its output shape is not the kernel's."""
    import torch.nn.functional as F

    mode = "nearest-exact" if method == "nearest" else "bilinear"
    extra = {} if method == "nearest" else {"align_corners": False}
    x = src[None]

    def call():
        return F.interpolate(x, scale_factor=1.0 / scale, mode=mode,
                             recompute_scale_factor=False, **extra)
    return call if tuple(call().shape[-2:]) == tuple(out_hw) else None


def compare(report: dict, name: str, tag: str, kernel, plain, args,
            rule: str = "exact", work=None, library=None,
            timed: bool = True, graph: bool = True,
            graph_library: bool = True) -> None:
    """Run ``kernel`` and ``plain`` on the same inputs, hold them to
    ``rule`` ("exact", "close" = the repo's quantile rule, "allclose" =
    rtol=atol=1e-4), time both, and record the case under ``name``.
    ``ms`` is the call (CUDA events around back-to-back calls: the host's
    work shows where it is longer than the kernel's); with ``graph``,
    ``device_ms`` (and, with ``graph_library``, ``library_device_ms``)
    is the same call replayed from a CUDA graph, the kernel's own time
    (a library call that is itself a graph's replay is not captured
    again)."""
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        fail(f"{name} {tag}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    exact = torch.equal(out, ref)
    d = (out - ref).abs()
    err = d.max().item()
    if not exact:
        if rule == "close":
            q99 = torch.quantile(d.flatten()[::7].double(), 0.99).item()
            ok = q99 <= 2e-3 and err <= 0.05
        elif rule == "allclose":
            ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4)
        else:
            ok = False
        if not ok:
            fail(f"{name} {tag}: kernel disagrees with its plain version "
                 f"(max |d| {err}, rule {rule})")
    entry = report.setdefault(name, {"max_abs_err": 0.0, "bit_exact": True,
                                     "cases": []})
    entry["bit_exact"] &= exact
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    case = {"tag": tag, "bit_exact": exact, "max_abs_err": err,
            "in": "x".join(str(s) for s in args[0].shape)}
    if timed:
        case["ms"] = cuda_ms(lambda: kernel(*args))
        case["plain_ms"] = cuda_ms(lambda: plain(*args))
        if work is not None:
            case["bound_ms"], case["bound_by"] = bound(*work)
        case["library_ms"] = cuda_ms(library) if library else None
        if graph:
            case["device_ms"] = graph_ms(lambda: kernel(*args))
            if library and graph_library:
                case["library_device_ms"] = graph_ms(library)
    del out, ref, d
    entry["cases"].append(case)
    times = " ".join(f"{k}={case[k]:.4f}" for k in
                     ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                      "library_device_ms")
                     if case.get(k) is not None)
    print(f"kernel {name}[{len(entry['cases']) - 1}] {tag} in={case['in']} "
          f"bit_exact={exact} max_abs_err={err} {times}")


def taps_bytes(src, oh, ow, iy, ix, bilinear: bool) -> float:
    """Bytes a separable resample must move: the distinct source texels
    its taps read, once, and the output, once."""
    c, h, w = src.shape
    if bilinear:
        iy = np.concatenate([iy, np.minimum(iy + 1, h - 1)])
        ix = np.concatenate([ix, np.minimum(ix + 1, w - 1)])
    return 4.0 * c * (len(np.unique(iy)) * len(np.unique(ix)) + oh * ow)


def check_kernels(dev, cfg, report: dict) -> None:
    """Phase 2a: every per-iteration kernel against its plain version, at
    the 16 MP level-0 shape and at level 8."""
    from ug_stereomatcher_tpu_torch.ops.cuda import (
        blur, direction, resample, smooth, warp)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    chain = cfg.dims_chain(H, W)
    for tag, level in (("16mp", 0), ("coarse", COARSE_LEVEL)):
        h, w = chain[level]
        hw = h * w
        (h1, w1), (h2, w2) = chain[level + 1], chain[level + 2]
        left = rand(3, h, w, hi=255.0)
        warped = torch.clamp(left + rand(3, h, w, lo=-20.0, hi=20.0), 0, 255)
        bl2 = blur.fused_blur_gaussian_plain(left * left, "clamp")
        state = torch.stack([rand(h, w, lo=-2.0, hi=5.0),
                             rand(h, w, lo=-1.0, hi=1.0),
                             rand(h, w, lo=0.05, hi=1.0)])
        smooth_n = cfg.smooth_passes_for_level(level)
        up_src = rand(3, h1, w1, lo=-3.0, hi=3.0)
        # offsets run off every edge near the borders
        dh = rand(h, w, lo=-24.0, hi=30.0)
        dv = rand(h, w, lo=-12.0, hi=12.0)
        stacked = rand(6, h, w, hi=255.0)
        sq = left * left
        compare(report, "blur", tag, blur.fused_blur_gaussian,
                blur.fused_blur_gaussian_plain, (stacked, "zero"),
                work=(2 * 6 * hw * 4.0, 6 * hw * 2 * PASS5_OPS),
                library=conv2d_blur(stacked))
        compare(report, "blur", tag, blur.fused_blur_gaussian,
                blur.fused_blur_gaussian_plain, (sq, "clamp"),
                work=(2 * 3 * hw * 4.0, 3 * hw * 2 * PASS5_OPS))
        for method, name in (("nearest", "resample"),
                             ("bilinear", "resample_bilinear")):
            bil = method == "bilinear"
            for src, (oh, ow), s, vs in (
                    (stacked, (h1, w1), cfg.scale, 1.0),
                    (stacked, (h2, w2), 2.0, 1.0),
                    (up_src, (h, w), 1.0 / cfg.scale, cfg.scale)):
                def coord_of(t, s=s):
                    return t * s
                if bil:
                    (iy, wy), (ix, wx) = (
                        resample.bilinear_taps(oh, src.shape[1], coord_of),
                        resample.bilinear_taps(ow, src.shape[2], coord_of))
                    weights = (torch.from_numpy(wy).to(dev),
                               torch.from_numpy(wx).to(dev))
                else:
                    iy = resample.nearest_indices(oh, src.shape[1], coord_of)
                    ix = resample.nearest_indices(ow, src.shape[2], coord_of)
                    weights = ()
                args = (src, torch.from_numpy(iy).to(dev),
                        torch.from_numpy(ix).to(dev), vs, *weights)
                per_out = (12 if bil else 0) + (vs != 1.0)
                # the value-scaled upsample is two PyTorch calls, not one
                library = (interpolate_resample(src, s, (oh, ow), method)
                           if vs == 1.0 else None)
                compare(report, name, tag, resample.resample_static,
                        resample.resample_static_plain, args,
                        work=(taps_bytes(src, oh, ow, iy, ix, bil),
                              src.shape[0] * oh * ow * per_out),
                        library=library)
        sh, sv = smooth_field(dev, h, w)
        for method, name in (("nearest", "warp"),
                             ("bilinear", "warp_bilinear")):
            for sub, fh, fv in ((tag, dh, dv), (f"{tag}-smooth", sh, sv)):
                compare(report, name, sub, warp.warp, warp.warp_plain,
                        (left, fh, fv, method),
                        work=(8 * hw * 4.0, WARP_OPS[method] * hw),
                        library=grid_sample_warp(left, fh, fv, method))
        for thr, rep in ((1.0, False), (0.55, True)):
            compare(report, "direction", tag,
                    direction.fused_direction_update,
                    direction.fused_direction_update_plain,
                    (left, warped, bl2, state, thr, rep, cfg.conf_consts),
                    work=(15 * hw * 4.0, DIRECTION_OPS * hw))
        compare(report, "smooth", tag, smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, (state, smooth_n),
                work=(6 * hw * 4.0,
                      (SMOOTH_PASS_OPS * smooth_n + AVERAGE_OPS) * hw))
        if level == COARSE_LEVEL:
            # more passes than one launch runs: chunks through scratch
            compare(report, "smooth", f"{tag}-n{MANY_PASSES}",
                    smooth.fused_smooth_average,
                    smooth.fused_smooth_average_plain, (state, MANY_PASSES),
                    timed=False)
        check_row_halo(report, tag, left, warped, bl2, state, dh, dv,
                       smooth_n, cfg.conf_consts)
        check_guards(dev, report, tag, [
            (f"warp {m}", warp.warp, (left, sh, sv, m))
            for m in ("nearest", "bilinear")] + [
            ("direction", direction.fused_direction_update,
             (left, warped, bl2, state, 1.0, False, cfg.conf_consts)),
            ("smooth", smooth.fused_smooth_average, (state, smooth_n))])
        del left, warped, bl2, state, stacked, up_src, dh, dv, sq, sh, sv
        torch.cuda.empty_cache()
    check_convergence(dev, cfg, report)


def check_guards(dev, report: dict, tag: str, cases) -> None:
    """Phase 2a, early exit's guarded forms: with the level's flag set,
    each of warp, direction and smooth leaves its output as it was (filled
    with a NaN sentinel first); with the flag clear it is bit-equal to
    the unguarded launch."""
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    for name, fn, args in cases:
        ref = fn(*args)
        out = torch.full_like(ref, float("nan"))
        flag.fill_(1)
        fn(*args, stop=flag, out=out)
        torch.cuda.synchronize()
        untouched = bool(torch.isnan(out).all().item())
        flag.zero_()
        fn(*args, stop=flag, out=out)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        print(f"guard {name} {tag}: flag set leaves the output "
              f"{'untouched' if untouched else 'WRITTEN'}; flag clear "
              f"bit-equal to the unguarded launch: {same}")
        if not (untouched and same):
            fail(f"guard {name} {tag}: untouched {untouched}, equal {same}")
        report.setdefault("guards", []).append(
            {"name": name, "tag": tag, "untouched": untouched,
             "bit_equal": same})
        del ref, out


def check_convergence(dev, cfg, report: dict) -> None:
    """Phase 2a, the convergence kernel at levels 0 and 5 of 16 MP: (dh,
    dv) within 1e-5 relative of the plain version (float32 torch.sum)
    and 2e-6 of a float64 sum, the same bits on a second run, the flag
    set or left as the plain version sets it (a threshold under and over
    the change), nothing written once it is set; timed in the trace's
    form (the same work, no flag): call ms, device ms (a CUDA graph), the
    plain version and the bound (five planes read once)."""
    from ug_stereomatcher_tpu_torch.ops.cuda import convergence as conv

    gen = torch.Generator(device=dev).manual_seed(SEED)
    entry = report.setdefault("convergence", {"max_abs_err": 0.0,
                                              "bit_exact": False,
                                              "cases": []})
    for level in CONVERGENCE_LEVELS:
        h, w = cfg.dims_chain(H, W)[level]
        new = torch.rand(3, h, w, generator=gen, device=dev)
        new[:2] = new[:2] * 6.0 - 3.0
        old = new + (torch.rand(3, h, w, generator=gen, device=dev) - 0.5)
        c = new[2].double()
        gold = [((new[k] - old[k]).abs() * new[2]).double().sum().item()
                / c.sum().item() for k in (0, 1)]

        def run(step, thr):
            buf = conv.level_buffer(2, dev)
            step(new, old, 1, buf, thr)
            return buf

        got, again = run(conv.convergence_step, None), run(
            conv.convergence_step, None)
        ref = run(conv.convergence_step_plain, None)
        torch.cuda.synchronize()
        d, dref = conv.deltas(got)[1].tolist(), conv.deltas(ref)[1].tolist()
        rel_plain = max(abs(a / b - 1) for a, b in zip(d, dref))
        rel_gold = max(abs(a / b - 1) for a, b in zip(d, gold))
        err = max(abs(a - b) for a, b in zip(d, dref))
        repeat = torch.equal(got, again)
        flags = []
        for thr in (0.9 * max(gold), 1.1 * max(gold)):
            k, p = run(conv.convergence_step, thr), run(
                conv.convergence_step_plain, thr)
            flags.append((k[:2].tolist(), p[:2].tolist()))
        before = k.clone()
        conv.convergence_step(old, new, 0, k, 0.0)   # the flag is set
        torch.cuda.synchronize()
        idle = torch.equal(k, before)
        tag = f"level{level}"
        print(f"kernel convergence {tag} {h}x{w} (dh, dv) kernel {d} plain "
              f"{dref} float64 {gold}: rel to plain {rel_plain:.3e}, to "
              f"float64 {rel_gold:.3e}, repeats bit for bit {repeat}; "
              f"(stop, last) kernel/plain under and over the change "
              f"{flags}; after the exit it writes nothing: {idle}")
        if not (rel_plain <= 1e-5 and rel_gold <= 2e-6 and repeat and idle
                and all(a == b for a, b in flags)
                and [f[0] for f in flags] == [[0, 1], [1, 1]]):
            fail(f"convergence {tag}: disagrees with its plain version or "
                 f"float64 (rel {rel_plain}, {rel_gold}), repeat {repeat}, "
                 f"flags {flags}, after the exit {idle}")
        buf = conv.level_buffer(2, dev)
        case = {"tag": tag, "in": f"3x{h}x{w}", "bit_exact": False,
                "max_abs_err": err, "rel_to_plain": rel_plain,
                "rel_to_float64": rel_gold,
                "ms": cuda_ms(lambda: conv.convergence_step(new, old, 0,
                                                            buf)),
                "device_ms": graph_ms(lambda: conv.convergence_step(
                    new, old, 0, buf)),
                "plain_ms": cuda_ms(lambda: conv.convergence_step_plain(
                    new, old, 0, buf)), "library_ms": None}
        case["bound_ms"], case["bound_by"] = bound(
            CONVERGENCE_BYTES * h * w, CONVERGENCE_OPS * h * w)
        entry["cases"].append(case)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"kernel convergence[{len(entry['cases']) - 1}] {tag} "
              f"in={case['in']} max_abs_err={err} " + " ".join(
                  f"{k}={case[k]:.4f}" for k in (
                      "ms", "device_ms", "plain_ms", "bound_ms")))
        del new, old, c, got, again, ref, k, p, before, buf
        torch.cuda.empty_cache()


def band(x, lo: int, hi: int):
    """Rows [lo, hi) of x (..., H, W), clamped to the image: the haloed
    shard a row-sharded form takes."""
    idx = torch.arange(lo, hi, device=x.device).clamp(0, x.shape[-2] - 1)
    return x.index_select(-2, idx).contiguous()


def check_row_halo(report: dict, tag: str, left, warped, bl2, state, dh, dv,
                   smooth_n: int, consts) -> None:
    """Phase 2a, row-sharded forms: warp (on the random field dh, dv and
    on the smooth one), direction and smooth on the middle shard of four
    (timed; 816 rows at 16 MP) and the bottom shard (checked only), each
    against its plain version."""
    from ug_stereomatcher_tpu_torch.ops.cuda import direction, smooth, warp
    from ug_stereomatcher_tpu_torch.parallel import row_splits

    h, w = left.shape[-2:]
    splits = row_splits(h, 4)
    for shard, timed in ((1, True), (3, False)):
        a, b = splits[shard]
        hl, px = b - a, (b - a) * w
        sub = f"{tag}-shard{shard}"
        fields = ((sub, dh[a:b].contiguous(), dv[a:b].contiguous()),
                  (f"{sub}-smooth", *smooth_field(left.device, hl, w, a, h)))
        for method, name in (("nearest", "warp_row_halo"),
                             ("bilinear", "warp_bilinear_row_halo")):
            for fsub, dh_s, dv_s in fields:
                compare(report, name, fsub, warp.warp, warp.warp_plain,
                        (left, dh_s, dv_s, method, a),
                        work=(8 * px * 4.0, WARP_OPS[method] * px),
                        library=grid_sample_warp(left, dh_s, dv_s, method,
                                                 a),
                        timed=timed)
        d = direction.HALO
        compare(report, "direction_row_halo", sub,
                direction.fused_direction_update,
                direction.fused_direction_update_plain,
                (band(left, a - d, b + d), band(warped, a - d, b + d),
                 bl2[:, a:b].contiguous(), state[:, a:b].contiguous(), 1.0,
                 False, consts, a, h),
                work=((6 * (hl + 2 * d) + 9 * hl) * w * 4.0,
                      DIRECTION_OPS * px), timed=timed)
        s = smooth.smooth_halo_rows(smooth_n)
        compare(report, "smooth_row_halo", sub, smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain,
                (band(state, a - s, b + s), smooth_n, a, h),
                work=((3 * (hl + 2 * s) + 3 * hl) * w * 4.0,
                      (SMOOTH_PASS_OPS * smooth_n + AVERAGE_OPS) * px),
                timed=timed)
        if tag == "coarse":
            s = smooth.smooth_halo_rows(MANY_PASSES)
            compare(report, "smooth_row_halo", f"{sub}-n{MANY_PASSES}",
                    smooth.fused_smooth_average,
                    smooth.fused_smooth_average_plain,
                    (band(state, a - s, b + s), MANY_PASSES, a, h),
                    timed=False)


def level_inputs(dev, h: int, w: int):
    """A textured pair at a level's shape with the scene's 3 px shift,
    and a noisy start state."""
    from ug_stereomatcher_tpu_torch import scene

    left_np, right_np = scene.make_pair(h, w, seed=SEED)
    left, right = (torch.from_numpy(np.moveaxis(a, -1, 0).astype(
        np.float32)).to(dev).contiguous() for a in (left_np, right_np))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = torch.rand(3, h, w, generator=gen, device=dev)
    state = torch.stack([1.0 + 3.0 * noise[0], noise[1] - 0.5,
                         0.2 + 0.8 * noise[2]])
    return left, right, state


def check_level(dev, cfg, report: dict) -> None:
    """Phase 2b: the level-resident kernel against its plain version (the
    per-iteration loop) at levels 8 and 13, both methods, replace_first on
    and off; the CUDA graph of the per-iteration kernels as the one-call
    yardstick."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch.ops.cuda import level

    chain = cfg.dims_chain(H, W)
    print(f"level kernel: at most {level.max_coresident_blocks('nearest')} "
          f"co-resident blocks of 512 threads (n_smooth = 5); n_smooth at "
          f"most {level.max_smooth_passes('nearest')}")
    for lv in (COARSE_LEVEL, SMALL_LEVEL):
        h, w = chain[lv]
        left, right, state = level_inputs(dev, h, w)
        mi = cfg.iters_for_level(lv)
        n = cfg.smooth_passes_for_level(lv)
        thr = cfg.threshold_schedule(mi)
        for method in ("nearest", "bilinear"):
            per_px = (WARP_OPS[method] + DIRECTION_OPS
                      + SMOOTH_PASS_OPS * n + AVERAGE_OPS)
            for rep in (False, True):
                timed = not rep
                library = None
                if timed and method == "nearest" and lv == COARSE_LEVEL:
                    library = graph_replay(lambda: match_mod.match_level(
                        left, right, state, lv, cfg, rep,
                        resident_max_pixels=0))
                compare(report, "level", f"level{lv}-{method}-replace{rep}",
                        level.level_resident_match,
                        level.level_resident_match_plain,
                        (left, right, state, thr, n, rep, cfg.conf_consts,
                         method),
                        rule="close" if method == "nearest" else "allclose",
                        work=(12 * h * w * 4.0, mi * per_px * h * w),
                        library=library, timed=timed, graph_library=False)
                if timed:
                    count_barriers(report["level"]["cases"][-1], level,
                                   (left, right, state, thr, n, rep,
                                    cfg.conf_consts, method), mi)
        del left, right, state
    torch.cuda.empty_cache()


def check_fovea_kernels(dev, cfg, report: dict) -> None:
    """Phase 2c, mode 2's kernel cases at 16 MP: the level kernel at the
    fovea size (407 x 615) with the schedules of levels 0 and 1 (10
    smoothing passes, 2 and 4 iterations, replace_first off), both
    methods, as ``level_fovea``; the windowed resample of a fovea
    transition (407 x 615 onto the centred fovea window of the 576 x 870
    grid of level 5, values x SCALE), both methods, as
    ``resample_fovea_window`` / ``resample_bilinear_fovea_window``."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch.ops.cuda import level, resample

    chain = cfg.dims_chain(H, W)
    fh, fw = cfg.fovea_dims(H, W)
    left, right, state = level_inputs(dev, fh, fw)
    for lv in (0, 1):
        mi = cfg.iters_for_level(lv)
        n = cfg.smooth_passes_for_level(lv)
        for method in ("nearest", "bilinear"):
            per_px = (WARP_OPS[method] + DIRECTION_OPS
                      + SMOOTH_PASS_OPS * n + AVERAGE_OPS)
            args = (left, right, state, cfg.threshold_schedule(mi), n, False,
                    cfg.conf_consts, method)
            library = None
            if method == "nearest":
                library = graph_replay(lambda lv=lv: match_mod.match_level(
                    left, right, state, lv, cfg, False,
                    resident_max_pixels=0))
            compare(report, "level_fovea", f"fovea-{mi}it-n{n}-{method}",
                    level.level_resident_match,
                    level.level_resident_match_plain, args,
                    rule="close" if method == "nearest" else "allclose",
                    work=(12 * fh * fw * 4.0, mi * per_px * fh * fw),
                    library=library, graph_library=False)
            count_barriers(report["level_fovea"]["cases"][-1], level, args,
                           mi)
    del left, right, state
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src = -3.0 + 6.0 * torch.rand(3, fh, fw, generator=gen, device=dev)
    bh, bw = chain[cfg.fovea_level - 2]
    r0, c0 = bh // 2 - fh // 2, bw // 2 - fw // 2

    def coord_of(t):
        return t * (1.0 / cfg.scale)
    for method, name in (("nearest", "resample_fovea_window"),
                         ("bilinear", "resample_bilinear_fovea_window")):
        bil = method == "bilinear"
        if bil:
            (iy, wy), (ix, wx) = (
                resample.bilinear_taps(fh, fh, coord_of, r0),
                resample.bilinear_taps(fw, fw, coord_of, c0))
            weights = (torch.from_numpy(wy).to(dev),
                       torch.from_numpy(wx).to(dev))
        else:
            iy = resample.nearest_indices(fh, fh, coord_of, r0)
            ix = resample.nearest_indices(fw, fw, coord_of, c0)
            weights = ()
        compare(report, name, f"{fh}x{fw}-window-of-{bh}x{bw}",
                resample.resample_static, resample.resample_static_plain,
                (src, torch.from_numpy(iy).to(dev),
                 torch.from_numpy(ix).to(dev), cfg.scale, *weights),
                work=(taps_bytes(src, fh, fw, iy, ix, bil),
                      3 * fh * fw * ((12 if bil else 0) + 1)))
        # the wrapper's own window (host taps with the offsets) is the
        # same launch
        win = resample.resample_tex(src, fh, fw, coord_of, cfg.scale, method,
                                    row_off=r0, col_off=c0)
        whole = resample.resample_tex(src, bh, bw, coord_of, cfg.scale,
                                      method)
        if not torch.equal(win, whole[:, r0:r0 + fh, c0:c0 + fw]):
            fail(f"{name}: the window differs from the crop of the whole "
                 f"resample")
    del src
    torch.cuda.empty_cache()


def count_barriers(case: dict, level, args, mi: int) -> None:
    """The grid barriers one launch of the level kernel passed and its
    block 0's clock per phase, counted on the card, printed beside the
    kernel's time (each phase's share of block 0's cycles times the median
    time, per iteration); more than 3 barriers per iteration fails."""
    prof = level.profile_level(*args)
    n, cycles = prof["grid_barriers"], prof["cycles"]
    total = sum(cycles.values())
    us = {k: case["ms"] * 1e3 * c / total / mi for k, c in cycles.items()}
    case.update(grid_barriers=n, barriers_per_iteration=n / mi,
                phase_cycles=cycles, phase_us_per_iteration=us)
    print(f"level {case['tag']} grid_barriers={n} over {mi} iterations "
          f"({n / mi:.2f} per iteration) ms={case['ms']:.4f}")
    print(f"level {case['tag']} us per iteration by phase (block 0): "
          + " ".join(f"{k}={v:.2f}" for k, v in us.items()))
    if n > 3 * mi:
        fail(f"level {case['tag']}: {n} grid barriers over {mi} iterations")


def graph_replay(fn):
    """Capture ``fn`` (a sequence of kernel launches) in a CUDA graph and
    return its replay as one call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def first_call(dev, label: str, call, want: dict):
    """Launch counts and first-call latency of ``call()``: the counts are
    set to 0 just before it and read just after, and must equal the
    config's ``want``.  Returns the result, the seconds, the counts and
    the peak device memory."""
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label} launches {json.dumps(counts, sort_keys=True)} expected "
          f"{json.dumps(want, sort_keys=True)}")
    if counts != want:
        fail(f"{label}: launch counts {counts} differ from the config's "
             f"{want}")
    return out, first_s, counts, peak


def check_planes(label: str, trip, shape) -> None:
    for name, plane in zip(("disparity_h", "disparity_v", "confidence"),
                           trip):
        if tuple(plane.shape) != tuple(shape):
            fail(f"{label}: {name} has shape {tuple(plane.shape)}")
        if not torch.isfinite(plane).all().item():
            fail(f"{label}: {name} has non-finite values")


def value_gates(label: str, trip, margin: int, gate=None,
                shift=None) -> dict:
    """med|dh-s|, frac(|dh-s| < 1) and mean|dv| inside ``margin``, s the
    scene's shift (``shift``: at a coarser level's scale); with a
    ``gate``, fail unless med|dh-s| < gate, mean|dv| < gate and frac >
    0.9 (the JAX package's on-chip check)."""
    from ug_stereomatcher_tpu_torch import scene

    dh, dv, conf = trip
    m = slice(margin, -margin)
    shift = scene.SHIFT_PX if shift is None else shift
    errh = (dh[m, m] - shift).abs()
    vals = {"med_abs_dh_err": errh.median().item(),
            "frac_dh_err_lt_1": (errh < 1.0).float().mean().item(),
            "mean_abs_dv": dv[m, m].abs().mean().item()}
    print(f"{label} values med|dh-{shift:.3f}|="
          f"{vals['med_abs_dh_err']:.4f} "
          f"frac(|dh-{shift:.3f}|<1)={vals['frac_dh_err_lt_1']:.4f} "
          f"mean|dv|={vals['mean_abs_dv']:.4f} "
          f"mean conf={conf.mean().item():.4f}"
          + ("" if gate is None else f" (gated at {gate})"))
    if gate is not None and not (vals["med_abs_dh_err"] < gate
                                 and vals["mean_abs_dv"] < gate
                                 and vals["frac_dh_err_lt_1"] > 0.9):
        fail(f"{label}: value gates (med|dh-3| < {gate}, mean|dv| < {gate}, "
             f"frac(|dh-3| < 1) > 0.9)")
    return vals


def warm_summary(label: str, call, first_s: float, counts: dict,
                 peak: int) -> dict:
    """Warm latency (host clock around a synchronised call, median of 5)
    and the profile of one more call."""
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    median = statistics.median(warm)
    print(f"{label} first_call_s={first_s:.4f} warm_median_s={median:.4f} "
          f"warm_s={[round(x, 4) for x in warm]} peak_mem_bytes={peak}")
    return {"first_call_s": first_s, "warm_s": warm, "warm_median_s": median,
            "peak_mem_bytes": peak, "launches": counts,
            "profile": profile_match(call, median, label)}


def run_slice(dev, cfg, left, right, label: str, gate: float,
              resident_max_pixels=None, mesh=None):
    """Phase 3: one 16 MP match configuration through the kernels: value
    gates (med|dh-3| < gate, mean|dv| < gate, frac(|dh-3| < 1) > 0.9),
    launch counts, latency, peak memory and the profile.  With a mesh the
    pair goes through StereoEngine.match_batch on it.  Returns the
    summary and the level-0 triplet."""
    from ug_stereomatcher_tpu_torch import StereoEngine

    eng = StereoEngine(cfg, device=dev,
                       resident_max_pixels=resident_max_pixels)
    if mesh is None:
        def call():
            return eng.match(left, right).triplet
        want = expected_launches(cfg, H, W, resident_max_pixels)
    else:
        def call():
            return eng.match_batch(left[None], right[None],
                                   mesh=mesh).triplet[:, 0]
        want = expected_mesh_launches(cfg, H, W, mesh.row_devices(0))
    trip, first_s, counts, peak = first_call(dev, label, call, want)
    check_planes(label, trip, (H, W))
    vals = value_gates(label, trip, 64, gate)
    return {**warm_summary(label, call, first_s, counts, peak), **vals}, trip


def run_fovea_slice(dev, cfg, left, right, label: str, gate: float,
                    resident_max_pixels=None, mesh=None,
                    hierarchical: bool = False):
    """Phase 3, mode 2: StereoEngine.match_foveated of the 16 MP pair
    (match_batch(foveated=True) on ``mesh``; match_hierarchical with
    ``hierarchical``): launch counts, latency, peak memory and the
    profile as in run_slice; the value gates on stack level 0, the
    full-resolution fovea window, inside 32 px, and the coarser stack
    levels' values printed without a gate.  Returns the summary and the
    (3, fovea_level * fh, fw) stack, or the (3, H, W) hierarchical map
    with its centred fovea window as stack level 0."""
    from ug_stereomatcher_tpu_torch import StereoEngine, scene

    eng = StereoEngine(cfg, device=dev,
                       resident_max_pixels=resident_max_pixels)
    fh, fw = cfg.fovea_dims(H, W)
    k = cfg.fovea_level
    if hierarchical:
        def call():
            return eng.match_hierarchical(left, right).triplet
        want = expected_launches(cfg, H, W, resident_max_pixels,
                                 hierarchical=True)
    elif mesh is None:
        def call():
            res = eng.match_foveated(left, right)
            return torch.stack([res.stack_h, res.stack_v, res.stack_c])
        want = expected_launches(cfg, H, W, resident_max_pixels,
                                 foveated=True)
    else:
        def call():
            res = eng.match_batch(left[None], right[None], mesh=mesh,
                                  foveated=True)
            return torch.stack([res.stack_h[0], res.stack_v[0],
                                res.stack_c[0]])
        want = expected_mesh_launches(cfg, H, W, mesh.row_devices(0),
                                      foveated=True)
    out, first_s, counts, peak = first_call(dev, label, call, want)
    if hierarchical:
        check_planes(label, out, (H, W))
        full = value_gates(f"{label} full map", out, 64)
        top, lft = H // 2 - fh // 2, W // 2 - fw // 2
        levels = [out[:, top:top + fh, lft:lft + fw]]
    else:
        check_planes(label, out, (k * fh, fw))
        full = {}
        levels = [out[:, i * fh:(i + 1) * fh] for i in range(k)]
    vals = value_gates(f"{label} level 0", levels[0], 32, gate)
    # stack level i holds the shift at its level's scale
    coarse = [value_gates(f"{label} level {i}", lv, 32,
                          shift=scene.SHIFT_PX / cfg.scale ** i)
              for i, lv in enumerate(levels[1:], 1)]
    return {**warm_summary(label, call, first_s, counts, peak), **vals,
            "full_map": full, "coarser_levels": coarse}, out


def profile_match(call, warm_s: float, label: str) -> dict:
    """Kernel time by name over one warm ``call()`` (torch.profiler), and
    the device's busy share of the unprofiled warm latency ``warm_s``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): a host op such as
        # aten::mul also reports its kernel's time, which would count twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    print(f"{label} profile device_busy_ms={busy_ms:.3f} warm_latency_ms="
          f"{warm_s * 1e3:.3f} busy_share={busy_ms / (warm_s * 1e3):.3f}")
    for r in rows[:12]:
        print(f"{label} profile {r['device_ms']:10.3f} ms {r['calls']:6d}x "
              f"{r['name']}")
    for r in rows:  # the smoothing kernels, wherever they rank
        if "smooth" in r["name"]:
            print(f"{label} profile smoothing {r['device_ms']:.3f} ms "
                  f"{r['calls']}x {r['name']}")
    return {"device_busy_ms": busy_ms, "warm_latency_s": warm_s,
            "busy_share": busy_ms / (warm_s * 1e3), "kernels": rows}


def check_same(label: str, out, ref) -> None:
    """The sharded result must equal the unsharded one bit for bit."""
    same = torch.equal(out, ref)
    err = (out - ref).abs().max().item()
    print(f"{label} equals the unsharded slice: {same} (max |d| {err})")
    if not same:
        fail(f"{label}: differs from the unsharded slice (max |d| {err})")


def pair_batch(dev, cfg, report: dict) -> None:
    """Phase 3c: two pairs (816 x 1232, seeds 0 and 1) through
    StereoEngine.match_batch on a (2 pairs x 2 rows) mesh of this card,
    each equal to StereoEngine.match of its pair bit for bit."""
    from ug_stereomatcher_tpu_torch import StereoEngine, scene
    from ug_stereomatcher_tpu_torch.parallel import make_mesh

    h, w = 816, 1232
    pairs = [scene.make_pair(h, w, seed=s) for s in (0, 1)]
    left = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    right = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    eng = StereoEngine(cfg, device=dev)
    mesh = make_mesh(2, 2, devices=[dev] * 4)
    res = eng.match_batch(left, right, mesh=mesh)
    torch.cuda.synchronize()
    same = []
    for i in range(2):
        ref = eng.match(left[i], right[i]).triplet
        same.append(torch.equal(res.triplet[:, i], ref))
    t0 = time.perf_counter()
    eng.match_batch(left, right, mesh=mesh)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    print(f"pair_batch 2x{h}x{w} on a 2x2 mesh of one card: equal to match "
          f"per pair {same}, warm {batch_s:.4f} s")
    if not all(same):
        fail("pair_batch: match_batch on the 2x2 mesh differs from match")
    report["pair_batch"] = {"shape": [h, w], "equal": same,
                            "warm_s": batch_s}


def across_cards(dev, cfg, left, right, ref, report: dict) -> None:
    """With more than one card: the pair on meshes over the cards, each
    pair against the unsharded slice bit for bit, with its route and the
    graph replays a call: the 1 x N rows mesh (one graph across the N
    cards), the 1 x 2 rows mesh over two of them and the 2 x 2 hybrid
    over four (one graph a rows-group), and the N x 1 mesh, N copies of
    the pair (a graph a card).  Each is timed warm (median of 5, every
    card synchronised) against the eager matcher on the same mesh
    (``capture=False``, its result bit-equal too) in turns (eager, graph,
    graph, eager), with its capture seconds, the memory its graphs hold
    on each card (reserved after the calls over reserved before, the
    cache emptied) and each card's busy ms over one graph call.  With
    one card it prints that it did not run."""
    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch.parallel import (
        make_batch_matcher, make_mesh)

    n = torch.cuda.device_count()
    row = report["across_cards"] = {"cards": n}
    if n < 2:
        print(f"across_cards: did not run: {n} CUDA card (a mesh over "
              f"cards needs two or more)")
        row["ran"] = False
        return
    cards = [torch.device("cuda", k) for k in range(n)]
    meshes = [("rows", make_mesh(1, n), 1, 1)]
    if n > 2:
        meshes.append(("rows_1x2", make_mesh(1, 2, devices=cards[:2]), 1, 1))
    if n >= 4:
        meshes.append(("hybrid", make_mesh(2, 2, devices=cards[:4]), 2, 2))
    meshes.append(("pairs", make_mesh(n, 1), n, n))
    for label, mesh, b, replays_wanted in meshes:
        lb, rb = (x.expand((b,) + tuple(x.shape)) for x in (left, right))
        eng = StereoEngine(cfg, device=dev)
        eager = make_batch_matcher(cfg, mesh, capture=False)
        lt, rt = (x.movedim(-1, 1).float().contiguous() for x in (lb, rb))

        def graph():
            out = eng.match_batch(lb, rb, mesh=mesh).triplet
            synchronize_all()
            return out

        def eager_call():
            out = eager(lt, rt)
            synchronize_all()
            return out

        torch.cuda.empty_cache()
        base = [torch.cuda.memory_reserved(c) for c in cards]
        out, got, _, syncs, replays = counted_call(graph)
        route = eng.metrics["match_batch_route"]
        for i in range(b):
            check_same(f"across_cards {label} {mesh.shape} pair {i}",
                       out[:, i], ref)
        del out
        eout, want, _, _, _ = counted_call(eager_call)
        for i in range(b):
            check_same(f"across_cards {label} eager pair {i}", eout[i], ref)
        del eout
        calls = held_calls(eng)
        capture_s = sum(c.capture_s for c in calls)
        _, _, _, _, replays = counted_call(graph)
        e1, e1s = warm_ms(eager_call)
        g1, g1s = warm_ms(graph)
        g2, g2s = warm_ms(graph)
        e2, e2s = warm_ms(eager_call)
        graph_med = statistics.median(g1s + g2s)
        eager_med = statistics.median(e1s + e2s)
        busy = card_busy_ms(graph, n)
        torch.cuda.empty_cache()
        held = [torch.cuda.memory_reserved(c) - b0
                for c, b0 in zip(cards, base)]
        del eng, calls
        torch.cuda.empty_cache()
        print(f"across_cards {label} {mesh.shape} route={route} "
              f"replays_per_call={replays} launches equal to eager: "
              f"{got == want}, {syncs} host reads; warm graph="
              f"{graph_med:.3f} ms eager={eager_med:.3f} ms runs graph "
              f"{g1s + g2s} eager {e1s + e2s}; capture_s={capture_s:.4f} "
              f"graph_held_bytes per card={held}; graph busy ms per card="
              f"{[round(x, 3) for x in busy]}")
        if route != "graph" or replays != replays_wanted:
            fail(f"across_cards {label}: route {route}, {replays} replays "
                 f"({replays_wanted} wanted)")
        if got != want or syncs:
            fail(f"across_cards {label}: launches {got} against eager "
                 f"{want}, {syncs} host reads")
        row[label] = {"mesh": list(mesh.shape.values()), "route": route,
                      "replays_per_call": replays, "launches": got,
                      "graph_warm_ms": graph_med, "eager_warm_ms": eager_med,
                      "graph_warm_runs_ms": g1s + g2s,
                      "eager_warm_runs_ms": e1s + e2s,
                      "capture_s": capture_s, "graph_held_bytes": held,
                      "graph_busy_ms_per_card": busy}
    torch.cuda.empty_cache()


def card_busy_ms(call, n: int) -> list:
    """Each of the n cards' device-busy ms over one ``call()``: the kernel
    and copy events of torch.profiler summed by the card they ran on."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    synchronize_all()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        call()
        synchronize_all()
    busy = [0.0] * n
    for ev in prof.events():
        if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                and 0 <= ev.device_index < n):
            busy[ev.device_index] += ev.self_device_time_total / 1e3
    return busy


def level_table(dev, cfg, left, right, report: dict) -> None:
    """Phase 3b: each level 4-13 of the nearest 16 MP match, from the
    state the next coarser level hands it, timed level-resident against
    per iteration (CUDA events; both routes return the same bits)."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr

    lp, rp = pyr.build_pyramid_pair(
        left.movedim(-1, 0).float().contiguous(),
        right.movedim(-1, 0).float().contiguous(), cfg,
        cfg.num_levels(H, W))
    n = len(lp)
    dims = cfg.dims_chain(H, W)
    state = torch.zeros((3,) + tuple(dims[n - 1]), device=dev)
    rows = []
    for i in range(n - 1, min(TABLE_LEVELS) - 1, -1):
        def run(gate, i=i, state=state):
            return match_mod.match_level(lp[i], rp[i], state, i, cfg,
                                         i == n - 1, resident_max_pixels=gate)
        resident, per_iter = run(1 << 62), run(0)
        torch.cuda.synchronize()
        same = torch.equal(resident, per_iter)
        r_ms = cuda_ms(lambda: run(1 << 62), 5, 1)
        p_ms = cuda_ms(lambda: run(0), 5, 1)
        h, w = dims[i]
        row = {"level": i, "shape": [h, w], "pixels": h * w,
               "iters": cfg.iters_for_level(i), "resident_ms": r_ms,
               "per_iteration_ms": p_ms, "bit_exact": same,
               "gated": match_mod.uses_level_resident(h, w)}
        rows.append(row)
        print(f"level_table level={i} {h}x{w} px={h * w} "
              f"iters={row['iters']} resident_ms={r_ms:.3f} "
              f"per_iteration_ms={p_ms:.3f} bit_exact={same} "
              f"gated={row['gated']}")
        if not same:
            fail(f"level {i}: the two routes differ")
        state = pyr.upsample_to_level(resident, *dims[i - 1], cfg)
    report["level_table"] = rows


def lockstep_level(dev, cfg, left, right, report: dict) -> None:
    """Phase 4: one level refined by the kernels and by the plain versions
    on the card, from the same input state."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr
    from ug_stereomatcher_tpu_torch.ops.cuda import (
        blur, direction, smooth, warp)

    lv = LOCKSTEP_LEVEL
    lp, rp = pyr.build_pyramid_pair(
        left.movedim(-1, 0).float().contiguous(),
        right.movedim(-1, 0).float().contiguous(), cfg, lv + 2)
    h, w = lp[lv].shape[-2:]
    coarse = torch.zeros((3,) + tuple(lp[lv + 1].shape[-2:]), device=dev)
    coarse = match_mod.match_level(lp[lv + 1], rp[lv + 1], coarse, lv + 1,
                                   cfg, True)
    state0 = pyr.upsample_to_level(coarse, h, w, cfg)

    def plain_level():
        bl2 = blur.fused_blur_gaussian_plain(lp[lv] * lp[lv], "clamp")
        s = state0
        mi = cfg.iters_for_level(lv)
        for m, thr in enumerate(cfg.threshold_schedule(mi)):
            wp = warp.warp_nearest_plain(rp[lv], s[0], s[1])
            s = direction.fused_direction_update_plain(
                lp[lv], wp, bl2, s, thr, False, cfg.conf_consts)
            s = smooth.fused_smooth_average_plain(
                s, cfg.smooth_passes_for_level(lv))
        return s

    def kernel_level():
        return match_mod.match_level(lp[lv], rp[lv], state0, lv, cfg, False)

    out, ref = kernel_level(), plain_level()
    torch.cuda.synchronize()
    d = (out - ref).abs().flatten()
    q99 = torch.quantile(d[::7].double(), 0.99).item()
    dmax = d.max().item()
    kms, pms = cuda_ms(kernel_level, 3, 1), cuda_ms(plain_level, 3, 1)
    print(f"lockstep level {lv} ({h}x{w}) q99={q99} max={dmax} "
          f"bit_exact={torch.equal(out, ref)} kernel_ms={kms:.3f} "
          f"plain_ms={pms:.3f}")
    if not (q99 <= 2e-3 and dmax <= 0.05):
        fail(f"level {lv} lockstep: q99 {q99} max {dmax}")
    report["lockstep"] = {"level": lv, "shape": [h, w], "q99": q99,
                          "max": dmax, "kernel_ms": kms, "plain_ms": pms}


def mode2_slices(dev, cfg, bil, left, right, slices: dict) -> None:
    """Phase 3, mode 2 on the 16 MP pair: foveated (nearest, default
    gate), foveated_per_iteration (resident_max_pixels=0), foveated_bilinear,
    hierarchical and sharded_foveated (match_batch(foveated=True) on a
    1 x 4 mesh of this card); then the structural checks: the
    per-iteration route within the quantile rule of the default one, the
    sharded stack and the hierarchical map's centred fovea window equal to
    the foveated stack (level 0) bit for bit."""
    from ug_stereomatcher_tpu_torch.parallel import make_mesh

    fh, fw = cfg.fovea_dims(H, W)
    slices["foveated"], fov = run_fovea_slice(dev, cfg, left, right,
                                              "foveated", 0.5)
    slices["foveated_per_iteration"], per_iter = run_fovea_slice(
        dev, cfg, left, right, "foveated_per_iteration", 0.5,
        resident_max_pixels=0)
    d = (per_iter - fov).abs().flatten()
    q99 = torch.quantile(d[::7].double(), 0.99).item()
    dmax = d.max().item()
    same = torch.equal(per_iter, fov)
    print(f"foveated routes: per iteration against level-resident "
          f"bit_exact={same} q99={q99} max={dmax}")
    if not (q99 <= 2e-3 and dmax <= 0.05):
        fail(f"foveated routes disagree: q99 {q99} max {dmax}")
    slices["foveated_per_iteration"]["against_resident"] = {
        "bit_exact": same, "q99": q99, "max": dmax}
    del per_iter, d
    slices["foveated_bilinear"], _ = run_fovea_slice(
        dev, bil, left, right, "foveated_bilinear", 0.1)
    slices["hierarchical"], hier = run_fovea_slice(
        dev, cfg, left, right, "hierarchical", 0.5, hierarchical=True)
    top, lft = H // 2 - fh // 2, W // 2 - fw // 2
    window = hier[:, top:top + fh, lft:lft + fw]
    if not torch.equal(window, fov[:, :fh]):
        fail("hierarchical: the centred fovea window differs from stack "
             f"level 0 (max |d| {(window - fov[:, :fh]).abs().max().item()})")
    print("hierarchical: the centred fovea window equals stack level 0")
    del hier, window
    torch.cuda.empty_cache()
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    slices["sharded_foveated"], sharded = run_fovea_slice(
        dev, cfg, left, right, "sharded_foveated", 0.5, mesh=mesh)
    check_same("sharded_foveated", sharded, fov)
    print("mode 2 warm_median_s " + " ".join(
        f"{k}={slices[k]['warm_median_s']:.4f}" for k in (
            "foveated", "foveated_per_iteration", "foveated_bilinear",
            "hierarchical", "sharded_foveated")))
    torch.cuda.empty_cache()


def early_exit_slice(dev, cfg, left, right, label: str, gate: float,
                     ref_summary: dict) -> dict:
    """Phase 3d, (k) and (l): StereoEngine.match with early exit, decided
    on the card.  The counts are set to 0 just before the match and read
    just after: the whole schedule is launched, warp, direction and smooth
    as in the fixed schedule (the level kernel at 8), and one convergence
    test per iteration of the levels that may exit (42); no host read;
    ``iterations_run()`` gives the iterations that did work.  Then each
    per-iteration level driven alone from the same pyramid and state, on
    the device loop and on the host-read loop (``exit_loop="host"``) on
    the card: the same iterations and the same bits, where no change of an
    iteration that ran lies within 1e-5 (relative) of the threshold (the
    level's convergence trace; asserted, since the two loops add in
    another order); the chain of levels equals the match.  Value gates,
    latency and busy share beside the fixed schedule's slice
    ``ref_summary``."""
    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    eng = StereoEngine(cfg, device=dev)

    def call():
        return eng.match(left, right).triplet

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    match_mod.reset_host_syncs()
    t0 = time.perf_counter()
    trip = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts, syncs = _build.launch_counts(), match_mod.host_syncs()
    iters = match_mod.iterations_run()
    peak = torch.cuda.max_memory_allocated(dev)
    n = cfg.num_levels(H, W)
    dims = cfg.dims_chain(H, W)
    exit_levels = [i for i in range(n) if cfg.iters_for_level(i) > 1
                   and not match_mod.uses_level_resident(
                       *dims[i], None, cfg.smooth_passes_for_level(i),
                       cfg.iters_for_level(i), cfg.interp, dev)]
    want = expected_launches(cfg, H, W)
    want["convergence"] = sum(cfg.iters_for_level(i) for i in exit_levels)
    print(f"{label} launches {json.dumps(counts, sort_keys=True)} expected "
          f"{json.dumps(want, sort_keys=True)}; host reads {syncs}, "
          f"iterations run {iters} of {want['convergence']}")
    if counts != want or syncs != 0 or not 0 < iters <= want["convergence"]:
        fail(f"{label}: launch counts {counts} (expected {want}), host "
             f"reads {syncs}, iterations {iters}")
    check_planes(label, trip, (H, W))
    vals = value_gates(label, trip, 64, gate)

    # each level alone, from the same pyramid and states: the device loop
    # against the host-read loop on the card
    thr = float(np.float32(cfg.early_exit_delta))
    lp, rp = pyr.build_pyramid_pair(
        left.movedim(-1, 0).float().contiguous(),
        right.movedim(-1, 0).float().contiguous(), cfg, n)
    state = torch.zeros((3,) + tuple(dims[n - 1]), device=dev)
    levels = {}
    for i in range(n - 1, -1, -1):
        coarsest = i == n - 1
        if i in exit_levels:
            _, deltas = match_mod.level_convergence_trace(
                lp[i], rp[i], state, i, cfg, coarsest)
            match_mod.reset_host_syncs()
            ref = match_mod.match_level(lp[i], rp[i], state, i, cfg,
                                        coarsest, exit_loop="host")
            host_iters = match_mod.host_syncs()
            match_mod.reset_host_syncs()
            state = match_mod.match_level(lp[i], rp[i], state, i, cfg,
                                          coarsest)
            got = match_mod.iterations_run()
            reads = match_mod.host_syncs()
            change = deltas.max(dim=1).values[:host_iters].double()
            margin = (change / thr - 1).abs().min().item()
            same = torch.equal(state, ref)
            levels[i] = {"iterations": got, "host_loop_iterations":
                         host_iters, "of": cfg.iters_for_level(i),
                         "bit_equal": same, "margin": margin,
                         "changes": change.tolist()}
            if not (got == host_iters and same and reads == 0
                    and margin > 1e-5):
                fail(f"{label} level {i}: device loop {got} iterations "
                     f"({reads} host reads), host-read loop {host_iters}, "
                     f"bit-equal {same}, closest change {margin:.2e} "
                     f"(relative) from the threshold")
            del ref, deltas
        else:
            state = match_mod.match_level(lp[i], rp[i], state, i, cfg,
                                          coarsest)
        if i:
            state = pyr.upsample_to_level(state, *dims[i - 1], cfg)
    same = torch.equal(state, trip)
    print(f"{label} iterations per level (device loop / host-read loop on "
          f"the card, of the schedule; closest change to the threshold) "
          + " ".join(f"{i}:{v['iterations']}/{v['host_loop_iterations']}/"
                     f"{v['of']} ({v['margin']:.2e})"
                     for i, v in sorted(levels.items()))
          + f"; each level bit-equal to the host-read loop; the levels "
          f"chained equal the match: {same}")
    if not same or sum(v["iterations"] for v in levels.values()) != iters:
        fail(f"{label}: the levels driven alone differ from the match")
    del lp, rp, state
    summary = warm_summary(label, call, first_s, counts, peak)
    warm = summary["warm_s"]
    # the host's share: the time until the call returns (everything
    # enqueued, nothing read back), median of 5
    enqueue = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    enqueue_s = statistics.median(enqueue)
    print(f"{label} warm_median_s={summary['warm_median_s']:.4f} "
          f"(spread {min(warm):.4f}-{max(warm):.4f}) busy_share="
          f"{summary['profile']['busy_share']:.3f} enqueue_s="
          f"{enqueue_s:.4f} against the fixed "
          f"schedule's {ref_summary['warm_median_s']:.4f} (spread "
          f"{min(ref_summary['warm_s']):.4f}-{max(ref_summary['warm_s']):.4f})"
          f" / {ref_summary['profile']['busy_share']:.3f}")
    return {**summary, **vals, "host_syncs": syncs, "iterations_run": iters,
            "levels": levels, "fixed_iterations": want["convergence"],
            "enqueue_s": enqueue_s}


def convergence_trace(dev, cfg, left, right, report: dict) -> None:
    """Phase 3d: level_convergence_trace at level 4 (815 x 1231, 10
    iterations) from the state level 5 hands it; its triplet equals the
    per-iteration match_level's bit for bit."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr

    lv = LOCKSTEP_LEVEL
    lp, rp = pyr.build_pyramid_pair(
        left.movedim(-1, 0).float().contiguous(),
        right.movedim(-1, 0).float().contiguous(), cfg, lv + 2)
    coarse = torch.zeros((3,) + tuple(lp[lv + 1].shape[-2:]), device=dev)
    coarse = match_mod.match_level(lp[lv + 1], rp[lv + 1], coarse, lv + 1,
                                   cfg, True)
    state0 = pyr.upsample_to_level(coarse, *lp[lv].shape[-2:], cfg)
    trip, deltas = match_mod.level_convergence_trace(
        lp[lv], rp[lv], state0, lv, cfg, False)
    ref = match_mod.match_level(lp[lv], rp[lv], state0, lv, cfg, False,
                                resident_max_pixels=0)
    same = torch.equal(trip, ref)
    d = deltas.cpu().tolist()
    print(f"convergence_trace level {lv} {tuple(lp[lv].shape[-2:])} "
          f"equals match_level: {same}; deltas (h, v) "
          + " ".join(f"({a:.4f}, {b:.4f})" for a, b in d))
    if not same or deltas.shape != (cfg.iters_for_level(lv), 2):
        fail("convergence_trace: differs from the per-iteration level")
    report["convergence_trace"] = {"level": lv, "deltas": d}


def verged_rig():
    """The verged rig of tests/test_geom.py:18-32 scaled to 4928 x 3264:
    intrinsics x 7.7 in x and x 6.8 in y, the right camera 0.1 to the
    side and turned 0.03 rad about y."""
    from ug_stereomatcher_tpu_torch import geom

    th = 0.03
    K = np.array([[700.0 * 7.7, 0, 320.0 * 7.7], [0, 690.0 * 6.8,
                                                  240.0 * 6.8], [0, 0, 1.0]])
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    P2 = K @ np.c_[R, [-0.1, 0.0, 0.0]]
    left = geom.CameraCalibration(K=K, D=np.zeros(5), P=np.c_[K, np.zeros(3)])
    return geom.StereoCalibration(left=left, right=geom.CameraCalibration(
        K=K, D=np.zeros(5), P=P2))


def lstsq_gold(P1, P2, x1, y1, x2, y2) -> np.ndarray:
    """float64 NumPy least-squares solve of the four equations the closed
    form solves (rows 0-1 of P1, rows 0-1 of P2 against its row 2), the
    matrices rounded to float32 first as the port rounds them: (n, 3)."""
    p1 = np.asarray(P1, np.float32).astype(np.float64)
    p2 = np.asarray(P2, np.float32).astype(np.float64)
    z = np.zeros_like(x1)
    A = np.stack([
        np.stack([np.full_like(x1, p1[0, 0]), z, p1[0, 2] - x1], -1),
        np.stack([z, np.full_like(x1, p1[1, 1]), p1[1, 2] - y1], -1),
        p2[0, :3][None] - x2[:, None] * p2[2, :3][None],
        p2[1, :3][None] - y2[:, None] * p2[2, :3][None]], 1)
    b = np.stack([z, z, x2 * p2[2, 3] - p2[0, 3], y2 * p2[2, 3] - p2[1, 3]],
                 -1)
    return np.linalg.solve(np.einsum("nij,nik->njk", A, A),
                           np.einsum("nij,ni->nj", A, b)[..., None])[..., 0]


def timed_geometry(label: str, call) -> tuple:
    """One warm call's result and its seconds (host clock around a
    synchronised call, after a first call), and its device part."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prof = profile_match(call, secs, label)
    print(f"{label} warm_s={secs:.4f} device_ms={prof['device_busy_ms']:.3f}")
    return out, {"warm_s": secs, "device_busy_ms": prof["device_busy_ms"],
                 "busy_share": prof["busy_share"]}


def geometry(dev, cfg, left_np, trip, stack, kernels: dict,
             slices: dict) -> None:
    """Phase 3d, geometry on the verged rig: the full-resolution cloud of
    slice (a) with its finite share and a float64 least-squares gold on
    4096 seeded pixels (relative error q50/q99, q99 <= 1e-3), the resized
    clouds at factor 0.2 (bilinear: the resample kernel, held against its
    plain version on this range map; cubic: plain torch), and the
    foveated cloud of stack level 0 of slice (f); each timed with its
    device part.  Launch counts over the cloud functions: one bilinear
    resample, no other kernel."""
    from ug_stereomatcher_tpu_torch import geom
    from ug_stereomatcher_tpu_torch.ops.cuda import _build, resample

    rig = verged_rig()
    dh, dv = trip[0], trip[1]
    out: dict = {}
    _build.reset_launch_counts()
    cloud = geom.disparity_to_pointcloud(rig, dh, dv, left_np)
    resized = {m: geom.resized_pointcloud(rig, dh, dv, left_np, 0.2, m)
               for m in ("bilinear", "cubic")}
    fov = geom.foveated_disparity_to_pointcloud(rig, cfg, stack[0], stack[1],
                                                left_np)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"geometry launches {json.dumps(counts, sort_keys=True)} expected "
          f"{{\"resample_bilinear\": 1}}")
    if counts != {"resample_bilinear": 1}:
        fail(f"geometry: launch counts {counts}")
    finite = float(np.isfinite(cloud.xyz).all(axis=1).mean())
    idx = np.random.RandomState(SEED).choice(H * W, 4096, replace=False)
    yy, xx = (idx // W).astype(np.float64), (idx % W).astype(np.float64)
    x2 = (xx.astype(np.float32) + dh.flatten()[idx].cpu().numpy()).astype(
        np.float64)
    y2 = (yy.astype(np.float32) + dv.flatten()[idx].cpu().numpy()).astype(
        np.float64)
    gold = lstsq_gold(rig.left.P, rig.right.P, xx, yy, x2, y2)
    rel = np.abs(cloud.xyz[idx] - gold) / np.maximum(np.abs(gold), 1e-12)
    q50, q99 = float(np.quantile(rel, 0.5)), float(np.quantile(rel, 0.99))
    print(f"geometry cloud {len(cloud)} points, finite share {finite:.6f}, "
          f"median Z {float(np.median(cloud.xyz[:, 2])):.4f}; against the "
          f"float64 least-squares gold on 4096 pixels: rel q50={q50:.3e} "
          f"q99={q99:.3e}")
    if not (finite > 0.999 and q99 <= 1e-3):
        fail(f"geometry: finite share {finite}, gold q99 {q99}")
    out["cloud"] = {"points": len(cloud), "finite_share": finite,
                    "gold_rel_q50": q50, "gold_rel_q99": q99}
    for m, c in resized.items():
        print(f"geometry resized {m} {len(c)} points, finite share "
              f"{float(np.isfinite(c.xyz).all(axis=1).mean()):.6f}")
    if not np.array_equal(resized["bilinear"].xyz[:, :2],
                          resized["cubic"].xyz[:, :2]):
        fail("geometry: the resized clouds' X, Y differ between methods")
    print(f"geometry foveated level 0: {len(fov)} points, finite share "
          f"{float(np.isfinite(fov.xyz).all(axis=1).mean()):.6f}")

    # the range-map resize: its kernel against its plain version
    z = geom.range_map(rig.left.P, rig.right.P, dh, dv)[None].contiguous()
    oh, ow = int(H * 0.2), int(W * 0.2)
    (iy, wy), (ix, wx) = (resample.bilinear_taps(oh, H, lambda t: t * 5.0),
                          resample.bilinear_taps(ow, W, lambda t: t * 5.0))
    args = (z, *(torch.from_numpy(a).to(dev) for a in (iy, ix)), 1.0,
            *(torch.from_numpy(a).to(dev) for a in (wy, wx)))
    compare(kernels, "resample_bilinear_range_map", "16mp-0.2",
            resample.resample_static, resample.resample_static_plain, args,
            work=(taps_bytes(z, oh, ow, iy, ix, True), oh * ow * 12),
            library=interpolate_resample(z, 5.0, (oh, ow), "bilinear"))

    for label, call in (
            ("cloud", lambda: geom.disparity_to_pointcloud(rig, dh, dv,
                                                           left_np)),
            ("resized_bilinear", lambda: geom.resized_pointcloud(
                rig, dh, dv, left_np, 0.2, "bilinear")),
            ("resized_cubic", lambda: geom.resized_pointcloud(
                rig, dh, dv, left_np, 0.2, "cubic")),
            ("foveated_cloud", lambda: geom.foveated_disparity_to_pointcloud(
                rig, cfg, stack[0], stack[1], left_np)),
            ("triangulate", lambda: geom.triangulate_disparity(
                rig.left.P, rig.right.P, dh, dv))):
        _, out[label] = timed_geometry(f"geometry {label}", call)
    slices["geometry"] = {**out, "launches": counts}


def extras(dev, cfg, bil, left, right, left_np, near_ref, slices: dict,
           kernels: dict, report: dict) -> None:
    """Phase 3d, the engine extras and the geometry at 16 MP: (k) early
    exit nearest (0.1) and (l) bilinear (0.02), the convergence trace,
    match_with_consistency, profile_match, warmup and get_disparities,
    and the point clouds."""
    import dataclasses

    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch.ops.cuda import warp

    slices["early_exit_nearest"] = early_exit_slice(
        dev, dataclasses.replace(cfg, early_exit_delta=0.1), left, right,
        "early_exit_nearest", 0.5, slices["nearest"])
    slices["early_exit_bilinear"] = early_exit_slice(
        dev, dataclasses.replace(bil, early_exit_delta=0.02), left, right,
        "early_exit_bilinear", 0.1, slices["bilinear"])
    torch.cuda.empty_cache()
    convergence_trace(dev, cfg, left, right, report)

    eng = StereoEngine(cfg, device=dev)
    want = {k: 2 * v for k, v in expected_launches(cfg, H, W).items()}
    want["warp"] += 1
    (fwd, mask, err), first_s, counts, peak = first_call(
        dev, "consistency", lambda: eng.match_with_consistency(left, right),
        want)
    m = slice(64, -64)
    share = mask[m, m].float().mean().item()
    q = torch.quantile(err[m, m].flatten()[::7].double(),
                       torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                    device=dev)).tolist()
    same = torch.equal(fwd.triplet, near_ref)
    print(f"consistency share={share:.4f} on [64:-64, 64:-64] error "
          f"q50={q[0]:.4f} q90={q[1]:.4f} q99={q[2]:.4f}; forward equals "
          f"(a): {same}; first_call_s={first_s:.4f}")
    if not (share > 0.9 and same):
        fail(f"consistency: share {share}, forward equals (a) {same}")
    # the check's own launches: those beyond the two matches
    own = counts["warp"] - 2 * expected_launches(cfg, H, W)["warp"]
    slices["consistency"] = {"share": share, "error_q50_q90_q99": q,
                             "first_call_s": first_s, "peak_mem_bytes": peak,
                             "launches": {"warp": own}}
    bwd = eng.match(right, left)
    stack = torch.stack([bwd.disparity_h, bwd.disparity_v])
    compare(kernels, "warp_consistency", "16mp-2planes", warp.warp,
            warp.warp_plain, (stack, fwd.disparity_h.contiguous(),
                              fwd.disparity_v.contiguous(), "nearest"),
            work=(6 * H * W * 4.0, WARP_OPS["nearest"] * H * W),
            library=grid_sample_warp(stack, fwd.disparity_h,
                                     fwd.disparity_v, "nearest"))
    del fwd, bwd, mask, err, stack

    (res, prof), first_s, counts, _ = first_call(
        dev, "profile_match", lambda: eng.profile_match(left, right),
        expected_launches(cfg, H, W))
    same = torch.equal(res.triplet, near_ref)
    print("profile_match levels " + " ".join(
        f"{k}:{v['match_s'] * 1e3:.3f}+{v.get('upsample_s', 0) * 1e3:.3f}ms"
        for k, v in sorted(prof["levels"].items())))
    print(f"profile_match pyramid_build_s={prof['pyramid_build_s']:.4f} "
          f"match_total_s={prof['match_total_s']:.4f} total_s="
          f"{prof['total_s']:.4f} against (a) warm "
          f"{slices['nearest']['warm_median_s']:.4f}; equals (a): {same}")
    if not same:
        fail("profile_match differs from match")
    slices["profile_match"] = {"breakdown": prof, "launches": counts}

    fresh = StereoEngine(cfg, device=dev)
    t0 = time.perf_counter()
    fresh.warmup(H, W)
    fresh.warmup(H, W, foveated=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    got = fresh.get_disparities(left, right)
    st = fresh.get_disparities(left, right, foveated=True)
    ref = eng.match_foveated(left, right)
    same = (torch.equal(got.triplet, near_ref)
            and all(torch.equal(getattr(st, k), getattr(ref, k))
                    for k in ("stack_h", "stack_v", "stack_c")))
    print(f"warmup (both modes) {warm_s:.4f} s; get_disparities equals "
          f"match and match_foveated: {same}")
    if not same:
        fail("get_disparities differs from match / match_foveated")
    report["warmup_s"] = warm_s
    del got
    geometry(dev, cfg, left_np, near_ref,
             torch.stack([ref.stack_h, ref.stack_v]), kernels, slices)
    torch.cuda.empty_cache()


GRAPH_CASES = (
    # (label, entry point, config fields)
    ("mode1_nearest", "match", {}),
    ("mode1_bilinear", "match", {"interp": "bilinear"}),
    ("mode1_nearest_ee", "match", {"early_exit_delta": 0.1}),
    ("mode1_bilinear_ee", "match", {"interp": "bilinear",
                                    "early_exit_delta": 0.02}),
    ("mode2_nearest", "match_foveated", {}),
    ("mode2_bilinear", "match_foveated", {"interp": "bilinear"}),
    ("hierarchical", "match_hierarchical", {}),
    ("batch", "match_batch", {}),
    ("batch_foveated", "match_batch_foveated", {}),
)


def graph_case(dev, cfg, entry: str):
    """(eager, engine): the eager module path of ``entry`` and the
    engine's entry point, each a call on (left, right) as a caller passes
    them (uint8 HWC on the card) that returns its tensors, synchronised."""
    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr
    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher

    eng = StereoEngine(cfg, device=dev)
    fov = entry.endswith("foveated")
    k = cfg.fovea_level

    def chw(x):
        return x.movedim(-1, -3).float().contiguous()

    def eager(left, right):
        if entry.startswith("match_batch"):
            out = make_batch_matcher(cfg, None, dev, fov, capture=False)(
                chw(left), chw(right))
        else:
            lt, rt = chw(left), chw(right)
            h, w = lt.shape[-2:]
            if entry == "match":
                lp, rp = pyr.build_pyramid_pair(lt, rt, cfg,
                                                cfg.num_levels(h, w))
                out = match_mod.match_pyramid(lp, rp, cfg, (h, w)).levels[0]
            else:
                levels, lf, rf = match_mod.match_foveated_pair(lt, rt, cfg)
                if entry == "match_hierarchical":
                    out = pyr.hierarchical_disparity(levels, cfg, (h, w))
                else:
                    out = (torch.cat(levels[:k], dim=-2),
                           *(torch.cat([x.flatten(0, 1) for x in f[:k]])
                             for f in (lf, rf)))
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    def engine(left, right):
        if entry.startswith("match_batch"):
            res = eng.match_batch(left, right, foveated=fov)
            planes = ((res.stack_h, res.stack_v, res.stack_c) if fov else
                      (res.disparity_h, res.disparity_v, res.confidence))
            out = (torch.stack(planes, dim=1),)
        elif entry == "match_foveated":
            res = eng.match_foveated(left, right)
            out = (torch.stack([res.stack_h, res.stack_v, res.stack_c]),
                   res.stack_left, res.stack_right)
        else:
            out = (getattr(eng, entry)(left, right).triplet,)
        torch.cuda.synchronize()
        return out
    return eng, eager, engine


def counted_call(call, *inputs):
    """call(*inputs) with every count set to 0 just before it: (result,
    launches, early-exit iterations, host reads, graph replays)."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    match_mod.reset_host_syncs()
    out = call(*inputs)
    return (out, _build.launch_counts(), match_mod.iterations_run(),
            match_mod.host_syncs(), _build.graph_replays())


def same_bits(label: str, what: str, out, ref) -> None:
    for i, (a, b) in enumerate(zip(out, ref)):
        if a.shape != b.shape or not torch.equal(a, b):
            err = ((a - b).abs().max().item() if a.shape == b.shape
                   else f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
            fail(f"graphs {label}: {what}: output {i} differs from the "
                 f"eager path (max |d| {err})")


def warm_ms(call, *inputs, n: int = 5):
    """Median warm latency in ms (host clock around a synchronised call)
    and the runs in ms."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call(*inputs)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return med * 1e3, [round(t * 1e3, 3) for t in times]


def held_calls(holder) -> list:
    """The captured calls (graphs.CapturedCall) an engine or a batch
    matcher holds: an engine's entry points and profile stages, and the
    graphs of its batch matchers (one a batch shape and card)."""
    calls = []
    for obj in [holder] + list(getattr(holder, "matchers", {}).values()):
        for v in getattr(obj, "graphs", {}).values():
            calls.extend(v.values() if isinstance(v, dict) else [v])
    return calls


def graph_entry(dev, label: str, make, first, second, replays: int,
                info: dict) -> dict:
    """One entry of phase 3h.  ``make()`` gives ``(holder, eager,
    graph)``: ``graph`` a call that replays the graphs ``holder`` (an
    engine or a batch matcher) captures at its first call, ``eager`` its
    eager counterpart, each returning a tuple of tensors, synchronised.
    The two on the same inputs: bit for bit,
    with the same launch counts, early-exit iterations, no host read and
    ``replays`` replays, on the first call (the capture) and on a replay
    of ``second``; the first result unchanged by the second.  Then the
    warm latency (median of 10) and busy share of both in turns (eager,
    graph, graph, eager), the capture seconds, the peak memory of the
    first call against the eager call's and the memory the graphs hold
    (only this function holds ``holder``, and drops it)."""
    holder, eager, graph = make()
    torch.cuda.reset_peak_memory_stats(dev)
    ref1, want1, it1, _, _ = counted_call(eager, *first)
    eager_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out1, got1, git1, syncs1, rep1 = counted_call(graph, *first)
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated(dev)
    calls = held_calls(holder)
    capture_s = sum(c.capture_s for c in calls)
    same_bits(label, "first call", out1, ref1)
    if (got1, git1, syncs1, rep1) != (want1, it1, 0, replays):
        fail(f"graphs {label}: first call counts {got1}, {git1} "
             f"iterations, {syncs1} host reads, {rep1} replays; eager "
             f"{want1}, {it1} iterations, {replays} replays wanted")
    ref2, want2, it2, _, _ = counted_call(eager, *second)
    out2, got2, git2, syncs2, rep2 = counted_call(graph, *second)
    same_bits(label, "second call", out2, ref2)
    same_bits(label, "first result after the second call", out1, ref1)
    if (got2, git2, syncs2, rep2) != (want2, it2, 0, replays):
        fail(f"graphs {label}: replay counts {got2}, {git2} "
             f"iterations, {syncs2} host reads, {rep2} replays; eager "
             f"{want2}, {it2} iterations, {replays} replays wanted")
    del ref1, ref2, out1, out2
    # in turns: eager, graph, graph, eager
    e1, e1s = warm_ms(eager, *first)
    g1, g1s = warm_ms(graph, *first)
    g2, g2s = warm_ms(graph, *first)
    e2, e2s = warm_ms(eager, *first)
    graph_med = statistics.median(g1s + g2s)
    eager_med = statistics.median(e1s + e2s)
    gprof = profile_match(lambda: graph(*first), graph_med / 1e3,
                          f"graphs {label} graph")
    eprof = profile_match(lambda: eager(*first), eager_med / 1e3,
                          f"graphs {label} eager")
    route = getattr(holder, "route", None)
    # the graphs' private pools outlive empty_cache while they live
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved(dev)
    del holder, graph, eager, calls
    torch.cuda.empty_cache()
    held = reserved1 - torch.cuda.memory_reserved(dev)
    if route not in (None, "graph"):
        fail(f"graphs {label}: the matcher ran {route}")
    row = {**info, "launches": got1, "iterations_run": git1,
           "iterations_run_second": git2, "replays_per_call": replays,
           "graph_warm_ms": graph_med, "eager_warm_ms": eager_med,
           "graph_warm_runs_ms": g1s + g2s,
           "eager_warm_runs_ms": e1s + e2s,
           "graph_busy_share": gprof["busy_share"],
           "eager_busy_share": eprof["busy_share"],
           "graph_device_busy_ms": gprof["device_busy_ms"],
           "eager_device_busy_ms": eprof["device_busy_ms"],
           "first_call_s": first_s, "capture_s": capture_s,
           "peak_mem_bytes": graph_peak, "eager_peak_mem_bytes":
           eager_peak, "graph_held_bytes": held}
    print(f"graphs {label} bit-equal to eager (first call and replay), "
          f"launches and iterations ({git1}, {git2}) equal, 0 host "
          f"reads, {replays} replays a call; warm graph={graph_med:.3f} ms "
          f"(busy {row['graph_busy_share']:.3f}) eager={eager_med:.3f} ms "
          f"(busy {row['eager_busy_share']:.3f}) runs graph "
          f"{g1s + g2s} eager {e1s + e2s}; first_call_s={first_s:.4f} "
          f"capture_s={capture_s:.4f} peak_mem graph={graph_peak} "
          f"eager={eager_peak} graph_held={held}")
    return row


def synced(fn):
    """``fn`` as a phase 3h call: its result as a tuple, synchronised."""
    def call(*inputs):
        out = fn(*inputs)
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)
    return call


def mesh_entries(dev, cfg, bil, left, right, other):
    """Phase 3h's mesh entries: (label, config, mesh, foveated, first
    inputs, second inputs, info), the inputs (B, 3, H, W) batches on the
    card as a caller passes them (uint8 views of the scene; float32 for
    the harness's points).  The row-sharded 16 MP slices (d), (e) and (j)
    on a 1 x 4 mesh of this card; the 2 x 2 pair batch of phase 3c; the
    dp, sp, hybrid and dp_fov points of measure_throughput at 408 x 616
    on 4 entries of this card (its mesh shapes, batches and inputs)."""
    from ug_stereomatcher_tpu_torch import scene
    from ug_stereomatcher_tpu_torch.parallel import make_mesh
    from ug_stereomatcher_tpu_torch.parallel.throughput import _mesh_shape

    def batch(*images):
        return [torch.stack([x.movedim(-1, -3) for x in side])
                for side in zip(*images)]

    rows = make_mesh(1, 4, devices=[dev] * 4)
    full = batch((left, right)), batch(other)
    for label, c, fov in (("mesh_sharded_nearest", cfg, False),
                          ("mesh_sharded_bilinear", bil, False),
                          ("mesh_sharded_foveated", cfg, True)):
        yield (label, c, rows, fov, *full, {"shape": [H, W], "mesh": [1, 4],
                                            "batch": 1, "foveated": fov})
    h, w = 816, 1232
    pb = [batch(*[[torch.from_numpy(x).to(dev)
                   for x in scene.make_pair(h, w, seed=s + k)]
                  for k in (0, 1)]) for s in (0, 100)]
    yield ("mesh_pair_batch_2x2", cfg, make_mesh(2, 2, devices=[dev] * 4),
           False, *pb, {"shape": [h, w], "mesh": [2, 2], "batch": 2,
                        "foveated": False})
    for family in ("dp", "sp", "hybrid", "dp_fov"):
        p, r, b = _mesh_shape(family.removesuffix("_fov"), 4, 1)
        ins = []
        for seed in (0, 1):
            x = np.random.RandomState(seed).rand(
                b, 3, SCALE_H, SCALE_W).astype(np.float32) * 255
            ins.append([torch.from_numpy(x).to(dev),
                        torch.from_numpy(np.roll(x, 2, axis=-1)).to(dev)])
        fov = family.endswith("_fov")
        yield (f"mesh_throughput_{family}", cfg, make_mesh(
            p, r, devices=[dev] * (p * r)), fov, *ins,
            {"shape": [SCALE_H, SCALE_W], "mesh": [p, r], "batch": b,
             "foveated": fov})


def eager_profile(dev, cfg):
    """The eager counterpart of StereoEngine.profile_match on the card
    (its loop before the stage graphs): the module path's stages, each
    synchronised and timed.  Returns ``(left, right) -> (triplet,)`` and
    the list its breakdowns go to."""
    from ug_stereomatcher_tpu_torch import match as match_mod
    from ug_stereomatcher_tpu_torch import pyramid as pyr

    seen = []

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run(left, right):
        lt, rt = (x.movedim(-1, -3).float().contiguous()
                  for x in (left, right))
        h, w = lt.shape[-2:]
        n = cfg.num_levels(h, w)
        dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)
        (lp, rp), build_s = timed(pyr.build_pyramid_pair, lt, rt, cfg, n)
        disp = torch.zeros((3,) + tuple(dims[n - 1]), device=dev)
        total = 0.0
        for i in range(n - 1, -1, -1):
            disp, secs = timed(match_mod.match_level, lp[i], rp[i], disp, i,
                               cfg, i == n - 1)
            total += secs
            if i > 0:
                disp, secs = timed(pyr.upsample_to_level, disp,
                                   *dims[i - 1], cfg)
                total += secs
        seen.append({"pyramid_build_s": build_s, "match_total_s": total})
        return (disp,)
    return run, seen


def graphs_phase(dev, cfg, left, right, report: dict) -> None:
    """Phase 3h, the compile-once cache (graphs.py): each captured entry
    point at 16 MP (mode 1 nearest and bilinear, each with and without
    early exit at 0.1 / 0.02 px; mode 2 nearest and bilinear; the
    hierarchical map) and the 8-pair batch at 815 x 1231 (mode 1 and
    foveated) against the eager module path on the same inputs; then the
    mesh route's graphs (mesh_entries: the batch matcher against its
    eager form, capture=False, one replay a call on this card), and
    profile_match's stage graphs against its eager stages (2n replays a
    call).  Each through graph_entry: bit for bit, the same counts, on
    the capture and on a replay of a second scene (seed + 1), warm
    latency and busy share in turns, capture seconds, peak and held
    memory."""
    import dataclasses

    from ug_stereomatcher_tpu_torch import StereoEngine, scene
    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher

    t_phase = time.perf_counter()
    other = [torch.from_numpy(x).to(dev)
             for x in scene.make_pair(H, W, seed=SEED + 1)]
    pairs = {s: [scene.make_pair(TPUT_H, TPUT_W, seed=s + i)
                 for i in range(TPUT_BATCH)] for s in (SEED, SEED + 100)}
    batches = {s: [torch.from_numpy(np.stack([p[j] for p in ps])).to(dev)
                   for j in (0, 1)] for s, ps in pairs.items()}
    out = report["graphs"] = {}
    for label, entry, fields in GRAPH_CASES:
        c = dataclasses.replace(cfg, **fields)
        if entry.startswith("match_batch"):
            first, second = batches[SEED], batches[SEED + 100]
        else:
            first, second = (left, right), other
        torch.cuda.empty_cache()
        out[label] = graph_entry(
            dev, label, lambda: graph_case(dev, c, entry), first, second, 1,
            {"entry": entry, "config": fields})
    del batches, first, second

    def matchers(c, mesh, fov):
        graph = make_batch_matcher(c, mesh, foveated=fov)
        return graph, synced(make_batch_matcher(c, mesh, foveated=fov,
                                                capture=False)), synced(graph)
    bil = dataclasses.replace(cfg, interp="bilinear")
    for label, c, mesh, fov, first, second, info in mesh_entries(
            dev, cfg, bil, left, right, other):
        torch.cuda.empty_cache()
        out[label] = graph_entry(
            dev, label, lambda: matchers(c, mesh, fov), first, second, 1,
            {"entry": "make_batch_matcher", **info})
        del first, second
    torch.cuda.empty_cache()
    n = cfg.num_levels(H, W)
    eager_stages, graph_stages = [], []

    def profiled():
        eng = StereoEngine(cfg, device=dev)
        eager, seen = eager_profile(dev, cfg)
        eager_stages[:] = [seen]

        def staged(lft, rgt):
            res, prof = eng.profile_match(lft, rgt)
            graph_stages.append(prof)
            torch.cuda.synchronize()
            return (res.triplet,)
        return eng, eager, staged
    out["profile_match"] = row = graph_entry(
        dev, "profile_match", profiled, (left, right), other, 2 * n,
        {"entry": "profile_match", "stages": 2 * n})
    # the ten warm calls of each (after the first two, before the profile)
    for name, runs in (("graph", graph_stages),
                       ("eager", eager_stages[0])):
        for key in ("pyramid_build_s", "match_total_s"):
            row[f"{name}_{key}_median"] = statistics.median(
                r[key] for r in runs[2:12])
        print(f"graphs profile_match {name} stages: pyramid_build_s median "
              f"{row[f'{name}_pyramid_build_s_median']:.5f} match_total_s "
              f"median {row[f'{name}_match_total_s_median']:.5f} over 10 "
              f"warm calls")
    if sorted(graph_stages[-1]["levels"]) != [f"level_{i:02d}"
                                              for i in range(n)]:
        fail("graphs profile_match: the breakdown's levels changed")
    del other
    torch.cuda.empty_cache()
    print(f"graphs phase {time.perf_counter() - t_phase:.1f} s; "
          f"nvidia-smi {nvidia_smi()}")


# The per-scene accuracy gates of tests/test_eval_cli.py:24-33 (interp ->
# scene -> (median EPE max, share of pixels above 1 px max)), copied here:
# the smoke imports nothing of the JAX package or its tests.
EPE_GATES = {
    "nearest": {"constant": (0.45, 0.03), "vertical": (0.45, 0.02),
                "slant": (0.45, 0.02), "sine": (0.45, 0.02),
                "step": (0.50, 0.05)},
    "bilinear": {"constant": (0.08, 0.03), "vertical": (0.08, 0.02),
                 "slant": (0.08, 0.02), "sine": (0.08, 0.02),
                 "step": (0.05, 0.02)},
}
# card against CPU: interp -> (|d median EPE| max, |d bad_1_0| max); a
# nearest transition flips on float noise, so nearest gets more room
EPE_CARD_VS_CPU = {"nearest": (0.03, 0.01), "bilinear": (0.002, None)}

CAMERA_XML = """<?xml version="1.0"?>
<opencv_storage>
<K type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>
<data>{K}</data></K>
<D type_id="opencv-matrix"><rows>1</rows><cols>5</cols><dt>d</dt>
<data>{D}</data></D>
<P type_id="opencv-matrix"><rows>3</rows><cols>4</cols><dt>d</dt>
<data>{P}</data></P>
</opencv_storage>
"""


def write_camera_xml(path: Path, cam) -> str:
    """One camera of a StereoCalibration as an OpenCV FileStorage XML."""
    def text(m):
        return " ".join(repr(float(v)) for v in np.ravel(m))
    path.write_text(CAMERA_XML.format(K=text(cam.K), D=text(cam.D),
                                      P=text(cam.P)))
    return str(path)


def pcd_points(path: str) -> int:
    """The points a binary PCD file holds, from its size: 16 bytes a point
    after the header, which must name the same count."""
    with open(path, "rb") as fh:
        head = fh.read(512)
    end = head.index(b"DATA binary\n") + len(b"DATA binary\n")
    n = (Path(path).stat().st_size - end) / 16
    if f"POINTS {int(n)}\n".encode() not in head[:end]:
        fail(f"{path}: header does not hold {n} points")
    return int(n)


def counted(label: str, call, want: dict):
    """``call()`` with the launch counts set to 0 just before it and read
    just after; fails unless they equal ``want``.  Returns the result,
    its seconds (host clock, synchronised) and the counts."""
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"{label} {secs:.4f} s launches "
          f"{json.dumps(counts, sort_keys=True)}")
    if counts != want:
        fail(f"{label}: launch counts {counts} differ from {want}")
    return out, secs, counts


def runner_phase(dev, cfg, left_np, right_np, near_ref, tmp: Path,
                 out: dict) -> None:
    """Phase 3e, the runner: a 3-pair .npy manifest (the scene and its
    row-flipped and row-rolled copies, each with the 3 px shift) and the
    verged rig as two XML files; the native library built first (timed
    on its own); BatchRunner with clouds, with and without prefetch in
    turns (with, without, without, with), each pair's launches those of
    a match; pair 0's dumps equal (a) bit for bit, every PCD holds 16.1
    M points; a rerun with the checkpoint skips all three pairs; one
    more run under the profiler for the device's busy share; and pair
    0's wall time by stage (load, H2D, match, dump, cloud, PCD write)."""
    import shutil

    from ug_stereomatcher_tpu_torch import StereoEngine, geom, native
    from ug_stereomatcher_tpu_torch.io import load_image
    from ug_stereomatcher_tpu_torch.pipeline import (BatchRunner,
                                                     ImageListCapture)

    pairs = [(left_np, right_np),
             (left_np[::-1], right_np[::-1]),
             (np.roll(left_np, H // 3, 0), np.roll(right_np, H // 3, 0))]
    paths = []
    for i, pair in enumerate(pairs):
        for side, img in zip("lr", pair):
            p = tmp / f"{side}{i}.npy"
            np.save(p, np.ascontiguousarray(img))
            paths.append(str(p))
    man = tmp / "pairs.txt"
    man.write_text("\n".join(paths) + "\n")
    rig = verged_rig()
    cal = [write_camera_xml(tmp / f"cal{s}.xml", c)
           for s, c in (("L", rig.left), ("R", rig.right))]
    calib = geom.StereoCalibration.from_xml(*cal)
    eng = StereoEngine(cfg, device=dev)
    want = {k: 3 * v for k, v in expected_launches(cfg, H, W).items()}
    ck = tmp / "progress.jsonl"
    t0 = time.perf_counter()
    if not native.available():
        fail("native: the library did not build or load")
    out["native_build_s"] = time.perf_counter() - t0
    print(f"native library built and loaded in {out['native_build_s']:.2f}"
          f" s -> {native.bindings.library_path()}")

    def run(label, prefetch, checkpoint=None, n_want=want):
        dump = tmp / label
        runner = BatchRunner(eng, calibration=calib, out_dir=str(dump),
                             save_clouds=True, prefetch=prefetch,
                             checkpoint_path=checkpoint, dump_ext=".npy")
        cap = ImageListCapture(str(man), camera_info_left=cal[0],
                               camera_info_right=cal[1])
        res, secs, _ = counted(f"runner {label}", lambda: runner.run(cap),
                               n_want)
        return res, secs, dump

    for turn, prefetch in enumerate((True, False, False, True)):
        label = f"{'prefetch' if prefetch else 'no_prefetch'}_{turn}"
        # the last run without prefetch keeps its dumps for the resume
        res, secs, dump = run(label, prefetch, str(ck) if turn == 2 else None)
        if [r.index for r in res] != [0, 1, 2]:
            fail(f"runner {label}: pairs {[r.index for r in res]}")
        for tag, plane in zip("HVC", near_ref):
            if not np.array_equal(np.load(res[0].dump_paths[tag]),
                                  plane.cpu().numpy()):
                fail(f"runner {label}: pair 0's {tag} dump differs from "
                     f"(a)")
        points = [pcd_points(str(dump / f"cloud_{i}.pcd")) for i in range(3)]
        if points != [H * W] * 3:
            fail(f"runner {label}: PCD points {points}")
        rows = [{"match_s": r.match_seconds, "dump_s": r.dump_seconds,
                 "cloud_s": r.cloud_seconds} for r in res]
        print(f"runner {label}: {3 / secs:.3f} pairs/s ({secs:.3f} s for 3)"
              f"; pair 0's dumps equal (a); PCDs of {points[0]} points; per"
              f" pair match/dump/cloud+PCD s " + " ".join(
                  f"{x['match_s']:.4f}/{x['dump_s']:.3f}/{x['cloud_s']:.3f}"
                  for x in rows))
        out[f"runner_{label}"] = {"seconds": secs, "pairs_per_s": 3 / secs,
                                  "pairs": rows, "pcd_points": points}
        if turn != 2:
            shutil.rmtree(dump)
    res, _, _ = run("resume", False, str(ck), n_want={})
    if res:
        fail(f"runner resume: reran pairs {[r.index for r in res]}")
    print("runner resume: the checkpoint skips all 3 pairs")
    shutil.rmtree(tmp / "no_prefetch_2")
    runs = {p: [v["seconds"] for k, v in out.items()
                if k.startswith(f"runner_{p}_")]
            for p in ("prefetch", "no_prefetch")}
    print("runner pairs/s " + " ".join(
        f"{p}={[round(3 / x, 3) for x in v]}" for p, v in runs.items()))

    def profiled():
        runner = BatchRunner(eng, calibration=calib,
                             out_dir=str(tmp / "profiled"), save_clouds=True,
                             dump_ext=".npy")
        return runner.run(ImageListCapture(str(man)))

    out["runner_profile"] = profile_match(
        profiled, statistics.median(runs["prefetch"]), "runner prefetch")
    shutil.rmtree(tmp / "profiled")

    # pair 0 by stage, each on its own (host clock, synchronised)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return r

    imgs = stage("load", lambda: [load_image(p) for p in paths[:2]])
    dev_imgs = stage("h2d", lambda: [torch.from_numpy(a).to(dev)
                                     for a in imgs])
    res = stage("match", lambda: eng.match(*dev_imgs))
    from ug_stereomatcher_tpu_torch.io import save_disparity_maps
    stage("dump", lambda: save_disparity_maps(res, str(tmp / "stage"),
                                              ext=".npy"))
    cloud = stage("cloud", lambda: geom.disparity_to_pointcloud(
        calib, res.disparity_h, res.disparity_v, imgs[0]))
    pcd = str(tmp / "stage" / "native.pcd")
    stage("pcd_write", lambda: native.write_pcd(pcd, cloud.xyz, cloud.rgb))
    stage("pcd_write_numpy", lambda: geom.save_pcd(
        str(tmp / "stage" / "numpy.pcd"), cloud))
    same = (Path(pcd).read_bytes()
            == (tmp / "stage" / "numpy.pcd").read_bytes())
    print("runner pair 0 by stage s " + " ".join(
        f"{k}={v:.4f}" for k, v in stages.items())
          + f"; native PCD equals geom.save_pcd's bytes: {same}")
    if not same:
        fail("native: write_pcd differs from geom.save_pcd")
    out["pair0_stages_s"] = stages
    out["native_available"] = True
    shutil.rmtree(tmp / "stage")


def service_phase(dev, cfg, left, right, near_ref, out: dict) -> None:
    """Phase 3e, the service and the supervisor: DisparityService planes
    equal (a) bit for bit and, in the foveated mode, match_foveated's
    stacks; the default EngineSupervisor (StereoEngine() on the card)
    returns for full, foveated and hierarchical."""
    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch.pipeline import (DisparityService,
                                                     EngineSupervisor)
    from ug_stereomatcher_tpu_torch.pipeline.messages import (
        GetDisparitiesRequest)

    eng = StereoEngine(cfg, device=dev)
    req = GetDisparitiesRequest(left=left, right=right)
    rsp, secs, counts = counted("service full", lambda: DisparityService(
        eng)(req), expected_launches(cfg, H, W))
    for msg, plane in zip((rsp.disp_h, rsp.disp_v, rsp.disp_c), near_ref):
        if not np.array_equal(msg.image, plane.cpu().numpy()):
            fail("service full: a plane differs from (a)")
    ref = eng.match_foveated(left, right)
    rsp, fsecs, fcounts = counted(
        "service foveated", lambda: DisparityService(eng, foveated=True)(req),
        expected_launches(cfg, H, W, foveated=True))
    for msg, plane in zip((rsp.fdisp_h, rsp.fdisp_v, rsp.fdisp_c),
                          (ref.stack_h, ref.stack_v, ref.stack_c)):
        if not np.array_equal(msg.image_stack, plane.cpu().numpy()):
            fail("service foveated: a stack differs from match_foveated")
    print("service: full planes equal (a), foveated stacks equal "
          "match_foveated, bit for bit")
    sup = EngineSupervisor()
    if sup.engine.device.type != "cuda":
        fail(f"supervisor: default engine on {sup.engine.device}")
    times = {}
    for mode in ("full", "foveated", "hierarchical"):
        t0 = time.perf_counter()
        r = sup.match(left, right, mode=mode)
        times[mode] = time.perf_counter() - t0
        shape = (tuple(r.stack_h.shape) if mode == "foveated"
                 else tuple(r.disparity_h.shape))
        print(f"supervisor {mode}: {shape} in {times[mode]:.4f} s")
    if (sup.stats.frames, sup.stats.failures) != (3, 0):
        fail(f"supervisor: stats {sup.stats}")
    out["service"] = {"full_s": secs, "foveated_s": fsecs,
                      "launches": counts, "foveated_launches": fcounts,
                      "supervisor_s": times}


def cli_phase(left_np, right_np, near_ref, tmp: Path, out: dict) -> None:
    """Phase 3e, the command line in subprocesses (process start, the
    imports and the cached kernel build included): match to .npy dumps,
    pair 0's H equal to (a), and cloud to a PCD of 16.1 M points."""
    repo = Path(__file__).resolve().parent
    lp, rp = tmp / "l0.npy", tmp / "r0.npy"
    rig = verged_rig()
    cal = [write_camera_xml(tmp / f"cli_cal{s}.xml", c)
           for s, c in (("L", rig.left), ("R", rig.right))]
    runs = {
        "match": ["match", str(lp), str(rp), "-o", str(tmp / "cli"),
                  "--ext", ".npy"],
        "cloud": ["cloud", str(lp), str(rp), "--cal-left", cal[0],
                  "--cal-right", cal[1], "-o", str(tmp / "cli.pcd")],
    }
    for name, argv in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "ug_stereomatcher_tpu_torch", *argv],
                              cwd=repo, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"cli {name}: rc {proc.returncode}: {proc.stderr[-2000:]}")
        payload = json.loads(proc.stdout.strip().splitlines()[-1])
        if name == "match":
            got = np.load(payload["outputs"]["H"])
            if not np.array_equal(got, near_ref[0].cpu().numpy()):
                fail("cli match: H differs from (a)")
        elif pcd_points(payload["output"]) != H * W:
            fail(f"cli cloud: {payload}")
        print(f"cli {name}: rc 0 in {wall:.2f} s wall (process start "
              f"included) {json.dumps(payload)[:160]}")
        out[f"cli_{name}"] = {"wall_s": wall, "payload": payload}


def eval_phase(dev, out: dict) -> None:
    """Phase 3e, the accuracy harness: accuracy_table(192, 256) on the
    card against the per-scene gates and against the same table on the
    CPU; evaluate_occlusion in both modes (matched above occluded
    confidence)."""
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
    from ug_stereomatcher_tpu_torch import eval as ev

    t0 = time.perf_counter()
    card = ev.accuracy_table(192, 256, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = ev.accuracy_table(192, 256, device="cpu")
    cpu_s = time.perf_counter() - t0
    rows = []
    for interp, gates in EPE_GATES.items():
        med_tol, bad_tol = EPE_CARD_VS_CPU[interp]
        for scene, (med_max, bad_max) in gates.items():
            c, p = card[interp][scene], cpu[interp][scene]
            d_med = abs(c.median_epe - p.median_epe)
            d_bad = abs(c.bad_1_0 - p.bad_1_0)
            rows.append({"interp": interp, "scene": scene,
                         "card": c.as_dict(), "cpu": p.as_dict(),
                         "d_median": d_med, "d_bad_1_0": d_bad})
            print(f"eval {interp:8s} {scene:8s} card median "
                  f"{c.median_epe:.6f} bad1 {c.bad_1_0:.6f} | cpu "
                  f"{p.median_epe:.6f} {p.bad_1_0:.6f} | d {d_med:.6f} "
                  f"{d_bad:.6f}")
            if not (c.median_epe < med_max and c.bad_1_0 < bad_max):
                fail(f"eval {interp} {scene}: gates ({med_max}, {bad_max})"
                     f" {c.as_dict()}")
            if d_med > med_tol or (bad_tol is not None and d_bad > bad_tol):
                fail(f"eval {interp} {scene}: card and CPU differ by "
                     f"{d_med} / {d_bad}")
    for scene in EPE_GATES["nearest"]:
        if not (card["bilinear"][scene].median_epe
                < card["nearest"][scene].median_epe):
            fail(f"eval {scene}: bilinear not ahead of nearest")
    occ = {}
    for interp in ("nearest", "bilinear"):
        r = ev.evaluate_occlusion(StereoEngine(MatcherConfig(interp=interp),
                                               device=dev))
        occ[interp] = r.as_dict()
        print(f"eval occlusion {interp}: matched median EPE "
              f"{r.matched_epe.median_epe:.4f}, confidence matched "
              f"{r.mean_conf_matched:.4f} occluded "
              f"{r.mean_conf_occluded:.4f}")
        if not r.mean_conf_matched > r.mean_conf_occluded:
            fail(f"eval occlusion {interp}: no confidence gap")
    print(f"eval: the card's table passes the gates and agrees with the "
          f"CPU's; {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    out["eval"] = {"table": rows, "occlusion": occ, "card_s": card_s,
                   "cpu_s": cpu_s}


def pipeline_phase(dev, cfg, left, right, left_np, right_np, near_ref,
                   report: dict) -> None:
    """Phase 3e: the runner, the service and the supervisor, the command
    line and the accuracy harness, writing only .npy, .txt, .json, .xml
    and .pcd files into a temporary directory."""
    import tempfile

    out = report["pipeline"] = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ugsm_smoke_") as d:
        tmp = Path(d)
        runner_phase(dev, cfg, left_np, right_np, near_ref, tmp, out)
        service_phase(dev, cfg, left, right, near_ref, out)
        torch.cuda.empty_cache()
        cli_phase(left_np, right_np, near_ref, tmp, out)
    eval_phase(dev, out)
    out["wall_s"] = time.perf_counter() - t0
    print(f"pipeline phase {out['wall_s']:.1f} s")


# Phase 3f sizes: the JAX bench's batched throughput (bench.py:406-408)
# and scaling probe (bench.py:463), and the processes' pairs
TPUT_H, TPUT_W, TPUT_BATCH = 815, 1231, 8
SCALE_H, SCALE_W = 408, 616
PROC_H, PROC_W, PROC_PAIRS = 816, 1232, 3
TRACE_KERNELS = ("warp_kernel", "direction_kernel", "smooth_chunk_kernel")


def synchronize_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def batched_throughput(dev, cfg, out: dict) -> None:
    """Phase 3f (a): StereoEngine.match_batch of 8 pairs at 815 x 1231
    (seeds SEED..SEED+7), mode 1 and foveated=True, in turn on this card
    (over a pairs-only mesh of the cards where there are several): each
    pair's launches those of a match, the value gates on pair 0, pairs/s
    from the least of three warm batches, and the busy share of one batch
    under the profiler."""
    from ug_stereomatcher_tpu_torch import StereoEngine, scene
    from ug_stereomatcher_tpu_torch.parallel import make_mesh, mesh_shape_for

    n = torch.cuda.device_count()
    mesh = make_mesh(*mesh_shape_for(n, n_pairs=TPUT_BATCH)) if n > 1 else None
    pairs = [scene.make_pair(TPUT_H, TPUT_W, seed=SEED + s)
             for s in range(TPUT_BATCH)]
    left = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    right = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    eng = StereoEngine(cfg, device=dev)
    fh, fw = cfg.fovea_dims(TPUT_H, TPUT_W)
    for label, fov in (("batched_throughput", False),
                       ("foveated_throughput", True)):
        def call():
            res = eng.match_batch(left, right, mesh=mesh, foveated=fov)
            synchronize_all()
            return res
        per_pair = expected_launches(cfg, TPUT_H, TPUT_W, foveated=fov)
        res, first_s, counts, _ = first_call(
            dev, label, call, {k: TPUT_BATCH * v for k, v in per_pair.items()})
        if fov:
            stack = torch.stack([res.stack_h[0], res.stack_v[0],
                                 res.stack_c[0]])
            check_planes(label, stack, (cfg.fovea_level * fh, fw))
            value_gates(f"{label} pair 0 level 0", stack[:, :fh], 32, 0.5)
        else:
            check_planes(label, res.triplet[:, 0], (TPUT_H, TPUT_W))
            value_gates(f"{label} pair 0", res.triplet[:, 0], 64, 0.5)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        sec = min(times)
        print(f"{label} {TPUT_H}x{TPUT_W} batch {TPUT_BATCH} on "
              f"{'one card' if mesh is None else mesh.shape}: "
              f"pairs_per_s={TPUT_BATCH / sec:.3f} seconds_per_batch="
              f"{sec:.4f} first_s={first_s:.3f} "
              f"times={[round(t, 4) for t in times]}")
        out[label] = {"shape": [TPUT_H, TPUT_W], "batch": TPUT_BATCH,
                      "seconds_per_batch": sec, "times_s": times,
                      "pairs_per_s": TPUT_BATCH / sec, "first_s": first_s,
                      "launches": counts,
                      "profile": profile_match(call, sec, label)}


def scaling_curves(dev, out: dict) -> None:
    """Phase 3f (b): measure_throughput at 408 x 616 in the dp, sp, hybrid
    and foveated dp families, at 1, 2 and 4 entries of this card (and over
    the cards where there are several), every point printed; then one sp
    batch on four shards of this card with its launches against the
    config's, its profile, and the wall and the host cost (device idle)
    per shard-iteration."""
    import dataclasses

    from ug_stereomatcher_tpu_torch import MatcherConfig
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    from ug_stereomatcher_tpu_torch.parallel import (
        make_batch_matcher, make_mesh, measure_throughput)

    curves = out["curves"] = {}
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    setups = [("one_card", [dev] * 4, [1, 2, 4])]
    if len(cards) > 1:
        setups.append(("cards", cards, None))
    cfg = MatcherConfig()
    for where, devices, counts in setups:
        for family in ("dp", "sp", "hybrid", "dp_fov"):
            pts = measure_throughput(
                SCALE_H, SCALE_W, device_counts=counts, cfg=cfg, repeats=3,
                mode=family.removesuffix("_fov"),
                foveated=family.endswith("_fov"), devices=devices)
            for pt in pts:
                print(f"scaling {where} {family} devices={pt.n_devices} "
                      f"mesh={pt.mesh_shape} batch={pt.batch} "
                      f"pairs_per_s={pt.pairs_per_second:.3f} "
                      f"seconds_per_batch={pt.seconds_per_batch:.5f} "
                      f"efficiency={pt.scaling_efficiency:.3f} "
                      f"oversubscribed={pt.oversubscribed}")
            curves[f"{where}_{family}"] = [dataclasses.asdict(pt)
                                           for pt in pts]
    sp4 = next(pt for pt in curves["one_card_sp"] if pt["n_devices"] == 4)
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    fn = make_batch_matcher(cfg, mesh)
    rng = np.random.RandomState(0)
    left = torch.from_numpy(
        rng.rand(1, 3, SCALE_H, SCALE_W).astype(np.float32) * 255).to(dev)
    right = torch.roll(left, 2, dims=-1)
    _, _, launches = counted(
        "scaling sp 4 shards", lambda: fn(left, right),
        expected_mesh_launches(cfg, SCALE_H, SCALE_W, [dev] * 4))
    shard_iters = launches["warp_row_halo"]
    prof = profile_match(lambda: fn(left, right), sp4["seconds_per_batch"],
                         "scaling sp 4 shards")
    wall_ms = sp4["seconds_per_batch"] * 1e3
    wall_per = wall_ms / shard_iters
    idle_per = (wall_ms - prof["device_busy_ms"]) / shard_iters
    print(f"scaling sp 4 shards of one card at {SCALE_H}x{SCALE_W}: "
          f"{shard_iters} shard-iterations, wall {wall_per:.4f} ms per "
          f"shard-iteration (the batch's wall over them), host cost "
          f"{idle_per:.4f} ms per shard-iteration (the wall less the "
          f"profiled device-busy time, over them), busy share "
          f"{prof['busy_share']:.3f}")
    out["sp4_host"] = {"shard_iterations": shard_iters,
                       "wall_ms_per_shard_iteration": wall_per,
                       "idle_ms_per_shard_iteration": idle_per,
                       "launches": launches, "profile": prof}


def process_child(backend: str) -> int:
    """One rank of phase 3f (c) or (d), started by ``run_ranks`` with
    torchrun's four variables: the process group (``backend="gloo"``
    passed explicitly, or the default for a card: NCCL), pod_mesh() of
    the group, and three 816 x 1232 pairs (seeds 0-2) through
    match_batch in mode 1 and mode 2, each returned pair against
    StereoEngine.match (match_foveated's stack) of that pair in this
    process, bit for bit, and this rank's launches those of its share (a
    pair row-sharded over its rows-group's cards counted as
    expected_mesh_launches counts it).  Prints one JSON line; exits 1 on
    a mismatch."""
    import os

    import torch.distributed as dist

    from ug_stereomatcher_tpu_torch import StereoEngine, MatcherConfig, scene
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    from ug_stereomatcher_tpu_torch.parallel import (
        initialize_distributed, pod_mesh)
    from ug_stereomatcher_tpu_torch.parallel.multihost import card_slots

    # this rank's first card, as card_slots gives it (torchrun's
    # LOCAL_WORLD_SIZE shares the host's cards out; without it each rank
    # drives every card it sees, from card 0)
    rank = int(os.environ.get("RANK", "0"))
    slots = card_slots(int(os.environ.get("WORLD_SIZE", "1")),
                       torch.cuda.device_count(),
                       int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    torch.cuda.set_device(next(s.device for s in slots
                               if s.process_index == rank))
    initialize_distributed(device="cuda",
                           backend="gloo" if backend == "gloo" else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"rank {rank} of {world}: backend {dist.get_backend()}"
          + (" (passed explicitly: NCCL refuses two ranks on one card)"
             if backend == "gloo" else " (the default for a card)"),
          file=sys.stderr)
    cfg = MatcherConfig()
    mesh = pod_mesh()
    pairs = [scene.make_pair(PROC_H, PROC_W, seed=s)
             for s in range(PROC_PAIRS)]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])
    eng = StereoEngine(cfg, device="cuda")
    mine = [i for i in range(PROC_PAIRS)
            if mesh.owner(i % mesh.shape["pairs"]) == rank]
    report = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "mesh": mesh.shape, "local_pairs": mesh.local_pairs(),
              "cards": [str(d) for d in mesh.local_devices()],
              "pairs_matched": mine, "device": torch.cuda.get_device_name(0)}
    ok = True
    for mode, fov in (("mode1", False), ("mode2", True)):
        want: dict = {}
        for i in mine:   # a pair's launches: whole, or on its rows-group
            devs = mesh.row_devices(i % mesh.shape["pairs"])
            per = (expected_launches(cfg, PROC_H, PROC_W, foveated=fov)
                   if len(devs) == 1 else expected_mesh_launches(
                       cfg, PROC_H, PROC_W, devs, foveated=fov))
            for k, v in per.items():
                want[k] = want.get(k, 0) + v
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        res = eng.match_batch(left, right, mesh=mesh, foveated=fov)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        eng.match_batch(left, right, mesh=mesh, foveated=fov)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        equal, single_s = [], 0.0
        for i in range(PROC_PAIRS):
            t0 = time.perf_counter()
            if fov:
                s = eng.match_foveated(left[i], right[i])
                ref = torch.stack([s.stack_h, s.stack_v, s.stack_c])
                got = torch.stack([res.stack_h[i], res.stack_v[i],
                                   res.stack_c[i]])
            else:
                ref = eng.match(left[i], right[i]).triplet
                got = res.triplet[:, i]
            torch.cuda.synchronize()
            single_s += time.perf_counter() - t0
            equal.append(bool(torch.equal(got, ref)))
        ok = ok and all(equal) and counts == want
        report[mode] = {"equal": equal, "launches": counts,
                        "expected_launches": want, "warm_batch_s": warm_s,
                        "single_sum_s": single_s}
    dist.destroy_process_group()
    print(json.dumps(report))
    return 0 if ok else 1


def run_ranks(label: str, world: int, backend: str, out: dict,
              per_rank_env=None, timeout: int = 600,
              torchrun: bool = False) -> None:
    """Start ``world`` ranks of process_child on a free local port (or,
    with ``torchrun``, one ``torchrun --standalone --nproc-per-node=world``
    that starts them and sets their variables, LOCAL_WORLD_SIZE
    included) and fail unless every rank exits 0 with every pair equal."""
    import os
    import socket

    child = [str(Path(__file__).resolve()), "--process-child", backend]
    if torchrun:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}"] + child,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(world)}
        procs = [subprocess.Popen(
            [sys.executable] + child,
            env={**env, "RANK": str(r), **(per_rank_env(r) if per_rank_env
                                           else {})},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    t0 = time.perf_counter()
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    reports = []
    for p, (stdout, stderr) in zip(procs, results):
        for line in stderr.splitlines():
            if line.startswith("rank "):
                print(f"{label} {line}")
        if p.returncode != 0:
            fail(f"{label}: a process exited {p.returncode}:\n"
                 f"{stdout[-2000:]}\n{stderr[-3000:]}")
        reports += [json.loads(line) for line in stdout.splitlines()
                    if line.startswith("{")]
    reports.sort(key=lambda rep: rep["rank"])
    if [rep["rank"] for rep in reports] != list(range(world)):
        fail(f"{label}: reports of ranks {[r['rank'] for r in reports]}")
    for rep in reports:
        for mode in ("mode1", "mode2"):
            m = rep[mode]
            launches = json.dumps(m["launches"], sort_keys=True)
            print(f"{label} rank {rep['rank']} {mode}: mesh {rep['mesh']}, "
                  f"pairs {rep['pairs_matched']} matched here on "
                  f"{rep['cards']}, launches {launches}, every pair equal "
                  f"to the single-process match: {m['equal']}, warm batch "
                  f"{m['warm_batch_s']:.4f} s (three single matches "
                  f"{m['single_sum_s']:.4f} s)")
    print(f"{label}: {world} rank(s) over {reports[0]['backend']}, "
          f"{wall:.1f} s wall")
    out[label] = {"world": world, "wall_s": wall, "ranks": reports}


def trace_phase(dev, cfg, left, right, out: dict) -> None:
    """Phase 3f (e): profiling.device_trace around one warm 16 MP match;
    the trace file must exist and name the warp, direction and smooth
    kernels."""
    import tempfile

    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch.profiling import device_trace

    eng = StereoEngine(cfg, device=dev)
    eng.match(left, right)
    with tempfile.TemporaryDirectory(prefix="ugsm_trace_") as d:
        with device_trace(d):
            eng.match(left, right)
        files = list(Path(d).glob("trace_*.json"))
        if len(files) != 1:
            fail(f"device_trace wrote {files}")
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in TRACE_KERNELS}
    print(f"device_trace: {size} bytes, {len(kernels)} kernel events, "
          f"{json.dumps(named)}")
    if not all(named.values()):
        fail(f"device_trace: the trace misses kernels: {named}")
    out["trace"] = {"bytes": size, "kernel_events": len(kernels),
                    "named": named}


def scaling_phase(dev, cfg, left, right, report: dict) -> None:
    """Phase 3f: mesh scaling and processes: (a) batched_throughput, (b)
    scaling_curves, (c) two gloo ranks, (d) one NCCL rank and, with
    several cards, two NCCL ranks on separate cards and two ranks under
    ``torchrun --nproc-per-node=2`` (each rank on its share of the cards,
    multihost.card_slots), (e) trace_phase."""
    out = report["scaling"] = {}
    t0 = time.perf_counter()
    batched_throughput(dev, cfg, out)
    torch.cuda.empty_cache()
    scaling_curves(dev, out)
    torch.cuda.empty_cache()
    run_ranks("processes_gloo", 2, "gloo", out)
    run_ranks("processes_nccl", 1, "nccl", out)
    if torch.cuda.device_count() > 1:
        run_ranks("processes_nccl_cards", 2, "nccl", out,
                  lambda r: {"CUDA_VISIBLE_DEVICES": str(r)})
        # each rank drives its share of the cards (card_slots): with four,
        # a rows-group over two cards a rank
        run_ranks("processes_torchrun", 2, "nccl", out, torchrun=True)
    else:
        print("processes_nccl_cards, processes_torchrun: one card, so two "
              "NCCL ranks on separate cards do not run")
    trace_phase(dev, cfg, left, right, out)
    out["wall_s"] = time.perf_counter() - t0
    print(f"scaling phase {out['wall_s']:.1f} s")


# Phase 3g: the lines of ``python -m ug_stereomatcher_tpu_torch bench``
# with BENCH_MODE=all at 16 MP, in the JAX bench's order (bench.py:579-614)
BENCH_ORDER = ("16mp_foveated_disparity_latency",
               "batched_throughput_815x1231", "foveated_throughput_815x1231",
               "16mp_mode1_bilinear_disparity_latency",
               "16mp_foveated_bilinear_disparity_latency",
               "16mp_mode1_ee_disparity_latency",
               "16mp_mode1_bilinear_ee_disparity_latency",
               "16mp_mode1_disparity_latency")


def bench_phase(kind: str, warm_median_s: float, report: dict) -> None:
    """Phase 3g: the port's bench in a subprocess (BENCH_MODE=all, 16 MP,
    BENCH_REPEATS=3), every line printed; it fails unless the bench exits
    0, its metrics come in the JAX bench's order, each line's
    extra.values pass the value gates (nearest 0.5, bilinear 0.1, frac >
    0.9) and name this card, and the mode-1 value lies within 0.5-1.5x of
    slice (a)'s warm median (a bench that timed the uploads or missed a
    synchronise would not)."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODE="all", BENCH_REPEATS="3")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ug_stereomatcher_tpu_torch",
                           "bench"], cwd=Path(__file__).resolve().parent,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    for line in lines:
        print(f"bench {json.dumps(line)}")
    if proc.returncode != 0:
        fail(f"bench: rc {proc.returncode}: {proc.stderr[-2000:]}")
    names = tuple(line["metric"] for line in lines)
    if names != BENCH_ORDER:
        fail(f"bench: metrics {names}, expected {BENCH_ORDER}")
    for line in lines:
        extra, gate = line["extra"], (0.1 if "bilinear" in line["metric"]
                                      else 0.5)
        v = extra["values"]
        if not (v["med_abs_dh_err"] < gate and v["mean_abs_dv"] < gate
                and v["frac_dh_err_lt_1"] > 0.9):
            fail(f"bench {line['metric']}: values {v} outside the gates "
                 f"({gate}, frac > 0.9)")
        if extra["device"] != kind:
            fail(f"bench {line['metric']}: device {extra['device']!r}, "
                 f"not {kind!r}")
    ratio = lines[-1]["value"] / warm_median_s
    print(f"bench: rc 0, {len(lines)} lines in {wall:.1f} s wall; mode1 "
          f"value {lines[-1]['value']:.5f} s = {ratio:.3f} x slice (a)'s "
          f"warm median {warm_median_s:.5f} s")
    if not 0.5 <= ratio <= 1.5:
        fail(f"bench: mode1 value {ratio:.3f} x slice (a)'s warm median, "
             f"outside 0.5-1.5")
    report["bench"] = {"wall_s": wall, "lines": lines,
                       "mode1_over_slice_a": ratio}


# name -> (source in csrc/, the TPU kernel's pallas_call it replaces,
#          which slice's launch count it reports[, the launch counter's
#          name where it is not the kernel's])
KERNELS = {
    "blur": ("blur.cu", "ops/pallas/blur.py:150", "nearest"),
    "resample": ("resample.cu", "ops/pallas/resample.py:223", "nearest"),
    "resample_bilinear": ("resample.cu", "ops/pallas/resample.py:223",
                          "bilinear"),
    "warp": ("warp.cu", "ops/pallas/warp.py:678", "nearest"),
    "warp_bilinear": ("warp.cu", "ops/pallas/warp.py:678", "bilinear"),
    "direction": ("direction.cu", "ops/pallas/direction.py:258", "nearest"),
    "smooth": ("smooth.cu", "ops/pallas/smooth.py:205", "nearest"),
    "level": ("level.cu", "ops/pallas/level.py:351", "nearest"),
    "warp_row_halo": ("warp.cu", "ops/pallas/warp.py:394", "sharded_nearest"),
    "warp_bilinear_row_halo": ("warp.cu", "ops/pallas/warp.py:394",
                               "sharded_bilinear"),
    "direction_row_halo": ("direction.cu", "ops/pallas/direction.py:258",
                           "sharded_nearest"),
    "smooth_row_halo": ("smooth.cu", "ops/pallas/smooth.py:205",
                        "sharded_nearest"),
    # mode 2: the level kernel at the fovea schedules, the windowed
    # resample of the fovea transitions
    "level_fovea": ("level.cu", "ops/pallas/level.py:351", "foveated",
                    "level"),
    "resample_fovea_window": ("resample.cu", "ops/pallas/resample.py:223",
                              "foveated", "resample"),
    "resample_bilinear_fovea_window": (
        "resample.cu", "ops/pallas/resample.py:223", "foveated_bilinear",
        "resample_bilinear"),
    # extras and geometry: the left-right check's warp of the backward
    # 2-plane stack, the point cloud's bilinear range-map resize
    "warp_consistency": ("warp.cu", "ops/pallas/warp.py:678", "consistency",
                         "warp"),
    "resample_bilinear_range_map": ("resample.cu",
                                    "ops/pallas/resample.py:223", "geometry",
                                    "resample_bilinear"),
    # early exit's convergence test: no pallas_call in the JAX package,
    # whose while loop computes it in XLA (weighted_difference)
    "convergence": ("convergence.cu", "ops/convergence.py:19",
                    "early_exit_nearest"),
}


# --ab's summary: every number a process reports (tree, name and round
# are labels)
AB_LABELS = ("tree", "name", "round")


def resample_cases(cfg):
    """The resample cases --ab times: (name, planes, source (h, w), output
    (h, w), coordinate scale, value scale, row_off, col_off) for the three
    16 MP resamples of a match (the sqrt(2) and x2 subsample of the
    stacked 6-plane level, the value-scaled upsample of the 3-plane
    state), the sqrt(2) subsample at level 8, the range map of a resized
    cloud (x0.2) and the fovea window (407 x 615 of the 576 x 870 grid)."""
    chain = cfg.dims_chain(H, W)
    fh, fw = cfg.fovea_dims(H, W)
    bh, bw = chain[cfg.fovea_level - 2]
    inv = 1.0 / cfg.scale
    return (("sqrt2", 6, chain[0], chain[1], cfg.scale, 1.0, 0, 0),
            ("x2", 6, chain[0], chain[2], 2.0, 1.0, 0, 0),
            ("up", 3, chain[1], chain[0], inv, cfg.scale, 0, 0),
            ("l8_sqrt2", 6, chain[COARSE_LEVEL], chain[COARSE_LEVEL + 1],
             cfg.scale, 1.0, 0, 0),
            ("range_map", 1, chain[0], (int(H * 0.2), int(W * 0.2)), 5.0,
             1.0, 0, 0),
            ("fovea", 3, (fh, fw), (fh, fw), inv, cfg.scale,
             bh // 2 - fh // 2, bw // 2 - fw // 2))


def time_resample(dev, resample, case, rand) -> dict:
    """One resample case in both methods: ``_ms`` the call on taps on the
    card (resample_static), ``_device_ms`` the same from a CUDA graph (the
    kernel alone), ``_tex_ms`` resample_tex (the host taps, their upload
    and the call), ``_tex_kept_ms`` resample_tex on the taps it keeps on
    the card (a tree with ScaleMap), ``_bound_ms``, and F.interpolate's
    call and device ms where one call computes the same function."""
    name, c, (sh, sw), (oh, ow), s, vs, r0, c0 = case
    src = rand(c, sh, sw, hi=255.0)

    def coord_of(t):
        return t * s
    times = {}
    for method in ("nearest", "bilinear"):
        bil = method == "bilinear"
        if bil:
            (iy, wy), (ix, wx) = (
                resample.bilinear_taps(oh, sh, coord_of, r0),
                resample.bilinear_taps(ow, sw, coord_of, c0))
            taps = (iy, ix, wy, wx)
        else:
            taps = (resample.nearest_indices(oh, sh, coord_of, r0),
                    resample.nearest_indices(ow, sw, coord_of, c0))
        iy_k, ix_k, *weights = (torch.from_numpy(a).to(dev) for a in taps)

        def call():
            return resample.resample_static(src, iy_k, ix_k, vs, *weights)

        def tex():
            return resample.resample_tex(src, oh, ow, coord_of, vs, method,
                                         r0, c0)
        key = f"resample_{method}_{name}"
        times[f"{key}_ms"] = cuda_ms(call)
        times[f"{key}_device_ms"] = graph_ms(call)
        times[f"{key}_tex_ms"] = cuda_ms(tex)
        kept = scale_map(s)
        if kept is not None:
            times[f"{key}_tex_kept_ms"] = cuda_ms(
                lambda: resample.resample_tex(src, oh, ow, kept, vs, method,
                                              r0, c0))
        times[f"{key}_bound_ms"] = bound(
            taps_bytes(src, oh, ow, taps[0], taps[1], bil),
            c * oh * ow * ((12 if bil else 0) + (vs != 1.0)))[0]
        library = (interpolate_resample(src, s, (oh, ow), method)
                   if vs == 1.0 and not (r0 or c0) else None)
        if library:
            times[f"interpolate_{method}_{name}_ms"] = cuda_ms(library)
            times[f"interpolate_{method}_{name}_device_ms"] = graph_ms(
                library)
    return times


def scale_map(factor: float):
    """ops.resample.ScaleMap(factor) of the port being timed, whose taps
    the resample wrapper keeps on the card; None in a tree without it."""
    from ug_stereomatcher_tpu_torch.ops import resample as plain

    sm = getattr(plain, "ScaleMap", None)
    return None if sm is None else sm(factor)


def host_costs(dev, resample) -> dict:
    """Host µs a call (this machine's CPU; host clock, the median of 7
    batches of 200 calls, the card not waited on: the kernel takes a few
    µs) of the bilinear range-map resample, 1 x 16 MP -> 652 x 985, and of
    the steps of its call: the numpy taps, their upload in four copies or
    one packed copy, the checks of the image and of four tap tensors, the
    output's allocation, the current device, the current stream as a
    torch.cuda.Stream or as its raw handle, the C entry called through
    ctypes (the launch included) and _build.launch around it;
    resample_static (taps on the card), resample_tex (the whole call; and
    on its kept taps, ``tex_kept``, in a tree with ScaleMap) and
    F.interpolate beside them."""
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    oh, ow = int(H * 0.2), int(W * 0.2)
    z = torch.rand(1, H, W, device=dev)

    def coord_of(t):
        return t * 5.0

    def taps():
        return (resample.bilinear_taps(oh, H, coord_of),
                resample.bilinear_taps(ow, W, coord_of))
    (iy, wy), (ix, wx) = taps()
    host = (iy, ix, wy, wx)
    packed = np.concatenate([a.view(np.int32) for a in host])
    on_card = [torch.from_numpy(a).to(dev) for a in host]

    def check_vectors():
        for v, dt in zip(on_card, (torch.int32,) * 2 + (torch.float32,) * 2):
            resample._check_vector("v", v, dt, z.device)
    out_buf = torch.empty((1, oh, ow), device=dev)
    c_name = "ugsm_resample_bilinear"
    args = [t.data_ptr() for t in (z, out_buf, *on_card)]
    args += [1, H, W, oh, ow, 1.0, 0]
    if len(_build.SIGNATURES[c_name]) > len(args) + 1:   # the launch shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        args += resample.bilinear_launch(1, oh, ow, sms)
    entry = getattr(_build.library(), c_name)
    stream = torch.cuda.current_stream().cuda_stream
    steps = {
        "taps": taps,
        "upload_four": lambda: [torch.from_numpy(a).to(dev, non_blocking=True)
                                for a in host],
        "upload_one": lambda: torch.from_numpy(packed).to(
            dev, non_blocking=True),
        "check_image": lambda: _build.check_planes("z", z),
        "check_vectors": check_vectors,
        "empty": lambda: torch.empty((1, oh, ow), device=dev),
        "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        "current_device": torch.cuda.current_device,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
        "ctypes_entry": lambda: entry(*args, stream),
        "build_launch": lambda: _build.launch(c_name, "host_costs", *args),
        "static": lambda: resample.resample_static(z, on_card[0], on_card[1],
                                                   1.0, *on_card[2:]),
        "tex": lambda: resample.resample_tex(z, oh, ow, coord_of, 1.0,
                                             "bilinear"),
        "interpolate": interpolate_resample(z, 5.0, (oh, ow), "bilinear"),
    }
    kept = scale_map(5.0)
    if kept is not None:   # a tree that keeps a call site's taps on the card
        steps["tex_kept"] = lambda: resample.resample_tex(z, oh, ow, kept,
                                                          1.0, "bilinear")
    out = {}
    for step, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        batches = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            batches.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        out[f"host_{step}_us"] = statistics.median(batches)
    return out


def ab_child(tree: str, matches: int) -> dict:
    """One --ab process: the port imported from ``tree``, timed."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import ug_stereomatcher_tpu_torch as port
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, scene
    from ug_stereomatcher_tpu_torch.ops.cuda import (
        blur, direction, level, resample, smooth, warp)
    from ug_stereomatcher_tpu_torch.parallel import row_splits

    where = Path(port.__file__).resolve()
    if Path(tree).resolve() not in where.parents:
        fail(f"imported {where}, not the port of {tree}")
    dev = torch.device("cuda")
    left_np, right_np = scene.make_pair(H, W, seed=SEED)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    times = {"tree": tree}

    def time_entry(label, interp, entry, early=None):
        eng = StereoEngine(MatcherConfig(interp=interp,
                                         early_exit_delta=early), device=dev)
        fn = getattr(eng, entry, None)
        if fn is None:   # a tree from before mode 2
            return
        fn(left, right)
        torch.cuda.synchronize()
        warm = []
        for _ in range(matches):
            t0 = time.perf_counter()
            fn(left, right)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        median = statistics.median(warm)
        prof = profile_match(lambda: fn(left, right), median, label)
        times.update({f"{label}_warm_s": warm,
                      f"{label}_warm_median_s": median,
                      f"{label}_busy_share": prof["busy_share"]})

    time_entry("match", "nearest", "match")
    time_entry("bilinear_match", "bilinear", "match")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    img = rand(3, H, W, hi=255.0)
    other = torch.clamp(img + rand(3, H, W, lo=-20.0, hi=20.0), 0, 255)
    bl2 = rand(3, H, W, hi=1e4)
    state = torch.stack([rand(H, W, lo=-2.0, hi=5.0),
                         rand(H, W, lo=-1.0, hi=1.0),
                         rand(H, W, lo=0.05, hi=1.0)])
    dh, dv = rand(H, W, lo=-24.0, hi=30.0), rand(H, W, lo=-12.0, hi=12.0)
    sh, sv = smooth_field(dev, H, W)
    a, b = row_splits(H, 4)[1]
    d = direction.HALO
    band_img = img[:, a - d:b + d].contiguous()
    band_other = other[:, a - d:b + d].contiguous()
    band_bl2, band_state = (x[:, a:b].contiguous() for x in (bl2, state))
    s = smooth.smooth_halo_rows(10)
    smooth_band = state[:, a - s:b + s].contiguous()
    times.update({
        "blur_ms": cuda_ms(lambda: blur.fused_blur_gaussian(img, "clamp")),
        "warp_ms": cuda_ms(lambda: warp.warp(img, dh, dv)),
        "warp_bilinear_ms": cuda_ms(
            lambda: warp.warp(img, dh, dv, "bilinear")),
        "warp_smooth_ms": cuda_ms(lambda: warp.warp(img, sh, sv)),
        "warp_bilinear_smooth_ms": cuda_ms(
            lambda: warp.warp(img, sh, sv, "bilinear")),
        "direction_ms": cuda_ms(lambda: direction.fused_direction_update(
            img, other, bl2, state, 1.0, False)),
        "direction_row_halo_ms": cuda_ms(
            lambda: direction.fused_direction_update(
                band_img, band_other, band_bl2, band_state, 1.0, False,
                row0=a, global_h=H)),
        "smooth0_ms": cuda_ms(lambda: smooth.fused_smooth_average(state, 0)),
        "smooth5_ms": cuda_ms(lambda: smooth.fused_smooth_average(state, 5)),
        "smooth_ms": cuda_ms(lambda: smooth.fused_smooth_average(state, 10)),
        "smooth_row_halo_ms": cuda_ms(lambda: smooth.fused_smooth_average(
            smooth_band, 10, row0=a, global_h=H)),
    })
    # the same 16 MP kernels alone (a CUDA graph), the host out of the way
    for key, call in (
            ("warp", lambda: warp.warp(img, dh, dv)),
            ("warp_bilinear", lambda: warp.warp(img, dh, dv, "bilinear")),
            ("direction", lambda: direction.fused_direction_update(
                img, other, bl2, state, 1.0, False)),
            ("smooth", lambda: smooth.fused_smooth_average(state, 10))):
        times[f"{key}_device_ms"] = graph_ms(call)
    del img, other, bl2, state, dh, dv, sh, sv, band_img, band_other
    del band_bl2, band_state, smooth_band

    cfg = MatcherConfig()
    chain = cfg.dims_chain(H, W)
    for lv in (COARSE_LEVEL, SMALL_LEVEL):
        args = level_inputs(dev, *chain[lv])
        mi = cfg.iters_for_level(lv)
        args += (cfg.threshold_schedule(mi), cfg.smooth_passes_for_level(lv),
                 False, cfg.conf_consts)
        times[f"level{lv}_ms"] = cuda_ms(
            lambda: level.level_resident_match(*args))
    stacked = rand(6, H, W, hi=255.0)
    times["blur_zero6_ms"] = cuda_ms(
        lambda: blur.fused_blur_gaussian(stacked, "zero"))
    del stacked
    # level 8: the call, and the kernel alone, of every per-iteration
    # kernel (a small level's call is the host's work)
    h8, w8 = chain[COARSE_LEVEL]
    img8 = rand(3, h8, w8, hi=255.0)
    state8 = torch.stack([rand(h8, w8, lo=-2.0, hi=5.0),
                          rand(h8, w8, lo=-1.0, hi=1.0),
                          rand(h8, w8, lo=0.05, hi=1.0)])
    for key, call in (
            ("blur_l8", lambda: blur.fused_blur_gaussian(img8, "clamp")),
            ("warp_l8", lambda: warp.warp(img8, state8[0], state8[1])),
            ("direction_l8", lambda: direction.fused_direction_update(
                img8, img8, img8, state8, 1.0, False)),
            ("smooth_l8", lambda: smooth.fused_smooth_average(state8, 5))):
        times[f"{key}_ms"] = cuda_ms(call)
        times[f"{key}_device_ms"] = graph_ms(call)
    del img8, state8
    for case in resample_cases(cfg):
        times.update(time_resample(dev, resample, case, rand))
    times.update(host_costs(dev, resample))
    # last, so that every tree's kernels are timed after the same work
    time_entry("foveated", "nearest", "match_foveated")
    # early exit at slices (k) and (l)'s thresholds
    time_entry("ee_match", "nearest", "match", early=0.1)
    time_entry("ee_bilinear_match", "bilinear", "match", early=0.02)
    return times


def ab(trees, rounds: int, matches: int, out) -> int:
    """--ab: the trees timed in turns, one process per tree and round."""
    smi = nvidia_smi()
    runs = []
    for r in range(rounds):
        for name, tree in (trees if r % 2 == 0 else trees[::-1]):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--ab-child",
                 tree, "--matches", str(matches), "--seed", str(SEED)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                fail(f"--ab: the process of {name} exited {proc.returncode}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run.update(name=name, round=r)
            runs.append(run)
            print(f"ab round {r} {name} done")
    print(f"nvidia-smi {smi}")
    summary = {}
    for name, _ in trees:
        mine = [x for x in runs if x["name"] == name]
        # a tree from before mode 2 has no foveated times
        keys = [k for k, v in mine[0].items() if k not in AB_LABELS
                and isinstance(v, (int, float))
                and all(k in x for x in mine)]
        summary[name] = {k: {"median": statistics.median(x[k] for x in mine),
                             "min": min(x[k] for x in mine),
                             "max": max(x[k] for x in mine)}
                         for k in keys}
    for k in summary[trees[0][0]]:
        print(f"ab {k}: " + "  ".join(
            f"{name} {v[k]['median']:.6g} [{v[k]['min']:.6g}, "
            f"{v[k]['max']:.6g}]" for name, v in summary.items() if k in v))
    if out:
        with open(out, "w") as fh:
            json.dump({"nvidia_smi": smi, "runs": runs, "summary": summary},
                      fh, indent=1)
    return 0


def gate_sweep(dev, cfg, left, right, gates, rounds: int,
               report: dict) -> None:
    """--gates: the warm 16 MP nearest latency at each level-resident
    gate, one match per gate per round, the order of the gates reversed
    every other round (host clock around a synchronised call)."""
    from ug_stereomatcher_tpu_torch import StereoEngine

    engines = {g: StereoEngine(cfg, device=dev, resident_max_pixels=g)
               for g in gates}
    times = {g: [] for g in gates}
    for g in gates:  # warm every route once
        engines[g].match(left, right)
    torch.cuda.synchronize()
    for r in range(rounds):
        for g in (gates if r % 2 == 0 else gates[::-1]):
            t0 = time.perf_counter()
            engines[g].match(left, right)
            torch.cuda.synchronize()
            times[g].append(time.perf_counter() - t0)
    rows = []
    for g in gates:
        ts = sorted(times[g])
        row = {"gate_pixels": g, "warm_median_s": statistics.median(ts),
               "q1_s": ts[len(ts) // 4], "q3_s": ts[(3 * len(ts)) // 4],
               "warm_s": times[g]}
        rows.append(row)
        print(f"gate_sweep gate={g} warm_median_s={row['warm_median_s']:.4f}"
              f" q1={row['q1_s']:.4f} q3={row['q3_s']:.4f}")
    report["gate_sweep"] = rows


def main() -> int:
    global SEED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report here as JSON")
    ap.add_argument("--ab", action="append", default=[],
                    metavar="NAME=PATH",
                    help="compare source trees instead (give two or more)")
    ap.add_argument("--rounds", type=int,
                    help="rounds of --ab (default 2) or --gates (8)")
    ap.add_argument("--matches", type=int, default=7)
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the scene, the inputs and the fields")
    ap.add_argument("--ab-child", help=argparse.SUPPRESS)
    ap.add_argument("--process-child", help=argparse.SUPPRESS)
    ap.add_argument("--gates", help="time the match at these comma-"
                    "separated level-resident gates instead")
    args = ap.parse_args()
    SEED = args.seed

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    if args.ab_child:
        print(json.dumps(ab_child(args.ab_child, args.matches)))
        return 0
    if args.process_child:
        return process_child(args.process_child)
    if args.ab:
        trees = [t.split("=", 1) for t in args.ab]
        if len(trees) < 2 or any(len(t) != 2 for t in trees):
            ap.error("give at least two --ab NAME=PATH")
        return ab(trees, args.rounds or 2, args.matches, args.out)
    from ug_stereomatcher_tpu_torch import MatcherConfig, scene
    from ug_stereomatcher_tpu_torch.device import resolve_device
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    from ug_stereomatcher_tpu_torch.parallel import make_mesh

    dev = resolve_device("cuda")
    cfg = MatcherConfig()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}")
    print(f"nvidia-smi {smi}")
    if args.gates:
        gates = [int(g) for g in args.gates.split(",")]
        left_np, right_np = scene.make_pair(H, W, seed=SEED)
        left = torch.from_numpy(left_np).to(dev)
        right = torch.from_numpy(right_np).to(dev)
        report = {"device": kind, "nvidia_smi": smi}
        level_table(dev, cfg, left, right, report)
        gate_sweep(dev, cfg, left, right, gates, args.rounds or 8, report)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=1)
        return 0
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.2f} s -> {_build.build()}")

    kernels: dict = {}
    report = {"device": kind, "nvidia_smi": smi, "build_s": build_s,
              "kernels": kernels}
    check_kernels(dev, cfg, kernels)
    check_level(dev, cfg, kernels)
    check_fovea_kernels(dev, cfg, kernels)

    t0 = time.perf_counter()
    left_np, right_np = scene.make_pair(H, W, seed=SEED)
    print(f"scene {H}x{W} made in {time.perf_counter() - t0:.2f} s "
          f"(known shift {scene.SHIFT_PX} px)")
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    slices = report["slices"] = {}
    bil = MatcherConfig(interp="bilinear")
    slices["nearest"], near_ref = run_slice(dev, cfg, left, right, "nearest",
                                            0.5)
    slices["nearest_per_iteration"], _ = run_slice(
        dev, cfg, left, right, "nearest_per_iteration", 0.5,
        resident_max_pixels=0)
    slices["bilinear"], bil_ref = run_slice(dev, bil, left, right,
                                            "bilinear", 0.1)
    a, b = slices["nearest"], slices["nearest_per_iteration"]
    print(f"gate warm_median_s resident={a['warm_median_s']:.4f} "
          f"per_iteration={b['warm_median_s']:.4f} busy_share "
          f"resident={a['profile']['busy_share']:.3f} "
          f"per_iteration={b['profile']['busy_share']:.3f}")
    torch.cuda.empty_cache()

    # The row-sharded slices: four shards of the pair on this one card.
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    for label, c, gate, ref in (("sharded_nearest", cfg, 0.5, near_ref),
                                ("sharded_bilinear", bil, 0.1, bil_ref)):
        slices[label], trip = run_slice(dev, c, left, right, label, gate,
                                        mesh=mesh)
        check_same(label, trip, ref)
        del trip
    del bil_ref
    torch.cuda.empty_cache()
    pair_batch(dev, cfg, report)
    across_cards(dev, cfg, left, right, near_ref, report)
    torch.cuda.empty_cache()
    mode2_slices(dev, cfg, bil, left, right, slices)
    extras(dev, cfg, bil, left, right, left_np, near_ref, slices, kernels,
           report)
    graphs_phase(dev, cfg, left, right, report)
    pipeline_phase(dev, cfg, left, right, left_np, right_np, near_ref, report)
    torch.cuda.empty_cache()
    scaling_phase(dev, cfg, left, right, report)
    torch.cuda.empty_cache()
    bench_phase(kind, slices["nearest"]["warm_median_s"], report)
    del near_ref
    level_table(dev, cfg, left, right, report)
    lockstep_level(dev, cfg, left, right, report)

    jaxy = [m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m.split(".")[0] == "ug_stereomatcher_tpu"]
    if jaxy:
        fail(f"the JAX package was imported: {jaxy[:5]}")

    rows = []
    for name, (src, replaces, path, *counter) in KERNELS.items():
        launches = slices[path]["launches"].get(
            counter[0] if counter else name, 0)
        if launches < 1:
            fail(f"{name}: not launched on the {path} main path")
        k = kernels[name]
        # the first timed case: 16 MP (the stacked 6-plane zero blur and
        # subsample, replace=False, n_smooth=10; the row-sharded forms on
        # the middle shard of four, 816 rows); level 8 for the level
        # kernel (nearest, replace_first off), its fovea level 0 for
        # level_fovea (2 iterations, 10 passes)
        case = next(c for c in k["cases"] if "ms" in c)
        rows.append({"name": name, "route": "cuda",
                     "source": f"ug_stereomatcher_tpu_torch/csrc/{src}",
                     "replaces": f"ug_stereomatcher_tpu/{replaces}",
                     "launches": launches,
                     "max_abs_err": k["max_abs_err"],
                     "ms": case["ms"], "device_ms": case.get("device_ms"),
                     "plain_ms": case["plain_ms"],
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"],
                     "library_ms": case["library_ms"]})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
