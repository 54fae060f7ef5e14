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
   each kernel's least possible time on the card (bound) and, where one
   PyTorch call computes the same function, that call's time;
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
   the 1 x N mesh across the cards where there are several; mode 2 on
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
   (k) nearest at 0.1 px and (l) bilinear at 0.02 px (the iterations of
   each per-iteration level from its warp launches, the host reads, the
   launch counts against those iterations with the level kernel at 8,
   the value gates, latency and busy share beside (a) and (c)), the
   convergence trace at level 4, match_with_consistency (the consistent
   share on [64:-64, 64:-64] > 0.9, one warp launch beyond the two
   matches), profile_match equal to (a) with its per-level breakdown,
   warmup and get_disparities equal to match and match_foveated, and on
   the verged rig of tests/test_geom.py scaled to 4928 x 3264 the
   full-resolution point cloud of (a) (finite share; a float64
   least-squares gold on 4096 seeded pixels, q99 <= 1e-3), the resized
   clouds at 0.2 (bilinear through the resample kernel, which is held
   against its plain version on that range map, and cubic) and the
   foveated cloud of (f), each timed with its device part; then phase
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
StereoEngine.match nearest and bilinear and match_foveated nearest
(where the tree has it) on the bench scene, warm (host clock around a
synchronised call, median of ``--matches`` after one warm-up), each with
the device's busy share of one profiled match; the
whole-image blur, warp (nearest and bilinear, on the random and the
smooth field), direction and smooth (n = 0, 5 and 10) kernels at 16
MP, the 6-plane zero-boundary blur of the stacked pyramid level, and
the row-sharded direction and smooth (n = 10) on the middle shard of
four; the level-resident kernel at levels 8 and 13 (nearest,
replace_first off) and the nearest and bilinear resample at the sqrt(2)
subsample of six stacked 16 MP planes, each with cuda_ms.  It prints a
JSON line per process, the nvidia-smi line and per tree the median,
least and greatest of each:
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
            timed: bool = True) -> None:
    """Run ``kernel`` and ``plain`` on the same inputs, hold them to
    ``rule`` ("exact", "close" = the repo's quantile rule, "allclose" =
    rtol=atol=1e-4), time both, and record the case under ``name``."""
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
    del out, ref, d
    entry["cases"].append(case)
    times = " ".join(f"{k}={case[k]:.4f}" for k in
                     ("ms", "plain_ms", "bound_ms", "library_ms")
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
        del left, warped, bl2, state, stacked, up_src, dh, dv, sq, sh, sv
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
                        library=library, timed=timed)
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
                    library=library)
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
    """With more than one card: the 1 x N mesh over the cards, checked
    against the unsharded slice and timed warm."""
    from ug_stereomatcher_tpu_torch import StereoEngine
    from ug_stereomatcher_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    mesh = make_mesh(1, n)
    eng = StereoEngine(cfg, device=dev)
    out = eng.match_batch(left[None], right[None], mesh=mesh).triplet[:, 0]
    check_same(f"across_cards 1x{n}", out, ref)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.match_batch(left[None], right[None], mesh=mesh)
        warm.append(time.perf_counter() - t0)
    print(f"across_cards 1x{n} warm_median_s={statistics.median(warm):.4f} "
          f"warm_s={[round(x, 4) for x in warm]}")
    report["across_cards"] = {"cards": n, "warm_s": warm}


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
    """Phase 3d, (k) and (l): StereoEngine.match with early exit.  The
    counts are set to 0 just before the match and read just after: warp,
    direction and smooth once per iteration that ran (the host reads of
    the exit test, one per iteration of levels 0-5), the level kernel
    still at 8, the rest as in the fixed schedule.  Then each level
    driven alone from the same pyramid gives its iterations (warp
    launches) and the same bits.  Value gates, latency and busy share
    beside the fixed schedule's slice ``ref_summary``."""
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
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_launches(cfg, H, W)
    form = "" if cfg.interp == "nearest" else f"_{cfg.interp}"
    full = want[f"warp{form}"]
    for name in (f"warp{form}", "direction", "smooth"):
        want[name] = syncs
    print(f"{label} launches {json.dumps(counts, sort_keys=True)} expected "
          f"{json.dumps(want, sort_keys=True)}; host reads {syncs}, "
          f"iterations {syncs} of {full}")
    if counts != want or not 0 < syncs <= full:
        fail(f"{label}: launch counts {counts} differ from {want}")
    check_planes(label, trip, (H, W))
    vals = value_gates(label, trip, 64, gate)

    # each per-iteration level alone, from the same pyramid and states
    n = cfg.num_levels(H, W)
    dims = cfg.dims_chain(H, W)
    lp, rp = pyr.build_pyramid_pair(
        left.movedim(-1, 0).float().contiguous(),
        right.movedim(-1, 0).float().contiguous(), cfg, n)
    state = torch.zeros((3,) + tuple(dims[n - 1]), device=dev)
    iters = {}
    for i in range(n - 1, -1, -1):
        _build.reset_launch_counts()
        state = match_mod.match_level(lp[i], rp[i], state, i, cfg, i == n - 1)
        torch.cuda.synchronize()
        if not match_mod.uses_level_resident(*dims[i]):
            iters[i] = _build.launch_counts().get(f"warp{form}", 0)
        if i:
            state = pyr.upsample_to_level(state, *dims[i - 1], cfg)
    same = torch.equal(state, trip)
    print(f"{label} iterations per level (warp launches) "
          + " ".join(f"{i}:{k}/{cfg.iters_for_level(i)}"
                     for i, k in sorted(iters.items()))
          + f"; level by level equals the match: {same}")
    if not same or sum(iters.values()) != syncs:
        fail(f"{label}: the levels driven alone differ from the match")
    summary = warm_summary(label, call, first_s, counts, peak)
    print(f"{label} warm_median_s={summary['warm_median_s']:.4f} busy_share="
          f"{summary['profile']['busy_share']:.3f} against the fixed "
          f"schedule's {ref_summary['warm_median_s']:.4f} / "
          f"{ref_summary['profile']['busy_share']:.3f}")
    return {**summary, **vals, "host_syncs": syncs,
            "iterations_per_level": iters, "fixed_iterations": full}


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
}


AB_TIMES = ("match_warm_median_s", "match_busy_share",
            "bilinear_match_warm_median_s", "bilinear_match_busy_share",
            "foveated_warm_median_s", "foveated_busy_share",
            "blur_ms", "blur_zero6_ms", "warp_ms", "warp_bilinear_ms",
            "warp_smooth_ms", "warp_bilinear_smooth_ms", "direction_ms",
            "direction_row_halo_ms", "smooth0_ms", "smooth5_ms", "smooth_ms",
            "smooth_row_halo_ms", "level8_ms", "level13_ms", "resample_ms",
            "resample_bilinear_ms")


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

    def time_entry(label, interp, entry):
        eng = StereoEngine(MatcherConfig(interp=interp), device=dev)
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
    (h1, w1) = chain[1]

    def coord_of(t):
        return t * cfg.scale
    iy, ix = (torch.from_numpy(resample.nearest_indices(n, m, coord_of)).to(
        dev) for n, m in ((h1, H), (w1, W)))
    times["resample_ms"] = cuda_ms(
        lambda: resample.resample_static(stacked, iy, ix))
    (iy, wy), (ix, wx) = (
        (torch.from_numpy(a).to(dev) for a in resample.bilinear_taps(
            n, m, coord_of)) for n, m in ((h1, H), (w1, W)))
    times["resample_bilinear_ms"] = cuda_ms(
        lambda: resample.resample_static(stacked, iy, ix, 1.0, wy, wx))
    del stacked
    # last, so that every tree's kernels are timed after the same work
    time_entry("foveated", "nearest", "match_foveated")
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
            print(json.dumps(run))
    print(f"nvidia-smi {smi}")
    summary = {}
    for name, _ in trees:
        mine = [x for x in runs if x["name"] == name]
        # a tree from before mode 2 has no foveated times
        summary[name] = {k: {"median": statistics.median(x[k] for x in mine),
                             "min": min(x[k] for x in mine),
                             "max": max(x[k] for x in mine)}
                         for k in AB_TIMES if all(k in x for x in mine)}
        print(f"{name}: " + " ".join(
            f"{k}={v['median']:.4f} [{v['min']:.4f}, {v['max']:.4f}]"
            for k, v in summary[name].items()))
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
    if torch.cuda.device_count() > 1:
        across_cards(dev, cfg, left, right, near_ref, report)
    torch.cuda.empty_cache()
    mode2_slices(dev, cfg, bil, left, right, slices)
    extras(dev, cfg, bil, left, right, left_np, near_ref, slices, kernels,
           report)
    pipeline_phase(dev, cfg, left, right, left_np, right_np, near_ref, report)
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
                     "ms": case["ms"], "plain_ms": case["plain_ms"],
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
