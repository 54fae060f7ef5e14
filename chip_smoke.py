#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: mode 1 at 16 MP through
the hand-written Hopper kernels, nearest and bilinear.

Phases (any failure exits non-zero before the last line is printed):

1. device: nvidia-smi name and power limit, torch and CUDA versions, and
   the nvcc build of the kernel library from the sources in csrc/;
2. kernels: each kernel against its plain PyTorch version on the card,
   with the median time of each beside the other (CUDA events):
   blur, resample (nearest and bilinear), warp (nearest and bilinear),
   direction and smooth at the 16 MP level-0 shape and at pyramid level 8
   (202 x 306), and the level-resident kernel at levels 8 and 13 in both
   methods with replace_first on and off; each kernel's least possible
   time on the card (bound) and, where one PyTorch call computes the same
   function, that call's time;
3. slices: StereoEngine.match on the 1/f octave scene with a known 3 px
   shift at 3264 x 4928, (a) nearest with the level-resident gate, (b)
   nearest with every level per iteration, (c) bilinear: the value gates
   of the JAX package's on-chip check on [64:-64, 64:-64], the launch
   count of every kernel against the count the config implies, first-call
   and warm latency, peak device memory, and the kernel time by name over
   one warm match (torch.profiler) with the device's busy share; then
   levels 5-13 of the nearest match timed level-resident against per
   iteration;
4. lockstep: pyramid level 4 (815 x 1231) refined from one input state
   by the kernels and by the plain versions on the card, held to the
   repo's quantile rule (q99 <= 2e-3, max <= 0.05);
5. a JSON line of the kernels, the nvidia-smi line, and the last line
   {"ok": true, "device": {...}}.

It imports torch, numpy and the port, never jax.  Usage:
    python3 chip_smoke.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 3264, 4928          # the published 16 MP frame
COARSE_LEVEL = 8           # 202 x 306 on the 16 MP chain
SMALL_LEVEL = 13           # 34 x 53, the coarsest
LOCKSTEP_LEVEL = 4         # 815 x 1231
TABLE_LEVELS = range(5, 14)
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


def expected_launches(cfg, h: int, w: int, resident_max_pixels=None) -> dict:
    """Kernel launches of one StereoEngine.match, derived from the config:
    one level-resident launch per gated level; warp, direction and smooth
    once per iteration of every other level, each with one G(L^2) blur;
    the pyramid blurs that feed a resample (levels 0 .. n-3); n-1
    subsamples and n-1 upsamples (2(n-1) upsamples when confidence is
    resampled on its own).  Bilinear forms count under their own names."""
    from ug_stereomatcher_tpu_torch.match import uses_level_resident

    n = cfg.num_levels(h, w)
    dims = cfg.dims_chain(h, w)[:n]
    resident = [i for i in range(n)
                if uses_level_resident(*dims[i], resident_max_pixels)]
    iters = sum(cfg.iters_for_level(i) for i in range(n) if i not in resident)
    pyramid_blurs = (1 + max(0, n - 3)) if n > 1 else 0
    upsamples = (n - 1) * (1 if cfg.scale_conf_on_upsample else 2)
    form = "" if cfg.interp == "nearest" else f"_{cfg.interp}"
    counts = {f"warp{form}": iters, "direction": iters, "smooth": iters,
              "blur": (n - len(resident)) + pyramid_blurs,
              f"resample{form}": (n - 1) + upsamples,
              "level": len(resident)}
    return {k: v for k, v in counts.items() if v}


def grid_sample_warp(img, dh, dv, mode):
    """F.grid_sample of the same backward warp (texel centres at x + 0.5,
    clamp addressing as padding_mode="border"), one PyTorch call."""
    import torch.nn.functional as F

    _, h, w = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    grid = torch.stack([(2.0 * (xs + dh) + 1.0) / w - 1.0,
                        (2.0 * (ys + dv) + 1.0) / h - 1.0], dim=-1)[None]
    x = img[None]
    return lambda: F.grid_sample(x, grid, mode=mode, padding_mode="border",
                                 align_corners=False)


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
        for method, name in (("nearest", "warp"),
                             ("bilinear", "warp_bilinear")):
            compare(report, name, tag, warp.warp, warp.warp_plain,
                    (left, dh, dv, method),
                    work=(8 * hw * 4.0, WARP_OPS[method] * hw),
                    library=grid_sample_warp(left, dh, dv, method))
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
        del left, warped, bl2, state, stacked, up_src, dh, dv, sq
        torch.cuda.empty_cache()


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
          f"co-resident blocks of 512 threads")
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
        del left, right, state
    torch.cuda.empty_cache()


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


def run_slice(dev, cfg, left, right, label: str, gate: float,
              resident_max_pixels=None) -> dict:
    """Phase 3: one 16 MP match configuration through the kernels: value
    gates (med|dh-3| < gate, mean|dv| < gate, frac(|dh-3| < 1) > 0.9),
    launch counts, latency, peak memory and the profile."""
    from ug_stereomatcher_tpu_torch import StereoEngine, scene
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    eng = StereoEngine(cfg, device=dev,
                       resident_max_pixels=resident_max_pixels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.match(left, right)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = expected_launches(cfg, H, W, resident_max_pixels)
    print(f"{label} launches {json.dumps(counts, sort_keys=True)} expected "
          f"{json.dumps(want, sort_keys=True)}")
    if counts != want:
        fail(f"{label}: launch counts {counts} differ from the config's "
             f"{want}")

    dh, dv, conf = res.disparity_h, res.disparity_v, res.confidence
    for name, plane in (("disparity_h", dh), ("disparity_v", dv),
                        ("confidence", conf)):
        if tuple(plane.shape) != (H, W):
            fail(f"{label}: {name} has shape {tuple(plane.shape)}")
        if not torch.isfinite(plane).all().item():
            fail(f"{label}: {name} has non-finite values")
    errh = (dh[64:-64, 64:-64] - scene.SHIFT_PX).abs()
    med = errh.median().item()
    frac = (errh < 1.0).float().mean().item()
    mean_dv = dv[64:-64, 64:-64].abs().mean().item()
    print(f"{label} values med|dh-3|={med:.4f} frac(|dh-3|<1)={frac:.4f} "
          f"mean|dv|={mean_dv:.4f} mean conf={conf.mean().item():.4f}")
    if not (med < gate and mean_dv < gate and frac > 0.9):
        fail(f"{label}: 16 MP value gates (med|dh-3| < {gate}, mean|dv| < "
             f"{gate}, frac(|dh-3| < 1) > 0.9)")
    del res, dh, dv, conf, errh

    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.match(left, right)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    median = statistics.median(warm)
    print(f"{label} first_call_s={first_s:.4f} warm_median_s={median:.4f} "
          f"warm_s={[round(x, 4) for x in warm]} peak_mem_bytes={peak}")
    return {"first_call_s": first_s, "warm_s": warm, "warm_median_s": median,
            "peak_mem_bytes": peak, "med_abs_dh_err": med,
            "frac_dh_err_lt_1": frac, "mean_abs_dv": mean_dv,
            "launches": counts,
            "profile": profile_match(eng, left, right, median, label)}


def profile_match(eng, left, right, warm_s: float, label: str) -> dict:
    """Kernel time by name over one warm match (torch.profiler), and the
    device's busy share of the unprofiled warm latency ``warm_s``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        eng.match(left, right)
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
    return {"device_busy_ms": busy_ms, "warm_latency_s": warm_s,
            "busy_share": busy_ms / (warm_s * 1e3), "kernels": rows}


def level_table(dev, cfg, left, right, report: dict) -> None:
    """Phase 3b: each level 5-13 of the nearest 16 MP match, from the
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


# name -> (source in csrc/, the TPU kernel's pallas_call it replaces,
#          which slice's launch count it reports)
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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report here as JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    from ug_stereomatcher_tpu_torch import MatcherConfig, scene
    from ug_stereomatcher_tpu_torch.device import resolve_device
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    dev = resolve_device("cuda")
    cfg = MatcherConfig()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}")
    print(f"nvidia-smi {smi}")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.2f} s -> {_build.build()}")

    kernels: dict = {}
    report = {"device": kind, "nvidia_smi": smi, "build_s": build_s,
              "kernels": kernels}
    check_kernels(dev, cfg, kernels)
    check_level(dev, cfg, kernels)

    t0 = time.perf_counter()
    left_np, right_np = scene.make_pair(H, W, seed=SEED)
    print(f"scene {H}x{W} made in {time.perf_counter() - t0:.2f} s "
          f"(known shift {scene.SHIFT_PX} px)")
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    slices = report["slices"] = {}
    slices["nearest"] = run_slice(dev, cfg, left, right, "nearest", 0.5)
    slices["nearest_per_iteration"] = run_slice(
        dev, cfg, left, right, "nearest_per_iteration", 0.5,
        resident_max_pixels=0)
    slices["bilinear"] = run_slice(dev, MatcherConfig(interp="bilinear"),
                                   left, right, "bilinear", 0.1)
    a, b = slices["nearest"], slices["nearest_per_iteration"]
    print(f"gate warm_median_s resident={a['warm_median_s']:.4f} "
          f"per_iteration={b['warm_median_s']:.4f} busy_share "
          f"resident={a['profile']['busy_share']:.3f} "
          f"per_iteration={b['profile']['busy_share']:.3f}")
    torch.cuda.empty_cache()
    level_table(dev, cfg, left, right, report)
    lockstep_level(dev, cfg, left, right, report)

    jaxy = [m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m.split(".")[0] == "ug_stereomatcher_tpu"]
    if jaxy:
        fail(f"the JAX package was imported: {jaxy[:5]}")

    rows = []
    for name, (src, replaces, path) in KERNELS.items():
        launches = slices[path]["launches"].get(name, 0)
        if launches < 1:
            fail(f"{name}: not launched on the {path} main path")
        k = kernels[name]
        # the first timed case: 16 MP (the stacked 6-plane zero blur and
        # subsample, replace=False, n_smooth=10); level 8 for the level
        # kernel (nearest, replace_first off)
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
