#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: mode 1 at 16 MP through
the hand-written Hopper kernels.

Phases (any failure exits non-zero before the last line is printed):

1. device: nvidia-smi name and power limit, torch and CUDA versions, and
   the nvcc build of the kernel library from the sources in csrc/;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the 16 MP level-0 shape and at a coarse level (202 x 306), with the
   median time of each beside the other (CUDA events);
3. slice: StereoEngine(MatcherConfig(), device="cuda").match on the 1/f
   octave scene with a known 3 px shift at 3264 x 4928: the value gates
   of the JAX package's on-chip check on [64:-64, 64:-64], the launch
   count of every kernel against the count the config implies, the
   first-call and warm latency, the peak device memory, and the kernel
   time by name over one warm match (torch.profiler) with the device's
   busy share of the warm latency;
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

import torch

H, W = 3264, 4928          # the published 16 MP frame
COARSE_LEVEL = 8           # 202 x 306 on the 16 MP chain
LOCKSTEP_LEVEL = 4         # 815 x 1231
SEED = 0


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


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def expected_launches(cfg, h: int, w: int) -> dict:
    """Kernel launches of one StereoEngine.match, derived from the config:
    warp, direction and smooth once per iteration; one G(L^2) blur per
    level plus the pyramid blurs that feed a resample (levels 0 .. n-3);
    n-1 subsamples and n-1 upsamples (2(n-1) upsamples when confidence
    is resampled on its own)."""
    n = cfg.num_levels(h, w)
    iters = sum(cfg.iters_for_level(i) for i in range(n))
    pyramid_blurs = (1 + max(0, n - 3)) if n > 1 else 0
    upsamples = (n - 1) * (1 if cfg.scale_conf_on_upsample else 2)
    return {"warp": iters, "direction": iters, "smooth": iters,
            "blur": n + pyramid_blurs, "resample": (n - 1) + upsamples}


def check_kernels(dev, cfg, report: dict) -> None:
    """Phase 2: every kernel against its plain version, two shapes."""
    from ug_stereomatcher_tpu_torch.ops.cuda import (
        blur, direction, resample, smooth, warp)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    chain = cfg.dims_chain(H, W)
    for tag, level in (("16mp", 0), ("coarse", COARSE_LEVEL)):
        h, w = chain[level]
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
        cases = {
            "blur": [(blur.fused_blur_gaussian, blur.fused_blur_gaussian_plain,
                      (stacked, "zero")),
                     (blur.fused_blur_gaussian, blur.fused_blur_gaussian_plain,
                      (left * left, "clamp"))],
            "resample": [],
            "warp": [(warp.warp_nearest, warp.warp_nearest_plain,
                      (left, dh, dv))],
            "direction": [(direction.fused_direction_update,
                           direction.fused_direction_update_plain,
                           (left, warped, bl2, state, thr, rep,
                            cfg.conf_consts))
                          for thr, rep in ((1.0, False), (0.55, True))],
            "smooth": [(smooth.fused_smooth_average,
                        smooth.fused_smooth_average_plain, (state, smooth_n))],
        }
        for src, (oh, ow), coord_of, vs in (
                (stacked, (h1, w1), lambda t: t * cfg.scale, 1.0),
                (stacked, (h2, w2), lambda t: t * 2.0, 1.0),
                (up_src, (h, w), lambda t: t * (1.0 / cfg.scale), cfg.scale)):
            iy = torch.from_numpy(resample.nearest_indices(
                oh, src.shape[1], coord_of)).to(dev)
            ix = torch.from_numpy(resample.nearest_indices(
                ow, src.shape[2], coord_of)).to(dev)
            cases["resample"].append((resample.resample_static,
                                      resample.resample_static_plain,
                                      (src, iy, ix, vs)))
        for name, runs in cases.items():
            entry = report.setdefault(name, {"max_abs_err": 0.0,
                                             "bit_exact": True})
            for i, (kernel, plain, args) in enumerate(runs):
                out = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                if out.shape != ref.shape:
                    fail(f"{name} {tag}: shape {tuple(out.shape)} vs "
                         f"{tuple(ref.shape)}")
                exact = torch.equal(out, ref)
                err = (out - ref).abs().max().item()
                if not exact:
                    within = ((out - ref).abs()
                              <= 1e-5 * ref.abs().clamp(min=1.0)).all().item()
                    if name not in ("direction", "smooth") or not within:
                        fail(f"{name} {tag}: kernel disagrees with its plain "
                             f"version (max |d| {err})")
                entry["bit_exact"] &= exact
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                ms = cuda_ms(lambda: kernel(*args))
                plain_ms = cuda_ms(lambda: plain(*args))
                shapes = "x".join(str(s) for s in args[0].shape)
                print(f"kernel {name}[{i}] {tag} in={shapes} "
                      f"bit_exact={exact} max_abs_err={err} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f}")
                if tag == "16mp":
                    entry.setdefault("ms_runs", []).append(ms)
                    entry.setdefault("plain_ms_runs", []).append(plain_ms)
                else:
                    entry.setdefault("coarse_ms_runs", []).append(ms)
                    entry.setdefault("coarse_plain_ms_runs", []).append(
                        plain_ms)
        del cases, left, warped, bl2, state, stacked, up_src, dh, dv
        torch.cuda.empty_cache()


def run_slice(dev, cfg, report: dict):
    """Phase 3: the 16 MP match through the kernels; value gates; counts."""
    from ug_stereomatcher_tpu_torch import StereoEngine, scene
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    left_np, right_np = scene.make_pair(H, W, seed=SEED)
    print(f"scene {H}x{W} made in {time.perf_counter() - t0:.2f} s "
          f"(known shift {scene.SHIFT_PX} px)")
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    eng = StereoEngine(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.match(left, right)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    want = expected_launches(cfg, H, W)
    print(f"launches {json.dumps(counts, sort_keys=True)} expected "
          f"{json.dumps(want, sort_keys=True)}")
    if counts != want:
        fail(f"launch counts {counts} differ from the config's {want}")

    dh, dv, conf = res.disparity_h, res.disparity_v, res.confidence
    for name, plane in (("disparity_h", dh), ("disparity_v", dv),
                        ("confidence", conf)):
        if tuple(plane.shape) != (H, W):
            fail(f"{name} has shape {tuple(plane.shape)}")
        if not torch.isfinite(plane).all().item():
            fail(f"{name} has non-finite values")
    errh = (dh[64:-64, 64:-64] - scene.SHIFT_PX).abs()
    med = errh.median().item()
    frac = (errh < 1.0).float().mean().item()
    mean_dv = dv[64:-64, 64:-64].abs().mean().item()
    print(f"values med|dh-3|={med:.4f} frac(|dh-3|<1)={frac:.4f} "
          f"mean|dv|={mean_dv:.4f} mean conf={conf.mean().item():.4f}")
    if not (med < 0.5 and mean_dv < 0.5 and frac > 0.9):
        fail("16 MP value gates (med|dh-3| < 0.5, mean|dv| < 0.5, "
             "frac(|dh-3| < 1) > 0.9)")

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.match(left, right)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"slice first_call_s={first_s:.4f} warm_median_s="
          f"{statistics.median(warm):.4f} warm_s={[round(x, 4) for x in warm]}"
          f" peak_mem_bytes={peak}")
    report["slice"] = {"first_call_s": first_s, "warm_s": warm,
                       "warm_median_s": statistics.median(warm),
                       "peak_mem_bytes": peak, "med_abs_dh_err": med,
                       "frac_dh_err_lt_1": frac, "mean_abs_dv": mean_dv,
                       "launches": counts}
    report["profile"] = profile_match(eng, left, right,
                                      statistics.median(warm))
    return left, right, counts


def profile_match(eng, left, right, warm_s: float) -> dict:
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
    print(f"profile device_busy_ms={busy_ms:.3f} warm_latency_ms="
          f"{warm_s * 1e3:.3f} busy_share={busy_ms / (warm_s * 1e3):.3f}")
    for r in rows[:12]:
        print(f"profile {r['device_ms']:10.3f} ms {r['calls']:6d}x "
              f"{r['name']}")
    return {"device_busy_ms": busy_ms, "warm_latency_s": warm_s,
            "kernels": rows}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report here as JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    from ug_stereomatcher_tpu_torch import MatcherConfig
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
    left, right, counts = run_slice(dev, cfg, report)
    lockstep_level(dev, cfg, left, right, report)

    jaxy = [m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m.split(".")[0] == "ug_stereomatcher_tpu"]
    if jaxy:
        fail(f"the JAX package was imported: {jaxy[:5]}")

    sources = {"blur": ("blur.cu", "ops/pallas/blur.py:150"),
               "resample": ("resample.cu", "ops/pallas/resample.py:223"),
               "warp": ("warp.cu", "ops/pallas/warp.py:678"),
               "direction": ("direction.cu", "ops/pallas/direction.py:258"),
               "smooth": ("smooth.cu", "ops/pallas/smooth.py:205")}
    rows = []
    for name, (src, replaces) in sources.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"ug_stereomatcher_tpu_torch/csrc/{src}",
                     "replaces": f"ug_stereomatcher_tpu/{replaces}",
                     "launches": counts.get(name, 0),
                     "max_abs_err": k["max_abs_err"],
                     # the first 16 MP case: the stacked 6-plane blur and
                     # subsample, replace=False, n_smooth=10
                     "ms": k["ms_runs"][0],
                     "plain_ms": k["plain_ms_runs"][0]})
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
