"""The port's bench: the JAX package's headline metrics on one CUDA card.

Counterpart of the repo's root ``bench.py``, with its metric names,
units, ``BENCH_*`` variables and ``vs_baseline`` baselines, so that a
card's lines sit beside the TPU's.  ``BENCH_MODE=all`` (the default)
prints one JSON line per metric, the secondaries first and the primary
``16mp_mode1_disparity_latency`` last, with the secondaries embedded in
its ``extra``:

  foveated, mode1_bilinear, foveated_bilinear, mode1_ee,
  mode1_bilinear_ee  -- 16 MP latency of mode 2 and of the quality and
                        early-exit (nearest 0.1 px, bilinear 0.02 px)
                        variants (reference: 10 s mode 1, 3 s mode 2);
  throughput, foveated_throughput -- batched pairs/s at 815 x 1231
                        (reference scaled by pixels);
  scaling (alone)    -- parallel.measure_throughput curves at 408 x 616.

Unlike the JAX bench, every latency and batched line is checked: the
value gates of the JAX package's on-chip check (the bench scene has a
known 3 px shift) are measured on the last warm result, outside the
timed window, and stand in ``extra.values``.  A line whose gates fail,
or whose run raised, prints ``{name}_FAILED`` with the error, and the run
returns 1 after printing everything else; a scaling family that raised
does the same.  Only a run in which every line was measured and passed
its gates returns 0.  Times are not rounded.  On the card the engine
replays one CUDA graph per entry point and shape (graphs.py): a line's
first call (``compile_plus_first_run_s``) builds the kernels and
captures the graph, its warm calls and ``host_path_s`` (the warm call
from host arrays) are replays.

Environment: BENCH_MODE (one of ``_MODES``), BENCH_H, BENCH_W (default
3264 x 4928), BENCH_REPEATS (3), BENCH_BATCH (8), BENCH_SCALING_MODES
(dp,sp,hybrid,dp_fov), BENCH_PLATFORM=cpu (run the kernels' plain
versions on the CPU; ``scaling`` then uses BENCH_CPU_DEVICES CPU mesh
entries, default 8).  Without BENCH_PLATFORM=cpu the bench runs on the
card, and a machine without one fails with ``bench_env_FAILED`` (rc 1):
it never falls back to the CPU.  Every line's ``extra`` names the device
(``torch.cuda.get_device_name``) and the card's ``power_limit_w``.

    python -m ug_stereomatcher_tpu_torch bench [--mode mode1|foveated]
    BENCH_MODE=throughput python -m ug_stereomatcher_tpu_torch bench
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.scene import SHIFT_PX, make_pair

_MODES = ("all", "throughput", "foveated_throughput", "scaling", "mode1",
          "foveated", "mode1_bilinear", "foveated_bilinear", "mode1_ee",
          "mode1_bilinear_ee")
_LATENCY_MODES = _MODES[4:]
FULL_H, FULL_W = 3264, 4928    # the Glasgow rig's 16 MP frame
# the JAX package's on-chip gates: med|dh - 3| and mean|dv| below the
# mode's value, frac(|dh - 3| < 1) above FRAC_GATE
GATES = {"nearest": 0.5, "bilinear": 0.1}
FRAC_GATE = 0.9


class GateFailure(RuntimeError):
    """A line's values fall outside its gates."""


def _env_failed(error: str) -> None:
    print(json.dumps({"metric": "bench_env_FAILED", "value": 0,
                      "unit": "n/a", "vs_baseline": 0, "error": error}))


def _make_pair(h: int, w: int, batch=None):
    """The bench scene: (left, right) uint8 (h, w, 3) with right[:, x + 3]
    == left[:, x]; with ``batch``, (batch, h, w, 3) stacks of seeds
    0..batch-1."""
    if batch is None:
        return make_pair(h, w)
    pairs = [make_pair(h, w, seed=b) for b in range(batch)]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def _card(device: torch.device) -> dict:
    """The device's name and, on a card, its power limit in watts from
    nvidia-smi (None where nvidia-smi does not answer)."""
    if device.type == "cpu":
        return {"device": "cpu", "power_limit_w": None}
    power = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        power = float(out.splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.TimeoutExpired, IndexError, ValueError):
        pass
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": power}


def _synchronize(device: torch.device) -> None:
    """Wait for every card (a batch may run on a mesh of them)."""
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _gate_values(pairs, margin: int) -> dict:
    """The three gate statistics inside ``margin`` of each (dh, dv): the
    worst over the pairs."""
    m = slice(margin, -margin)
    meds, fracs, dvs = [], [], []
    for dh, dv in pairs:
        err = (dh[..., m, m].double() - SHIFT_PX).abs()
        meds.append(err.median().item())
        fracs.append((err < 1.0).double().mean().item())
        dvs.append(dv[..., m, m].double().abs().mean().item())
    return {"med_abs_dh_err": max(meds), "frac_dh_err_lt_1": min(fracs),
            "mean_abs_dv": max(dvs)}


def _check_gates(extra: dict, interp: str) -> None:
    """Add ``values`` and ``gate`` to a line's extra; raise GateFailure
    unless the values pass."""
    gate = GATES[interp]
    v = extra["values"]
    extra["gate"] = {"med_abs_dh_err_lt": gate, "mean_abs_dv_lt": gate,
                     "frac_dh_err_lt_1_gt": FRAC_GATE}
    if not (v["med_abs_dh_err"] < gate and v["mean_abs_dv"] < gate
            and v["frac_dh_err_lt_1"] > FRAC_GATE):
        raise GateFailure(
            f"value gates failed: {v} (med|dh-{SHIFT_PX}| < {gate}, "
            f"mean|dv| < {gate}, frac(|dh-{SHIFT_PX}| < 1) > {FRAC_GATE})")


def _margin(h: int, w: int, cap: int) -> int:
    """The gates' margin: ``cap`` px (64 for a full map, 32 for a fovea),
    at most a quarter of the plane, so that a small one keeps pixels."""
    return min(cap, h // 4, w // 4)


def _latency(mode: str, h: int, w: int, repeats: int, device: torch.device,
             card: dict) -> dict:
    """One latency line (bench.py ``_latency``): first call from host
    arrays, then ``repeats`` warm calls on inputs already on the device,
    each ended by a synchronise; ``value`` is the least.  The
    ``_bilinear`` variants run ``interp="bilinear"``, the ``_ee`` variants
    the early exit at the mode's accuracy-safe threshold.  The gates are
    measured on the last warm result: mode 1's map inside min(64, h/4,
    w/4), mode 2's stack level 0 (the fovea at full resolution) inside
    min(32, fh/4, fw/4)."""
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine

    parts = mode.split("_")
    base_mode = parts[0]
    interp = "bilinear" if "bilinear" in parts else "nearest"
    early = ((0.02 if interp == "bilinear" else 0.1)
             if "ee" in parts else None)
    baseline_s = 10.0 if base_mode == "mode1" else 3.0
    left, right = _make_pair(h, w)
    eng = StereoEngine(MatcherConfig(interp=interp, early_exit_delta=early),
                       device=device)
    run = eng.match if base_mode == "mode1" else eng.match_foveated

    def once(lft, rgt):
        t0 = time.perf_counter()
        res = run(lft, rgt)
        _synchronize(device)
        return time.perf_counter() - t0, res

    # the first call builds the kernels and captures the graph
    compile_s, _ = once(left, right)
    left_dev = torch.from_numpy(left).to(device)
    right_dev = torch.from_numpy(right).to(device)
    _synchronize(device)
    times = []
    for _ in range(repeats):
        t, res = once(left_dev, right_dev)
        times.append(t)
    value = min(times)
    host_path_s = min(once(left, right)[0] for _ in range(2))

    if base_mode == "mode1":
        values = _gate_values([(res.disparity_h, res.disparity_v)],
                              _margin(h, w, 64))
    else:
        dh, dv, _ = res.level_disparity(0)
        values = _gate_values([(dh, dv)],
                              _margin(res.roi_height, res.roi_width, 32))
    extra = {"height": h, "width": w, "repeats": repeats, "interp": interp,
             "early_exit_delta": early,
             "compile_plus_first_run_s": compile_s, "all_runs_s": times,
             "host_path_s": host_path_s, **card, "baseline_s": baseline_s,
             "values": values}
    _check_gates(extra, interp)
    return {"metric": f"16mp_{mode}_disparity_latency"
                      if (h, w) == (FULL_H, FULL_W) else
                      f"{mode}_disparity_latency_{h}x{w}",
            "value": value, "unit": "s/pair",
            "vs_baseline": round(baseline_s / value, 3), "extra": extra}


def _throughput(h: int, w: int, repeats: int, device: torch.device,
                card: dict, foveated: bool = False) -> dict:
    """Batched pairs/s (bench.py ``_throughput``): BENCH_BATCH pairs at
    815 x 1231 unless BENCH_H is set, through StereoEngine.match_batch on
    the card, or on a mesh of the cards where there are several.  The
    gates are measured on every pair of the last warm batch."""
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
    from ug_stereomatcher_tpu_torch.parallel import make_mesh, mesh_shape_for

    if "BENCH_H" not in os.environ:  # unset: the 1 MP working resolution
        h, w = 815, 1231
    batch = int(os.environ.get("BENCH_BATCH", 8))
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = (make_mesh(*mesh_shape_for(n_dev, n_pairs=batch))
            if n_dev > 1 else None)
    left, right = _make_pair(h, w, batch=batch)
    eng = StereoEngine(MatcherConfig(), device=device)
    lb = torch.from_numpy(left).to(device)
    rb = torch.from_numpy(right).to(device)

    def once():
        t0 = time.perf_counter()
        res = eng.match_batch(lb, rb, mesh, foveated=foveated)
        _synchronize(device)
        return time.perf_counter() - t0, res

    compile_s, _ = once()
    times = []
    for _ in range(repeats):
        t, res = once()
        times.append(t)
    sec = min(times)
    # the reference's s/pair at 16 MP scaled by pixels (3 s mode 2, 10 s
    # mode 1)
    base_s = 3.0 if foveated else 10.0
    ref_pps = 1.0 / (base_s * (h * w) / (FULL_H * FULL_W))
    pps = batch / sec
    if foveated:
        dh, dv, _ = res.level_disparity(0)
        values = _gate_values(zip(dh, dv),
                              _margin(res.roi_height, res.roi_width, 32))
    else:
        values = _gate_values(zip(res.disparity_h, res.disparity_v),
                              _margin(h, w, 64))
    extra = {"batch": batch, "devices": n_dev, "seconds_per_batch": sec,
             "all_runs_s": times, "compile_plus_first_run_s": compile_s,
             **card, "baseline_pairs_per_s": ref_pps, "values": values}
    _check_gates(extra, "nearest")
    tag = "foveated_throughput" if foveated else "batched_throughput"
    return {"metric": f"{tag}_{h}x{w}", "value": pps, "unit": "pairs/s",
            "vs_baseline": round(pps / ref_pps, 3), "extra": extra}


def _scaling(h: int, w: int, repeats: int, device: torch.device,
             card: dict) -> dict:
    """Scaling curves (bench.py ``_scaling``) from
    parallel.measure_throughput in the dp, sp, hybrid and dp_fov
    families (BENCH_SCALING_MODES narrows them) at 408 x 616 unless
    BENCH_H is set, over the visible cards (on the CPU,
    BENCH_CPU_DEVICES entries of it).  The headline is the dp efficiency
    at the largest device count that does not repeat a device; a failed
    dp family is never replaced by another family's points: the line is
    then the diagnostic with value 0.  A family that raised keeps its
    error in ``curves``."""
    from ug_stereomatcher_tpu_torch import MatcherConfig
    from ug_stereomatcher_tpu_torch.parallel import throughput

    if "BENCH_H" not in os.environ:
        h, w = 408, 616   # the scaling probe resolution (fovea-sized)
    known = ("dp", "sp", "hybrid", "dp_fov")
    modes = [m.strip() for m in
             os.environ.get("BENCH_SCALING_MODES", ",".join(known)).split(",")
             if m.strip()]
    skipped = [m for m in modes if m not in known]
    modes = [m for m in modes if m in known] or ["dp"]
    devices = (["cpu"] * int(os.environ.get("BENCH_CPU_DEVICES", 8))
               if device.type == "cpu" else
               [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())])
    curves = {}
    dp_points = None
    last_ok = None  # (family, points) of the last family that measured
    for mode in modes:
        cfg = MatcherConfig()
        if mode.endswith("_fov"):
            # a small probe may not carry fovea_level pyramid levels
            n = cfg.num_levels(h, w)
            if n < cfg.fovea_level:
                cfg = MatcherConfig(fovea_level=max(2, n))
        try:
            points = throughput.measure_throughput(
                height=h, width=w, repeats=repeats,
                mode=mode.removesuffix("_fov"), cfg=cfg,
                foveated=mode.endswith("_fov"), devices=devices)
        except Exception as e:  # recorded; main() then returns 1
            curves[mode] = {"error": f"{type(e).__name__}: {e}"}
            continue
        curves[mode] = [{"devices": p.n_devices, "mesh": list(p.mesh_shape),
                         "batch": p.batch,
                         "pairs_per_s": p.pairs_per_second,
                         "seconds_per_batch": p.seconds_per_batch,
                         "efficiency": p.scaling_efficiency,
                         "oversubscribed": p.oversubscribed}
                        for p in points]
        last_ok = (mode, points)
        if mode == "dp":
            dp_points = points
    if "dp" in modes:
        head = ("dp", dp_points) if dp_points else None
    else:
        head = last_ok
    if head is None:
        return {"metric": f"mesh_scaling_{h}x{w}", "value": 0,
                "unit": "dp_efficiency_at_max_diagnostic_devices",
                "vs_baseline": 0,
                "extra": {"curves": curves, "skipped_modes": skipped,
                          **card}}
    head_mode, head_points = head
    diag = ([p for p in head_points if not p.oversubscribed]
            or list(head_points))
    best = diag[-1]
    return {"metric": f"mesh_scaling_{h}x{w}",
            "value": best.scaling_efficiency,
            "unit": f"{head_mode}_efficiency_at_max_diagnostic_devices",
            "vs_baseline": best.scaling_efficiency,  # the ref has one GPU
            "extra": {"curves": curves, "devices": len(devices),
                      "physical_cores": os.cpu_count(),
                      "headline_devices": best.n_devices,
                      "skipped_modes": skipped, **card}}


def _scaling_errors(line: dict) -> list:
    """What went wrong in a scaling line: each family that raised, and an
    unmeasured headline."""
    extra = line["extra"]
    errors = [f"{fam}: {c['error']}" for fam, c in extra["curves"].items()
              if isinstance(c, dict)]
    if "headline_devices" not in extra:
        errors.append("no headline family was measured")
    return errors


def _measured(name: str, fn) -> tuple:
    """(line, ok): ``fn()``'s line, or the ``{name}_FAILED`` line of what
    it raised."""
    try:
        return fn(), True
    except Exception as e:  # a failed line, reported; main() returns 1
        return {"metric": f"{name}_FAILED",
                "error": f"{type(e).__name__}: {e}"}, False


def main() -> int:
    mode = os.environ.get("BENCH_MODE", "all")
    if mode not in _MODES:
        # before any device is touched: a typo must not start the suite
        _env_failed(f"unknown BENCH_MODE {mode!r}; valid: "
                    f"{', '.join(_MODES)}")
        return 2
    try:
        h = int(os.environ.get("BENCH_H", FULL_H))
        w = int(os.environ.get("BENCH_W", FULL_W))
        repeats = int(os.environ.get("BENCH_REPEATS", 3))
    except ValueError as e:
        _env_failed(f"bad BENCH_* value: {e}")
        return 2
    from ug_stereomatcher_tpu_torch.device import resolve_device
    try:
        device = resolve_device(
            "cpu" if os.environ.get("BENCH_PLATFORM") == "cpu" else "cuda")
    except RuntimeError as e:  # no card: never a CPU run in its place
        _env_failed(f"{e} (or set BENCH_PLATFORM=cpu)")
        return 1
    card = _card(device)

    def latency(m):
        return lambda: _latency(m, h, w, repeats, device, card)

    def batched(foveated):
        return lambda: _throughput(h, w, repeats, device, card,
                                   foveated=foveated)

    if mode != "all":
        if mode in _LATENCY_MODES:
            fn = latency(mode)
        elif mode == "scaling":
            def fn():
                return _scaling(h, w, repeats, device, card)
        else:
            fn = batched(mode == "foveated_throughput")
        line, ok = _measured(mode, fn)
        print(json.dumps(line))
        if ok and mode == "scaling":
            for err in _scaling_errors(line):
                print(f"bench: scaling {err}", file=sys.stderr)
                ok = False
        return 0 if ok else 1

    # all: the secondaries first, each on its own line, then the primary
    # mode-1 line with the secondaries embedded, so that a reader of the
    # last line has every number; any failed line makes the run fail
    side = {}
    failed = []
    for name, fn in (("foveated", latency("foveated")),
                     ("throughput", batched(False)),
                     ("foveated_throughput", batched(True)),
                     ("mode1_bilinear", latency("mode1_bilinear")),
                     ("foveated_bilinear", latency("foveated_bilinear")),
                     ("mode1_ee", latency("mode1_ee")),
                     ("mode1_bilinear_ee", latency("mode1_bilinear_ee"))):
        line, ok = _measured(name, fn)
        side[name] = ({k: line[k] for k in
                       ("metric", "value", "unit", "vs_baseline")}
                      if ok else {"error": line["error"]})
        if not ok:
            failed.append(name)
        print(json.dumps(line))
        sys.stdout.flush()
    primary, ok = _measured("mode1", latency("mode1"))
    primary.setdefault("extra", {}).update(side)
    print(json.dumps(primary))
    if not ok:
        failed.append("mode1")
    if failed:
        print(f"bench: failed lines: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
