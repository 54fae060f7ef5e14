"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the cell's pool of distinct pairs on the card from the
seed, copies it to host memory once, builds the engine and calls the
cell's entry point on each pool entry (the first call builds or loads
the kernels and captures the entry's CUDA graph).  The window is a
closed loop with one client: request i hands pool entry i mod P, as
host uint8 arrays (or, in a mix with ``"inputs": "device"``, as uint8
tensors already on the card), to the public entry point and is timed on the host
clock until the call returns (the engine synchronises its cards before
it returns).  A few requests drawn from the seed are sampled (in a
batch call, one pair from each of a few equal strata of the batch):
their answers go to host memory with the window's clock paused.  In an
early-exit configuration the program's count of early-exit iterations
(``match.iterations_run()``) is read before and after each sampled
request, with the clock paused too.  After the window the peak memory is
read, the engine is freed, and the plain reference
(stereo_bench/reference) recomputes each sampled answer from the same
pool entry on the card.
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from stereo_bench import check, scene, spec, stats, trace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "ug_stereomatcher_tpu")
GIB = float(2 ** 30)


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def forbidden_modules(names: Sequence[str] = ()) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, compared whole."""
    names = names or list(sys.modules)
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _cards(cell: spec.Cell, device: Optional[str]) -> List:
    import torch

    mesh = cell.traffic.get("mesh")
    n = mesh[0] * mesh[1] if mesh else 1
    if device is not None:
        return [torch.device(device)] * n
    if not torch.cuda.is_available():
        raise NoChip("torch finds no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        raise NoChip(f"the cell needs {cell.chips} cards, torch finds "
                     f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


def _entry(cell: spec.Cell, engine, cards) -> Callable:
    """The cell's timed call: ``(left, right) -> output``."""
    traffic = cell.traffic
    if traffic["entry"] == "one_pair":
        fn = engine.match_foveated if cell.foveated else engine.match
        return fn
    if traffic["entry"] != "match_batch":
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    mesh = None
    if traffic.get("mesh"):
        from ug_stereomatcher_tpu_torch.parallel import make_mesh
        p, r = traffic["mesh"]
        mesh = make_mesh(p, r, devices=cards)
    return lambda lb, rb: engine.match_batch(lb, rb, mesh=mesh,
                                             foveated=cell.foveated)


def _answers(cell: spec.Cell, out, pairs: Sequence[int]
             ) -> List[Dict[str, np.ndarray]]:
    """One host dict (check.parts' keys) for each of ``pairs`` of a
    call's output; only those pairs are copied to the host."""
    def host(t, j):
        return t[j].detach().cpu().numpy()

    if cell.traffic["entry"] == "match_batch":
        planes = ((out.stack_h, out.stack_v, out.stack_c) if cell.foveated
                  else (out.disparity_h, out.disparity_v, out.confidence))
        key = "stack" if cell.foveated else "triplet"
        return [{key: np.stack([host(t, j) for t in planes])}
                for j in pairs]
    if cell.foveated:
        planes = np.stack([host(t, ...) for t in
                           (out.stack_h, out.stack_v, out.stack_c)])
        return [{"stack": planes, "stack_left": host(out.stack_left, ...),
                 "stack_right": host(out.stack_right, ...)}]
    return [{"triplet": np.stack([host(t, ...) for t in
                                  (out.disparity_h, out.disparity_v,
                                   out.confidence)])}]


def sampled(traffic: dict, seed: int) -> Dict[int, List[int]]:
    """The requests whose answers are checked, each with the pairs of its
    call that are judged: ``sample["calls"]`` requests drawn from the
    seed among the first ``sample["within"]``; in a batch call one pair
    from each of ``sample["pairs"]`` equal strata of the batch (every
    pair where ``pairs`` is absent), so a fault in any half of a batch
    shows."""
    samp = traffic["sample"]
    rng = np.random.default_rng(abs(int(seed)))
    calls = rng.choice(int(samp["within"]), size=int(samp["calls"]),
                       replace=False)
    per_call = int(traffic["pairs_per_call"]) \
        if traffic["entry"] == "match_batch" else 1
    strata = min(int(samp.get("pairs", per_call)), per_call)
    edges = np.linspace(0, per_call, strata + 1).astype(int)
    return {int(c): [int(rng.integers(a, b))
                     for a, b in zip(edges[:-1], edges[1:])]
            for c in sorted(calls.tolist())}


def _pairs_of(entry: Tuple, batch: bool) -> List[Tuple]:
    lft, rgt = entry
    if not batch:
        return [(lft, rgt)]
    return [(lft[j], rgt[j]) for j in range(lft.shape[0])]


def _power_limit() -> Optional[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else None


def _iteration_counter(cfg: dict) -> Optional[Callable[[], int]]:
    """The program's count of early-exit iterations, in an early-exit
    configuration where the program has one."""
    if cfg["matcher"]["early_exit_delta"] is None:
        return None
    from ug_stereomatcher_tpu_torch import match as program_match
    return getattr(program_match, "iterations_run", None)


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t0: Optional[float] = None, root=spec.ROOT,
        device: Optional[str] = None, overrides: Optional[dict] = None,
        program_fields: Optional[dict] = None, log=print) -> dict:
    """One run of cell ``workload``; returns the result line's object.

    ``device`` ("cpu") and ``overrides`` (keys merged into the traffic
    mix, such as a small ``frame``) are for the tests: they skip the look
    for a card and run the plain versions.  ``program_fields`` (matcher
    fields merged into the program's configuration alone; the reference
    keeps the cell's) is for the control (stereo_bench.control)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load(workload, root)
    cell.traffic.update(overrides or {})
    traffic, cfg = cell.traffic, cell.config
    import torch

    tf32 = bool(cfg["guarantees"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    cards = _cards(cell, device)
    on_card = cards[0].type == "cuda"
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
    from ug_stereomatcher_tpu_torch.ops.cuda import _build

    t_imp = time.perf_counter()
    batch = traffic["entry"] == "match_batch"
    per_call = int(traffic["pairs_per_call"])
    n_pool = int(traffic["pool"])
    pool = scene.make_pool(n_pool, per_call if batch else 1, cell.frame,
                           seed, traffic["disparity"], cards[0],
                           traffic["inputs"])
    distinct = sorted(set(cards), key=str)
    if on_card:
        for c in distinct:
            torch.cuda.synchronize(c)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(c)
    t_pool = time.perf_counter()
    engine = StereoEngine(MatcherConfig(**{**cfg["matcher"],
                                           **(program_fields or {})}),
                          device=cards[0])
    call = _entry(cell, engine, cards)
    for i in range(int(traffic["warmup_calls"])):
        call(*pool[i % n_pool])
        if i == 0:
            t_first = time.perf_counter()
    setup_s = time.perf_counter() - t0
    log(f"setup: imports {t_imp - t0:.3f} s, pool {t_pool - t_imp:.3f} s, "
        f"first call {t_first - t_pool:.3f} s, other warm-up calls "
        f"{t0 + setup_s - t_first:.3f} s", file=sys.stderr)

    sample_at = sampled(traffic, seed)
    kept: Dict[int, List[Dict[str, np.ndarray]]] = {}
    count_iterations = _iteration_counter(cfg)
    iterations_at: Dict[int, int] = {}
    lat: List[float] = []
    done: List[float] = []   # each request's end on the window's clock
    failed = 0
    mark = trace.annotate if traced else (lambda name: contextlib.nullcontext())
    gc.collect()
    _build.reset_launch_counts()
    iterations_open = count_iterations() if count_iterations else None
    with trace.profiled(traced and on_card) as prof:
        with mark(trace.WINDOW):
            paused = 0.0
            t_open = time.perf_counter()
            i = 0
            while time.perf_counter() - t_open - paused < seconds:
                lft, rgt = pool[i % n_pool]
                if count_iterations and i in sample_at:
                    with mark(trace.PAUSE):
                        tp = time.perf_counter()
                        iterations_at[i] = count_iterations()
                        paused += time.perf_counter() - tp
                with mark(trace.REQUEST):
                    ts = time.perf_counter()
                    try:
                        out = call(lft, rgt)
                    except Exception as exc:  # a failed request, counted
                        failed += 1
                        out = None
                        log(f"request {i} failed: {exc!r}", file=sys.stderr)
                    lat.append(time.perf_counter() - ts)
                    done.append(ts + lat[-1] - t_open - paused)
                if i in sample_at and out is not None:
                    with mark(trace.PAUSE):
                        tp = time.perf_counter()
                        kept[i] = _answers(cell, out, sample_at[i])
                        if count_iterations:
                            iterations_at[i] = (count_iterations()
                                                - iterations_at[i])
                        paused += time.perf_counter() - tp
                out = None
                i += 1
            window_s = time.perf_counter() - t_open - paused
    launches = sum(_build.launch_counts().values())
    iterations = (count_iterations() - iterations_open
                  if count_iterations else None)
    peak = max(torch.cuda.max_memory_allocated(c) for c in distinct) \
        if on_card else 0
    t_ref = time.perf_counter()
    del call, engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    power = _power_limit() if on_card else None

    # the check: the reference recomputes every sampled answer
    from stereo_bench.reference import match_pair
    from stereo_bench.reference.matcher import Schedule

    readings = []
    levels = int(Schedule(cfg["matcher"]).p["fovea_level"])
    gate = cfg["guarantees"].get("exit_levels_above_px")
    ref_iterations: Dict[int, List[int]] = {}
    for i in sorted(kept):
        pairs = _pairs_of(pool[i % n_pool], batch)
        call_iterations = 0
        for j, got in zip(sample_at[i], kept[i]):
            lft, rgt = pairs[j]
            ref = match_pair(_chw(lft, cards[0]), _chw(rgt, cards[0]),
                             cfg["matcher"], cell.foveated,
                             exit_above_px=gate)
            call_iterations += check.iterations_of(ref)
            for lv in ref["exit_levels"]:
                ref_iterations.setdefault(lv, []).append(
                    ref["iterations"][lv])
            ref = {k: v for k, v in ref.items() if k in got}
            readings.append(check.compare(
                {k: torch.from_numpy(v) for k, v in got.items()}, ref,
                levels))
        if i in iterations_at:
            readings[-1][check.ITERATIONS_GAP] = check.iterations_gap(
                iterations_at[i], call_iterations)
    missing = sorted(set(sample_at) - set(kept))
    ok, numbers = check.judge(readings, cfg["limits"])
    correct = ok and failed == 0 and not missing
    ref_s = time.perf_counter() - t_ref

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(cards[0])
                   if on_card else "cpu",
                   "count": len(distinct), "memory_peak_bytes": int(peak)}
    if power:
        device_info["power_limit"] = power
    t_tr = time.perf_counter()
    tr = None
    if traced:
        if on_card:
            tr = trace.Trace(prof["events"], [c.index for c in distinct])
        # what a per-layer metric's reader may read of the run
        view = types.SimpleNamespace(
            trace=tr, cards=[c.index for c in distinct],
            pairs=len(lat) * per_call, launches=launches,
            pairs_traced=tr.requests * per_call if tr else 0,
            least_s=_least_s(cfg, cell,
                             ref_iterations if readings else None),
            iterations=iterations, power_limit=power, latencies_s=lat)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = sum(
                tr.cards[c]["busy_s"] for c in view.cards) / len(view.cards)
            device_info["window_s"] = tr.window_s
    else:
        w = stats.window_metrics(lat, per_call, window_s)
        w["device_mem_peak_gib"] = peak / GIB
        w["setup_s"] = setup_s
        # "<metric>.<qualifier>" is <metric> in the cells it lists, under
        # a bound of its own
        metrics = {m["name"]: {"value": w[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["check"] = numbers
    log(f"requests_per_s {per_second(done, window_s)}", file=sys.stderr)
    log(f"setup_s {setup_s:.3f} window_s {window_s:.3f} requests {len(lat)} "
        f"sampled {sorted(kept)} missing {missing} reference_s {ref_s:.3f} "
        f"trace_s {time.perf_counter() - t_tr:.3f}", file=sys.stderr)
    return result


def _least_s(cfg: dict, cell: spec.Cell,
             ref_iterations: Optional[Dict[int, List[int]]]
             ) -> Optional[float]:
    """work.match_least_s of one match; with early exit, from the mean
    iterations that the reference ran on the sampled pairs (None where
    it judged none)."""
    if ref_iterations is None:
        if cfg["matcher"]["early_exit_delta"] is not None:
            return None
        ref_iterations = {}
    mean = {lv: sum(v) / len(v) for lv, v in ref_iterations.items()}
    return work.match_least_s(cfg["matcher"], cell.frame, cell.foveated,
                              mean)["least_s"]


def per_second(done_s: Sequence[float], window_s: float) -> List[int]:
    """The requests that ended in each whole second of the window (the
    last, partial second counted with the one before it)."""
    n = max(1, int(window_s))
    counts = [0] * n
    for t in done_s:
        counts[min(n - 1, max(0, int(t)))] += 1
    return counts


def _chw(img, dev):
    """An (H, W, 3) uint8 image, host array or tensor, as (3, H, W) on
    ``dev``."""
    import torch

    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(img)
    return img.to(dev).permute(2, 0, 1)
