"""Coarse-to-fine iterative matching (modes 1 and 2).

Counterpart of ``ug_stereomatcher_tpu/match.py``.  ``match_level`` refines
one pyramid level by one of two routes that compute the same result:

* per iteration: a Python loop over the fixed iteration schedule whose
  body is warp -> direction update -> smoothing chain, each one kernel on
  the card (reference matchlevel body, MatchGPULib.cpp:1743-2412), with
  the blurred left energy G(L^2) computed once per level;
* level-resident: every iteration of the level in one launch
  (ops/cuda/level.py), for levels of at most ``LEVEL_RESIDENT_MAX_PIXELS``
  pixels, where the per-iteration route is bound by the host's launch
  rate.  The route is chosen from the level's size and schedule before
  anything runs.

``match_pyramid`` runs the levels from coarsest to finest and upsamples
each result to the next level (``matching``, MatchGPULib.cpp:1196-1318);
on a foveated pyramid (mode 2) the levels finer than fovea_level - 1 are
fovea-sized windows, and each transition between them is a windowed
upsample (pyramid.foveated_upsample).

With ``cfg.early_exit_delta`` set, a per-iteration level stops once an
iteration changes the disparity by less than the threshold (the
reference's dormant convergence test, MatchGPULib.cpp:1323-1334); the
level-resident route runs its full schedule, as the JAX package's does.
On the card the exit is decided on the device, as the JAX package's
``lax.while_loop`` decides it: the level's whole schedule is enqueued
with a convergence kernel after each iteration, and the kernels after
the exit do nothing (``device_exit_loop``).  On the CPU the loop reads
each change on the host (``host_exit_loop``, the plain version of that
loop).  ``level_convergence_trace`` runs one level's full schedule and
returns the change of every iteration.

The JAX package's warp tiers exist only because a TPU cannot gather in
2-D; the port's warp is one exact gather, so it has none.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.ops.cuda import convergence, level
from ug_stereomatcher_tpu_torch.ops.cuda.blur import fused_blur_gaussian
from ug_stereomatcher_tpu_torch.ops.cuda.direction import (  # noqa: F401
    direction_maps,
    fused_direction_update,
    fused_direction_update_plain,
)
from ug_stereomatcher_tpu_torch.ops.cuda.level import level_resident_match
from ug_stereomatcher_tpu_torch.ops.cuda.smooth import (
    fused_smooth_average,
    fused_smooth_average_plain,
)
from ug_stereomatcher_tpu_torch.ops.cuda.warp import warp, warp_plain
from ug_stereomatcher_tpu_torch.ops.convergence import weighted_difference

# body(state, m, threshold, stop=None, out=None): one iteration
LevelBody = Callable[..., torch.Tensor]


class LevelOps(NamedTuple):
    """The ops of one iteration: the kernels' wrappers (``KERNEL_OPS``) or
    their plain versions (``PLAIN_OPS``, which a CPU test runs the card's
    loop with)."""
    warp: Callable[..., torch.Tensor]
    direction: Callable[..., torch.Tensor]
    smooth: Callable[..., torch.Tensor]


KERNEL_OPS = LevelOps(warp, fused_direction_update, fused_smooth_average)
PLAIN_OPS = LevelOps(warp_plain, fused_direction_update_plain,
                     fused_smooth_average_plain)

# Levels of at most this many pixels run level-resident: levels 6-13 of a
# 16 MP frame (level 6 is 407 x 615).  On an H100 the level kernel takes
# about 1.1 ms at level 7 and 2.0 ms at level 6 against about 5 ms per
# iteration, and in one call this gate timed the warm 16 MP match about
# 8 ms faster than 64 Ki and within the spread of 512 Ki and 1 Mi, which
# add levels 5 and 4 (PERF.md).
LEVEL_RESIDENT_MAX_PIXELS = 256 * 1024

# Host reads of the early-exit test (one per iteration of a level on the
# host-read loop; each waits for the device to finish that iteration).
_HOST_SYNCS = [0]
# Early-exit iterations run: the host-read loop's, counted on the host,
# and per device the device loop's sum of its levels' last iterations
# (a 0-d int32 tensor added to on the device) with one more per level.
_ITERATIONS = [0]
_DEVICE_LAST: dict = {}
# this thread's IterationCounts while it warms up or captures a CUDA graph
_LOCAL = threading.local()


class IterationCounts:
    """The device loop's counts of one CUDA graph (graphs.CapturedCall):
    ``last``, the sum of its early-exit levels' last iterations, a 0-d
    int32 tensor that the graph computes anew on each replay (None where
    no level exits early), and ``levels``, the number of those levels.
    ``add_iterations`` adds them to ``iterations_run()`` after a
    replay."""

    def __init__(self):
        self.last: Optional[torch.Tensor] = None
        self.levels = 0


@contextlib.contextmanager
def counting_iterations_into(counts: IterationCounts):
    """Count this thread's device-loop levels into ``counts`` instead of
    ``iterations_run()``'s counters while the block runs."""
    prev = getattr(_LOCAL, "counts", None)
    _LOCAL.counts = counts
    try:
        yield counts
    finally:
        _LOCAL.counts = prev


def _device_last(device: torch.device) -> torch.Tensor:
    last = _DEVICE_LAST.get(device)
    if last is None:
        last = _DEVICE_LAST[device] = torch.zeros((), dtype=torch.int32,
                                                  device=device)
    return last


def add_iterations(counts: IterationCounts) -> None:
    """Add one replay's device-loop counts to ``iterations_run()``: one
    add on the device, none where the graph has no early-exit level."""
    if counts.last is not None:
        _device_last(counts.last.device).add_(counts.last)
        _ITERATIONS[0] += counts.levels


def host_syncs() -> int:
    """Early-exit host reads since the last ``reset_host_syncs()``: 0 on
    the card, where the device decides each level's exit."""
    return _HOST_SYNCS[0]


def iterations_run() -> int:
    """Iterations that early-exit levels ran since the last
    ``reset_host_syncs()``, on either loop: the sum of ``last + 1`` over
    the levels.  It reads the device's counts, so it waits for the card;
    the loops never read them."""
    return _ITERATIONS[0] + sum(int(t) for t in _DEVICE_LAST.values())


def reset_host_syncs() -> None:
    """Set ``host_syncs()`` and ``iterations_run()`` to 0."""
    _HOST_SYNCS[0] = 0
    _ITERATIONS[0] = 0
    _DEVICE_LAST.clear()


def _level_blurred_l2(left: torch.Tensor) -> torch.Tensor:
    """G(L^2) with the clamp boundary, hoisted out of the iteration loop
    (the reference recomputes it every iteration, MatchGPULib.cpp:1809)."""
    return fused_blur_gaussian(left * left, boundary="clamp")


def _make_level_body(left: torch.Tensor, right: torch.Tensor,
                     blurred_l2: torch.Tensor, cfg: MatcherConfig,
                     is_coarsest: bool, n_smooth: int,
                     ops: LevelOps = KERNEL_OPS) -> LevelBody:
    """One refinement iteration: ``body(state, m, threshold, stop=None,
    out=None)`` maps the (3, H, W) state [disp_h, disp_v, conf] to the
    next one (written into ``out`` where given); with early exit's flag
    ``stop`` set, its three launches do nothing."""
    consts = cfg.conf_consts

    def body(state: torch.Tensor, m: int, threshold: float,
             stop: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        warped = ops.warp(right, state[0], state[1], cfg.interp, stop=stop)
        # The coarsest level's first iteration replaces the confidence
        # instead of blending it (MatchGPULib.cpp:2223-2225).
        state = ops.direction(left, warped, blurred_l2, state, threshold,
                              is_coarsest and m == 0, consts, stop=stop)
        # All three planes are smoothed against the same pre-pass
        # confidence, then averaged (MatchGPULib.cpp:2262-2412).
        return ops.smooth(state, n_smooth, stop=stop, out=out)

    return body


def uses_level_resident(height: int, width: int,
                        resident_max_pixels: Optional[int] = None,
                        n_smooth: int = 0, iters: int = 0,
                        interp: str = "nearest",
                        device: Optional[torch.device] = None) -> bool:
    """Whether a level takes the level-resident route: its size is within
    the gate and its schedule within what the level kernel takes (at most
    ``level.MAX_ITERS`` iterations; on a CUDA ``device``, at most
    ``level.max_smooth_passes(interp)`` smoothing passes, the window the
    card holds).  A level beyond those limits runs per iteration, as the
    JAX package's gate falls back (ug_stereomatcher_tpu/match.py:50-72)."""
    if resident_max_pixels is None:
        resident_max_pixels = LEVEL_RESIDENT_MAX_PIXELS
    if height * width > resident_max_pixels or iters > level.MAX_ITERS:
        return False
    if device is not None and torch.device(device).type == "cuda":
        return n_smooth <= level.max_smooth_passes(interp)
    return True


def match_level(left: torch.Tensor, right: torch.Tensor, disp: torch.Tensor,
                level_index: int, cfg: MatcherConfig, is_coarsest: bool,
                resident_max_pixels: Optional[int] = None, *,
                exit_loop: Optional[str] = None) -> torch.Tensor:
    """Refine the (3, H, W) disparity triplet of one pyramid level.

    left, right: (3, H, W) images of the level.  level_index sets the
    iteration count (22 for i > 5, else (i+1)*2) and the smoothing passes
    (10 on the two finest levels, else 5).  Levels of at most
    ``resident_max_pixels`` pixels (default LEVEL_RESIDENT_MAX_PIXELS; 0
    runs every level per iteration) run level-resident, unless the
    level's schedule exceeds the level kernel's limits
    (``uses_level_resident``).  On a CPU tensor both routes are the same
    plain loop.

    Early exit (``cfg.early_exit_delta`` set; opt-in, the reference runs
    its fixed schedule): on the per-iteration route, a level of more than
    one iteration stops after the first iteration whose
    max(weighted_difference) over both axes falls below the threshold,
    and runs at least one (JAX ``_match_level_scan``, match.py:368-421).
    On the card the device decides it with no host read
    (``device_exit_loop``); on the CPU each iteration reads its change
    on the host (``host_exit_loop``, ``host_syncs``).  ``exit_loop``
    ("device" or "host") takes either loop on any device, so that tests
    and chip_smoke.py can hold one against the other.
    ``iterations_run`` counts the iterations either ran.  A level on the
    level-resident route runs its full schedule: the JAX package's level
    kernel has no exit and its gate never reads the threshold
    (match.py:50-72, :217-258), so the level kernel here has none
    either.  At 16 MP that is levels 6-13 of mode 1 and all 14 levels of
    mode 2; only levels 0-5 of mode 1 (42 iterations at most) exit
    early.  torch.sum, and the card's float64
    sums, add in another order than XLA, so a change within about 1e-6
    of the threshold may stop a level one iteration sooner or later than
    the JAX package does, or than the other loop."""
    check_supported(cfg)
    if exit_loop not in (None, "device", "host"):
        raise ValueError(f"exit_loop must be 'device' or 'host', got "
                         f"{exit_loop!r}")
    mi = cfg.iters_for_level(level_index)
    n_smooth = cfg.smooth_passes_for_level(level_index)
    thresholds = cfg.threshold_schedule(mi)
    if uses_level_resident(left.shape[-2], left.shape[-1],
                           resident_max_pixels, n_smooth, mi, cfg.interp,
                           left.device):
        return level_resident_match(left, right, disp, thresholds, n_smooth,
                                    is_coarsest, cfg.conf_consts, cfg.interp)
    body = _make_level_body(left, right, _level_blurred_l2(left), cfg,
                            is_coarsest, n_smooth)
    if cfg.early_exit_delta is None or mi <= 1:
        state = disp
        for m, threshold in enumerate(thresholds):
            state = body(state, m, threshold)
        return state
    # the JAX loop compares float32 values: the threshold rounded so
    thr = float(np.float32(cfg.early_exit_delta))
    if exit_loop is None:
        exit_loop = "host" if left.device.type == "cpu" else "device"
    if exit_loop == "host":
        return host_exit_loop(body, disp, thresholds, thr)
    state, buf = device_exit_loop(body, convergence.convergence_step, disp,
                                  thresholds, thr)
    last = convergence.last_iteration(buf)[0]
    counts = getattr(_LOCAL, "counts", None)
    if counts is None:
        _device_last(left.device).add_(last)
        _ITERATIONS[0] += 1
    else:
        if counts.last is None:   # in a capture: the graph zeroes it
            counts.last = torch.zeros((), dtype=torch.int32,
                                      device=left.device)
        counts.last.add_(last)
        counts.levels += 1
    return state


def host_exit_loop(body: LevelBody, disp: torch.Tensor,
                   thresholds: Sequence[float], thr: float) -> torch.Tensor:
    """Early exit with the change read on the host after each iteration
    (``host_syncs`` counts the reads): match_level's loop on the CPU, and
    the plain version of ``device_exit_loop`` on any device."""
    state = disp
    for m, threshold in enumerate(thresholds):
        new = body(state, m, threshold)
        delta = _changes(new, state).max()
        state = new
        _HOST_SYNCS[0] += 1
        _ITERATIONS[0] += 1
        if not delta.item() >= thr:   # NaN stops too, as in JAX
            break
    return state


def device_exit_loop(body: LevelBody, converge: Callable[..., torch.Tensor],
                     disp: torch.Tensor, thresholds: Sequence[float],
                     thr: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A level's whole schedule enqueued with no host read, the JAX
    ``lax.while_loop`` (match.py:392-414) on the card: iteration m is
    ``body`` guarded by the level's flag, its smoothing written into one
    of two states the loop owns (m % 2), then ``converge`` (the
    convergence test, which sets the flag after the last iteration that
    runs; ``thr`` None: the trace's, which never sets it).  The iterations
    after the flag is set do nothing, so the state of iteration ``last``
    is the one the loop last wrote, and one device-side select returns
    it.  Returns (triplet, the level's convergence.level_buffer)."""
    mi = len(thresholds)
    buf = convergence.level_buffer(mi, disp.device)
    stop = convergence.stop_flag(buf)
    states = torch.empty((2,) + tuple(disp.shape), dtype=disp.dtype,
                         device=disp.device)
    old = disp
    for m, threshold in enumerate(thresholds):
        new = body(old, m, threshold, stop=stop, out=states[m % 2])
        converge(new, old, m, buf, thr)
        old = new
    parity = convergence.last_iteration(buf).remainder(2)
    return states.index_select(0, parity)[0], buf


def _changes(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """(2,) weighted_difference of disp_h and disp_v between two states,
    weighted by the new confidence."""
    return torch.stack([weighted_difference(new[k], old[k], new[2])
                        for k in (0, 1)])


def level_convergence_trace(left: torch.Tensor, right: torch.Tensor,
                            disp: torch.Tensor, level_index: int,
                            cfg: MatcherConfig, is_coarsest: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's full iteration schedule on the per-iteration route,
    whatever the level's size or ``cfg.early_exit_delta``: ``(triplet,
    deltas)``, deltas a (mi, 2) float32 tensor of each iteration's
    weighted_difference of (disp_h, disp_v) with no host read in the loop
    (JAX match.py:424-453): ``device_exit_loop`` with the trace's
    convergence test, the convergence kernel's on the card.  The triplet
    equals match_level's per-iteration route without early exit bit for
    bit."""
    check_supported(cfg)
    mi = cfg.iters_for_level(level_index)
    body = _make_level_body(left, right, _level_blurred_l2(left), cfg,
                            is_coarsest, cfg.smooth_passes_for_level(
                                level_index))
    state, buf = device_exit_loop(body, convergence.convergence_step, disp,
                                  cfg.threshold_schedule(mi), None)
    return state, convergence.deltas(buf).clone()


class PyramidMatchResult(NamedTuple):
    """Per-level disparity triplets, index 0 = finest level."""
    levels: Tuple[torch.Tensor, ...]


def level_dims_for_matching(cfg: MatcherConfig, height: int, width: int,
                            num_levels: int, foveated: bool
                            ) -> List[Tuple[int, int]]:
    """Per-level match dimensions: the full-resolution chain, with the
    levels finer than fovea_level - 1 at the fovea size in foveated mode
    (MatchGPULib.cpp:1230-1240)."""
    dims = list(cfg.dims_chain(height, width)[:num_levels])
    if foveated:
        fov = dims[cfg.fovea_level - 1]
        for i in range(cfg.fovea_level - 1):
            dims[i] = fov
    return dims


def match_pyramid(left_levels: Sequence[torch.Tensor],
                  right_levels: Sequence[torch.Tensor], cfg: MatcherConfig,
                  full_dims: Tuple[int, int], foveated: bool = False,
                  resident_max_pixels: Optional[int] = None
                  ) -> PyramidMatchResult:
    """Coarse-to-fine loop over a full-resolution pyramid, or over a
    foveated one (pyramid.foveate_pyramid) with ``foveated=True``.

    The initial disparity of the coarsest level is zero.  Returns every
    level's refined triplet: mode 1 uses index 0, mode 2 stacks the
    fovea_level finest.  ``resident_max_pixels`` is match_level's
    level-resident gate."""
    n = len(left_levels)
    height, width = full_dims
    dims = level_dims_for_matching(cfg, height, width, n, foveated)
    # A fovea-to-fovea transition upsamples onto the full grid of level
    # fovea_level - 2, whatever the level (dims taken before the fovea
    # override, MatchGPULib.cpp:1231-1232).
    big_h, big_w = cfg.dims_chain(height, width)[cfg.fovea_level - 2]
    results: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    h, w = dims[n - 1]
    ref = left_levels[0]
    disp = torch.zeros((3, h, w), dtype=ref.dtype, device=ref.device)
    for i in range(n - 1, -1, -1):
        disp = match_level(left_levels[i], right_levels[i], disp, i, cfg,
                           is_coarsest=(i == n - 1),
                           resident_max_pixels=resident_max_pixels)
        results[i] = disp
        if i == 0:
            break
        if not foveated or i >= cfg.fovea_level:
            disp = pyr.upsample_to_level(disp, *dims[i - 1], cfg)
        else:
            disp = pyr.foveated_upsample(disp, big_h, big_w, cfg)
    return PyramidMatchResult(levels=tuple(results))


def match_foveated_pair(left: torch.Tensor, right: torch.Tensor,
                        cfg: MatcherConfig,
                        resident_max_pixels: Optional[int] = None):
    """Mode 2 of one (3, H, W) pair: the full pyramids, foveated, then
    matched (matchStackPyramid, MatchGPULib.cpp:534).  Returns every
    level's triplet (index 0 = finest) and the foveated left and right
    pyramids."""
    h, w = left.shape[-2:]
    n = cfg.num_levels(h, w)
    lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
    lf = pyr.foveate_pyramid(lp, cfg, (h, w))
    rf = pyr.foveate_pyramid(rp, cfg, (h, w))
    res = match_pyramid(lf, rf, cfg, (h, w), foveated=True,
                        resident_max_pixels=resident_max_pixels)
    return res.levels, lf, rf
