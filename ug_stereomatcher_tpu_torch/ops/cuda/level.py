"""A whole pyramid level in one launch: wrapper of ``csrc/level.cu``.

Replaces ``level_resident_match`` (ug_stereomatcher_tpu/ops/pallas/
level.py:307, ``pallas_call`` at :351), nearest and bilinear.  The TPU
kernel keeps every plane of a coarse level in VMEM so that the level's
``mi`` iterations cost one dispatch instead of several per iteration.
On the card the same job is done by one cooperative launch with two
phases per iteration, each a loop over 16 x 32 tiles that recomputes its
halo in shared memory: (A) warp, G(W^2) and the direction update over the
tile +- 3, (B) the ``n_smooth`` passes and the average over the tile
+- (n_smooth + 1).  The blocks meet at a grid barrier after each phase
(2 per iteration; ``profile_level`` reads the count and block 0's
cycles per phase back from the card), with the planes between
phases in device memory (a coarse level's working set fits the 50 MB
L2).  A CUDA graph captures the cooperative launch as it is; the
co-resident grid is a host query made once per device and schedule
(``_limits``), outside any capture, and a graph replays on the device it
was captured on.  Phase B's window is dynamic shared memory that grows with
``n_smooth``; an ``n_smooth`` above what the card holds
(``max_smooth_passes``, 33 on an H100) raises.  The per-pixel math is
the per-iteration kernels' own, so the result is bit-exact against the
plain per-iteration loop.

The port's warp is an exact gather, so this kernel has no warp window,
no overflow flag and no recompute path: it computes what ``match_level``
returns in every case.  The grid is sized to what the card can hold at
once; a larger grid is refused by the C entry point and raises here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ug_stereomatcher_tpu_torch.config import (
    INTERP_METHODS,
    average_kernel,
    gaussian_kernel,
    unsupported_interp,
)
from ug_stereomatcher_tpu_torch.ops.cuda._build import (
    check,
    check_planes,
    launch,
    library,
    ptr,
)
from ug_stereomatcher_tpu_torch.ops.cuda.blur import fused_blur_gaussian_plain
from ug_stereomatcher_tpu_torch.ops.cuda.direction import (
    DEFAULT_CONSTS,
    fused_direction_update_plain,
)
from ug_stereomatcher_tpu_torch.ops.cuda.smooth import fused_smooth_average_plain
from ug_stereomatcher_tpu_torch.ops.cuda.warp import warp_plain

MAX_ITERS = 256        # the threshold table travels in the launch arguments
SCRATCH_PLANES = 6     # G(L^2) and the direction update
# The phases block 0 of the kernel times (level.cu Phase): G(L^2); phase
# A's warp (with the staging of L), Gc(W^2), direction update and grid
# barrier; phase B's window load, smoothing passes, average and grid
# barrier.
PHASES = ("prologue", "a_warp", "a_gw2", "a_direction", "a_barrier",
          "b_load", "b_passes", "b_average", "b_barrier")
BAR_WORDS = 2 + len(PHASES)  # arrivals, barriers passed, cycles per phase


def level_resident_match_plain(left: torch.Tensor, right: torch.Tensor,
                               disp: torch.Tensor,
                               thresholds: Sequence[float], n_smooth: int,
                               replace_first: bool,
                               consts: Sequence[float] = DEFAULT_CONSTS,
                               method: str = "nearest") -> torch.Tensor:
    """Plain PyTorch version: the per-iteration loop of match_level, one
    plain warp -> direction update -> smoothing chain per threshold, after
    the clamp blur G(L^2)."""
    bl2 = fused_blur_gaussian_plain(left * left, "clamp")
    state = disp
    for m, threshold in enumerate(thresholds):
        warped = warp_plain(right, state[0], state[1], method)
        state = fused_direction_update_plain(
            left, warped, bl2, state, threshold, replace_first and m == 0,
            consts)
        state = fused_smooth_average_plain(state, n_smooth)
    return state


def _limits(method: str, n_smooth: int):
    """(max_smooth, max_grid) of the current CUDA device: host queries,
    made once per device, method and ``n_smooth`` (the first also raises
    the kernel's shared memory limit on that device), so that no launch,
    and no CUDA graph capture, repeats them."""
    return _device_limits(torch.cuda.current_device(), method, int(n_smooth))


@functools.lru_cache(maxsize=None)
def _device_limits(index: int, method: str, n_smooth: int):
    max_smooth, max_grid = ctypes.c_int(0), ctypes.c_int(0)
    check("ugsm_level_limits",
          library().ugsm_level_limits(int(method == "bilinear"), n_smooth,
                                      ctypes.byref(max_smooth),
                                      ctypes.byref(max_grid)))
    return max_smooth.value, max_grid.value


def max_smooth_passes(method: str = "nearest") -> int:
    """The largest ``n_smooth`` whose phase-B window the current CUDA
    device holds in shared memory."""
    return _limits(method, 0)[0]


def max_coresident_blocks(method: str = "nearest", n_smooth: int = 5) -> int:
    """The largest grid of level-kernel blocks the current CUDA device
    holds at once for ``n_smooth`` passes."""
    return _limits(method, n_smooth)[1]


def _check_args(left, right, disp, thresholds, n_smooth, method):
    if method not in INTERP_METHODS:
        raise unsupported_interp(method)
    shape = disp.shape
    if len(shape) != 3 or shape[0] != 3:
        raise ValueError(f"expected (3, H, W) state, got {tuple(shape)}")
    for name, t in (("left", left), ("right", right)):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if n_smooth < 0:
        raise ValueError(f"n_smooth must be >= 0, got {n_smooth}")
    thresholds = [float(t) for t in thresholds]
    if len(thresholds) > MAX_ITERS:
        raise ValueError(f"at most {MAX_ITERS} iterations, got "
                         f"{len(thresholds)}")
    return thresholds, check_planes("level_resident_match", left, right, disp)


def _launch(left, right, disp, thresholds, n_smooth, replace_first, consts,
            method, grid_blocks):
    """One launch of the kernel; returns the state and the BAR_WORDS
    barrier words (float32 storage holding uint32 words)."""
    most = max_smooth_passes(method)
    if n_smooth > most:
        raise ValueError(f"n_smooth={n_smooth}: the level kernel's window "
                         f"holds at most {most} smoothing passes on this "
                         f"device")
    _, H, W = disp.shape
    out = torch.empty_like(disp)
    scratch = torch.empty(SCRATCH_PLANES * H * W + BAR_WORDS,
                          dtype=torch.float32, device=disp.device)
    barrier = scratch[SCRATCH_PLANES * H * W:]
    thr = (ctypes.c_float * max(1, len(thresholds)))(*thresholds)
    g = gaussian_kernel()
    launch("ugsm_level_resident", "level", ptr(left), ptr(right), ptr(disp),
           ptr(out), ptr(scratch), ptr(barrier), thr, len(thresholds), H, W,
           int(n_smooth), int(bool(replace_first)), int(method == "bilinear"),
           float(g[0]), float(g[1]), float(g[2]), float(average_kernel()[1]),
           *(float(c) for c in consts), int(grid_blocks),
           max_coresident_blocks(method, n_smooth))
    return out, barrier


def level_resident_match(left: torch.Tensor, right: torch.Tensor,
                         disp: torch.Tensor, thresholds: Sequence[float],
                         n_smooth: int, replace_first: bool,
                         consts: Sequence[float] = DEFAULT_CONSTS,
                         method: str = "nearest",
                         grid_blocks: int = 0) -> torch.Tensor:
    """Refine the (3, H, W) state ``disp`` over one level: one iteration
    per entry of ``thresholds`` (warp of ``right`` by the state, direction
    update against ``left``, ``n_smooth`` smoothing passes and the
    average).  ``replace_first`` replaces the confidence on the first
    iteration (the coarsest level); ``consts`` is MatcherConfig.conf_consts.
    Returns the refined state.  A CUDA tensor runs the kernel in one
    cooperative launch; a CPU tensor runs the plain version.
    ``grid_blocks`` > 0 asks for that many blocks instead of sizing the
    grid from the level: a test-only override, to show that a grid the
    card cannot hold at once is refused."""
    thresholds, dev = _check_args(left, right, disp, thresholds, n_smooth,
                                  method)
    if dev.type == "cpu":
        return level_resident_match_plain(left, right, disp, thresholds,
                                          n_smooth, replace_first, consts,
                                          method)
    return _launch(left, right, disp, thresholds, n_smooth, replace_first,
                   consts, method, grid_blocks)[0]


def profile_level(left: torch.Tensor, right: torch.Tensor,
                  disp: torch.Tensor, thresholds: Sequence[float],
                  n_smooth: int, replace_first: bool,
                  consts: Sequence[float] = DEFAULT_CONSTS,
                  method: str = "nearest") -> dict:
    """Launch the kernel on CUDA tensors as level_resident_match does,
    synchronise, and return what its block 0 counted on the card: the
    grid barriers it passed (``"grid_barriers"``) and the SM clock cycles
    of its thread (0, 0) in each of PHASES, summed over the iterations
    (``"cycles"``)."""
    thresholds, dev = _check_args(left, right, disp, thresholds, n_smooth,
                                  method)
    if dev.type != "cuda":
        raise ValueError("profile_level: the kernel runs on CUDA tensors "
                         "only")
    _, words = _launch(left, right, disp, thresholds, n_smooth,
                       replace_first, consts, method, 0)
    words = words.view(torch.int32).tolist()
    return {"grid_barriers": words[1],
            "cycles": dict(zip(PHASES, words[2:]))}
