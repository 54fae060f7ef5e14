"""Confidence-weighted smoothing chain: wrapper of ``csrc/smooth.cu``.

Replaces ``fused_smooth_average`` (ug_stereomatcher_tpu/ops/pallas/
smooth.py, ``pallas_call`` at :205).  Its byte bound is the 3 state
planes read and written once, but with the state in shared memory the
passes are bound by instruction issue (three IEEE divisions and about
150 instructions a pixel and pass).  One launch runs up to
``max_chunk()`` (10) passes and, in the last launch, the 3-tap average:
each block loads its output tile plus a halo of one line per pass (and
one for the average) into shared memory once, runs the passes there and
writes only its tile, so the default configs (5 and 10 passes) take one
launch and no scratch plane; more passes go through ceil(n /
max_chunk()) launches and scratch states.  Each pass is weighted by the confidence
from before it; row 0 and column 0 are kept; clamp addressing.  The term
order is that of ops.smooth (centre, left, right, up, down; num / den)
with no fused multiply-add, so it is bit-exact against the plain version.

The row-sharded form (``row0`` given; ``row_halo=True`` of the TPU
kernel, smooth.py:48-110 and :172-202) smooths one shard's rows with
``smooth_halo_rows(n)`` real rows of halo on each side: row 0 and the
clamps resolve at the image's global edges, and each pass spoils one more
row at each cut edge of the band, never the shard's own rows.

Early exit's guarded form (``stop`` given, match.match_level on the
card): every block of every launch returns before its first load while
the level's flag is set (ops/cuda/convergence.py), so ``out``, which
match_level gives (one of the two states it owns per level), keeps the
last state that ran.
"""

from __future__ import annotations

from typing import Optional

import torch

from ug_stereomatcher_tpu_torch.config import average_kernel
from ug_stereomatcher_tpu_torch.ops.conv import blur_average_clamp
from ug_stereomatcher_tpu_torch.ops.cuda._build import (
    check_out,
    check_planes,
    guarded_plain,
    launch,
    library,
    ptr,
    stop_ptr,
)
from ug_stereomatcher_tpu_torch.ops.resample import band_rows
from ug_stereomatcher_tpu_torch.ops.smooth import weighted_smooth


def smooth_halo_rows(n_passes: int) -> int:
    """Halo rows the row-sharded form needs on each side for ``n_passes``
    passes and the 3-tap average."""
    return n_passes + 1


def max_chunk() -> int:
    """The smoothing passes one launch of the kernel runs (a compile-time
    constant of csrc/smooth.cu, sized to the shared memory)."""
    return library().ugsm_smooth_max_chunk()


def fused_smooth_average_plain(state: torch.Tensor, n_passes: int,
                               row0: Optional[int] = None,
                               global_h: Optional[int] = None, *,
                               stop: Optional[torch.Tensor] = None,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version: n weighted_smooth passes + the average.  In
    the row-sharded form the band's rows outside the image are re-clamped
    to the image's edge rows before every pass and before the average.
    The guard is ``_build.guarded_plain``'s."""
    rows = state.shape[-2] - (0 if row0 is None
                              else 2 * smooth_halo_rows(n_passes))
    return guarded_plain(stop, out, (3, rows, state.shape[-1]), state,
                         lambda: _smooth_plain(state, n_passes, row0,
                                               global_h))


def _smooth_plain(state, n_passes, row0, global_h) -> torch.Tensor:
    if row0 is None:
        for _ in range(n_passes):
            state = weighted_smooth(state, state[2])
        return blur_average_clamp(state)
    halo = smooth_halo_rows(n_passes)
    rows = state.shape[-2] - 2 * halo
    edge, _ = band_rows(state.shape[-2], row0 - halo, global_h, state.device)
    for _ in range(n_passes):
        state = state.index_select(-2, edge)
        state = weighted_smooth(state, state[2], row0 - halo)
    out = blur_average_clamp(state.index_select(-2, edge))
    return out[..., halo:halo + rows, :].contiguous()


def fused_smooth_average(state: torch.Tensor, n_passes: int,
                         row0: Optional[int] = None,
                         global_h: Optional[int] = None, *,
                         stop: Optional[torch.Tensor] = None,
                         out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``n_passes`` smoothing passes and the 3-tap average over a (3, H, W)
    float32 [disp_h, disp_v, conf] state.

    Row-sharded form: with ``row0`` and ``global_h`` given, ``state`` is
    (3, Hl + 2 h, W) with h = smooth_halo_rows(n_passes), the rows [row0 -
    h, row0 + Hl + h) of a ``global_h``-row image (rows outside the image
    may hold anything), and the result is the (3, Hl, W) rows [row0, row0
    + Hl).

    ``out``: the (3, Hl, W) result's buffer (default a new one; it must
    not overlap ``state``).  ``stop``: early exit's flag (one int32; the
    kernel does nothing while it is set).  A CUDA tensor runs the kernel
    (``max(1, ceil(n_passes / max_chunk()))`` launches, counted as one
    call); a CPU tensor runs the plain version."""
    if state.ndim != 3 or state.shape[0] != 3:
        raise ValueError(f"expected (3, H, W) state, got {tuple(state.shape)}")
    if n_passes < 0:
        raise ValueError(f"n_passes must be >= 0, got {n_passes}")
    _, rows, W = state.shape
    halo = 0 if row0 is None else smooth_halo_rows(n_passes)
    Hl = rows - 2 * halo
    if row0 is not None and (global_h is None or Hl < 1
                             or not 0 <= row0 <= global_h - Hl):
        raise ValueError(f"a band of {rows} rows with {halo} halo rows on "
                         f"each side does not lie in an image of "
                         f"global_h={global_h} rows from row {row0}")
    dev = check_planes("fused_smooth_average", state)
    if dev.type == "cpu":
        return fused_smooth_average_plain(state, n_passes, row0, global_h,
                                          stop=stop, out=out)
    out = check_out("fused_smooth_average", out, (3, Hl, W), state)
    # scratch states between launches: none for n <= max_chunk()
    chunks = -(-n_passes // max_chunk())
    tmp = [torch.empty_like(state) for _ in range(min(2, max(0, chunks - 1)))]
    tmp_ptrs = [ptr(t) for t in tmp] + [None] * (2 - len(tmp))
    tap = float(average_kernel()[1])
    launch("ugsm_smooth_average",
           "smooth" if row0 is None else "smooth_row_halo", ptr(state),
           ptr(out), *tmp_ptrs,
           rows if row0 is None else global_h, W, Hl, row0 or 0, halo,
           int(n_passes), tap, stop_ptr("fused_smooth_average", stop, dev))
    return out
