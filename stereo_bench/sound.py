"""Sound float32 runs that differ from the reference in their last bits:
the plain reference with its sums in another order.

They keep every guarantee the configurations state (float32, TF32 off,
the schedule), as a fused or reordered kernel of the program would,
so what they read against the reference is what a sound change of the
program may read: the lower reading of each limit of the check.
The bfloat16 control (``reference.match_pair(..., torch.bfloat16)``)
gives the upper reading.  ``python3 -m stereo_bench.control`` reads both.

* ``taps_reversed``: every 1-D stencil sum (the blurs, the 3-tap average)
  from the last tap to the first;
* ``stencil_reversed``: the smooth's plus stencil with the neighbours
  first, in reverse order, and its centre last; and each correlation
  map's channel sum from the last channel;
* ``exit_sums_float32``: early exit's weighted sums accumulated in
  float32 by ``torch.sum`` (the JAX package's precision) instead of
  float64, which moves a change within rounding of the threshold to the
  other side of it (early-exit configurations only).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch

from stereo_bench.reference import matcher as M

VARIANTS = ("taps_reversed", "stencil_reversed", "exit_sums_float32")
# the variants that change only the early-exit test
EXIT_VARIANTS = ("exit_sums_float32",)


def _conv1d_reversed(x: torch.Tensor, taps: Sequence[float], axis: int,
                     boundary: str) -> torch.Tensor:
    r = len(taps) // 2
    axis = axis % x.ndim
    xp = M._pad(x, axis, r, boundary)
    n = x.shape[axis]
    out = None
    for k in range(r, -r - 1, -1):
        w = taps[r - k]
        if w == 0.0:
            continue
        term = w * xp.narrow(axis, r + k, n)
        out = term if out is None else out + term
    return out


def _smooth_reversed(state: torch.Tensor, passes: int) -> torch.Tensor:
    h, w = state.shape[-2], state.shape[-1]
    row = torch.arange(h, device=state.device)[:, None]
    col = torch.arange(w, device=state.device)[None, :]
    keep = (row == 0) | (col == 0)
    for _ in range(passes):
        conf = state[2]
        num = den = None
        for (dx, dy) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            cs = M.shift(conf, dx, dy)
            t = M.shift(state, dx, dy) * cs
            num = t if num is None else num + t
            den = cs if den is None else den + cs
        state = torch.where(keep, state, (num + state * conf) / (den + conf))
    return M.blur(state, M.AVERAGE, "clamp")


def _weighted_difference_float32(new: torch.Tensor, old: torch.Tensor,
                                 conf: torch.Tensor) -> float:
    num = torch.sum((new - old).abs() * conf).item()
    den = torch.sum(conf).item()
    return num / den if den > 0.0 else 0.0


@contextlib.contextmanager
def variant(name: str) -> Iterator[None]:
    """The reference runs as ``name`` inside the block."""
    if name not in VARIANTS:
        raise ValueError(f"no variant {name!r}; the variants are {VARIANTS}")
    saved = {k: getattr(M, k) for k in ("conv1d", "smooth", "_clip01",
                                        "weighted_difference")}
    try:
        if name == "taps_reversed":
            M.conv1d = _conv1d_reversed
        elif name == "exit_sums_float32":
            M.weighted_difference = _weighted_difference_float32
        else:
            clip = saved["_clip01"]
            M.smooth = _smooth_reversed
            # direction_update sums the clipped (C, H, W) maps from the
            # first channel: flipped, the sum runs from the last
            M._clip01 = lambda r: clip(r).flip(0) if r.ndim == 3 else clip(r)
        yield
    finally:
        for k, v in saved.items():
            setattr(M, k, v)
