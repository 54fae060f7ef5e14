"""The plain reference matcher: modes 1 and 2 in straightforward PyTorch.

A frozen copy of the arithmetic the port's plain operations compute
(separable convolutions with the reference's two boundaries, the
texture-style resamples and warp, the correlate -> parabola -> update
step, the confidence-weighted smoothing and the 3-tap average, the
factor-2 pyramid, the coarse-to-fine loop and the fovea stack), written
once per operation with one rounding per product and per sum, in the
order the original matcher (gerac83/ug_stereomatcher, MatchGPULib.cpp
and MatchLib.cu) computes it.  It imports nothing of the program: its
constants, tap tables, dimension chains and schedules are worked out
here from the configuration file's ``matcher`` fields.

``dtype`` sets the precision every plane is held and computed in:
float32 is the reference; bfloat16 is the lower-precision control
(check.py).  Matrix products and cuDNN convolutions never run here, and
TF32 is switched off all the same.

Early exit (``early_exit_delta`` set) runs as the JAX package defines it
(ug_stereomatcher_tpu/match.py:392-414, ops/convergence.py:19-38): a
level of more than one iteration, larger than the level-resident gate
the configuration states, loops while ``m < mi`` and ``delta >= thr``,
``delta`` the larger of the two axes' confidence-weighted mean absolute
change (0 where the new confidence sums to 0, and a NaN stops it),
``thr`` the delta rounded to float32, at least one iteration.  One
departure, on purpose: the weighted sums are accumulated in float64,
the order closest to exact, where XLA sums in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# MatchLib_common.h:15, the truncated literal (not math.sqrt(2))
SCALE = 1.41421356
# MatchGPULib.cpp:761-774, renormalised by its own sum
_RAW_GAUSSIAN = (0.0816475, 0.218507, 0.303281, 0.218507, 0.0816475)
# MatchGPULib.cpp:344-350: a 3-tap average in 5-tap storage
_AVERAGE = (0.0, 0.3333, 0.3333, 0.3333, 0.0)
# the correlation search moves (dx, dy): left, right, up, down, centre
# (MatchGPULib.cpp:1677)
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0))

DEFAULTS: Dict[str, object] = {
    "max_level": 14, "scale": SCALE, "min_dim": 8, "fovea_level": 7,
    "level_cutoff": 22, "coarse_min_index": 6, "early_exit_delta": None,
    "smooth_passes": 5, "smooth_passes_fine": 10, "fine_smooth_levels": 2,
    "conf_blend_new": 0.75, "conf_blend_old": 0.25, "conf_no_peak": 0.4,
    "conf_affine_scale": 0.3, "conf_affine_bias": 0.7,
    "threshold_init": 1.0, "threshold_floor": 0.1,
    "threshold_decay_window": 7, "interp": "nearest",
    "scale_conf_on_upsample": True, "dtype": "float32",
}


def _taps(raw: Sequence[float]) -> Tuple[float, ...]:
    k = np.asarray(raw, dtype=np.float64)
    return tuple(float(v) for v in k.astype(np.float32))


GAUSS = _taps(np.asarray(_RAW_GAUSSIAN) / np.sum(_RAW_GAUSSIAN))
AVERAGE = _taps(_AVERAGE)


class Schedule:
    """The matcher's sizes and schedule, from a mapping of its fields."""

    def __init__(self, fields: Mapping[str, object]):
        unknown = set(fields) - set(DEFAULTS)
        if unknown:
            raise ValueError(f"unknown matcher fields {sorted(unknown)}")
        p = {**DEFAULTS, **fields}
        if p["interp"] not in ("nearest", "bilinear"):
            raise ValueError(f"interp {p['interp']!r}")
        self.p = p
        self.scale = float(p["scale"])
        self.interp = str(p["interp"])

    def dims_chain(self, h: int, w: int) -> List[Tuple[int, int]]:
        """dims[i+1] = int(dims[i] / SCALE) (MatchGPULib.cpp:1224-1228)."""
        out = [(h, w)]
        for _ in range(int(self.p["max_level"]) - 1):
            h, w = int(h / self.scale), int(w / self.scale)
            out.append((h, w))
        return out

    def num_levels(self, h: int, w: int) -> int:
        n = 0
        for (a, b) in self.dims_chain(h, w):
            if a < self.p["min_dim"] or b < self.p["min_dim"]:
                break
            n += 1
        return max(1, n)

    def fovea_dims(self, h: int, w: int) -> Tuple[int, int]:
        return self.dims_chain(h, w)[int(self.p["fovea_level"]) - 1]

    @property
    def exit_threshold(self) -> Optional[float]:
        """The early-exit threshold rounded to float32, or None (the fixed
        schedule)."""
        delta = self.p["early_exit_delta"]
        return None if delta is None else float(np.float32(delta))

    def exits(self, i: int, px: int, above_px: Optional[int]) -> bool:
        """Whether level ``i`` of ``px`` pixels may exit early: early exit
        is on, the level has more than one iteration and is larger than
        the level-resident gate ``above_px`` (the levels within it run
        their full schedule, as the JAX package's level kernel does)."""
        if self.exit_threshold is None:
            return False
        if above_px is None:
            raise ValueError("an early-exit schedule needs the gate of the "
                             "levels that may exit")
        return self.iters(i) > 1 and px > above_px

    def iters(self, i: int) -> int:
        """MatchGPULib.cpp:1741."""
        if i >= self.p["coarse_min_index"]:
            return int(self.p["level_cutoff"])
        return (i + 1) * 2

    def passes(self, i: int) -> int:
        """MatchGPULib.cpp:2257-2261."""
        if i < self.p["fine_smooth_levels"]:
            return int(self.p["smooth_passes_fine"])
        return int(self.p["smooth_passes"])

    def thresholds(self, mi: int) -> List[float]:
        """The clamp threshold of iterations 1..mi, updated after every
        even one (MatchGPULib.cpp:2299-2306)."""
        th = float(self.p["threshold_init"])
        floor = float(self.p["threshold_floor"])
        out, half = [], mi // 2
        for m in range(1, mi + 1):
            out.append(th)
            if m % 2 == 0 and m < mi:
                rem = half - m // 2
                if rem < self.p["threshold_decay_window"]:
                    th = (rem - 1) * ((1.0 - floor) / (half - 1.0)) + floor
                else:
                    th = float(self.p["threshold_init"])
        return out

    @property
    def conf(self) -> Tuple[float, ...]:
        p = self.p
        return (p["conf_no_peak"], p["conf_affine_scale"],
                p["conf_affine_bias"], p["conf_blend_new"],
                p["conf_blend_old"])


# ---------------------------------------------------------------- stencils
def _pad(x: torch.Tensor, axis: int, r: int, boundary: str) -> torch.Tensor:
    n = x.shape[axis]
    if boundary == "clamp":
        idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
        return x.index_select(axis, idx)
    pads = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [r, r]
    return F.pad(x, pads)


def conv1d(x: torch.Tensor, taps: Sequence[float], axis: int,
           boundary: str) -> torch.Tensor:
    """out[i] = sum over k of taps[r - k] * x[i + k], in offset order,
    zero taps skipped (MatchLib.cu:133)."""
    r = len(taps) // 2
    axis = axis % x.ndim
    xp = _pad(x, axis, r, boundary)
    n = x.shape[axis]
    out = None
    for k in range(-r, r + 1):
        w = taps[r - k]
        if w == 0.0:
            continue
        term = w * xp.narrow(axis, r + k, n)
        out = term if out is None else out + term
    return out


def blur(x: torch.Tensor, taps: Sequence[float], boundary: str):
    """The row pass, then the column pass (MatchGPULib.cpp:866-960)."""
    return conv1d(conv1d(x, taps, -1, boundary), taps, -2, boundary)


def shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """dst(x, y) = src(x + dx, y + dy), clamp addressing."""
    h, w = img.shape[-2], img.shape[-1]
    out = img
    if dy:
        out = out.index_select(-2, (torch.arange(h, device=img.device)
                                    + dy).clamp(0, h - 1))
    if dx:
        out = out.index_select(-1, (torch.arange(w, device=img.device)
                                    + dx).clamp(0, w - 1))
    return out


# ---------------------------------------------------------------- sampling
def _gather(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    idx = (iy.long() * w + ix.long()).reshape(-1)
    return flat.index_select(-1, idx).reshape(img.shape[:-2] + iy.shape)


def warp(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
         method: str) -> torch.Tensor:
    """dst(x, y) = src(x + 0.5 + dx, y + 0.5 + dy) in texel coordinates,
    clamp addressing: point sampling, or CUDA's linear filtering with
    weights from (coord - 0.5) (warpAbyB, MatchLib.cu:499-549).  The
    coordinates are float32 in every precision; the weights and the
    sums take the image's dtype."""
    h, w = img.shape[-2], img.shape[-1]
    f32 = torch.float32
    ys = (torch.arange(h, dtype=f32, device=img.device) + 0.5)[:, None]
    xs = (torch.arange(w, dtype=f32, device=img.device) + 0.5)[None, :]
    x, y = xs + dx.to(f32), ys + dy.to(f32)
    if method == "nearest":
        ix = torch.clamp(torch.floor(x), 0, w - 1)
        iy = torch.clamp(torch.floor(y), 0, h - 1)
        return _gather(img, iy, ix)
    xf, yf = x - 0.5, y - 0.5
    x0, y0 = torch.floor(xf), torch.floor(yf)
    ax, ay = (xf - x0).to(img.dtype), (yf - y0).to(img.dtype)
    x0i, x1i = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
    y0i, y1i = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    top = _gather(img, y0i, x0i) * (1 - ax) + _gather(img, y0i, x1i) * ax
    bot = _gather(img, y1i, x0i) * (1 - ax) + _gather(img, y1i, x1i) * ax
    return top * (1 - ay) + bot * ay


def _axis_taps(n_out: int, n_in: int, factor: float, divide: bool,
               off: int, method: str):
    """One axis of a texture resample, in float64 on the host: nearest
    indices, or bilinear floor taps and float32 weights (a clamped pair
    of equal taps gets weight 0)."""
    t = np.arange(n_out) + off + 0.5
    c = t / factor if divide else t * factor
    if method == "nearest":
        return np.clip(np.floor(c), 0, n_in - 1).astype(np.int64), None
    f = c - 0.5
    i0f = np.floor(f)
    wt = (f - i0f).astype(np.float32)
    i0 = np.clip(i0f, 0, n_in - 1).astype(np.int64)
    i1 = np.clip(i0f + 1, 0, n_in - 1).astype(np.int64)
    same = i1 == i0
    wt = np.where(same, 0.0, wt).astype(np.float32)
    i0 = np.where(same & (i0f < 0), 0, i0)
    return np.minimum(i0, n_in - 1), wt


def resample(img: torch.Tensor, out_h: int, out_w: int, factor: float,
             value_scale: float, method: str, divide: bool = False,
             row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """Axis-separable resample: destination texel centres t map to t *
    factor (t / factor with ``divide``); rows interpolate first, then
    columns, then the value scale (subsampleKernel and
    subsampleDispKernel, MatchLib.cu:311-429).  ``row_off``/``col_off``
    evaluate a window of the full destination grid."""
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    iy, wy = _axis_taps(out_h, h, factor, divide, row_off, method)
    ix, wx = _axis_taps(out_w, w, factor, divide, col_off, method)
    iy0, ix0 = torch.from_numpy(iy).to(dev), torch.from_numpy(ix).to(dev)
    if wy is None:
        out = img.index_select(-2, iy0).index_select(-1, ix0)
    else:
        iy1 = torch.clamp(iy0 + 1, max=h - 1)
        ix1 = torch.clamp(ix0 + 1, max=w - 1)
        wyt = torch.from_numpy(wy).to(dev, img.dtype)[:, None]
        wxt = torch.from_numpy(wx).to(dev, img.dtype)
        rows = (img.index_select(-2, iy0) * (1 - wyt)
                + img.index_select(-2, iy1) * wyt)
        out = (rows.index_select(-1, ix0) * (1 - wxt)
               + rows.index_select(-1, ix1) * wxt)
    return out if value_scale == 1.0 else value_scale * out


# ---------------------------------------------------------------- one step
def _clip01(r: torch.Tensor) -> torch.Tensor:
    r = torch.where(r > 1.0, 1.0, r)
    return torch.where(r < 0.0, 0.0, r)


def _parabola(lo, c, hi, threshold: float, no_peak, a_scale, a_bias):
    """PolyDisparity (MatchLib.cu:790): the offset increment and the
    axis confidence; a NaN input gives (0, no_peak)."""
    b1 = (hi - lo) * 0.5
    c1 = hi - (c + b1)
    peak = c1 < 0
    off = torch.clamp((-b1 * 0.5) / c1, -threshold, threshold)
    cstar = (c1 * off + b1) * off + c
    over = cstar > 1.0
    d = cstar - c
    off_over = torch.where(d > 1e-10, off * ((1.0 - c) / d), off)
    conf_in = torch.where(over, 1.0, a_scale * cstar + a_bias)
    off_in = torch.where(over, off_over, off)
    return (torch.where(peak, off_in, 0.0),
            torch.where(peak, conf_in, no_peak))


def direction_update(left, warped, bl2, state, threshold: float,
                     replace_conf: bool, conf) -> torch.Tensor:
    """Correlate the left image with the warped right at the five moves
    (MoveCorrelation, MatchLib.cu:666), fit a parabola on each axis and
    update the state [disp_h, disp_v, conf]."""
    no_peak, a_scale, a_bias, w_new, w_old = conf
    bw2 = blur(warped * warped, GAUSS, "clamp")
    crosses = torch.stack([left * shift(warped, dx, dy)
                           for (dx, dy) in MOVES])
    bcross = blur(crosses, GAUSS, "zero")
    maps = []
    for k, (dx, dy) in enumerate(MOVES):
        r = (bcross[k] * bcross[k]) / (bl2 * shift(bw2, dx, dy))
        r = _clip01(r)
        acc = r[0]
        for c in range(1, r.shape[0]):
            acc = acc + r[c]
        maps.append(acc * (1.0 / r.shape[0]))
    m_l, m_r, m_u, m_d, m_c = maps
    inc_h, conf_h = _parabola(m_l, m_c, m_r, threshold, no_peak, a_scale,
                              a_bias)
    inc_v, conf_v = _parabola(m_u, m_c, m_d, threshold, no_peak, a_scale,
                              a_bias)
    new = conf_h * conf_v
    if replace_conf:
        c = new
    else:
        c = _clip01(w_new * new + w_old * state[2])
    return torch.stack([inc_h + state[0], inc_v + state[1], c])


def smooth(state: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` confidence-weighted plus-stencil passes (smoothKernel,
    MatchLib.cu:1092-1170; row 0 and column 0 keep their values), all
    three planes against the pass's input confidence, then the 3-tap
    average with the clamp boundary."""
    h, w = state.shape[-2], state.shape[-1]
    row = torch.arange(h, device=state.device)[:, None]
    col = torch.arange(w, device=state.device)[None, :]
    keep = (row == 0) | (col == 0)
    for _ in range(passes):
        conf = state[2]
        num, den = state * conf, conf
        for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cs = shift(conf, dx, dy)
            num = num + shift(state, dx, dy) * cs
            den = den + cs
        state = torch.where(keep, state, num / den)
    return blur(state, AVERAGE, "clamp")


# ---------------------------------------------------------------- pyramid
def build_pyramid(img: torch.Tensor, s: Schedule, n: int):
    """CreatePyramidFromImage (MatchGPULib.cpp:1033-1125): level 1 from
    blurred level 0 at scale SCALE, level i+2 from blurred level i at
    scale 2 (zero-boundary blurs)."""
    h, w = img.shape[-2:]
    dims = s.dims_chain(h, w)
    levels: List[Optional[torch.Tensor]] = [img] + [None] * (n - 1)
    scale2 = float(int(s.scale * s.scale + 0.5))
    for i in range(n):
        first = i == 0 and n > 1
        if not first and i + 2 >= n:
            continue
        b = blur(levels[i], GAUSS, "zero")
        if first:
            levels[1] = resample(b, *dims[1], s.scale, 1.0, s.interp)
        if i + 2 < n:
            levels[i + 2] = resample(b, *dims[i + 2], scale2, 1.0, s.interp)
    return levels


def _upsample(disp, out_h, out_w, s: Schedule, **win) -> torch.Tensor:
    """subsampleDispKernel (MatchLib.cu:372-429): values times SCALE, the
    confidence too unless ``scale_conf_on_upsample`` is off."""
    inv = 1.0 / s.scale
    up = resample(disp, out_h, out_w, inv, s.scale, s.interp, **win)
    if not s.p["scale_conf_on_upsample"]:
        conf = resample(disp[2:3], out_h, out_w, inv, 1.0, s.interp, **win)
        up = torch.cat([up[:2], conf])
    return up


def weighted_difference(new: torch.Tensor, old: torch.Tensor,
                        conf: torch.Tensor) -> float:
    """sum(|new - old| * conf) / sum(conf), each product rounded in the
    planes' dtype and both sums accumulated in float64; 0 where sum(conf)
    is not > 0 (weightedDifference, MatchGPULib.cpp:1336-1437)."""
    num = ((new - old).abs() * conf).double().sum().item()
    den = conf.double().sum().item()
    return num / den if den > 0.0 else 0.0


def changed_enough(dh: float, dv: float, thr: float) -> bool:
    """The JAX loop's condition ``max(dh, dv) >= thr``: a NaN in either
    carries through the max and stops the level."""
    if math.isnan(dh) or math.isnan(dv):
        return False
    return max(dh, dv) >= thr


def match_level(left, right, disp, i: int, s: Schedule, coarsest: bool,
                exits: bool = False) -> Tuple[torch.Tensor, int]:
    """One level: warp, update, smooth per iteration, over the fixed
    schedule or, where the level ``exits``, until an iteration changes
    the disparity by less than the threshold.  Returns (the level's
    triplet, the iterations run)."""
    bl2 = blur(left * left, GAUSS, "clamp")
    n_smooth = s.passes(i)
    thr = s.exit_threshold
    state = disp
    ths = s.thresholds(s.iters(i))
    for m, th in enumerate(ths):
        warped = warp(right, state[0], state[1], s.interp)
        new = direction_update(left, warped, bl2, state, th,
                               coarsest and m == 0, s.conf)
        new = smooth(new, n_smooth)
        if exits:
            go_on = changed_enough(weighted_difference(new[0], state[0],
                                                       new[2]),
                                   weighted_difference(new[1], state[1],
                                                       new[2]), thr)
            if not go_on:
                return new, m + 1
        state = new
    return state, len(ths)


def match_pair(left: torch.Tensor, right: torch.Tensor,
               fields: Mapping[str, object], foveated: bool,
               dtype: torch.dtype = torch.float32,
               exit_above_px: Optional[int] = None) -> Dict[str, object]:
    """One pair, (3, H, W) images of any dtype on any device.  Mode 1:
    ``{"triplet": (3, H, W)}``; mode 2 (``foveated``): ``{"stack": (3, k *
    fh, fw), "stack_left", "stack_right": (k * 3 * fh, fw)}``, k =
    fovea_level, the levels level-major (UG_GPU_matcher.cpp:163-369).
    Both also hold ``iterations``, the iterations each level ran (index
    0 the finest), and ``exit_levels``, the levels that could exit early:
    those larger than ``exit_above_px`` pixels (the configuration's
    level-resident gate), where early exit is on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = Schedule(fields)
    h, w = left.shape[-2:]
    n = s.num_levels(h, w)
    k = int(s.p["fovea_level"])
    if foveated and n < k:
        raise ValueError(f"{h}x{w} has {n} levels, fewer than fovea {k}")
    pyr = build_pyramid(torch.cat([left, right]).to(dtype), s, n)
    lp, rp = [lv[:3] for lv in pyr], [lv[3:] for lv in pyr]
    dims = s.dims_chain(h, w)[:n]
    if foveated:
        fh, fw = dims[k - 1]
        for side in (lp, rp):
            for i in range(k - 1):
                top, lft = dims[i][0] // 2 - fh // 2, dims[i][1] // 2 - fw // 2
                side[i] = side[i][..., top:top + fh, lft:lft + fw]
        big_h, big_w = dims[k - 2]
        dims = [(fh, fw)] * (k - 1) + dims[k - 1:]
    disp = torch.zeros((3,) + tuple(dims[n - 1]), dtype=dtype,
                       device=left.device)
    levels: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    iterations = [0] * n
    exit_levels = [i for i in range(n)
                   if s.exits(i, dims[i][0] * dims[i][1], exit_above_px)]
    for i in range(n - 1, -1, -1):
        disp, iterations[i] = match_level(lp[i], rp[i], disp, i, s,
                                          i == n - 1, i in exit_levels)
        levels[i] = disp
        if i == 0:
            break
        if not foveated or i >= k:
            disp = _upsample(disp, *dims[i - 1], s)
        else:
            fh, fw = disp.shape[-2:]
            disp = _upsample(disp, fh, fw, s, row_off=big_h // 2 - fh // 2,
                             col_off=big_w // 2 - fw // 2)
    counts = {"iterations": iterations, "exit_levels": exit_levels}
    if not foveated:
        return {"triplet": levels[0], **counts}
    return {"stack": torch.cat(levels[:k], dim=-2),
            "stack_left": torch.cat([x.flatten(0, 1) for x in lp[:k]]),
            "stack_right": torch.cat([x.flatten(0, 1) for x in rp[:k]]),
            **counts}
