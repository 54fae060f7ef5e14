"""Separable resample, nearest and bilinear: wrapper of
``csrc/resample.cu``.

Replaces ``resample_static`` (ug_stereomatcher_tpu/ops/pallas/resample.py,
``pallas_call`` at :223), reached through ``resample_tex`` (:286), for
``method="nearest"`` and ``"bilinear"`` (the ``wy``/``wx`` form with
``_bilinear_taps`` :261).  Bound on the card by device memory: a gather.
The TPU kernel selects rows and columns with one-hot (two-hot for
bilinear) matmuls because its vector unit cannot gather; the kernels here
read their source floats directly with coalesced writes.  Both give each
thread 4 columns (32 apart) of a strip of rows across the planes, the
taps held in registers; the bilinear kernel also keeps the source rows a
strip reuses in registers, and its grid is sized to the output
(``bilinear_launch``).  Bit-exact against the plain version.

The taps are computed on the host in float64 with numpy, as the JAX
package's ``resample_tex`` computes them: nearest indices, or bilinear
floor taps with float32 weights (``ops.resample.bilinear_taps``), and go
to the card in one copy (``upload_taps``).  Where the coordinate map is
an ``ops.resample.ScaleMap`` (every call of the pyramid and the
upsamples) the taps are constants of the call site, as XLA folds them
into the JAX package's executable: one device copy per (device, method,
output size, source size, map, window) is computed and uploaded at its
first call and kept for the process (``device_taps`` through
``kept_taps``, which the row-sharded resample of parallel/spatial.py
uses for each shard's taps too; a few KB each), so a later call, and a
CUDA graph captured over it, reads them with no host work and no
host-to-device copy.  Any other map computes and uploads its
taps per call, which a capture refuses.  The bilinear form uses these
host taps on every level.  The JAX package sends small levels to its
float32 ``tex_gather`` instead (pyramid.py:39-54), a size gate that exists
only to skip the TPU kernel's tiling on small images; the port has no
such gate, so its bilinear pyramid differs from the JAX package's on
those levels by the float32 rounding of the coordinates (about 1e-5
relative; tests/test_torch_kernels.py).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.config import INTERP_METHODS, unsupported_interp
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.resample import (
    CoordFn,
    ScaleMap,
    bilinear_taps,
    nearest_indices,
    resample_static_plain,
)

MAX_KERNEL_ELEMENTS = 2 ** 31  # the bilinear kernel's offsets are 32-bit
COLUMN_SPAN = 128              # columns a warp covers: 4 a thread, 32 apart
STRIP_ROWS = (4, 2, 1)         # the bilinear kernel's strip heights
BLOCK_WARPS = (8, 4, 2, 1)
MIN_BLOCKS_PER_SM = 2          # the grid the launch shape aims for
MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=4096)
def bilinear_launch(c: int, h2: int, w2: int,
                    sms: int) -> Tuple[int, int, int]:
    """(rows, planes, warps) of the bilinear kernel for a (c, h2, w2)
    output on a card of ``sms`` SMs: the strip height, the planes a block
    takes and the warps a block has.  The first of: the tallest strip with
    every plane in the block and 8 warps, then fewer planes a block, then
    fewer warps, whose grid has MIN_BLOCKS_PER_SM blocks an SM; the last
    where none has."""
    col_blocks = -(-w2 // COLUMN_SPAN)

    def blocks(rows, planes, warps):
        return (col_blocks * min(-(-h2 // (rows * warps)), MAX_GRID_Y)
                * -(-c // planes))
    splits = sorted({-(-c // g) for g in range(1, c + 1)}, reverse=True)
    shapes = ([(r, c, BLOCK_WARPS[0]) for r in STRIP_ROWS]
              + [(1, p, BLOCK_WARPS[0]) for p in splits[1:]]
              + [(1, 1, w) for w in BLOCK_WARPS[1:]])
    for shape in shapes:
        if blocks(*shape) >= MIN_BLOCKS_PER_SM * sms:
            return shape
    return shapes[-1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def upload_taps(dev: torch.device,
                taps: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """1-D int32 and float32 host arrays on ``dev`` in one copy: packed
    into one int32 buffer (the float32 ones bit-cast), then split into
    views on the device that keep each array's dtype and bits."""
    for a in taps:
        if a.ndim != 1 or a.dtype not in (np.int32, np.float32):
            raise ValueError(f"upload_taps: expected 1-D int32 or float32 "
                             f"arrays, got {a.dtype} of shape {a.shape}")
    buf = torch.from_numpy(np.concatenate([a.view(np.int32) for a in taps]))
    buf = buf.to(dev, non_blocking=True)
    views, start = [], 0
    for a in taps:
        v = buf[start:start + a.size]
        views.append(v.view(torch.float32) if a.dtype == np.float32 else v)
        start += a.size
    return views


def _check_image(name: str, img: torch.Tensor) -> torch.device:
    if img.ndim != 3:
        raise ValueError(f"{name}: expected (C, H, W), got "
                         f"{tuple(img.shape)}")
    return check_planes(name, img)


def _check_vector(name: str, v: torch.Tensor, dtype: torch.dtype,
                  dev: torch.device) -> None:
    if (v.dtype != dtype or v.ndim != 1 or v.device != dev
            or not v.is_contiguous()):
        raise ValueError(f"resample_static: {name} must be a contiguous "
                         f"1-D {dtype} tensor on {dev}")


def _launch(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
            value_scale: float, wy: Optional[torch.Tensor] = None,
            wx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on checked CUDA tensors."""
    C, H, W = img.shape
    H2, W2 = iy.numel(), ix.numel()
    scale = (float(value_scale), int(value_scale != 1.0))
    if wy is None:
        out = torch.empty((C, H2, W2), dtype=img.dtype, device=img.device)
        launch("ugsm_resample_nearest", "resample", ptr(img), ptr(out),
               ptr(iy), ptr(ix), C, H, W, H2, W2, *scale)
        return out
    if max(C * H * W, C * H2 * W2) >= MAX_KERNEL_ELEMENTS:
        raise ValueError(f"resample_static: {C} x {H} x {W} -> {H2} x {W2}: "
                         f"the bilinear kernel takes planes of fewer than "
                         f"2^31 floats")
    out = torch.empty((C, H2, W2), dtype=img.dtype, device=img.device)
    launch("ugsm_resample_bilinear", "resample_bilinear", ptr(img), ptr(out),
           ptr(iy), ptr(ix), ptr(wy), ptr(wx), C, H, W, H2, W2, *scale,
           *bilinear_launch(C, H2, W2, _sms(img.device.index)))
    return out


def resample_static(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    value_scale: float = 1.0,
                    wy: Optional[torch.Tensor] = None,
                    wx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable resample of a (C, H, W) float32 image from per-axis taps
    on the image's device: int32 indices ``iy``/``ix``, each in range, and
    for bilinear their float32 weights ``wy``/``wx`` (the contract of
    ops.resample.resample_static_plain).  Nearest: out[c, r, x] =
    value_scale * img[c, iy[r], ix[x]].  A CUDA tensor runs the kernel; a
    CPU tensor runs the plain version."""
    if (wy is None) != (wx is None):
        raise ValueError("resample_static: pass both wy and wx, or neither")
    dev = _check_image("resample_static", img)
    if dev.type == "cpu":
        return resample_static_plain(img, iy, ix, value_scale, wy, wx)
    _check_vector("iy", iy, torch.int32, dev)
    _check_vector("ix", ix, torch.int32, dev)
    if wy is not None:
        _check_vector("wy", wy, torch.float32, dev)
        _check_vector("wx", wx, torch.float32, dev)
        if wy.numel() != iy.numel() or wx.numel() != ix.numel():
            raise ValueError("resample_static: weights and taps differ in "
                             "length")
    return _launch(img, iy, ix, value_scale, wy, wx)


def host_taps(method: str, out_h: int, out_w: int, h: int, w: int,
              coord_of: CoordFn, row_off: int = 0,
              col_off: int = 0) -> Tuple[np.ndarray, ...]:
    """The per-axis taps of ``resample_tex`` for an (h, w) source, as host
    arrays: nearest ``(iy, ix)``, bilinear ``(iy, ix, wy, wx)``."""
    if method == "nearest":
        return (nearest_indices(out_h, h, coord_of, row_off),
                nearest_indices(out_w, w, coord_of, col_off))
    (iy, wy), (ix, wx) = (bilinear_taps(out_h, h, coord_of, row_off),
                          bilinear_taps(out_w, w, coord_of, col_off))
    return iy, ix, wy, wx


# (device, call-site key) -> the taps on that device; never evicted: a
# CUDA graph may read them
_DEVICE_TAPS: Dict[tuple, List[torch.Tensor]] = {}


def kept_taps(dev: torch.device, key: tuple,
              make: Callable[[], Sequence[np.ndarray]]) -> List[torch.Tensor]:
    """The host taps ``make()`` gives for a call site's ``key``, on
    ``dev``: computed and uploaded at the first call of (dev, key), the
    same tensors on every later one.  A first call inside a CUDA graph
    capture raises: a pageable host-to-device copy cannot be captured (a
    graph's warm-up call fills the cache before it captures)."""
    full = (dev,) + tuple(key)
    taps = _DEVICE_TAPS.get(full)
    if taps is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"resample: the taps of {tuple(key)} are not on the card "
                f"yet, and a CUDA graph cannot capture their upload")
        taps = upload_taps(dev, make())
        if dev.type == "cuda":
            # the copy is done before any stream reads the kept taps
            torch.cuda.current_stream(dev).synchronize()
        # the first copy kept wins: a graph may already read it
        taps = _DEVICE_TAPS.setdefault(full, taps)
    return taps


def device_taps(dev: torch.device, method: str, out_h: int, out_w: int,
                h: int, w: int, coord_of: ScaleMap, row_off: int = 0,
                col_off: int = 0) -> List[torch.Tensor]:
    """``host_taps`` on ``dev``, kept per call site (``kept_taps``)."""
    args = (method, out_h, out_w, h, w, coord_of, row_off, col_off)
    return kept_taps(dev, args, lambda: host_taps(*args))


def resample_tex(img: torch.Tensor, out_h: int, out_w: int, coord_of: CoordFn,
                 value_scale: float = 1.0, method: str = "nearest",
                 row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """Axis-separable texture resample of a (C, H, W) image: destination
    texel centres map through ``coord_of`` to source coordinates, point
    sampling (``"nearest"``) or linear filtering (``"bilinear"``), clamp
    addressing, then ``value_scale``.  ``row_off``/``col_off`` evaluate
    only the window of rows [row_off, row_off + out_h) and columns
    [col_off, col_off + out_w) of the full destination grid (JAX
    ops/pallas/resample.py:286-297): the window lives in the host taps,
    so the kernel is the same.  On the card a ScaleMap's taps come from
    ``device_taps``; any other map's go to the card in one copy."""
    if method not in INTERP_METHODS:
        raise unsupported_interp(method)
    dev = _check_image("resample_tex", img)
    h, w = img.shape[-2], img.shape[-1]
    args = (method, out_h, out_w, h, w, coord_of, row_off, col_off)
    if dev.type == "cpu":
        iy, ix, *weights = (torch.from_numpy(a) for a in host_taps(*args))
        return resample_static_plain(img, iy, ix, value_scale, *weights)
    if isinstance(coord_of, ScaleMap):
        iy, ix, *weights = device_taps(dev, *args)
    elif torch.cuda.is_current_stream_capturing():
        raise RuntimeError("resample_tex: a CUDA graph captures only "
                           "ScaleMap coordinate maps, whose taps stay on "
                           "the card")
    else:
        iy, ix, *weights = upload_taps(dev, host_taps(*args))
    return _launch(img, iy, ix, value_scale, *weights)
