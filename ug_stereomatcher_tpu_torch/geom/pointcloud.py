"""RGB point clouds from disparity, and their PCD and PLY files.

Counterpart of ``ug_stereomatcher_tpu/geom/pointcloud.py``: the
reference point-cloud node's reconstructions (getPointCloud.cpp
doReconstructionRGB :675, doReconstructionRGB_FOV :615,
doReconstruction_resized :724, doReconstructionFOV_resized :802) and
PCL's PCD writer.  The triangulation runs in float32 on the disparity's
device (a NumPy disparity runs on the CPU); the cloud comes back as
NumPy.  The nearest and bilinear range-map resizes run the port's
resample kernel (ops/cuda/resample.resample_tex) on a CUDA tensor, and
its plain version on the CPU: its taps are computed on the host in
float64, where the JAX package's bilinear resize computes the
coordinates in float32 on the device, and it interpolates rows first,
so a bilinear value may differ from the JAX package's in its last bits.
The cubic resize is plain torch (ops.resample.subsample).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.geom.fovea_map import (
    fovea_margins,
    fovea_scale,
    map_fovea_coords,
)
from ug_stereomatcher_tpu_torch.geom.triangulate import (
    pixel_grid,
    triangulate_disparity,
    triangulate_points,
)
from ug_stereomatcher_tpu_torch.ops.cuda.resample import resample_tex
from ug_stereomatcher_tpu_torch.ops.resample import ScaleMap, subsample


@dataclasses.dataclass
class PointCloud:
    """Flat point cloud: xyz (N, 3) float32, rgb (N, 3) uint8."""
    xyz: np.ndarray
    rgb: np.ndarray

    def __len__(self) -> int:
        return self.xyz.shape[0]


def _plane(x) -> torch.Tensor:
    """A disparity plane as a float32 tensor (a NumPy one on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _rgb_from_image(image) -> np.ndarray:
    """Accept (H, W, 3) or (3, H, W), NumPy or torch; return (H, W, 3)
    uint8 NumPy."""
    arr = (image.detach().cpu().numpy() if isinstance(image, torch.Tensor)
           else np.asarray(image))
    if arr.ndim != 3:
        raise ValueError("expected RGB image")
    if arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = np.moveaxis(arr, 0, -1)
    return arr.astype(np.uint8)


def _cloud(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
           rgb: np.ndarray) -> PointCloud:
    xyz = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    return PointCloud(xyz=xyz.cpu().numpy().astype(np.float32),
                      rgb=rgb.reshape(-1, 3))


def _resize(z: torch.Tensor, out_h: int, out_w: int, scale: float,
            method: str) -> torch.Tensor:
    """Resample an (H, W) range map to (out_h, out_w) at src = dst *
    scale: cubic as plain torch, nearest and bilinear through the
    resample kernel's wrapper."""
    if method == "cubic":
        return subsample(z, out_h, out_w, scale, method="cubic")
    return resample_tex(z[None].contiguous(), out_h, out_w,
                        ScaleMap(scale), method=method)[0]


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _map_fovea(cfg: MatcherConfig, height: int, width: int, src_level: int,
               src_x: torch.Tensor, src_y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """geom.map_fovea_coords on float32 tensors, on their device: the
    margin plus the coordinate times the float64 factor, in float64 as
    NumPy promotes it, then rounded to float32 for the triangulation."""
    left, upper = fovea_margins(cfg, height, width, src_level)
    factor = float(fovea_scale(src_level))
    return ((left + src_x.double() * factor).float(),
            (upper + src_y.double() * factor).float())


def disparity_to_pointcloud(calib, disp_h, disp_v, left_image,
                            sampling: int = 1) -> PointCloud:
    """Full-resolution reconstruction (doReconstructionRGB,
    getPointCloud.cpp:675-722); ``sampling`` keeps every Nth pixel in each
    axis (the node's stride, :698)."""
    dh_full, dv_full = _plane(disp_h), _plane(disp_v)
    h, w = dh_full.shape
    dh = dh_full[::sampling, ::sampling]
    dv = dv_full[::sampling, ::sampling]
    xx, yy = pixel_grid(h, w, dh.device, sampling)
    X, Y, Z = triangulate_points(calib.left.P, calib.right.P, xx, yy,
                                 xx + dh, yy + dv)
    rgb = _rgb_from_image(left_image)[::sampling, ::sampling]
    return _cloud(X, Y, Z, rgb)


def _stack_level(stack, cfg: MatcherConfig, src_level: int) -> torch.Tensor:
    """Rows of stack level ``src_level`` of an (fovea_level * fh, fw)
    stack."""
    stack = _plane(stack)
    fov_h = stack.shape[0] // cfg.fovea_level
    return stack[src_level * fov_h:(src_level + 1) * fov_h]


def foveated_disparity_to_pointcloud(calib, cfg: MatcherConfig,
                                     stack_h, stack_v, left_image,
                                     src_level: int = 0,
                                     sampling: int = 1) -> PointCloud:
    """Foveated reconstruction from a disparity stack
    (doReconstructionRGB_FOV and get3DPoint's fovea branch,
    getPointCloud.cpp:615-673, 892-907): both match endpoints of stack
    level ``src_level`` mapped to full-resolution coordinates, colours
    from the full-resolution left image at the mapped coordinates
    truncated to integers."""
    rgb_img = _rgb_from_image(left_image)
    H, W = rgb_img.shape[:2]
    dh = _stack_level(stack_h, cfg, src_level)
    dv = _stack_level(stack_v, cfg, src_level)
    fov_h, fov_w = dh.shape
    dh, dv = dh[::sampling, ::sampling], dv[::sampling, ::sampling]
    xx, yy = pixel_grid(fov_h, fov_w, dh.device, sampling)
    x1, y1 = _map_fovea(cfg, H, W, src_level, xx, yy)
    x2, y2 = _map_fovea(cfg, H, W, src_level, xx + dh, yy + dv)
    X, Y, Z = triangulate_points(calib.left.P, calib.right.P, x1, y1, x2, y2)
    # the colour taps come from the host's float64 map, as in NumPy
    cy, cx = np.mgrid[0:fov_h:sampling, 0:fov_w:sampling].astype(np.float32)
    mx, my = map_fovea_coords(cfg, H, W, src_level, cx, cy)
    ix = np.clip(mx.astype(np.int64), 0, W - 1)
    iy = np.clip(my.astype(np.int64), 0, H - 1)
    return _cloud(X, Y, Z, rgb_img[iy, ix])


def resized_pointcloud(calib, disp_h, disp_v, left_image,
                       resize_factor: float = 0.2,
                       resize_method: str = "bilinear") -> PointCloud:
    """Resized-range-map reconstruction (doReconstruction_resized,
    getPointCloud.cpp:724-800): Z triangulated at full resolution and
    resized by ``resize_factor``, one point per resized pixel with X and Y
    from its full-resolution source pixel int(i / resize_factor).
    ``resize_method="cubic"`` is the reference's cv::INTER_CUBIC (:772);
    the default is bilinear (cubic overshoots at depth edges)."""
    P1, P2 = calib.left.P, calib.right.P
    dh, dv = _plane(disp_h), _plane(disp_v)
    h, w = dh.shape
    z = triangulate_disparity(P1, P2, dh, dv)[2]
    out_h, out_w = int(h * resize_factor), int(w * resize_factor)
    z_res = _resize(z, out_h, out_w, 1.0 / resize_factor, resize_method)
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    sx = np.clip((xx / resize_factor).astype(np.int64), 0, w - 1)
    sy = np.clip((yy / resize_factor).astype(np.int64), 0, h - 1)
    isx, isy = _index(sx, dh.device), _index(sy, dh.device)
    fx, fy = isx.to(torch.float32), isy.to(torch.float32)
    X, Y, _ = triangulate_points(P1, P2, fx, fy, fx + dh[isy, isx],
                                 fy + dv[isy, isx])
    return _cloud(X, Y, z_res, _rgb_from_image(left_image)[sy, sx])


def _foveated_range_map(calib, cfg: MatcherConfig, stack_h, stack_v,
                        full_dims: Tuple[int, int],
                        src_level: int) -> torch.Tensor:
    H, W = full_dims
    dh = _stack_level(stack_h, cfg, src_level)
    dv = _stack_level(stack_v, cfg, src_level)
    xx, yy = pixel_grid(*dh.shape, dh.device)
    x1, y1 = _map_fovea(cfg, H, W, src_level, xx, yy)
    x2, y2 = _map_fovea(cfg, H, W, src_level, xx + dh, yy + dv)
    return triangulate_points(calib.left.P, calib.right.P, x1, y1, x2, y2)[2]


def foveated_range_map(calib, cfg: MatcherConfig, stack_h, stack_v,
                       full_dims: Tuple[int, int],
                       src_level: int = 0) -> np.ndarray:
    """Z over the fovea grid of one stack level (getRangePointFOV,
    getPointCloud.cpp:984-1021): both match endpoints mapped to
    full-resolution coordinates first (the disparity endpoint after the
    fovea-scale disparity is added, :994-995).  (fov_h, fov_w) float32
    NumPy."""
    return _foveated_range_map(calib, cfg, stack_h, stack_v, full_dims,
                               src_level).cpu().numpy().astype(np.float32)


def foveated_resized_pointcloud(calib, cfg: MatcherConfig, stack_h, stack_v,
                                left_image, src_level: int = 0,
                                resize_factor: float = 0.2,
                                map_rgb_coords: bool = False,
                                resize_method: str = "bilinear") -> PointCloud:
    """Foveated resized-range-map reconstruction
    (doReconstructionFOV_resized, getPointCloud.cpp:802-884): the fovea
    level's range map (:func:`foveated_range_map`) resized by
    ``resize_factor``, one point per resized pixel, X and Y from the
    closed form at its fovea source pixel (:892-907), Z from the resized
    map.  The reference reads the colour at the unmapped fovea-grid
    coordinates (:864-867), kept as the default; ``map_rgb_coords=True``
    reads it at the mapped ones.  ``resize_method`` as in
    :func:`resized_pointcloud` (the reference's is cubic, :841)."""
    rgb_img = _rgb_from_image(left_image)
    H, W = rgb_img.shape[:2]
    dh = _stack_level(stack_h, cfg, src_level)
    dv = _stack_level(stack_v, cfg, src_level)
    fov_h, fov_w = dh.shape
    rmap = _foveated_range_map(calib, cfg, stack_h, stack_v, (H, W),
                               src_level)
    out_h, out_w = int(fov_h * resize_factor), int(fov_w * resize_factor)
    z_res = _resize(rmap, out_h, out_w, 1.0 / resize_factor, resize_method)

    # int(ii / resizeFactor) source lookup per resized pixel (:860-861)
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    sx = np.clip((xx / resize_factor).astype(np.int64), 0, fov_w - 1)
    sy = np.clip((yy / resize_factor).astype(np.int64), 0, fov_h - 1)
    isx, isy = _index(sx, dh.device), _index(sy, dh.device)
    fx, fy = isx.to(torch.float32), isy.to(torch.float32)
    x1, y1 = _map_fovea(cfg, H, W, src_level, fx, fy)
    x2, y2 = _map_fovea(cfg, H, W, src_level, fx + dh[isy, isx],
                        fy + dv[isy, isx])
    X, Y, _ = triangulate_points(calib.left.P, calib.right.P, x1, y1, x2, y2)

    if map_rgb_coords:
        mx, my = map_fovea_coords(cfg, H, W, src_level,
                                  sx.astype(np.float32), sy.astype(np.float32))
        cx = np.clip(mx.astype(np.int64), 0, W - 1)
        cy = np.clip(my.astype(np.int64), 0, H - 1)
    else:  # the reference: unmapped fovea-grid coordinates (:864)
        cx = np.clip(sx, 0, W - 1)
        cy = np.clip(sy, 0, H - 1)
    return _cloud(X, Y, z_res, rgb_img[cy, cx])


# ----------------------------------------------------------------------
# Files (PCL's savePCDFileASCII, getPointCloud.cpp:330, and binary PLY)
# ----------------------------------------------------------------------

def _packed_rgb_float(rgb: np.ndarray) -> np.ndarray:
    """PCL's rgb field: a float whose bits are 0x00RRGGBB
    (getPointCloud.cpp:660-666)."""
    r = rgb[:, 0].astype(np.uint32)
    g = rgb[:, 1].astype(np.uint32)
    b = rgb[:, 2].astype(np.uint32)
    return ((r << 16) | (g << 8) | b).view(np.float32)


def save_pcd(path: str, cloud: PointCloud, binary: bool = True) -> None:
    """Write a PCL-compatible .pcd file (x y z rgb), binary or ASCII."""
    n = len(cloud)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = np.concatenate(
        [cloud.xyz.astype(np.float32), _packed_rgb_float(cloud.rgb)[:, None]],
        axis=1)
    with open(path, "wb") as fh:
        fh.write(header.encode())
        if binary:
            fh.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
        else:
            np.savetxt(fh, data, fmt="%.6f %.6f %.6f %.9e")


def save_ply(path: str, cloud: PointCloud) -> None:
    """Write a binary little-endian PLY with a colour per vertex."""
    n = len(cloud)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = cloud.xyz.astype(np.float32)
    rec["rgb"] = cloud.rgb.astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(rec.tobytes())
