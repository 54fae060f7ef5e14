"""Camera calibration loading.

The port's own copy of ``ug_stereomatcher_tpu/geom/calibration.py``
(NumPy and the standard library only), so the port imports nothing of the
JAX package.  Parses the OpenCV FileStorage XML schema used by the reference
(calibrations/calL.xml:7-26 / calR.xml: K 3x3, D 1x5, P 3x4 — the right
camera's P is a full 3x4 matrix for the verged, non-rectified rig), plus
plain dict/npz construction.  Replaces publish_images.cpp:235-296
loadCameraInfo and getPointCloud.cpp:1109-1177 getCameraInfo.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CameraCalibration:
    """One camera: intrinsics K (3x3), distortion D (5,), projection P (3x4)."""
    K: np.ndarray
    D: np.ndarray
    P: np.ndarray
    width: Optional[int] = None
    height: Optional[int] = None
    name: str = ""

    def __post_init__(self):
        self.K = np.asarray(self.K, dtype=np.float64).reshape(3, 3)
        self.D = np.asarray(self.D, dtype=np.float64).reshape(-1)
        self.P = np.asarray(self.P, dtype=np.float64).reshape(3, 4)


@dataclasses.dataclass
class StereoCalibration:
    """Calibrated stereo rig (left = reference frame)."""
    left: CameraCalibration
    right: CameraCalibration

    @classmethod
    def from_xml(cls, left_path: str, right_path: str) -> "StereoCalibration":
        return cls(left=load_opencv_xml(left_path),
                   right=load_opencv_xml(right_path))


def _parse_matrix(node: ET.Element) -> np.ndarray:
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    data = node.findtext("data")
    vals = [float(v) for v in re.split(r"\s+", data.strip()) if v]
    return np.asarray(vals, dtype=np.float64).reshape(rows, cols)


def load_opencv_xml(path: str) -> CameraCalibration:
    """Load a single camera's OpenCV FileStorage XML calibration file."""
    tree = ET.parse(path)
    root = tree.getroot()
    mats = {}
    for key in ("K", "D", "P"):
        node = root.find(key)
        if node is None:
            raise ValueError(f"calibration file {path} missing matrix {key!r}")
        mats[key] = _parse_matrix(node)
    width = root.findtext("width")
    height = root.findtext("height")
    name = root.findtext("camera_name") or ""
    return CameraCalibration(
        K=mats["K"], D=mats["D"], P=mats["P"],
        width=int(width) if width else None,
        height=int(height) if height else None,
        name=name.strip())
