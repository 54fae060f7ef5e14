"""In-process message schemas — the msg/srv layer analog.

Typed dataclasses replacing the reference's generated ROS types:
msg/CamerasSync.msg, msg/foveatedstack.msg, stereo_msgs/DisparityImage, and
srv/GetDisparitiesGPU.srv.  The port's own copy of
``ug_stereomatcher_tpu/pipeline/messages.py``; the planes a service
returns are host NumPy arrays, whatever device matched them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Header:
    """ROS Header analog: sequence id, timestamp, frame id."""
    seq: int = 0
    stamp: float = 0.0
    frame_id: str = ""


@dataclasses.dataclass
class CamerasSync:
    """Capture trigger (msg/CamerasSync.msg): timestamp + 'full'/'preview'."""
    time_stamp: float
    data: str = "full"


@dataclasses.dataclass
class StereoFrame:
    """A synchronised stereo pair + camera info — what the ApproximateTime
    synchroniser delivers to the matcher node (UG_GPU_matcher.cpp:705-706)."""
    left: np.ndarray            # (H, W, 3) uint8
    right: np.ndarray
    header: Header = dataclasses.field(default_factory=Header)
    camera_info_left: Optional[object] = None    # CameraCalibration
    camera_info_right: Optional[object] = None


@dataclasses.dataclass
class DisparityMessage:
    """stereo_msgs/DisparityImage analog (single float plane)."""
    image: np.ndarray           # (H, W) float32
    header: Header = dataclasses.field(default_factory=Header)


@dataclasses.dataclass
class FoveatedStackMessage:
    """msg/foveatedstack.msg analog (foveatedstack.msg:7-21)."""
    image_stack: np.ndarray     # vertical stack, float32
    im_width: int
    im_height: int
    roi_width: int
    roi_height: int
    num_levels: int
    header: Header = dataclasses.field(default_factory=Header)


@dataclasses.dataclass
class GetDisparitiesRequest:
    """srv/GetDisparitiesGPU.srv request: (imL, imR)."""
    left: np.ndarray
    right: np.ndarray


@dataclasses.dataclass
class GetDisparitiesResponse:
    """srv/GetDisparitiesGPU.srv response: three DisparityImages and/or three
    foveated stacks."""
    disp_h: Optional[DisparityMessage] = None
    disp_v: Optional[DisparityMessage] = None
    disp_c: Optional[DisparityMessage] = None
    fdisp_h: Optional[FoveatedStackMessage] = None
    fdisp_v: Optional[FoveatedStackMessage] = None
    fdisp_c: Optional[FoveatedStackMessage] = None
