"""Capture simulator — the publish_images node analog.

Reads stereo pairs from an image-list manifest and serves them as
StereoFrames on demand (the 'acquire_images' trigger becomes a method call),
attaching calibration loaded from the same OpenCV XML files
(publish_images.cpp:46-211).  Frames are host NumPy images; the engine
moves them to its device.
"""

from __future__ import annotations

import time
from typing import Optional

from ug_stereomatcher_tpu_torch.geom.calibration import load_opencv_xml
from ug_stereomatcher_tpu_torch.io.image import load_image
from ug_stereomatcher_tpu_torch.io.manifest import ImageList, load_image_list
from ug_stereomatcher_tpu_torch.pipeline.messages import (
    CamerasSync,
    Header,
    StereoFrame,
)


class ImageListCapture:
    """Serves stereo pairs from a manifest, wrap-to-last-pair included."""

    def __init__(self, image_list: str | ImageList,
                 camera_info_left: Optional[str] = None,
                 camera_info_right: Optional[str] = None):
        if isinstance(image_list, str):
            image_list = load_image_list(image_list)
        self.images = image_list
        self.info_left = (load_opencv_xml(camera_info_left)
                          if camera_info_left else None)
        self.info_right = (load_opencv_xml(camera_info_right)
                           if camera_info_right else None)
        self.num_frames = 0

    def capture(self, trigger: Optional[CamerasSync] = None) -> StereoFrame:
        """Acquire the next pair (captureImage, publish_images.cpp:128-211).
        Only 'full' mode is supported, as in the reference (:140-148)."""
        if trigger is not None and trigger.data not in ("full",):
            raise ValueError(f"capture mode not supported: {trigger.data!r}")
        left_path, right_path = self.images.next_pair()
        self.num_frames += 1
        header = Header(seq=self.num_frames, stamp=time.time(),
                        frame_id="left_camera")
        return StereoFrame(
            left=load_image(left_path), right=load_image(right_path),
            header=header,
            camera_info_left=self.info_left,
            camera_info_right=self.info_right)

    def __iter__(self):
        for _ in range(len(self.images.pairs())):
            yield self.capture()
