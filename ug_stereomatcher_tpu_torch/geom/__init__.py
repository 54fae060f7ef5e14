"""Geometry: calibration, triangulation, fovea coordinate mapping, lens
distortion and RGB point clouds.

Counterpart of ``ug_stereomatcher_tpu/geom``, the reference's
triangulation node (src/pointcloud/getPointCloud.cpp) as whole-map torch
operations on the disparity's device.  ``calibration`` is the port's own
copy of the JAX package's NumPy module.
"""

from ug_stereomatcher_tpu_torch.geom.calibration import (
    CameraCalibration,
    StereoCalibration,
    load_opencv_xml,
)
from ug_stereomatcher_tpu_torch.geom.fovea_map import (
    fovea_margins,
    map_fovea_coords,
)
from ug_stereomatcher_tpu_torch.geom.pointcloud import (
    PointCloud,
    disparity_to_pointcloud,
    foveated_disparity_to_pointcloud,
    foveated_range_map,
    foveated_resized_pointcloud,
    resized_pointcloud,
    save_pcd,
    save_ply,
)
from ug_stereomatcher_tpu_torch.geom.triangulate import (
    range_map,
    triangulate_disparity,
    triangulate_points,
)

__all__ = [
    "CameraCalibration",
    "StereoCalibration",
    "load_opencv_xml",
    "triangulate_points",
    "triangulate_disparity",
    "range_map",
    "fovea_margins",
    "map_fovea_coords",
    "PointCloud",
    "disparity_to_pointcloud",
    "foveated_disparity_to_pointcloud",
    "foveated_range_map",
    "foveated_resized_pointcloud",
    "resized_pointcloud",
    "save_pcd",
    "save_ply",
]
