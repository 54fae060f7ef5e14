"""Pipeline layer: the in-process replacement for the ROS node graph.

The reference wires five OS processes over TCPROS topics (SURVEY.md §1 data
plane); here the same data plane is a composable in-process pipeline with an
optional background-prefetch executor.  Counterpart of
``ug_stereomatcher_tpu/pipeline``, on the port's engine.
"""

from ug_stereomatcher_tpu_torch.pipeline.messages import (
    CamerasSync,
    DisparityMessage,
    FoveatedStackMessage,
    StereoFrame,
)
from ug_stereomatcher_tpu_torch.pipeline.capture import ImageListCapture
from ug_stereomatcher_tpu_torch.pipeline.runner import (
    BatchRunner,
    PipelineResult,
)
from ug_stereomatcher_tpu_torch.pipeline.service import DisparityService
from ug_stereomatcher_tpu_torch.pipeline.supervisor import EngineSupervisor

__all__ = [
    "DisparityService",
    "EngineSupervisor",
    "CamerasSync",
    "StereoFrame",
    "DisparityMessage",
    "FoveatedStackMessage",
    "ImageListCapture",
    "BatchRunner",
    "PipelineResult",
]
