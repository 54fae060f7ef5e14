"""PyTorch + CUDA port of ug_stereomatcher_tpu for one NVIDIA H100.

Mode 1 (full-resolution two-axis disparity, nearest or bilinear) and mode
2 (the foveated stack and the hierarchical map built from it) run end to
end: the pyramid blur and resample, the warp, the fused direction
update, the smoothing chain and the level-resident matcher of the coarse
levels are hand-written CUDA kernels for Hopper (``csrc/``), built with
nvcc at first use.  CPU tensors take each kernel's plain
PyTorch version.  The package imports torch and numpy, never jax.
"""

from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.engine import (
    FoveatedStackResult,
    MatchResult,
    StereoEngine,
)

__all__ = ["FoveatedStackResult", "MatcherConfig", "MatchResult",
           "StereoEngine"]
