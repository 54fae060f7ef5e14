"""Multi-device matching: meshes, row sharding with halo exchange, pair
batches (modes 1 and 2), several processes on one batch over
``torch.distributed`` (multihost.py) and the scaling harness
(throughput.py)."""

from ug_stereomatcher_tpu_torch.parallel.batch import (
    batch_match,
    make_batch_matcher,
)
from ug_stereomatcher_tpu_torch.parallel.mesh import (
    Mesh,
    Slot,
    make_mesh,
    mesh_shape_for,
)
from ug_stereomatcher_tpu_torch.parallel.multihost import (
    initialize_distributed,
    pod_mesh,
)
from ug_stereomatcher_tpu_torch.parallel.spatial import (
    RowBlocks,
    halo_pad_rows,
    replicated_stage,
    row_splits,
    sharded_blur,
    sharded_build_pyramid,
    sharded_match_level,
    sharded_match_pair,
    sharded_resample,
    sharded_upsample_to_level,
)
from ug_stereomatcher_tpu_torch.parallel.throughput import (
    ThroughputPoint,
    measure_throughput,
)

__all__ = [
    "Mesh", "RowBlocks", "Slot", "ThroughputPoint", "batch_match",
    "halo_pad_rows", "initialize_distributed", "make_batch_matcher",
    "make_mesh", "measure_throughput", "mesh_shape_for", "pod_mesh",
    "replicated_stage", "row_splits", "sharded_blur",
    "sharded_build_pyramid", "sharded_match_level", "sharded_match_pair",
    "sharded_resample", "sharded_upsample_to_level",
]
