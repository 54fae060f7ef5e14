"""Multi-device matching: meshes, row sharding with halo exchange, and
pair batches (modes 1 and 2), driven by one process."""

from ug_stereomatcher_tpu_torch.parallel.batch import (
    batch_match,
    make_batch_matcher,
)
from ug_stereomatcher_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape_for,
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

__all__ = [
    "Mesh", "RowBlocks", "batch_match", "halo_pad_rows", "make_batch_matcher",
    "make_mesh", "mesh_shape_for", "replicated_stage", "row_splits",
    "sharded_blur", "sharded_build_pyramid", "sharded_match_level",
    "sharded_match_pair", "sharded_resample", "sharded_upsample_to_level",
]
