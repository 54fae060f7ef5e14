"""Pair-batch matching over a mesh (mode 1).

Counterpart of ``ug_stereomatcher_tpu/parallel/batch.py``.  One process
drives every device.  With no mesh the pairs run in turn on one device;
on a mesh with one row per pairs-group, pair i runs whole on the device of
group i mod P; with more rows, each group row-shards its pair over its
rows axis (spatial.sharded_match_pair), P pairs per step.  Results are
stacked on the mesh's first device.  An eager step has no fixed batch
shape, so a short last chunk leaves groups idle instead of padding them
with copies of its last pair, as the JAX package must.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.parallel.mesh import Mesh
from ug_stereomatcher_tpu_torch.parallel.spatial import (
    on_device,
    sharded_match_pair,
)

BatchMatcher = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _single_pair(left: torch.Tensor, right: torch.Tensor,
                 cfg: MatcherConfig) -> torch.Tensor:
    """The finest level's (3, H, W) triplet of one pair (StereoEngine.match
    without the input conversion)."""
    h, w = left.shape[-2:]
    n = cfg.num_levels(h, w)
    lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
    return match_mod.match_pyramid(lp, rp, cfg, (h, w),
                                   foveated=False).levels[0]


def make_batch_matcher(cfg: MatcherConfig, mesh: Optional[Mesh] = None,
                       device=None, foveated: bool = False) -> BatchMatcher:
    """A batch matcher (B, 3, H, W) x 2 -> (B, 3, H, W) float32 triplets.

    Without a mesh the pairs run in turn on ``device``; ``rows == 1``
    sends pair i to pairs-group i mod P; ``rows > 1`` runs the (pairs x
    rows) hybrid."""
    check_supported(cfg)
    if foveated:
        raise match_mod._foveated_not_ported()
    if mesh is None:
        dev = torch.device(device if device is not None else "cuda")

        def in_turn(lb, rb):
            with on_device(dev):
                return torch.stack([
                    _single_pair(lb[i].to(dev), rb[i].to(dev), cfg)
                    for i in range(lb.shape[0])])
        return in_turn
    if mesh.shape["rows"] > 1:
        return _make_hybrid_matcher(cfg, mesh)

    groups = [row[0] for row in mesh.devices]
    out_dev = groups[0]

    def round_robin(lb, rb):
        outs = []
        for i in range(lb.shape[0]):
            dev = groups[i % len(groups)]
            with on_device(dev):
                outs.append(_single_pair(lb[i].to(dev), rb[i].to(dev), cfg))
        return torch.stack([o.to(out_dev) for o in outs])
    return round_robin


def _make_hybrid_matcher(cfg: MatcherConfig, mesh: Mesh) -> BatchMatcher:
    """DP x SP batch matcher for a (pairs, rows) mesh with rows > 1: the
    batch goes in chunks of P pairs, pair j of a chunk row-sharded over the
    rows axis of pairs-group j."""
    p = mesh.shape["pairs"]
    out_dev = mesh.devices[0][0]

    def hybrid(lb, rb):
        outs = []
        for s in range(0, lb.shape[0], p):
            for j in range(min(p, lb.shape[0] - s)):
                dev = mesh.devices[j][0]
                res = sharded_match_pair(lb[s + j].to(dev), rb[s + j].to(dev),
                                         cfg, mesh, pair=j)
                outs.append(res.levels[0])
        return torch.stack([o.gather(out_dev) for o in outs])
    return hybrid


def batch_match(left_batch: torch.Tensor, right_batch: torch.Tensor,
                cfg: Optional[MatcherConfig] = None,
                mesh: Optional[Mesh] = None, device=None) -> torch.Tensor:
    """Match a (B, 3, H, W) float32 batch of pairs; one-shot form of
    make_batch_matcher.  Returns (B, 3, H, W) triplets."""
    return make_batch_matcher(cfg or MatcherConfig(), mesh, device)(
        left_batch, right_batch)
