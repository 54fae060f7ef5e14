"""Pair-batch matching over a mesh (modes 1 and 2).

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


def _stack_fovea_levels(levels, k: int) -> torch.Tensor:
    """The k finest (3, fh, fw) levels stacked level-major into one
    (3, k * fh, fw) triplet, the per-pair form of the reference's
    output_stackH/V/C layout (UG_GPU_matcher.cpp:203-213)."""
    return torch.cat(list(levels[:k]), dim=-2)


def _single_pair_foveated(left: torch.Tensor, right: torch.Tensor,
                          cfg: MatcherConfig) -> torch.Tensor:
    """Mode 2 for one pair: the stacked fovea triplet (3, fovea_level *
    fh, fw) of StereoEngine.match_foveated."""
    levels, _, _ = match_mod.match_foveated_pair(left, right, cfg)
    return _stack_fovea_levels(levels, cfg.fovea_level)


def make_batch_matcher(cfg: MatcherConfig, mesh: Optional[Mesh] = None,
                       device=None, foveated: bool = False) -> BatchMatcher:
    """A batch matcher (B, 3, H, W) x 2 -> (B, 3, H, W) float32 triplets,
    or with ``foveated=True`` -> (B, 3, fovea_level * fh, fw) stacked
    fovea triplets (mode 2).

    Without a mesh the pairs run in turn on ``device``; ``rows == 1``
    sends pair i to pairs-group i mod P; ``rows > 1`` runs the (pairs x
    rows) hybrid."""
    check_supported(cfg)
    single = _single_pair_foveated if foveated else _single_pair
    if mesh is None:
        dev = torch.device(device if device is not None else "cuda")

        def in_turn(lb, rb):
            with on_device(dev):
                return torch.stack([
                    single(lb[i].to(dev), rb[i].to(dev), cfg)
                    for i in range(lb.shape[0])])
        return in_turn
    if mesh.shape["rows"] > 1:
        return _make_hybrid_matcher(cfg, mesh, foveated)

    groups = [row[0] for row in mesh.devices]
    out_dev = groups[0]

    def round_robin(lb, rb):
        outs = []
        for i in range(lb.shape[0]):
            dev = groups[i % len(groups)]
            with on_device(dev):
                outs.append(single(lb[i].to(dev), rb[i].to(dev), cfg))
        return torch.stack([o.to(out_dev) for o in outs])
    return round_robin


def _make_hybrid_matcher(cfg: MatcherConfig, mesh: Mesh,
                         foveated: bool = False) -> BatchMatcher:
    """DP x SP batch matcher for a (pairs, rows) mesh with rows > 1: the
    batch goes in chunks of P pairs, pair j of a chunk row-sharded over the
    rows axis of pairs-group j."""
    p = mesh.shape["pairs"]
    out_dev = mesh.devices[0][0]

    def result(levels):
        if foveated:
            k = cfg.fovea_level
            return _stack_fovea_levels([lv.gather(out_dev)
                                        for lv in levels[:k]], k)
        return levels[0].gather(out_dev)

    def hybrid(lb, rb):
        outs = []
        for s in range(0, lb.shape[0], p):
            for j in range(min(p, lb.shape[0] - s)):
                dev = mesh.devices[j][0]
                res = sharded_match_pair(lb[s + j].to(dev), rb[s + j].to(dev),
                                         cfg, mesh, pair=j, foveated=foveated)
                outs.append(res.levels)
        return torch.stack([result(o) for o in outs])
    return hybrid


def batch_match(left_batch: torch.Tensor, right_batch: torch.Tensor,
                cfg: Optional[MatcherConfig] = None,
                mesh: Optional[Mesh] = None, device=None,
                foveated: bool = False) -> torch.Tensor:
    """Match a (B, 3, H, W) float32 batch of pairs; one-shot form of
    make_batch_matcher.  Returns (B, 3, H, W) triplets, or (B, 3,
    fovea_level * fh, fw) stacked fovea triplets with ``foveated=True``."""
    return make_batch_matcher(cfg or MatcherConfig(), mesh, device,
                              foveated)(left_batch, right_batch)
