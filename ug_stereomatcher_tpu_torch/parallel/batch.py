"""Pair-batch matching over a mesh (modes 1 and 2).

Counterpart of ``ug_stereomatcher_tpu/parallel/batch.py``.  With no mesh
the pairs run in turn on one device.  On a mesh, pair i goes to
pairs-group i mod P: with one row per group it runs whole on the group's
device, with more rows the group row-shards it over its rows axis
(spatial.sharded_match_pair), so the hybrid takes the batch in chunks of
P pairs.  An eager step has no fixed batch shape, so a short last chunk
leaves groups idle instead of padding them with copies of its last pair,
as the JAX package must.

A mesh with one owner is driven whole by the calling process, which
writes the results on its first device.  A mesh whose owners are
the ranks of the default ``torch.distributed`` group (multihost.pod_mesh)
is run by all of them on the same whole batch, as every JAX process
passes the same global array: each rank matches the pairs of the groups
it drives, so a pair goes to the same group whatever the number of
processes, and an all-gather gives every rank the whole result on its
first device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.parallel.mesh import Mesh, process_index
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

    Without a mesh the pairs run in turn on ``device``; on a mesh pair i
    goes to pairs-group i mod P, whole where ``rows == 1`` and row-sharded
    otherwise.  A mesh that spans processes needs the default process
    group (multihost.initialize_distributed) over exactly its ranks, and
    every rank calls the matcher with the same batch."""
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
    return _make_mesh_matcher(cfg, mesh, _group_matcher(cfg, mesh, foveated),
                              foveated)


GroupMatcher = Callable[[torch.Tensor, torch.Tensor, int, torch.device],
                        torch.Tensor]


def _group_matcher(cfg: MatcherConfig, mesh: Mesh,
                   foveated: bool) -> GroupMatcher:
    """``(left, right, g, out) ->`` one pair's result on device ``out``,
    matched by pairs-group g: whole on the group's device where the mesh
    has one row, else row-sharded over the group's rows axis."""
    if mesh.shape["rows"] == 1:
        single = _single_pair_foveated if foveated else _single_pair

        def whole(left, right, g, out):
            dev = mesh.devices[g][0]
            with on_device(dev):
                res = single(left.to(dev), right.to(dev), cfg)
            return res.to(out)
        return whole

    def sharded(left, right, g, out):
        dev = mesh.devices[g][0]
        levels = sharded_match_pair(left.to(dev), right.to(dev), cfg, mesh,
                                    pair=g, foveated=foveated).levels
        if foveated:
            k = cfg.fovea_level
            return _stack_fovea_levels([lv.gather(out) for lv in levels[:k]],
                                       k)
        return levels[0].gather(out)
    return sharded


def _result_shape(cfg: MatcherConfig, h: int, w: int,
                  foveated: bool) -> tuple:
    """One pair's result shape: (3, H, W), or (3, fovea_level * fh, fw)."""
    if foveated:
        fh, fw = cfg.fovea_dims(h, w)
        return (3, cfg.fovea_level * fh, fw)
    return (3, h, w)


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x`` on x's device.  NCCL gathers
    on the card; gloo's all_gather takes host tensors only, so under gloo
    the share goes to the host and the result back to x's device."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        with on_device(x.device):
            dist.all_gather_into_tensor(out, x.contiguous())
        return out.view((world,) + tuple(x.shape))
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.stack(parts).to(x.device)


def _make_mesh_matcher(cfg: MatcherConfig, mesh: Mesh,
                       on_group: GroupMatcher,
                       foveated: bool) -> BatchMatcher:
    """Each process matches the pairs of the groups it drives, in batch
    order, into a float32 share padded to the largest process's share; an
    all-gather of the shares, sliced back, puts every pair in its place on
    every rank.  No pair is matched twice.  A mesh with one owner is that
    process's own: its share is the whole batch, and it gathers only where
    the process group has no other rank (a one-rank group)."""
    ranks = mesh.process_indices()
    world = len(ranks)
    group = dist.is_available() and dist.is_initialized()
    if world > 1 and not group:
        raise RuntimeError(
            f"the mesh spans processes {ranks} but no torch.distributed "
            f"process group is initialised (multihost.initialize_distributed)")
    if world > 1 and ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh spans processes {ranks}, the process "
                         f"group ranks 0..{dist.get_world_size() - 1}: "
                         f"every rank must drive a pairs-group")
    # a one-rank group gathers too; a mesh of one rank of a larger group
    # is that rank's own
    gathers = group and ranks == list(range(dist.get_world_size()))
    p = mesh.shape["pairs"]
    me = ranks.index(process_index()) if world > 1 else 0
    out_dev = mesh.local_devices()[0]

    def matcher(lb, rb):
        b, _, h, w = lb.shape
        owned = [[i for i in range(b) if mesh.owner(i % p) == r]
                 for r in ranks]
        share = torch.empty((max(len(o) for o in owned),)
                            + _result_shape(cfg, h, w, foveated),
                            dtype=torch.float32, device=out_dev)
        for j, i in enumerate(owned[me]):
            share[j] = on_group(lb[i], rb[i], i % p, out_dev)
        parts = _all_gather(share) if gathers else share[None]
        if world == 1:
            return parts[0]
        out = share.new_empty((b,) + tuple(share.shape[1:]))
        for r, idx in enumerate(owned):
            out[idx] = parts[r, :len(idx)]
        return out
    return matcher


def batch_match(left_batch: torch.Tensor, right_batch: torch.Tensor,
                cfg: Optional[MatcherConfig] = None,
                mesh: Optional[Mesh] = None, device=None,
                foveated: bool = False) -> torch.Tensor:
    """Match a (B, 3, H, W) float32 batch of pairs; one-shot form of
    make_batch_matcher.  Returns (B, 3, H, W) triplets, or (B, 3,
    fovea_level * fh, fw) stacked fovea triplets with ``foveated=True``."""
    return make_batch_matcher(cfg or MatcherConfig(), mesh, device,
                              foveated)(left_batch, right_batch)
