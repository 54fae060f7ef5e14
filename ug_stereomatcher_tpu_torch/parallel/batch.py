"""Pair-batch matching over a mesh (modes 1 and 2), compiled once.

Counterpart of ``ug_stereomatcher_tpu/parallel/batch.py``.  With no mesh
the pairs run in turn on one device.  On a mesh, pair i goes to
pairs-group i mod P: with one row per group it runs whole on the group's
device, with more rows the group row-shards it over its rows axis
(spatial.sharded_match_pair), so the hybrid takes the batch in chunks of
P pairs.  A batch has no fixed chunking here, so a short last chunk
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

Compile once, replay (graphs.py), as each JAX matcher is one jitted
program (batch.py:65-170): on the card the matcher keeps one CUDA graph
per key (``graphs.graph_key`` of the batch shape, config and
``foveated``, plus ``mesh.mesh_key``) and card, captured at the key's
first call.  Without a mesh that is the pairs in turn on ``device``.  On
a mesh, the pairs this process matches go by their pairs-group
(``card_plan``): a group whose rows lie on one card into that card's
graph, a group whose rows lie on several cards into one graph across
those cards (the JAX package's compiled step of a rows-group, its
``ppermute`` halos and tiled ``all_gather``, batch.py:125-170 and
spatial.py:86-99, :180).  Either way the whole sharded_match_pair of
each pair, its halo exchanges and replicated stages included, becomes
graph nodes: a halo is a copy into a band at its final place, a peer
copy where it crosses cards.  The copies of the inputs onto each group's
first card and of the results onto the mesh's first device, and the
all-gather across processes, stay outside the graphs; every graph is
replayed before any result is copied back, so the cards run together.
Only CPU devices, or ``capture=False``, run eagerly, and the matcher's
``route`` names what its last call ran.  While tracing is on
(profiling.py) the copies onto the groups' cards, the replays, the
copies back and the all-gather are the spans ``mesh.scatter``,
``mesh.replay``, ``mesh.gather`` and ``mesh.all_gather``; the copies
are timed on the stream of the batch's card, which carries them or
orders them.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.device import DTYPE
from ug_stereomatcher_tpu_torch.graphs import CapturedCall, graph_key
from ug_stereomatcher_tpu_torch.parallel.mesh import (
    Mesh,
    mesh_key,
    process_index,
)
from ug_stereomatcher_tpu_torch.parallel.spatial import (
    _sharded_match_pair,
    on_device,
    warn_fixed_schedule,
)
from ug_stereomatcher_tpu_torch.profiling import span

# a graph's card (a group on one card) or a group's cards (several)
CardKey = Union[torch.device, Tuple[torch.device, ...]]


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


def card_plan(mesh: Mesh, batch: int, rank: int
              ) -> Tuple[Dict[CardKey, List[int]], List[int]]:
    """How process ``rank`` matches its pairs of a ``batch`` on ``mesh``:
    by graph, the pairs whose pairs-group lies on CUDA cards (one graph
    a key, pairs in batch order), keyed by the group's card where its
    rows lie on one, else by the tuple of its cards in row order; and the
    pairs it matches eagerly, whose group lies on the CPU.  Pair i goes
    to group i mod P; the pairs of the groups other processes drive are
    in neither."""
    p = mesh.shape["pairs"]
    cards: Dict[CardKey, List[int]] = {}
    eager: List[int] = []
    for i in range(batch):
        if mesh.owner(i % p) != rank:
            continue
        devs = tuple(dict.fromkeys(mesh.devices[i % p]))
        if all(d.type == "cuda" for d in devs):
            cards.setdefault(devs[0] if len(devs) == 1 else devs,
                             []).append(i)
        else:
            eager.append(i)
    return cards, eager


def _cards(key: CardKey) -> Tuple[torch.device, ...]:
    """The cards of a ``card_plan`` key, the group's first card first."""
    return (key,) if isinstance(key, torch.device) else key


def _as_input(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """One image as the kernels take it: float32, contiguous, on dev."""
    return x.to(dev, DTYPE).contiguous()


def _take(x: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """The pairs ``idx`` of a batch, stacked (``x`` itself for all)."""
    if idx == list(range(x.shape[0])):
        return x
    return torch.stack([x[i] for i in idx])


def _through_graphs(calls, lb, rb, share, at) -> None:
    """Each graph's pairs loaded onto its card, every graph replayed,
    then each result copied into its row of ``share``."""
    # the copies off the batch's card run on its stream
    with span("mesh.scatter", device=lb):
        for call, idx in calls:
            call.load(_take(lb, idx), _take(rb, idx))
    # every card's replay before any copy back: the cards overlap
    with span("mesh.replay"):
        outs = [call.replay() for call, _ in calls]
    # timed on the share's card, whose stream each copy joins
    with span("mesh.gather", device=share):
        for (_, idx), (out,) in zip(calls, outs):
            for k, i in enumerate(idx):
                share[at[i]].copy_(out[k])


def make_batch_matcher(cfg: MatcherConfig, mesh: Optional[Mesh] = None,
                       device=None, foveated: bool = False,
                       capture: bool = True) -> "BatchMatcher":
    """A batch matcher (B, 3, H, W) x 2 -> (B, 3, H, W) float32 triplets,
    or with ``foveated=True`` -> (B, 3, fovea_level * fh, fw) stacked
    fovea triplets (mode 2); the inputs may be of any dtype (uint8
    images are cast on their card).

    Without a mesh the pairs run in turn on ``device``; on a mesh pair i
    goes to pairs-group i mod P, whole where ``rows == 1`` and row-sharded
    otherwise.  A mesh that spans processes needs the default process
    group (multihost.initialize_distributed) over exactly its ranks, and
    every rank calls the matcher with the same batch.  On the card the
    matcher replays one CUDA graph per batch shape and card (the module
    docstring); ``capture=False`` runs the eager module path, the
    reference the graphs are held against."""
    check_supported(cfg)
    return BatchMatcher(cfg, mesh, device, foveated, capture)


class BatchMatcher:
    """The callable ``make_batch_matcher`` returns.

    * ``graphs``: key -> {card or tuple of cards: graphs.CapturedCall},
      the graphs it captured (``card_plan``'s keys; each holds its
      memory pools while the matcher lives);
    * ``route``: what the last call ran: ``"graph"``, ``"eager"``
      (``capture=False``, or CPU devices), or ``"graph+eager"`` where a
      mesh has groups of both kinds."""

    def __init__(self, cfg: MatcherConfig, mesh: Optional[Mesh], device,
                 foveated: bool, capture: bool):
        self.cfg, self.mesh, self.foveated = cfg, mesh, foveated
        self.capture = capture
        self.graphs: Dict[tuple, Dict[torch.device, CapturedCall]] = {}
        self.route: Optional[str] = None
        self._lock = threading.RLock()
        self._single = _single_pair_foveated if foveated else _single_pair
        if mesh is None:
            self.device = torch.device(device if device is not None
                                       else "cuda")
            return
        ranks = mesh.process_indices()
        world = len(ranks)
        group = dist.is_available() and dist.is_initialized()
        if world > 1 and not group:
            raise RuntimeError(
                f"the mesh spans processes {ranks} but no torch.distributed "
                f"process group is initialised "
                f"(multihost.initialize_distributed)")
        if world > 1 and ranks != list(range(dist.get_world_size())):
            raise ValueError(f"the mesh spans processes {ranks}, the process "
                             f"group ranks 0..{dist.get_world_size() - 1}: "
                             f"every rank must drive a pairs-group")
        self._ranks = ranks
        # a one-rank group gathers too; a mesh of one rank of a larger
        # group is that rank's own
        self._gathers = group and ranks == list(range(dist.get_world_size()))
        self._me = ranks.index(process_index()) if world > 1 else 0
        self._on_group = _group_matcher(cfg, mesh, foveated)
        self.device = mesh.local_devices()[0]

    def __call__(self, lb: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return self._in_turn(lb, rb)
        return self._on_mesh(lb, rb)

    def key(self, shape) -> tuple:
        """The graph key of a batch of ``shape``: graph_key of the entry,
        shape, config and ``foveated``, plus the mesh key."""
        return graph_key("match_batch", shape, self.cfg, None,
                         self.foveated) + (mesh_key(self.mesh),)

    def _call_on(self, card: CardKey, shape, fn) -> CapturedCall:
        """The graph of the batch shape ``shape`` on ``card`` (a card, or
        a rows-group's tuple of cards; made at the key's first call);
        ``fn`` is the call it captures."""
        with self._lock:
            calls = self.graphs.setdefault(self.key(shape), {})
            if card not in calls:
                first, *peers = _cards(card)
                calls[card] = CapturedCall(fn, [shape, shape], first, peers)
            return calls[card]

    def _pairs_on(self, dev: torch.device):
        """``(lb, rb) ->`` the pairs in turn on ``dev``, stacked."""
        def in_turn(lb, rb):
            with on_device(dev):
                return torch.stack([
                    self._single(_as_input(lb[i], dev), _as_input(rb[i], dev),
                                 self.cfg) for i in range(lb.shape[0])])
        return in_turn

    def _in_turn(self, lb, rb):
        dev = self.device
        if self.capture and dev.type == "cuda":
            self.route = "graph"
            return self._call_on(dev, tuple(lb.shape),
                                 self._pairs_on(dev))(lb, rb)
        self.route = "eager"
        return self._pairs_on(dev)(lb, rb)

    def _card_fn(self, card: CardKey, idx: List[int]):
        """``(lc, rc) ->`` the pairs ``idx`` (stacked in lc, rc on the
        first card of ``card``) each through its group, stacked there."""
        p = self.mesh.shape["pairs"]
        card = _cards(card)[0]

        def on_card(lc, rc):
            return torch.stack([self._on_group(lc[k], rc[k], i % p, card)
                                for k, i in enumerate(idx)])
        return on_card

    def _on_mesh(self, lb, rb):
        """Each process matches the pairs of the groups it drives, in batch
        order, into a float32 share padded to the largest process's
        share; an all-gather of the shares, sliced back, puts every pair
        in its place on every rank.  No pair is matched twice.  A mesh
        with one owner is that process's own: its share is the whole
        batch, and it gathers only where the process group has no other
        rank (a one-rank group)."""
        mesh, cfg = self.mesh, self.cfg
        b, _, h, w = lb.shape
        p = mesh.shape["pairs"]
        owned = [[i for i in range(b) if mesh.owner(i % p) == r]
                 for r in self._ranks]
        share = torch.empty((max(len(o) for o in owned),)
                            + _result_shape(cfg, h, w, self.foveated),
                            dtype=torch.float32, device=self.device)
        at = {i: j for j, i in enumerate(owned[self._me])}
        if self.capture:
            cards, eager = card_plan(mesh, b, self._ranks[self._me])
        else:
            cards, eager = {}, owned[self._me]
        if cfg.early_exit_delta is not None and mesh.shape["rows"] > 1:
            warn_fixed_schedule(stacklevel=4)
        with self._lock:   # the static buffers of the graphs
            shape = tuple(lb.shape)
            calls = [(self._call_on(card, (len(idx),) + shape[1:],
                                    self._card_fn(card, idx)), idx)
                     for card, idx in cards.items()]
            if calls:
                _through_graphs(calls, lb, rb, share, at)
        for i in eager:
            dev = mesh.devices[i % p][0]
            with span("mesh.scatter", device=lb):
                left, right = lb[i].to(dev), rb[i].to(dev)
            res = self._on_group(left, right, i % p, dev)
            with span("mesh.gather", device=share):
                share[at[i]] = res
        self.route = ("graph+eager" if cards and eager
                      else "graph" if cards else "eager")
        if self._gathers:
            with span("mesh.all_gather", device=share):
                parts = _all_gather(share)
        else:
            parts = share[None]
        if len(self._ranks) == 1:
            return parts[0]
        out = share.new_empty((b,) + tuple(share.shape[1:]))
        for r, idx in enumerate(owned):
            out[idx] = parts[r, :len(idx)]
        return out


GroupMatcher = Callable[[torch.Tensor, torch.Tensor, int, torch.device],
                        torch.Tensor]


def _group_matcher(cfg: MatcherConfig, mesh: Mesh,
                   foveated: bool) -> GroupMatcher:
    """``(left, right, g, out) ->`` one pair's result on device ``out``,
    matched by pairs-group g: whole on the group's device where the mesh
    has one row, else row-sharded over the group's rows axis (without
    sharded_match_pair's warning: the batch matcher warns once a
    call)."""
    if mesh.shape["rows"] == 1:
        single = _single_pair_foveated if foveated else _single_pair

        def whole(left, right, g, out):
            dev = mesh.devices[g][0]
            with on_device(dev):
                res = single(_as_input(left, dev), _as_input(right, dev),
                             cfg)
            return res.to(out)
        return whole

    def sharded(left, right, g, out):
        dev = mesh.devices[g][0]
        levels = _sharded_match_pair(_as_input(left, dev),
                                     _as_input(right, dev), cfg, mesh,
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


def batch_match(left_batch: torch.Tensor, right_batch: torch.Tensor,
                cfg: Optional[MatcherConfig] = None,
                mesh: Optional[Mesh] = None, device=None,
                foveated: bool = False) -> torch.Tensor:
    """Match a (B, 3, H, W) float32 batch of pairs; one-shot form of
    make_batch_matcher, run eagerly (a capture would outlive its one
    call).  Returns (B, 3, H, W) triplets, or (B, 3, fovea_level * fh,
    fw) stacked fovea triplets with ``foveated=True``."""
    return make_batch_matcher(cfg or MatcherConfig(), mesh, device,
                              foveated, capture=False)(left_batch,
                                                       right_batch)
