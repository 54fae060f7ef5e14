"""Row sharding of the match engine (modes 1 and 2) with explicit halo
exchange.

Counterpart of ``ug_stereomatcher_tpu/parallel/spatial.py``.  One process
drives every device of a mesh's rows axis (mesh.py).  A level's (C, H, W)
array is split into row shards of ``hl = ceil(H / n)`` rows, the last one
shorter (``RowBlocks``); a stage runs once per shard on the shard's
device, and the rows a stencil reaches beyond its shard (its halo) are
copied from whichever shards hold them into a band at their final place
beside the shard's rows, with the zero or clamp boundary at the image's
own edges (``halo_pad_rows``, ``RowBlocks.rows_into``).  A level's
exchanges reuse their bands on every iteration, so inside a CUDA graph
every halo has a fixed destination, on one card or across several.

A level (``sharded_match_level``) blurs G(L^2) on clamp-haloed shards,
gathers the whole right image once on each device (the warp's source:
the right image does not change across iterations), then runs each
iteration as warp -> direction -> smooth per shard, through the
row-sharded forms of the three kernels, with a halo exchange before
direction (HALO rows) and before smooth (n + 1 rows).  Each form is an
exact row slice of its unsharded kernel, so the sharded level, pyramid
and pair equal the unsharded ones bit for bit.  Stages whose rows are
too few to shard (``_row_ok``) run whole, once per distinct device
(``replicated_stage``): the coarse levels then keep the level-resident
kernel.

What the JAX module needs and this one does not: ``_refresh_pad`` and
the row padding, which exist because shard_map needs equal blocks; the
unfused body ``_level_body`` and its gate, because a halo here may come
from any number of shards; the one-hot height pass of the resample,
because a GPU gathers (each shard runs the resample kernel on the input
rows its taps reach, with the taps rebased).
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.ops.cuda.blur import fused_blur_gaussian
from ug_stereomatcher_tpu_torch.ops.cuda.direction import (
    HALO as DIR_HALO,
    fused_direction_update,
)
from ug_stereomatcher_tpu_torch.ops.cuda.resample import (
    kept_taps,
    resample_static,
    resample_tex,
    upload_taps,
)
from ug_stereomatcher_tpu_torch.ops.cuda.smooth import (
    fused_smooth_average,
    smooth_halo_rows,
)
from ug_stereomatcher_tpu_torch.ops.cuda.warp import warp
from ug_stereomatcher_tpu_torch.ops.resample import (
    CoordFn,
    ScaleMap,
    bilinear_taps,
    nearest_indices,
)
from ug_stereomatcher_tpu_torch.parallel.mesh import Mesh

MIN_ROWS_PER_SHARD = 16


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (the kernels launch on it)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def row_splits(height: int, n: int) -> List[Tuple[int, int]]:
    """Rows [start, stop) of each of n shards: ceil(height / n) rows each,
    the last one shorter.  Raises where the last shard would be empty (the
    JAX package's padding >= local rows case)."""
    hl = -(-height // n)
    pad = hl * n - height
    if pad >= hl:
        raise ValueError(
            f"cannot row-shard H={height} over {n} shards exactly "
            f"(padding {pad} >= local rows {hl}); use fewer shards or the "
            f"unsharded match_level")
    return [(k * hl, min((k + 1) * hl, height)) for k in range(n)]


def _row_ok(true_h: int, n: int, min_rows: int) -> bool:
    """Row-shard a stage?  Needs every shard non-empty and enough rows to
    be worth the halo copies."""
    hl = -(-true_h // n)
    return (hl * n - true_h) < hl and true_h >= min_rows * n


class RowBlocks:
    """A (..., H, W) array laid over devices by rows: row-sharded
    (``shards[k]`` holds the rows ``row_splits(height, n)[k]`` on its
    device) or whole (``copies`` maps a device to a full copy; a
    replicated stage leaves one per distinct device)."""

    def __init__(self, height: int, shards: Optional[List[torch.Tensor]] = None,
                 copies: Optional[Dict[torch.device, torch.Tensor]] = None):
        if (shards is None) == (copies is None):
            raise ValueError("pass shards or copies")
        self.height = height
        self.shards = shards
        self.copies = copies

    @classmethod
    def of(cls, x) -> "RowBlocks":
        """``x`` itself, or a tensor as a whole array on its device."""
        if isinstance(x, RowBlocks):
            return x
        return cls(x.shape[-2], copies={x.device: x})

    @property
    def sharded(self) -> bool:
        return self.shards is not None

    def _blocks(self) -> List[torch.Tensor]:
        return self.shards if self.sharded else list(self.copies.values())

    @property
    def width(self) -> int:
        return self._blocks()[0].shape[-1]

    def rows(self, lo: int, hi: int, device: torch.device,
             boundary: str = "clamp") -> torch.Tensor:
        """The global rows [lo, hi) on ``device``, contiguous, copied from
        whichever blocks hold them; rows outside the image are zeros
        (``"zero"``) or the image's edge row (``"clamp"``).  Rows that one
        block on ``device`` holds contiguously are that block's view."""
        device = torch.device(device)
        if 0 <= lo and hi <= self.height:
            srcs = self._sources(lo, hi, device)
            if len(srcs) == 1 and srcs[0][0].device == device:
                src, a, b = srcs[0]
                if src[..., a:b, :].is_contiguous():
                    return src[..., a:b, :]
        first = self._blocks()[0]
        out = torch.empty(first.shape[:-2] + (hi - lo, first.shape[-1]),
                          dtype=first.dtype, device=device)
        return self.rows_into(out, lo, boundary)

    def _sources(self, a: int, b: int, device: torch.device):
        """(block, first, stop): the blocks' local rows that hold the
        global rows [a, b), in order (the copy on ``device`` where the
        array is whole and has one there)."""
        if not self.sharded:
            src = self.copies.get(device, next(iter(self.copies.values())))
            return [(src, a, b)]
        return [(self.shards[k], s0, s1)
                for k, s0, s1 in _pieces(self.height, len(self.shards), a, b)]

    def rows_into(self, out: torch.Tensor, lo: int,
                  boundary: str = "clamp") -> torch.Tensor:
        """Write the global rows [lo, lo + out rows) into ``out`` (a band
        allocated by the caller, on any device) and return it: each piece
        goes straight to its place, with the zero or clamp boundary
        outside the image.  Where every piece lies on ``out``'s card,
        one ``torch.cat`` into the band writes it; otherwise (the CPU, or
        pieces on other cards) each piece is one copy into its rows, a
        peer copy where the piece lies on another card."""
        hi = lo + out.shape[-2]
        a, b = max(lo, 0), min(hi, self.height)
        if a >= b:
            raise ValueError(f"rows [{lo}, {hi}) miss the {self.height}-row "
                             f"image")
        views = [src[..., s0:s1, :]
                 for src, s0, s1 in self._sources(a, b, out.device)]
        top, bottom = a - lo, hi - b
        if out.device.type == "cuda" and all(v.device == out.device
                                             for v in views):
            if top:
                views.insert(0, _edge_rows(views[0][..., :1, :], top,
                                           boundary))
            if bottom:
                views.append(_edge_rows(views[-1][..., -1:, :], bottom,
                                        boundary))
            torch.cat(views, dim=-2, out=out)
            return out
        at = top
        for v in views:
            out[..., at:at + v.shape[-2], :].copy_(v)
            at += v.shape[-2]
        if top:
            _fill_edge(out[..., :top, :], out[..., top:top + 1, :], boundary)
        if bottom:
            _fill_edge(out[..., at:, :], out[..., at - 1:at, :], boundary)
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole array on ``device`` (an all-gather of the shards)."""
        device = torch.device(device)
        if not self.sharded and device in self.copies:
            return self.copies[device]
        return self.rows(0, self.height, device)

    def shard(self, devices: Sequence[torch.device]) -> "RowBlocks":
        """Row-sharded over ``devices``."""
        if self.sharded and [s.device for s in self.shards] == list(devices):
            return self
        return RowBlocks(self.height, shards=[
            self.rows(a, b, dev) for (a, b), dev in zip(
                row_splits(self.height, len(devices)), devices)])

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RowBlocks":
        """``fn`` applied to every block; it must keep the rows."""
        if self.sharded:
            return RowBlocks(self.height, shards=[fn(s) for s in self.shards])
        return RowBlocks(self.height,
                         copies={d: fn(x) for d, x in self.copies.items()})


def _edge_rows(row: torch.Tensor, n: int, boundary: str) -> torch.Tensor:
    shape = row.shape[:-2] + (n, row.shape[-1])
    if boundary == "zero":
        return row.new_zeros(shape)
    if boundary == "clamp":
        return row.expand(shape)
    raise ValueError(f"unknown boundary {boundary!r}")


def _fill_edge(dst: torch.Tensor, row: torch.Tensor, boundary: str) -> None:
    """Fill the rows ``dst`` outside the image: zeros, or ``row`` (the
    image's edge row) repeated."""
    if boundary == "zero":
        dst.zero_()
    elif boundary == "clamp":
        dst.copy_(row.expand(dst.shape))
    else:
        raise ValueError(f"unknown boundary {boundary!r}")


@functools.lru_cache(maxsize=4096)
def _pieces(height: int, n: int, a: int, b: int) -> Tuple[tuple, ...]:
    """The band plan of the global rows [a, b) of a ``height``-row array
    in n row shards: (shard k, first, stop) of each shard's local rows
    that hold some of them, top to bottom.  A halo taller than a shard
    takes rows from as many shards as it reaches."""
    return tuple((k, max(a, s0) - s0, min(b, s1) - s0)
                 for k, (s0, s1) in enumerate(row_splits(height, n))
                 if s0 < b and s1 > a)


def _blockwise(fn, *arrays: RowBlocks) -> RowBlocks:
    """``fn`` over the corresponding blocks of arrays of one layout."""
    first = arrays[0]
    if first.sharded:
        return RowBlocks(first.height, shards=[
            fn(*blocks) for blocks in zip(*(a.shards for a in arrays))])
    return RowBlocks(first.height, copies={
        d: fn(*(a.copies[d] for a in arrays)) for d in first.copies})


def halo_pad_rows(x: RowBlocks, halo: int, boundary: str = "clamp",
                  out: Optional[List[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Each shard of a row-sharded array with ``halo`` rows above and below
    it, on the shard's device: (..., Hl, W) -> (..., Hl + 2 halo, W).  The
    halo rows come from whichever shards hold them (a halo may be taller
    than a shard); outside the image they are zeros or the edge row.
    ``out`` gives the bands to write (the previous call's result: a
    level's exchanges reuse their bands, so every halo lands in the same
    place on each iteration and on each replay of a CUDA graph); without
    it each band is allocated."""
    splits = row_splits(x.height, len(x.shards))
    if out is None:
        return [x.rows(a - halo, b + halo, blk.device, boundary)
                for (a, b), blk in zip(splits, x.shards)]
    return [x.rows_into(band, a - halo, boundary)
            for (a, _), band in zip(splits, out)]


def _distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    return list(dict.fromkeys(devices))


def replicated_stage(fn, mesh: Mesh, *arrays, pair: int = 0) -> RowBlocks:
    """Run ``fn`` on the whole arrays once per distinct device of the rows
    axis of pairs-group ``pair`` (identical inputs, identical outputs)."""
    copies = {}
    for dev in _distinct(mesh.row_devices(pair)):
        inputs = [RowBlocks.of(a).gather(dev) for a in arrays]
        with on_device(dev):
            copies[dev] = fn(*inputs)
    out = next(iter(copies.values()))
    return RowBlocks(out.shape[-2], copies=copies)


def sharded_blur(x, boundary: str, mesh: Mesh, pair: int = 0,
                 min_rows_per_shard: int = MIN_ROWS_PER_SHARD) -> RowBlocks:
    """5-tap Gaussian blur of a (C, H, W) array: on each shard with 2 halo
    rows (boundary-extended at the image's edges), or whole when the rows
    are too few to shard."""
    x = RowBlocks.of(x)
    devices = mesh.row_devices(pair)
    if not _row_ok(x.height, len(devices), min_rows_per_shard):
        return replicated_stage(
            lambda t: fused_blur_gaussian(t, boundary), mesh, x, pair=pair)
    x = x.shard(devices)
    out = []
    for (a, b), block in zip(row_splits(x.height, len(devices)),
                             halo_pad_rows(x, 2, boundary)):
        with on_device(block.device):
            out.append(fused_blur_gaussian(block, boundary)
                       [..., 2:2 + b - a, :].contiguous())
    return RowBlocks(x.height, shards=out)


@functools.lru_cache(maxsize=4096)
def _kept_shard_windows(*args) -> List[tuple]:
    return _shard_windows(*args)


def _shard_windows(method: str, out_h: int, out_w: int, in_h: int,
                   in_w: int, coord_of: CoordFn, n: int) -> List[tuple]:
    """For each of n output row shards: (lo, hi, host taps), the input
    rows [lo, hi) its taps reach and its taps with the rows rebased to
    them (nearest ``(iy, ix)``, bilinear ``(iy, ix, wy, wx)``)."""
    if method == "bilinear":
        (iy, wy), (ix, wx) = (bilinear_taps(out_h, in_h, coord_of),
                              bilinear_taps(out_w, in_w, coord_of))
        last = np.minimum(iy + 1, in_h - 1)   # the second tap's row
    else:
        iy = nearest_indices(out_h, in_h, coord_of)
        ix = nearest_indices(out_w, in_w, coord_of)
        wy = wx = None
        last = iy
    windows = []
    for a, b in row_splits(out_h, n):
        lo, hi = int(iy[a:b].min()), int(last[a:b].max()) + 1
        taps = [(iy[a:b] - lo).astype(np.int32), ix]
        if wy is not None:
            taps += [wy[a:b], wx]
        windows.append((lo, hi, taps))
    return windows


def sharded_resample(x, out_h: int, out_w: int, coord_of: CoordFn,
                     value_scale: float, cfg: MatcherConfig, mesh: Mesh,
                     pair: int = 0,
                     min_rows_per_shard: int = MIN_ROWS_PER_SHARD
                     ) -> RowBlocks:
    """Separable texture resample of a (C, H, W) array (the semantics of
    resample_tex, method cfg.interp), row-sharded by output rows.

    Output shard k runs the resample kernel on the input rows its taps
    reach, taken from whichever input blocks hold them, with its height
    taps rebased to that window: the same taps as the whole resample, so
    the result is its exact row slice.  Outputs too short to shard run
    whole.  A ScaleMap's shard taps are kept on each device per call site
    (ops.cuda.resample.kept_taps), so a CUDA graph can capture the
    resample; any other map uploads them per call, which a capture
    refuses."""
    x = RowBlocks.of(x)
    devices = mesh.row_devices(pair)
    method = cfg.interp
    if not _row_ok(out_h, len(devices), min_rows_per_shard):
        return replicated_stage(
            lambda t: resample_tex(t, out_h, out_w, coord_of, value_scale,
                                   method), mesh, x, pair=pair)
    args = (method, out_h, out_w, x.height, x.width, coord_of, len(devices))
    kept = isinstance(coord_of, ScaleMap)
    windows = (_kept_shard_windows if kept else _shard_windows)(*args)
    out = []
    for k, ((lo, hi, taps), dev) in enumerate(zip(windows, devices)):
        with on_device(dev):
            if kept:
                iy_k, ix_k, *weights = kept_taps(
                    dev, ("row_shard", k) + args, lambda taps=taps: taps)
            elif (dev.type == "cuda"
                  and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("sharded_resample: a CUDA graph captures "
                                   "only ScaleMap coordinate maps, whose "
                                   "taps stay on the card")
            else:
                iy_k, ix_k, *weights = upload_taps(dev, taps)
            out.append(resample_static(x.rows(lo, hi, dev), iy_k, ix_k,
                                       value_scale, *weights))
    return RowBlocks(out_h, shards=out)


def sharded_upsample_to_level(disp, out_h: int, out_w: int,
                              cfg: MatcherConfig, mesh: Mesh, pair: int = 0,
                              min_rows_per_shard: int = MIN_ROWS_PER_SHARD
                              ) -> RowBlocks:
    """pyramid.upsample_to_level on row blocks: values x SCALE, with the
    confidence-plane quirk handled as the unsharded op handles it."""
    kw = dict(pair=pair, min_rows_per_shard=min_rows_per_shard)
    inv = 1.0 / cfg.scale
    up = sharded_resample(disp, out_h, out_w, ScaleMap(inv), cfg.scale,
                          cfg, mesh, **kw)
    if not cfg.scale_conf_on_upsample:
        conf = sharded_resample(RowBlocks.of(disp).map(lambda t: t[2:3]),
                                out_h, out_w, ScaleMap(inv), 1.0, cfg,
                                mesh, **kw)
        up = _blockwise(lambda u, c: torch.cat([u[:2], c]), up, conf)
    return up


def sharded_build_pyramid(image, cfg: MatcherConfig, n: int, mesh: Mesh,
                          pair: int = 0,
                          min_rows_per_shard: int = MIN_ROWS_PER_SHARD
                          ) -> List[RowBlocks]:
    """pyramid.build_pyramid on row blocks: per level one sharded blur and
    the even/odd factor-2 resample chain (only the blurs that feed a
    resample run); bit-identical to the unsharded build."""
    image = RowBlocks.of(image)
    dims = cfg.dims_chain(image.height, image.width)
    kw = dict(pair=pair, min_rows_per_shard=min_rows_per_shard)
    levels: List[RowBlocks] = [image] + [None] * (n - 1)  # type: ignore
    scale2 = float(int(cfg.scale * cfg.scale + 0.5))  # == 2.0
    for i in range(n):
        targets = [(1, cfg.scale)] if i == 0 and n > 1 else []
        if i + 2 < n:
            targets.append((i + 2, scale2))
        if not targets:
            continue
        blurred = sharded_blur(levels[i], "zero", mesh, **kw)
        for (j, s) in targets:
            levels[j] = sharded_resample(blurred, *dims[j],
                                         ScaleMap(s), 1.0, cfg,
                                         mesh, **kw)
    return levels


def sharded_match_level(left, right, disp, level_index: int,
                        cfg: MatcherConfig, is_coarsest: bool, mesh: Mesh,
                        pair: int = 0) -> RowBlocks:
    """match.match_level with the rows sharded over the rows axis of
    pairs-group ``pair``; left, right and disp are tensors or RowBlocks.
    The result equals match_level's bit for bit without early exit: the
    level runs its fixed schedule whatever ``cfg.early_exit_delta`` is
    (sharded_match_pair warns)."""
    check_supported(cfg)
    devices = mesh.row_devices(pair)
    left = RowBlocks.of(left).shard(devices)
    disp = RowBlocks.of(disp).shard(devices)
    right = RowBlocks.of(right)
    H = left.height
    shards = list(zip(row_splits(H, len(devices)), devices))
    mi = cfg.iters_for_level(level_index)
    n_smooth = cfg.smooth_passes_for_level(level_index)
    sm_halo = smooth_halo_rows(n_smooth)

    # Iteration-invariant: G(L^2) (clamp), left's haloed shards, and the
    # warp's source, the whole right image on each device.
    right_full = {dev: right.gather(dev) for dev in _distinct(devices)}
    left_h = halo_pad_rows(left, DIR_HALO)
    bl2 = []
    for ((a, b), dev), lb in zip(shards, halo_pad_rows(left, 2)):
        with on_device(dev):
            bl2.append(fused_blur_gaussian(lb * lb, "clamp")
                       [..., 2:2 + b - a, :].contiguous())

    state = disp
    warped_h = upd_h = None   # each exchange's bands, reused every iteration
    for m, threshold in enumerate(cfg.threshold_schedule(mi)):
        # The coarsest level's first iteration replaces the confidence.
        replace = is_coarsest and m == 0
        warped = []
        for ((a, _), dev), st in zip(shards, state.shards):
            with on_device(dev):
                warped.append(warp(right_full[dev], st[0], st[1], cfg.interp,
                                   row0=a))
        warped_h = halo_pad_rows(RowBlocks(H, shards=warped), DIR_HALO,
                                 out=warped_h)
        upd = []
        for k, ((a, _), dev) in enumerate(shards):
            with on_device(dev):
                upd.append(fused_direction_update(
                    left_h[k], warped_h[k], bl2[k], state.shards[k],
                    threshold, replace, cfg.conf_consts, row0=a, global_h=H))
        upd_h = halo_pad_rows(RowBlocks(H, shards=upd), sm_halo, out=upd_h)
        smoothed = []
        for ((a, _), dev), block in zip(shards, upd_h):
            with on_device(dev):
                smoothed.append(fused_smooth_average(block, n_smooth, row0=a,
                                                     global_h=H))
        state = RowBlocks(H, shards=smoothed)
    return state


def _fovea_crop(x: RowBlocks, upper: int, left: int, fov_h: int,
                fov_w: int, mesh: Mesh, pair: int,
                min_rows_per_shard: int) -> RowBlocks:
    """The (fov_h, fov_w) window of ``x`` at (upper, left): row-sharded
    where its rows suffice (each shard copies its window rows from
    whichever blocks hold them), else whole on each distinct device."""
    devices = mesh.row_devices(pair)

    def crop(a: int, b: int, dev: torch.device) -> torch.Tensor:
        rows = x.rows(upper + a, upper + b, dev)
        return rows[..., left:left + fov_w].contiguous()

    if _row_ok(fov_h, len(devices), min_rows_per_shard):
        return RowBlocks(fov_h, shards=[
            crop(a, b, dev) for (a, b), dev in zip(
                row_splits(fov_h, len(devices)), devices)])
    return RowBlocks(fov_h, copies={dev: crop(0, fov_h, dev)
                                    for dev in _distinct(devices)})


class ShardedMatchResult(NamedTuple):
    """Per-level disparity triplets, index 0 = finest level, each a
    RowBlocks (``.gather(device)`` gives the (3, h, w) tensor)."""
    levels: Tuple[RowBlocks, ...]


def sharded_match_pair(left: torch.Tensor, right: torch.Tensor,
                       cfg: MatcherConfig, mesh: Mesh, pair: int = 0,
                       min_rows_per_shard: int = MIN_ROWS_PER_SHARD,
                       foveated: bool = False) -> ShardedMatchResult:
    """Coarse-to-fine match of one (3, H, W) pair on the rows axis of
    pairs-group ``pair``: pyramid build, levels and upsamples are
    row-sharded where their rows suffice and run whole (once per distinct
    device) where they do not.  With ``foveated=True`` (mode 2) the levels
    finer than fovea_level - 1 are their fovea windows
    (pyramid.foveate_pyramid) and each transition between them is
    pyramid.foveated_upsample, run whole.  Every level equals
    match_pyramid's bit for bit.

    ``cfg.early_exit_delta`` stops only the levels that run whole
    (match.match_level); a row-sharded level runs its fixed schedule, since
    an exit would need every shard's change summed each iteration, and a
    warning says so (JAX spatial.py:839-848)."""
    check_supported(cfg)
    if cfg.early_exit_delta is not None:
        warn_fixed_schedule(stacklevel=3)
    return _sharded_match_pair(left, right, cfg, mesh, pair,
                               min_rows_per_shard, foveated)


def warn_fixed_schedule(stacklevel: int = 2) -> None:
    """The warning of a row-sharded match with ``early_exit_delta`` set."""
    warnings.warn(
        "early_exit_delta is ignored by row-sharded level bodies; "
        "sharded_match_pair runs the fixed iteration schedule on "
        "sharded levels", stacklevel=stacklevel)


def _sharded_match_pair(left: torch.Tensor, right: torch.Tensor,
                        cfg: MatcherConfig, mesh: Mesh, pair: int = 0,
                        min_rows_per_shard: int = MIN_ROWS_PER_SHARD,
                        foveated: bool = False) -> ShardedMatchResult:
    """sharded_match_pair without its warning (the batch matcher warns
    once a call, replays included)."""
    h, w = left.shape[-2:]
    n = cfg.num_levels(h, w)
    devices = mesh.row_devices(pair)
    kw = dict(pair=pair, min_rows_per_shard=min_rows_per_shard)
    # both images' pyramids in one stacked pass (pyramid.build_pyramid_pair)
    c = left.shape[-3]
    stacked = RowBlocks.of(torch.cat([left, right], dim=-3))
    if _row_ok(h, len(devices), min_rows_per_shard):
        stacked = stacked.shard(devices)
    levels = sharded_build_pyramid(stacked, cfg, n, mesh, **kw)
    full_chain = cfg.dims_chain(h, w)
    if foveated:
        fov_h, fov_w = full_chain[cfg.fovea_level - 1]
        for i in range(min(n, cfg.fovea_level - 1)):
            lh, lw = full_chain[i]
            levels[i] = _fovea_crop(levels[i], lh // 2 - fov_h // 2,
                                    lw // 2 - fov_w // 2, fov_h, fov_w,
                                    mesh, **kw)
    lp = [lv.map(lambda t: t[:c]) for lv in levels]
    rp = [lv.map(lambda t: t[c:]) for lv in levels]
    dims = match_mod.level_dims_for_matching(cfg, h, w, n, foveated)
    big_h, big_w = full_chain[cfg.fovea_level - 2]

    results: List[RowBlocks] = [None] * n  # type: ignore[list-item]
    disp = RowBlocks.of(torch.zeros((3,) + tuple(dims[n - 1]),
                                    dtype=left.dtype, device=left.device))
    for i in range(n - 1, -1, -1):
        is_coarsest = i == n - 1
        if _row_ok(dims[i][0], len(devices), min_rows_per_shard):
            disp = sharded_match_level(lp[i], rp[i], disp, i, cfg,
                                       is_coarsest, mesh, pair)
        else:
            disp = replicated_stage(
                functools.partial(match_mod.match_level, level_index=i,
                                  cfg=cfg, is_coarsest=is_coarsest),
                mesh, lp[i], rp[i], disp, pair=pair)
        results[i] = disp
        if i == 0:
            break
        if not foveated or i >= cfg.fovea_level:
            disp = sharded_upsample_to_level(disp, *dims[i - 1], cfg, mesh,
                                             **kw)
        else:
            disp = replicated_stage(
                functools.partial(pyr.foveated_upsample, big_h=big_h,
                                  big_w=big_w, cfg=cfg),
                mesh, disp, pair=pair)
    return ShardedMatchResult(levels=tuple(results))
