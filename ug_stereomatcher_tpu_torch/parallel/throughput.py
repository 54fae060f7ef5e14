"""Throughput and scaling harness.

Counterpart of ``ug_stereomatcher_tpu/parallel/throughput.py``: matched
pairs per second of the batch matcher (parallel/batch.py) at 1..N devices
in the dp, sp and hybrid mesh families, in mode 1 or mode 2.  The devices
are the visible CUDA cards unless the caller names them; a device may
repeat (``[cuda:0] * 4`` puts four mesh entries on one card, ``["cpu"] *
4`` runs the harness on the CPU), and such a point says what the sharded
code costs, not how it scales.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher
from ug_stereomatcher_tpu_torch.parallel.mesh import make_mesh


@dataclasses.dataclass
class ThroughputPoint:
    n_devices: int
    batch: int
    seconds_per_batch: float
    pairs_per_second: float
    scaling_efficiency: float  # vs the first point, per device
    mesh_shape: tuple = (1, 1)  # (pairs_axis, rows_axis)
    oversubscribed: bool = False  # the mesh repeats a device


def _mesh_shape(mode: str, nd: int, pairs_per_device: int
                ) -> Tuple[int, int, int]:
    """(pairs_axis, rows_axis, batch) for a scaling point.

    * ``dp``     - pairs only: (nd, 1), batch = nd * ppd;
    * ``sp``     - rows only: (1, nd), batch = ppd, the latency of one
      pair row-sharded over every device;
    * ``hybrid`` - pairs axis capped at 2, rows take the rest, the shape
      for a batch smaller than the devices."""
    if mode == "dp":
        return nd, 1, nd * pairs_per_device
    if mode == "sp":
        return 1, nd, pairs_per_device
    if mode == "hybrid":
        p = min(2, nd)
        return p, nd // p, p * pairs_per_device
    raise ValueError(f"unknown scaling mode {mode!r}")


def measure_throughput(height: int = 192, width: int = 256,
                       device_counts: Optional[Sequence[int]] = None,
                       pairs_per_device: int = 1,
                       cfg: Optional[MatcherConfig] = None,
                       repeats: int = 3,
                       mode: str = "dp",
                       foveated: bool = False,
                       devices: Optional[Sequence] = None
                       ) -> List[ThroughputPoint]:
    """Run the batch matcher at each device count; returns the scaling
    points.  ``mode`` picks the mesh shape of a point (_mesh_shape);
    ``foveated`` measures mode 2 (the stacked fovea triplet per pair) and
    needs enough pyramid levels for ``cfg.fovea_level`` at this size.

    ``devices`` defaults to the visible CUDA cards, and a machine without
    one raises.  On the card each point's matcher captures its CUDA
    graphs at its first call (parallel/batch.py), outside the timing,
    and the timed batches replay them.  A point's time is the least of
    ``repeats`` warm batches,
    each ended by a synchronise of every distinct device of its mesh;
    ``scaling_efficiency`` is its pairs/s over the first point's per
    device times its device count, and ``oversubscribed`` says the mesh
    repeats a device (fewer distinct devices than ``n_devices``).  Times
    are not rounded."""
    cfg = cfg or MatcherConfig()
    if foveated and cfg.num_levels(height, width) < cfg.fovea_level:
        raise ValueError(
            f"{height}x{width} supports only "
            f"{cfg.num_levels(height, width)} levels but fovea_level="
            f"{cfg.fovea_level}; lower MatcherConfig.fovea_level")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "measure_throughput: torch finds no CUDA device; pass "
                "devices= (e.g. ['cpu'] * 4) to run it without a card")
    devices = list(devices)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= len(devices)]
    if mode == "hybrid":
        device_counts = [d for d in device_counts if d % 2 == 0 or d == 1]
    rng = np.random.RandomState(0)

    points: List[ThroughputPoint] = []
    base_pps = None
    for nd in device_counts:
        pairs_ax, rows_ax, b = _mesh_shape(mode, nd, pairs_per_device)
        left = rng.rand(b, 3, height, width).astype(np.float32) * 255
        right = np.roll(left, 2, axis=-1)
        mesh = make_mesh(n_pairs_axis=pairs_ax, n_rows_axis=rows_ax,
                         devices=devices[:nd])
        used = mesh.distinct_devices()
        lt = torch.from_numpy(left).to(used[0])
        rt = torch.from_numpy(right).to(used[0])
        # one matcher per device count, timed warm: on the card it
        # replays its graphs, as the JAX harness times its compiled
        # function
        fn = make_batch_matcher(cfg, mesh, foveated=foveated)

        def run():
            fn(lt, rt)
            for dev in used:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

        run()  # the first call builds the kernels and captures
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        sec = min(times)
        pps = b / sec
        if base_pps is None:
            base_pps = pps / nd  # per-device baseline from the first point
        points.append(ThroughputPoint(
            n_devices=nd, batch=b, seconds_per_batch=sec,
            pairs_per_second=pps,
            scaling_efficiency=pps / (base_pps * nd),
            mesh_shape=(pairs_ax, rows_ax),
            oversubscribed=len(used) < nd))
    return points
