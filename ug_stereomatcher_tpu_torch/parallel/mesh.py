"""Device meshes: a (pairs, rows) grid of torch devices.

Counterpart of ``ug_stereomatcher_tpu/parallel/mesh.py``.  The JAX
package's sharded engine is single-controller: one process drives every
device of the mesh.  The port keeps that design: a shard is a tensor on
its mesh device, a halo exchange is a row slice copied with ``.to``, and
an all-gather is a ``torch.cat`` of such copies.  A device may appear
more than once, as the JAX tests' virtual CPU devices do: ``[cpu] * 4``
runs the sharded code in one process, and ``[cuda:0] * 4`` runs four
shards on one card with every halo copy real.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def mesh_shape_for(n_devices: int, n_pairs: Optional[int] = None
                   ) -> Tuple[int, int]:
    """Pick a (pairs, rows) mesh shape for n_devices.

    If the batch size is known, give the pairs axis min(n_pairs, ...) and use
    the rest for row tiling; otherwise split as square as possible with rows
    getting the larger factor."""
    if n_pairs is not None and n_pairs >= n_devices:
        return (n_devices, 1)
    best = (1, n_devices)
    for p in range(1, n_devices + 1):
        if n_devices % p:
            continue
        r = n_devices // p
        if n_pairs is not None and p > n_pairs:
            break
        if p > r:  # keep rows >= pairs (square-ish, rows gets the larger)
            break
        best = (p, r)
    return best


def _device(d) -> torch.device:
    """A torch.device with the CUDA index filled in."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


class Mesh:
    """A (pairs, rows) grid of torch devices; a device may repeat.

    ``devices[p][r]`` runs row shard r of the pair that pairs-group p
    matches; ``shape`` is ``{"pairs": P, "rows": R}`` as in the JAX mesh."""

    def __init__(self, devices: Sequence[Sequence]):
        self.devices: List[List[torch.device]] = [
            [_device(d) for d in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty (pairs, rows) grid")

    @property
    def shape(self) -> Dict[str, int]:
        return {"pairs": len(self.devices), "rows": len(self.devices[0])}

    def row_devices(self, pair: int = 0) -> List[torch.device]:
        """The rows axis of pairs-group ``pair``."""
        return list(self.devices[pair])

    def distinct_devices(self) -> List[torch.device]:
        """Every device of the mesh once, in mesh order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(n_pairs_axis: int = 1, n_rows_axis: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a ('pairs', 'rows') mesh.

    ``devices`` defaults to the visible CUDA cards, and a machine with too
    few of them raises: the mesh never falls back to the CPU.  An explicit
    list may name a device more than once (``["cpu"] * 4`` for a CPU run,
    ``["cuda:0"] * 4`` for four shards on one card)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_rows_axis is None:
        n_rows_axis = max(1, len(devices) // n_pairs_axis)
    need = n_pairs_axis * n_rows_axis
    if len(devices) < need:
        raise ValueError(
            f"mesh ({n_pairs_axis} pairs x {n_rows_axis} rows) needs {need} "
            f"devices but only {len(devices)} are available; pass devices= "
            f"to repeat one (e.g. ['cpu'] * {need})")
    return Mesh([devices[p * n_rows_axis:(p + 1) * n_rows_axis]
                 for p in range(n_pairs_axis)])
