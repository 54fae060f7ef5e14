"""Device meshes: a (pairs, rows) grid of torch devices.

Counterpart of ``ug_stereomatcher_tpu/parallel/mesh.py``.  The JAX
package's sharded engine is single-controller: one process drives every
device of the mesh.  The port keeps that design within a process: a shard
is a tensor on its mesh device, a halo exchange copies row slices into a
band on the shard's device (a peer copy between cards), and an all-gather
copies every shard's rows into one tensor.  A device may
appear more than once, as the JAX tests' virtual CPU devices do: ``[cpu] *
4`` runs the sharded code in one process, and ``[cuda:0] * 4`` runs four
shards on one card with every halo copy real.

Each entry of a mesh is a ``Slot``: its torch device, the rank of the
process that drives it (``process_index``) and an ``id`` unique in the
mesh, as a JAX device carries both.  ``make_mesh`` gives every entry to
the calling process; ``multihost.pod_mesh`` builds a mesh whose pairs axis
spans processes (parallel/batch.py then gathers the pairs over
``torch.distributed``).  A rows-group never spans processes: its halo
copies stay inside the process that drives it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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


def process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group, or
    0 where no group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass(frozen=True)
class Slot:
    """One mesh entry: the torch device, the rank of the process that
    drives it and an id unique in the mesh (JAX's ``process_index`` and
    ``id`` of a device)."""

    device: torch.device
    process_index: int = 0
    id: int = 0


def _slot(d, rank: int, index: int) -> Slot:
    if isinstance(d, Slot):
        return dataclasses.replace(d, device=_device(d.device))
    return Slot(_device(d), rank, index)


class Mesh:
    """A (pairs, rows) grid of torch devices; a device may repeat.

    ``devices[p][r]`` runs row shard r of the pair that pairs-group p
    matches; ``shape`` is ``{"pairs": P, "rows": R}`` as in the JAX mesh.
    An entry given as a ``Slot`` keeps its owner and id; any other entry
    (a torch device or its name) belongs to the calling process, with its
    flat position as its id.  Raises ValueError where a rows-group spans
    two processes."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = [list(row) for row in devices]
        widths = {len(row) for row in rows}
        if not rows or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty (pairs, rows) grid")
        rank, width = process_index(), len(rows[0])
        self.slots: List[List[Slot]] = [
            [_slot(d, rank, p * width + r) for r, d in enumerate(row)]
            for p, row in enumerate(rows)]
        self.devices: List[List[torch.device]] = [
            [s.device for s in row] for row in self.slots]
        for p, row in enumerate(self.slots):
            owners = sorted({s.process_index for s in row})
            if len(owners) > 1:
                raise ValueError(
                    f"rows-group {p} spans processes {owners}: a rows axis "
                    f"stays inside one process (its halo copies are local)")

    @property
    def shape(self) -> Dict[str, int]:
        return {"pairs": len(self.devices), "rows": len(self.devices[0])}

    def row_devices(self, pair: int = 0) -> List[torch.device]:
        """The rows axis of pairs-group ``pair``."""
        return list(self.devices[pair])

    def distinct_devices(self) -> List[torch.device]:
        """Every device of the mesh once, in mesh order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def process_indices(self) -> List[int]:
        """The ranks that drive the mesh, ascending."""
        return sorted({row[0].process_index for row in self.slots})

    def spans_processes(self) -> bool:
        """Whether more than one process drives the mesh.  A mesh with one
        owner is driven whole by whichever process runs it."""
        return len(self.process_indices()) > 1

    def owner(self, pair: int) -> int:
        """The rank that drives pairs-group ``pair``."""
        return self.slots[pair][0].process_index

    def local_pairs(self, rank: Optional[int] = None) -> List[int]:
        """The pairs-groups that process ``rank`` (default: this one)
        drives, ascending."""
        rank = process_index() if rank is None else rank
        return [p for p in range(len(self.slots)) if self.owner(p) == rank]

    def local_devices(self) -> List[torch.device]:
        """The devices this process drives when it runs the mesh, once
        each, in mesh order: every device of a mesh with one owner, else
        those of the groups ``local_pairs()`` names."""
        pairs = (self.local_pairs() if self.spans_processes()
                 else range(len(self.devices)))
        return list(dict.fromkeys(d for p in pairs for d in self.devices[p]))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.slots})"


def mesh_key(mesh: Optional[Mesh]) -> Optional[tuple]:
    """The cache key of a mesh, as the JAX engine's (engine.py:386-387):
    its shape and every slot (device, process, id) in mesh order; None
    for no mesh.  Equal meshes give equal keys; another slot order or
    another device gives another key."""
    if mesh is None:
        return None
    return (tuple(mesh.shape.items()),
            tuple(s for row in mesh.slots for s in row))


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
