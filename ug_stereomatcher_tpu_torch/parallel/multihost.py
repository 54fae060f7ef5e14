"""Several processes on one pair batch: ``torch.distributed`` start-up and
the pod mesh.

Counterpart of ``ug_stereomatcher_tpu/parallel/multihost.py``.  Each
process drives its own cards; the pairs axis of ``pod_mesh`` spans the
processes and its rows axis stays inside one of them, so a halo copy never
leaves its host.  ``parallel.batch`` gathers each process's pairs over the
default process group: NCCL on cards, gloo on the CPU.

The JAX module reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID``; this one reads the variables ``torchrun`` sets:

    JAX_COORDINATOR_ADDRESS  ->  MASTER_ADDR:MASTER_PORT
    JAX_NUM_PROCESSES        ->  WORLD_SIZE
    JAX_PROCESS_ID           ->  RANK

A process that finds none of them runs alone.  ``torchrun
--nproc-per-node=N`` also sets ``LOCAL_WORLD_SIZE``: each of a host's N
ranks then drives its own share of the host's cards (card_slots).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ug_stereomatcher_tpu_torch.parallel.mesh import (
    Mesh,
    Slot,
    process_index,
)


def distributed_config(init_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None
                       ) -> Tuple[Optional[str], Dict[str, int]]:
    """Resolve the process group's configuration.

    Explicit arguments win; otherwise ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` are read (the address only where both
    variables are set).  Returns ``(address_or_None, kwargs)`` with
    ``num_processes`` and ``process_id`` in ``kwargs`` where known: the
    parsing is testable without starting a process group."""
    if init_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_address = (f"{os.environ['MASTER_ADDR']}:"
                        f"{os.environ['MASTER_PORT']}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    kw: Dict[str, int] = {}
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    return init_address, kw


def initialize_distributed(init_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Start the default process group where one is configured.

    Returns False where no address is configured (the process runs
    alone); otherwise calls ``torch.distributed.init_process_group`` on
    ``tcp://address`` and returns whether more than one process takes
    part.  The backend is NCCL for a CUDA ``device`` and gloo for the CPU;
    an explicit ``backend`` wins (two ranks on one card need gloo: NCCL
    refuses them).  A backend that fails to start raises: there is no
    fallback from NCCL to gloo."""
    address, kw = distributed_config(init_address, num_processes, process_id)
    if not address:
        return False
    if "num_processes" not in kw or "process_id" not in kw:
        raise ValueError(
            f"process group at {address} needs the world size and this "
            f"process's rank (WORLD_SIZE and RANK, or the arguments)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=kw["num_processes"],
                            rank=kw["process_id"])
    return dist.get_world_size() > 1


def card_slots(world: int, n_cards: int, local_world: int = 1) -> list:
    """One slot per rank and card it drives, for ``world`` ranks on hosts
    of ``n_cards`` cards and ``local_world`` ranks each.  Ranks are
    numbered host-major (as torchrun numbers them), so rank r is local
    rank ``r % local_world`` of its host and drives k = n_cards //
    local_world cards of it, ``cuda:(local_rank * k + i)`` with id ``r * k
    + i``; where ranks outnumber the cards, local rank l shares card ``l %
    n_cards``."""
    k = max(1, n_cards // local_world)
    return [Slot(torch.device("cuda", (r % local_world * k + i) % n_cards),
                 r, r * k + i)
            for r in range(world) for i in range(k)]


def _live_slots() -> list:
    """card_slots of the process group on this machine's cards, with the
    ranks per host from torchrun's ``LOCAL_WORLD_SIZE`` (one where it is
    not set: one process per host drives every card)."""
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError(
            "pod_mesh: torch finds no CUDA device; pass devices= (Slots on "
            "'cpu') to build a mesh without a card")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return card_slots(world, n_cards,
                      int(os.environ.get("LOCAL_WORLD_SIZE", "1")))


def pod_mesh(rows_per_host: Optional[int] = None, *,
             devices: Optional[Sequence[Slot]] = None,
             n_local: Optional[int] = None) -> Mesh:
    """A ('pairs', 'rows') mesh for the process group: the rows axis spans
    cards of one process, the pairs axis the processes times any leftover
    local factor.

    ``devices`` defaults to one slot per rank and card it drives
    (card_slots; without a card it must be given: tests inject synthetic
    slots on the CPU), and ``n_local`` to the number of slots that this
    process drives.  ``rows_per_host`` is clamped down to a divisor of
    ``n_local``, so the rows axis never crosses a process boundary."""
    devices = _live_slots() if devices is None else list(devices)
    # group by the owning process first (stable by id within it), so that
    # the reshape below cannot put two processes' cards in one rows-group
    devices.sort(key=lambda d: (d.process_index, d.id))
    if n_local is None:   # the slots this process drives
        rank = process_index()
        n_local = sum(d.process_index == rank for d in devices)
        if n_local == 0:
            raise ValueError(f"pod_mesh: process {rank} drives none of the "
                             f"given slots; pass n_local=")
    n_local = max(1, min(n_local, len(devices)))
    n_hosts = max(1, len(devices) // n_local)
    # a ragged topology: use exactly n_hosts * n_local devices
    n_total = n_hosts * n_local
    devices = devices[:n_total]
    if rows_per_host is None:
        rows_per_host = n_local
    rows_per_host = max(1, min(rows_per_host, n_local))
    while n_local % rows_per_host:
        rows_per_host -= 1
    # host-major: each mesh row is rows_per_host consecutive cards of one
    # process
    return Mesh([devices[i:i + rows_per_host]
                 for i in range(0, n_total, rows_per_host)])
