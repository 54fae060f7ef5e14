"""The entry layer's upload of host arrays to a card: a ring of
page-locked host slots, and the threads that fill them, which the
engine owns, one ring per card.

A pageable ``tensor.to(card)`` makes the CUDA runtime stage the copy
through its own small pinned buffers with one host thread, and holds the
host for the whole DMA.  ``StagingRing.upload`` walks the array's bytes
in slot-sized chunks instead (``chunk_plan``).  For each chunk it waits
only on the event of the slot the chunk reuses and hands the chunk's
host copy into that slot to one of the ring's copy threads
(``ctypes.memmove``, which runs without the interpreter lock), so
several chunks are copied at once.  As the copies finish, in order, the
calling thread issues each slot's copy to the card with
``non_blocking=True`` on the card's current stream and records the
slot's event.  So the host copies of later chunks overlap the DMAs of
earlier ones, and the host returns before the last DMA ends: work issued
after it on the same stream is ordered after it, and no host synchronise
is added.

The copy threads are the ring's own, not torch's intra-op threads:
torch's CPU copy splits each chunk evenly over every intra-op thread
and waits for the last, so one thread that the host runs late stalls
the chunk, and on a host of many cores it wakes all of them for each
chunk; the ring's threads take whole chunks as they come free
(tools/staging_probe.py; PERF.md §6).

The destination is allocated as a plain ``.to`` allocates it: one tensor
of the array's shape and dtype from the caching allocator, on the
current stream; the slots hold no device memory.  A CPU tensor that is
already pinned takes one ``non_blocking`` copy and no staging.  Nothing
is keyed on the caller's array: every array takes the same path, and
the card reads only the ring's slots, so a caller may overwrite the
array as soon as the call returns.  ``_build.upload_bytes()`` counts the
bytes each route moved.

The slots are pinned, and the copy threads started, at the first upload
(an engine's warm-up pays for it).  One upload holds the ring's lock
from its first chunk to its last, so two threads uploading to one card
never share a slot.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Optional, Tuple

import torch

from ug_stereomatcher_tpu_torch.ops.cuda import _build

# Chosen on the H100 hosts of one card (8 cores) and of four (32) by
# tools/staging_probe.py (PERF.md §6).
SLOT_BYTES = 8 << 20
COPY_THREADS = 8    # at most; never more than the host's cores
DMA_SLOTS = 2       # slots beyond the copies in flight: their DMAs


def chunk_plan(nbytes: int, slot_bytes: int) -> List[Tuple[int, int]]:
    """The ``[start, end)`` byte ranges of an upload of ``nbytes``
    through slots of ``slot_bytes``: in order, each at most a slot, every
    byte in exactly one (none for zero bytes)."""
    if slot_bytes <= 0:
        raise ValueError(f"slot_bytes must be positive, got {slot_bytes}")
    return [(a, min(a + slot_bytes, nbytes))
            for a in range(0, nbytes, slot_bytes)]


def copy_threads(cores: Optional[int] = None) -> int:
    """The copy threads of a ring on a host of ``cores`` cores (those
    this process may run on): COPY_THREADS, or every core of a smaller
    host."""
    if cores is None:
        cores = len(os.sched_getaffinity(0))
    return max(1, min(COPY_THREADS, cores))


class StagingRing:
    """Pinned host slots of ``slot_bytes`` and ``copiers`` copy threads
    (default ``copy_threads()``) that stage uploads to one card (module
    docstring): a slot for each copy in flight and DMA_SLOTS more."""

    def __init__(self, device: torch.device, slot_bytes: int = SLOT_BYTES,
                 copiers: Optional[int] = None):
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"a staging ring needs an indexed CUDA device, "
                             f"got {device}")
        self.device = device
        self.slot_bytes = int(slot_bytes)
        self.copiers = copy_threads() if copiers is None else int(copiers)
        if self.copiers < 1:
            raise ValueError(f"a ring needs a copy thread, got "
                             f"{self.copiers}")
        self.n_slots = self.copiers + DMA_SLOTS
        self._slots: List[torch.Tensor] = []
        self._events: List[torch.cuda.Event] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, src: torch.Tensor) -> torch.Tensor:
        """``src``, a CPU tensor, as a tensor of its shape and dtype on
        the ring's card, its copy issued on the card's current stream."""
        if src.is_pinned():
            _build.record_upload("pinned", src.nbytes)
            return src.to(self.device, non_blocking=True)
        src = src.contiguous()
        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        nbytes = src.nbytes
        if nbytes:
            src_b = src.view(-1).view(torch.uint8)
            dst_b = dst.view(-1).view(torch.uint8)
            stream = torch.cuda.current_stream(self.device)
            with self._lock:
                if not self._slots:
                    self._start()
                self._stage(src_b, dst_b, stream)
        _build.record_upload("staged", nbytes)
        return dst

    def _stage(self, src_b: torch.Tensor, dst_b: torch.Tensor,
               stream) -> None:
        """The chunk loop: at most ``copiers`` host copies at once; the
        oldest one's DMA is issued before another copy starts, so a slot
        is refilled DMA_SLOTS DMAs after its last one was issued."""
        copying = collections.deque()   # (copy job, slot, start, end)
        try:
            for a, b in chunk_plan(src_b.numel(), self.slot_bytes):
                if len(copying) == self.copiers:
                    self._issue(copying.popleft(), dst_b, stream)
                k = self._next
                self._next = (k + 1) % self.n_slots
                self._events[k].synchronize()   # its last DMA is done
                copying.append((self._copy(k, src_b, a, b), k, a, b))
            while copying:
                self._issue(copying.popleft(), dst_b, stream)
        finally:   # no copy may still write a slot once the lock is free
            wait([job for job, _, _, _ in copying])

    def _copy(self, k: int, src_b: torch.Tensor, a: int, b: int):
        """A copy thread's job: bytes ``[a, b)`` of ``src_b`` into slot
        ``k``."""
        return self._pool.submit(ctypes.memmove, self._slots[k].data_ptr(),
                                 src_b.data_ptr() + a, b - a)

    def _issue(self, item, dst_b: torch.Tensor, stream) -> None:
        job, k, a, b = item
        job.result()
        dst_b[a:b].copy_(self._slots[k][:b - a], non_blocking=True)
        self._events[k].record(stream)

    def _start(self) -> None:
        self._slots = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                   pin_memory=True)
                       for _ in range(self.n_slots)]
        self._events = [torch.cuda.Event() for _ in range(self.n_slots)]
        self._pool = ThreadPoolExecutor(self.copiers,
                                        thread_name_prefix="ugsm-staging")
