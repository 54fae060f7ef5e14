"""Convergence test of one early-exit iteration and the level's exit flag:
wrapper of ``csrc/convergence.cu``.

The JAX package runs early exit as a ``lax.while_loop``
(ug_stereomatcher_tpu/match.py:392-414) whose condition, the larger of the
two ``weighted_difference`` values (ops/convergence.py:19-28, plain XLA,
no Pallas kernel) against the threshold, never leaves the device.  This
kernel is that condition on the card: one pass over the new and old
states (20 bytes a pixel) gives (dh, dv) of iteration m, and the level's
flag is set when ``!(max(dh, dv) >= thr)`` (a NaN stops the level, as
``jnp.maximum`` carries it).  The guarded warp, direction and smooth
launches that follow return at once once the flag is set, so
``match.match_level`` enqueues a level's whole schedule and reads nothing
back.  The sums are float64 in a fixed order (per-block partials, then
the last block), so a run repeats bit for bit; the plain version's
float32 ``torch.sum`` differs from them in the last bits.

A level's buffer (``level_buffer``) is one int32 tensor: ``stop``,
``last`` (the last iteration that ran), the last block's ticket and one
unused word; the kernel's float64 partial sums; then the (mi, 2) float32
deltas, stored as their bits (``deltas``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ug_stereomatcher_tpu_torch.ops.convergence import weighted_difference
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr

HEADER = 4            # stop, last, ticket, unused (int32 words)
MAX_BLOCKS = 1024     # the kernel's grid at most: 8 blocks of 256 an SM
PARTIAL_WORDS = 6 * MAX_BLOCKS   # 3 float64 sums a block


def level_buffer(mi: int, device) -> torch.Tensor:
    """A zeroed buffer for a level of ``mi`` iterations on ``device``."""
    return torch.zeros(HEADER + PARTIAL_WORDS + 2 * mi, dtype=torch.int32,
                       device=device)


def stop_flag(buf: torch.Tensor) -> torch.Tensor:
    """The level's exit flag: a one-element view of ``buf``, the ``stop``
    that the guarded kernels take."""
    return buf[0:1]


def last_iteration(buf: torch.Tensor) -> torch.Tensor:
    """The last iteration that ran, a one-element int32 view of ``buf``."""
    return buf[1:2]


def deltas(buf: torch.Tensor) -> torch.Tensor:
    """The (mi, 2) float32 view of the deltas: (dh, dv) of each iteration
    that ran, 0 for the others."""
    return buf[HEADER + PARTIAL_WORDS:].view(torch.float32).view(-1, 2)


def _check(new: torch.Tensor, old: torch.Tensor, m: int,
           buf: torch.Tensor) -> torch.device:
    if new.ndim != 3 or new.shape[0] != 3 or old.shape != new.shape:
        raise ValueError(f"expected two (3, H, W) states, got "
                         f"{tuple(new.shape)} and {tuple(old.shape)}")
    dev = check_planes("convergence_step", new, old)
    mi = (buf.numel() - HEADER - PARTIAL_WORDS) // 2
    if (buf.dtype != torch.int32 or buf.ndim != 1 or buf.device != dev
            or not buf.is_contiguous() or mi < 1):
        raise ValueError("convergence_step: buf must be a level_buffer on "
                         f"{dev}, got {buf.dtype} {tuple(buf.shape)} on "
                         f"{buf.device}")
    if not 0 <= m < mi:
        raise ValueError(f"iteration {m} outside the buffer's {mi}")
    return dev


def convergence_step_plain(new: torch.Tensor, old: torch.Tensor, m: int,
                           buf: torch.Tensor,
                           thr: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: with ``thr`` given and the flag set, nothing
    (the flag is read on the host: free on the CPU); else (dh, dv) =
    ops.convergence.weighted_difference of disp_h and disp_v weighted by
    the new confidence into row m of the deltas, last = m, and with
    ``thr`` the flag set when ``!(max(dh, dv) >= thr)`` (torch.max carries
    a NaN).  Returns ``buf``."""
    _check(new, old, m, buf)
    if thr is not None and int(buf[0]) != 0:
        return buf
    step = torch.stack([weighted_difference(new[k], old[k], new[2])
                        for k in (0, 1)])
    deltas(buf)[m] = step
    buf[1] = m
    if thr is not None:
        buf[0] = ~(step.max() >= thr)
    return buf


def convergence_step(new: torch.Tensor, old: torch.Tensor, m: int,
                     buf: torch.Tensor,
                     thr: Optional[float] = None) -> torch.Tensor:
    """The convergence test of iteration m of a level: ``new`` and ``old``
    the (3, H, W) float32 states after and before it, ``buf`` the level's
    ``level_buffer``.  With ``thr`` (the float32-rounded threshold) it is
    early exit's: a launch after the flag is set does nothing, and one
    whose change is not >= thr sets it.  Without, it is the trace's: it
    writes the deltas of every iteration and never sets the flag.  A CUDA
    tensor runs the kernel with no host read; a CPU tensor runs the plain
    version.  Returns ``buf``."""
    dev = _check(new, old, m, buf)
    if dev.type == "cpu":
        return convergence_step_plain(new, old, m, buf, thr)
    base = ptr(buf)
    launch("ugsm_convergence", "convergence", ptr(new), ptr(old),
           new.shape[1] * new.shape[2], float(0.0 if thr is None else thr),
           int(thr is not None), int(m), base, base + 4 * HEADER,
           base + 4 * (HEADER + PARTIAL_WORDS), MAX_BLOCKS)
    return buf
