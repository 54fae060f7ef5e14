"""How fast one 16 MP RGB image crosses to the card from each of three
placements of host memory, in this process.

    python3 -m stereo_bench.upload_probe [--copies 20]

Prints one JSON line: the machine's transparent-huge-page settings and,
for each placement, the median, least and largest milliseconds of
``torch.from_numpy(a).to("cuda")`` over ``--copies`` copies of a
3264 x 4928 x 3 uint8 image, the engine's own upload, each copy timed
on the host clock to its synchronisation.  The pageable copy's speed
differs between processes and between buffers of one process; run it
in several processes to see its spread.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import mmap
import statistics
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np

SHAPE = (3264, 4928, 3)
PLACEMENTS = ("torch", "huge_pages", "small_pages")
_HUGE = 2 ** 21


def host_array(shape: Tuple[int, ...], placement: str) -> np.ndarray:
    """An uninitialised host uint8 array of ``shape``.  ``torch``: from
    torch's CPU allocator, as ``.cpu()`` makes the harness's pool.
    ``huge_pages`` / ``small_pages``: its own anonymous mapping, aligned
    to 2 MiB and advised (``MADV_HUGEPAGE`` / ``MADV_NOHUGEPAGE``) before
    its first touch."""
    import torch

    if placement == "torch":
        return torch.empty(shape, dtype=torch.uint8).numpy()
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} is none of "
                         f"{PLACEMENTS}")
    n = int(np.prod(shape))
    buf = mmap.mmap(-1, n + _HUGE)
    buf.madvise(mmap.MADV_HUGEPAGE if placement == "huge_pages"
                else mmap.MADV_NOHUGEPAGE)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    return np.frombuffer(buf, dtype=np.uint8, count=n,
                         offset=(-addr) % _HUGE).reshape(shape)


def _thp() -> dict:
    out = {}
    for name in ("enabled", "defrag"):
        p = Path("/sys/kernel/mm/transparent_hugepage") / name
        out[name] = p.read_text().strip() if p.exists() else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stereo_bench.upload_probe")
    ap.add_argument("--copies", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    res = {"thp": _thp(), "ms": {}}
    for placement in PLACEMENTS:
        arr = host_array(SHAPE, placement)
        arr[...] = data
        torch.from_numpy(arr).to("cuda")
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.copies):
            t = time.perf_counter()
            torch.from_numpy(arr).to("cuda")
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        res["ms"][placement] = {"median": statistics.median(ms),
                                "least": min(ms), "largest": max(ms)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
