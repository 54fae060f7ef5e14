"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``sm_90a``) under ``csrc/``, compiled
by ``nvcc`` (one process per source, started together) and linked into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  The build runs at first
use, is keyed on a hash of the sources and the flags, and lands in
``_build/`` inside the package, which git ignores.

``--fmad=false`` keeps every multiply and add separately rounded, in the
order the source writes them: that is what makes the stencils bit-exact
against their plain PyTorch versions.  Never add ``--use_fast_math``.

Each wrapper adds one to its launch counter where it launches its kernel
(one count per wrapper call, however many CUDA kernels the call runs).
The nearest and bilinear forms of warp and resample count under their own
names (``warp`` / ``warp_bilinear``, ``resample`` / ``resample_bilinear``),
and so do the row-sharded forms of warp, direction and smooth
(``warp_row_halo``, ``warp_bilinear_row_halo``, ``direction_row_halo``,
``smooth_row_halo``).  The early-exit convergence test counts under
``convergence``; a guarded warp, direction or smooth (``stop`` given)
counts under its usual name, whether or not the flag lets it run.  A
CUDA graph (``graphs.CapturedCall``) counts its warm-up and capture into
counters of its own (``counting_into``) and adds the capture's counts
on each replay (``record_replay``), so the counts after a replay are
those of the eager call; ``graph_replays`` counts the replays and
``graph_captures`` the captures.  ``upload_bytes`` counts the host bytes
the engine's uploads moved to a card, by route (staging.py).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libugsm_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)     # host int out-parameter
_PF = ctypes.POINTER(ctypes.c_float)   # host float array
# C entry points: argument types (every device pointer and the stream is
# a c_void_p, so ctypes never truncates them to 32 bits) and int return.
SIGNATURES = {
    "ugsm_sep5": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    "ugsm_resample_nearest": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                              _P],
    "ugsm_resample_bilinear": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _F, _I, _I, _I, _I, _P],
    # the _P before the stream: the early-exit flag (null: unguarded)
    "ugsm_warp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "ugsm_direction_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              _I, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "ugsm_smooth_average": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _P, _P],
    # (new, old, H * W, threshold, may_exit, m, flags, partials, deltas,
    #  max_blocks)
    "ugsm_convergence": [_P, _P, _I, _F, _I, _I, _P, _P, _P, _I, _P],
    "ugsm_level_resident": [_P, _P, _P, _P, _P, _P, _PF, _I, _I, _I, _I,
                            _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I,
                            _I, _P],
}
# Host queries (no stream, no launch).
QUERIES = {
    # (bilinear, n_smooth, out: max n_smooth, out: max grid for n_smooth)
    "ugsm_level_limits": [_I, _I, _PI, _PI],
    # the smoothing passes one launch of the smooth kernel runs
    "ugsm_smooth_max_chunk": [],
}

LAUNCHES: Dict[str, int] = collections.Counter()
_REPLAYS = [0]
_CAPTURES = [0]
# host bytes uploaded to a card, by route: "staged" or "pinned"
_UPLOADS: Dict[str, int] = collections.Counter()
_UPLOADS_LOCK = threading.Lock()
# this thread's counter while it warms up or captures a CUDA graph
_LOCAL = threading.local()
_LIB: Optional[ctypes.CDLL] = None
_ENTRIES: Dict[str, Callable[..., int]] = {}


def sources() -> List[Path]:
    """Every kernel source, sorted: ``csrc/*.cu`` and ``csrc/*.cuh``."""
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def find_nvcc() -> Optional[str]:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else None."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def build_command(nvcc: str, out: Path) -> List[List[str]]:
    """The nvcc command lines that build the library at ``out``: one
    compile per ``.cu`` source (run together), then the link."""
    objs, cmds = [], []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = out.with_name(f"{out.name}.{src.stem}.o")
        cmds.append([nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", str(src),
                     "-o", str(obj)])
        objs.append(str(obj))
    cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *objs])
    return cmds


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands together; raise with the compiler's output if any
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for c, p in zip(cmds, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}\n-> {p.returncode}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless a build of these sources exists."""
    out = BUILD_DIR / _source_hash() / LIB_NAME
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
            "port's kernels")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmds = build_command(nvcc, tmp)
    _run_all(cmds[:-1])   # one nvcc per source, all at once
    _run_all(cmds[-1:])   # link
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in {**SIGNATURES, **QUERIES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ugsm_error_string.argtypes = [ctypes.c_int]
        lib.ugsm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(name: str, err: int) -> None:
    """Raise RuntimeError for a nonzero CUDA error code of C entry ``name``."""
    if err != 0:
        msg = library().ugsm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def launch(name: str, counter: str, *args) -> None:
    """Call C entry ``name`` on PyTorch's current stream, raise on a CUDA
    error, and count one launch under ``counter``.  The stream's handle is
    read without building a ``torch.cuda.Stream`` (the raw query that
    ``torch.cuda.current_stream`` itself wraps; device -1 is the current
    one), and each entry is looked up once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(library(), name)
    stream = torch._C._cuda_getCurrentRawStream(-1)
    check(name, fn(*args, stream))
    counts = getattr(_LOCAL, "counts", None)
    (LAUNCHES if counts is None else counts)[counter] += 1


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]):
    """Count this thread's launches into ``counts`` (a Counter) instead of
    the process's counters while the block runs."""
    prev = getattr(_LOCAL, "counts", None)
    _LOCAL.counts = counts
    try:
        yield counts
    finally:
        _LOCAL.counts = prev


def record_replay(counts: Dict[str, int]) -> None:
    """Add the launches of one replayed CUDA graph (those its capture
    counted) to the counters, and count the replay."""
    LAUNCHES.update(counts)
    _REPLAYS[0] += 1


def record_capture() -> None:
    """Count one CUDA graph captured."""
    _CAPTURES[0] += 1


def record_upload(route: str, nbytes: int) -> None:
    """Count ``nbytes`` of host memory uploaded to a card by ``route``."""
    with _UPLOADS_LOCK:
        _UPLOADS[route] += nbytes


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    _REPLAYS[0] = 0
    _CAPTURES[0] = 0
    with _UPLOADS_LOCK:
        _UPLOADS.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def graph_replays() -> int:
    """CUDA graph replays since the last ``reset_launch_counts()``."""
    return _REPLAYS[0]


def graph_captures() -> int:
    """CUDA graphs captured since the last ``reset_launch_counts()``: a
    key's first call captures, so in a steady loop this stays 0."""
    return _CAPTURES[0]


def upload_bytes() -> Dict[str, int]:
    """Host bytes uploaded to a card since the last
    ``reset_launch_counts()``, by route: ``staged`` through an engine's
    pinned ring, ``pinned`` copied straight from a caller's pinned
    tensor.  Tensors already on a card, and the CPU engine, count none."""
    with _UPLOADS_LOCK:
        return {"staged": _UPLOADS["staged"], "pinned": _UPLOADS["pinned"]}


def check_planes(name: str, *tensors: torch.Tensor) -> torch.device:
    """Common wrapper checks: one device, float32, contiguous.  Returns the
    device; raises for a device type that has neither plain nor kernel."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        # the kernel launches on the current device
        raise ValueError(f"{name}: tensors on {dev} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return dev


def ptr(t: torch.Tensor) -> int:
    """The device address of ``t`` (a c_void_p argument takes the int)."""
    return t.data_ptr()


def check_out(name: str, out: Optional[torch.Tensor], shape,
              like: torch.Tensor) -> torch.Tensor:
    """``out`` checked to be a contiguous float32 tensor of ``shape`` on
    ``like``'s device, or a new empty one where it is None."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.float32
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {like.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def stop_ptr(name: str, stop: Optional[torch.Tensor],
             dev: torch.device) -> Optional[int]:
    """The device address of an early-exit flag (one int32 on ``dev``;
    a kernel given one returns before any load or store while it is not
    0), or None for an unguarded launch."""
    if stop is None:
        return None
    if stop.numel() != 1 or stop.dtype != torch.int32 or stop.device != dev:
        raise ValueError(f"{name}: stop must be one int32 on {dev}, got "
                         f"{stop.dtype} {tuple(stop.shape)} on {stop.device}")
    return stop.data_ptr()


def guarded_plain(stop: Optional[torch.Tensor], out: Optional[torch.Tensor],
                  shape, like: torch.Tensor,
                  compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The guard of a plain version: with the flag ``stop`` set nothing is
    computed or written (the result is ``out`` as it was, or a new empty
    tensor); else ``compute()``, written into ``out`` where one is given.
    The flag is read on the host: free on the CPU, a sync on the card."""
    if stop is not None:
        stop_ptr("plain", stop, like.device)   # the kernel's checks
        if int(stop.reshape(())) != 0:
            return check_out("plain", out, shape, like)
    res = compute()
    if out is None:
        return res
    return check_out("plain", out, shape, like).copy_(res)
