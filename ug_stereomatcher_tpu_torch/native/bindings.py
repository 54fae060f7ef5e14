"""ctypes loader for the native host runtime, with NumPy fallbacks.

The library is compiled from the repo's ``native/ug_native.cpp`` with
``g++ -O3 -std=c++17 -fPIC -shared ... -lpthread`` into
``_build/native-<hash>/`` inside the package (git-ignored), the hash
taken over the source and the flags, like the kernel library
(ops/cuda/_build.py).  Where the source or a compiler is missing, or the
build fails, every entry point runs its NumPy version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "ug_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libug_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> Optional[Path]:
    """Where the library for this source and these flags lives (None
    without the source)."""
    if not SOURCE.is_file():
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def _build(out: Path) -> None:
    """Compile the library to ``out``; raise if that fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=120)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def _declare(lib: ctypes.CDLL) -> None:
    lib.ug_write_pcd.restype = ctypes.c_int
    lib.ug_write_pcd.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int64]
    lib.ug_write_ply.restype = ctypes.c_int
    lib.ug_write_ply.argtypes = lib.ug_write_pcd.argtypes
    lib.ug_ppm_probe.restype = ctypes.c_int
    lib.ug_ppm_probe.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.ug_ppm_read.restype = ctypes.c_int
    lib.ug_ppm_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                ctypes.c_int64]
    lib.ug_ppm_write.restype = ctypes.c_int
    lib.ug_ppm_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.ug_prefetcher_start.restype = ctypes.c_void_p
    lib.ug_prefetcher_start.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64]
    lib.ug_prefetcher_next_size.restype = ctypes.c_int64
    lib.ug_prefetcher_next_size.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ug_prefetcher_copy.restype = ctypes.c_int64
    lib.ug_prefetcher_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64]
    lib.ug_prefetcher_stop.restype = None
    lib.ug_prefetcher_stop.argtypes = [ctypes.c_void_p]


def ensure_built() -> bool:
    """Build (if needed) and load the native library.  Returns success;
    a failed build is not retried in this process."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return True
        if _build_failed:
            return False
        path = library_path()
        try:
            if path is None:
                raise RuntimeError(f"no native source at {SOURCE}")
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _build_failed = True
            return False
        _declare(lib)
        _lib = lib
        return True


def available() -> bool:
    return ensure_built()


def _prep_cloud(xyz: np.ndarray, rgb: np.ndarray):
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
        raise ValueError(f"expected xyz and rgb of shape (N, 3), got "
                         f"{xyz.shape} and {rgb.shape}")
    return xyz, rgb


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary PCD writer (native fast path, NumPy fallback); the bytes of
    ``geom.save_pcd``."""
    xyz, rgb = _prep_cloud(xyz, rgb)
    if ensure_built() and _lib.ug_write_pcd(
            path.encode(), xyz.ctypes.data, rgb.ctypes.data,
            xyz.shape[0]) == 0:
        return
    from ug_stereomatcher_tpu_torch.geom.pointcloud import (
        PointCloud,
        save_pcd,
    )
    save_pcd(path, PointCloud(xyz=xyz, rgb=rgb))


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY writer; the bytes of ``geom.save_ply``."""
    xyz, rgb = _prep_cloud(xyz, rgb)
    if ensure_built() and _lib.ug_write_ply(
            path.encode(), xyz.ctypes.data, rgb.ctypes.data,
            xyz.shape[0]) == 0:
        return
    from ug_stereomatcher_tpu_torch.geom.pointcloud import (
        PointCloud,
        save_ply,
    )
    save_ply(path, PointCloud(xyz=xyz, rgb=rgb))


def _read_ppm_numpy(path: str) -> np.ndarray:
    """A small pure-Python P6 parser."""
    with open(path, "rb") as fh:
        magic = fh.readline().split()
        if not magic or magic[0] != b"P6":
            raise ValueError(f"{path}: not a binary P6 PPM file")

        def tokens(line: bytes) -> List[int]:
            # a '#' starts a comment running to end of line; it may share
            # the line with dimension tokens ("640 480 # scanner output")
            return [int(v) for v in line.split(b"#", 1)[0].split()]

        vals: List[int] = tokens(b" ".join(magic[1:]))
        while len(vals) < 3:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: truncated PPM header")
            vals += tokens(line)
        w, h, maxv = vals[0], vals[1], vals[2]
        if maxv != 255:
            raise ValueError(f"{path}: only maxval 255 PPMs supported")
        data = fh.read(w * h * 3)
    return np.frombuffer(data, dtype=np.uint8).reshape(h, w, 3)


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM as (H, W, 3) uint8."""
    if ensure_built():
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        if _lib.ug_ppm_probe(path.encode(), ctypes.byref(w),
                             ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 3), dtype=np.uint8)
            if _lib.ug_ppm_read(path.encode(), out.ctypes.data,
                                out.nbytes) == 0:
                return out
    return _read_ppm_numpy(path)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as a binary P6 PPM."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        # the native writer writes w*h*3 bytes straight from this buffer:
        # anything but (H, W, 3) would over-read or scramble channels
        raise ValueError(
            f"write_ppm needs an (H, W, 3) uint8 image, got {image.shape}")
    h, w = image.shape[:2]
    if ensure_built() and _lib.ug_ppm_write(path.encode(), image.ctypes.data,
                                            w, h) == 0:
        return
    with open(path, "wb") as fh:
        fh.write(b"P6\n%d %d\n255\n" % (w, h))
        fh.write(image.tobytes())


class FilePrefetcher:
    """Background raw-file prefetcher: the native ring buffer, or a Python
    thread where the library is unavailable.  Yields ``(index, bytes)``
    in order; an unreadable file yields empty bytes."""

    _native = False
    _handle = None

    def __init__(self, paths: List[str], capacity: int = 2):
        self.paths = list(paths)
        self._native = ensure_built()
        if self._native:
            self._arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])  # kept alive with self
            self._handle = _lib.ug_prefetcher_start(
                self._arr, len(self.paths), capacity)
        else:
            self._q: queue.Queue = queue.Queue(maxsize=capacity)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        for i, p in enumerate(self.paths):
            try:
                with open(p, "rb") as fh:
                    self._q.put((i, fh.read()))
            except OSError:
                self._q.put((i, b""))
        self._q.put(None)

    def __iter__(self):
        if not self._native:
            while True:
                item = self._q.get()
                if item is None:
                    return
                yield item
        while self._handle:
            idx = ctypes.c_int64()
            size = _lib.ug_prefetcher_next_size(self._handle,
                                                ctypes.byref(idx))
            if size < 0:
                return
            buf = np.empty(size, dtype=np.uint8)
            if _lib.ug_prefetcher_copy(self._handle, buf.ctypes.data,
                                       size) < 0:
                return
            yield int(idx.value), buf.tobytes()

    def close(self) -> None:
        if self._native and self._handle:
            _lib.ug_prefetcher_stop(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()
