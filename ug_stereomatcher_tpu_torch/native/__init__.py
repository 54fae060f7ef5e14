"""ctypes bindings for the native host runtime (native/ug_native.cpp).

The port's own loader of the repo's C++ source: PCD/PLY writers, PPM
read/write and a background file prefetcher.  The library is built with
g++ at first use into ``_build/`` (keyed on a hash of the source and the
flags); every entry point keeps a pure-NumPy fallback, as the JAX
package's bindings do.
"""

from ug_stereomatcher_tpu_torch.native.bindings import (
    FilePrefetcher,
    available,
    ensure_built,
    read_ppm,
    write_pcd,
    write_ply,
    write_ppm,
)

__all__ = [
    "available",
    "ensure_built",
    "write_pcd",
    "write_ply",
    "read_ppm",
    "write_ppm",
    "FilePrefetcher",
]
