"""Result dumps, the viz/save node analogs.

Replaces UG_dispImgTest.cpp / UG_FdispImgTest.cpp, which sync-subscribe
the H/V/C outputs and write ``<prefix>_H.tif`` etc.  Each plane comes to
the host through ``device.to_numpy`` (``np.asarray`` of a CUDA tensor
raises).
"""

from __future__ import annotations

import os

from ug_stereomatcher_tpu_torch.io.image import save_float_tiff


def _dump(planes, out_dir: str, prefix: str, ext: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for tag, plane in planes:
        p = os.path.join(out_dir, f"{prefix}_{tag}{ext}")
        save_float_tiff(p, plane)
        paths[tag] = p
    return paths


def save_disparity_maps(result, out_dir: str, prefix: str = "disparity",
                        ext: str = ".tif") -> dict:
    """Dump a MatchResult's H/V/C planes (UG_dispImgTest.cpp:106-108)."""
    return _dump((("H", result.disparity_h), ("V", result.disparity_v),
                  ("C", result.confidence)), out_dir, prefix, ext)


def save_foveated_stack(stack, out_dir: str, prefix: str = "fdisparity",
                        ext: str = ".tif") -> dict:
    """Dump a FoveatedStackResult's stacks (UG_FdispImgTest.cpp:107-109
    writes _FH/_FV/_FC)."""
    return _dump((("FH", stack.stack_h), ("FV", stack.stack_v),
                  ("FC", stack.stack_c)), out_dir, prefix, ext)
