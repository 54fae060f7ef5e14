"""Image loading and saving: ``.npy`` directly, anything else through PIL.

PIL is imported at first use, so a machine without it (the card's has
none) runs every ``.npy`` path.
"""

from __future__ import annotations

import numpy as np

from ug_stereomatcher_tpu_torch.device import to_numpy


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError("PIL unavailable; use .npy files") from exc
    return Image


def load_image(path: str) -> np.ndarray:
    """Load an RGB image as (H, W, 3) uint8 (.npy files load verbatim)."""
    if path.endswith(".npy"):
        return np.load(path)
    with _pil_image().open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_image(path: str, image) -> None:
    """Save an (H, W, 3) uint8 or (H, W) image (NumPy or a tensor on any
    device)."""
    image = to_numpy(image)
    if path.endswith(".npy"):
        np.save(path, image)
        return
    _pil_image().fromarray(image).save(path)


def save_float_tiff(path: str, data) -> None:
    """Save a float32 single-plane TIFF, the viz nodes' dump format
    (UG_dispImgTest.cpp:106-108 writes _H.tif/_V.tif/_C.tif); ``.npy``
    paths save the float32 array."""
    data = np.asarray(to_numpy(data), dtype=np.float32)
    if path.endswith(".npy"):
        np.save(path, data)
        return
    _pil_image().fromarray(data, mode="F").save(path)
