"""IO: images, manifests, result dumps.

Counterpart of ``ug_stereomatcher_tpu/io``: the reference's OpenCV/file
plumbing (settings.h's image-list reader, the publish_images inputs, the
viz nodes' TIFF dumps), the port's own copy.  Every plane goes to the
host through ``device.to_numpy``, so results on the card dump as they
do on the CPU.
"""

from ug_stereomatcher_tpu_torch.io.image import (
    load_image,
    save_float_tiff,
    save_image,
)
from ug_stereomatcher_tpu_torch.io.manifest import ImageList, load_image_list
from ug_stereomatcher_tpu_torch.io.dumps import (
    save_disparity_maps,
    save_foveated_stack,
)

__all__ = [
    "load_image",
    "save_image",
    "save_float_tiff",
    "ImageList",
    "load_image_list",
    "save_disparity_maps",
    "save_foveated_stack",
]
