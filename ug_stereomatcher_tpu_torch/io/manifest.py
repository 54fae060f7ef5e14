"""Stereo image-list manifests.

Replaces the reference's OpenCV FileStorage image list
(src/utils/input_images.xml read by settings.h:47-66): a flat list of paths
ordered left1, right1, left2, right2, ...  Supports the reference XML schema
plus plain text (one path per line) and JSON/YAML lists.  Reproduces the
reference's wrap-to-last-pair behaviour (settings.h:33-38).  The port's
own copy of ``ug_stereomatcher_tpu/io/manifest.py``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import xml.etree.ElementTree as ET
from typing import List, Tuple


@dataclasses.dataclass
class ImageList:
    """Iterator over stereo pairs with reference wrap semantics."""
    paths: List[str]
    at: int = 0

    def __post_init__(self) -> None:
        # the list is left1,right1,left2,right2,...; an odd-length list
        # would silently pair a left image with the WRONG frame's right
        # after the wrap (and pairs() would drop the dangling path)
        if len(self.paths) % 2:
            raise ValueError(
                f"image list has {len(self.paths)} entries — stereo "
                f"manifests must hold whole left/right pairs")

    def skip_pair(self) -> None:
        """Advance past one pair without touching the images (used by
        checkpoint resume to skip completed work cheaply)."""
        self.next_pair()

    def next_image(self) -> str:
        """settings.h:30-45 nextImage: past the end, restart at the
        next-to-last entry (so the final pair repeats forever)."""
        if self.at >= len(self.paths):
            self.at = max(0, len(self.paths) - 2)
        path = self.paths[self.at]
        self.at += 1
        return path

    def next_pair(self) -> Tuple[str, str]:
        return self.next_image(), self.next_image()

    def pairs(self) -> List[Tuple[str, str]]:
        it = iter(self.paths)
        return list(zip(it, it))

    def __len__(self) -> int:
        return len(self.paths)


def load_image_list(path: str) -> ImageList:
    """Load an image-list manifest (.xml OpenCV schema, .json, .yaml, .txt)."""
    if path.endswith(".xml"):
        tree = ET.parse(path)
        root = tree.getroot()
        node = root.find("images")
        if node is None or node.text is None:
            raise ValueError(f"no <images> list in {path}")
        paths = [p for p in re.split(r"\s+", node.text.strip()) if p]
        return ImageList(paths)
    if path.endswith(".json"):
        with open(path) as fh:
            return ImageList(list(json.load(fh)))
    if path.endswith((".yaml", ".yml")):
        import yaml
        with open(path) as fh:
            return ImageList(list(yaml.safe_load(fh)))
    with open(path) as fh:
        return ImageList([ln.strip() for ln in fh if ln.strip()])
