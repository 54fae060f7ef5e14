"""Stereo pairs made from a seed, on the device, by one general generator.

The texture is the port's octave texture (ug_stereomatcher_tpu_torch/
scene.py ``octave_texture``: nearest-upscaled random octaves of size 4,
8, ... with amplitude 0.85 an octave, so every pyramid level finds
structure), rewritten in torch so that it is drawn on the card from a
``torch.Generator``.  The right image is the left warped by a smooth
two-axis disparity field: ``left(x, y) = right(x + dh, y + dv)``, the
matcher's convention.  The horizontal field is a slant plus sinusoids,
the vertical one (a verged rig's) a slant plus one sinusoid; each is
stretched to the range the traffic file gives at ``at_width`` columns
and scaled with the frame's width, so every seed has the same range and
only the field's shape changes with the seed.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**63)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def octave_texture(h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """(3, h, w) float32 in [0, 255] on the generator's device."""
    dev = gen.device
    out = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    amp, size = 1.0, 4
    while size <= max(h, w):
        bh, bw = min(size, h), min(size, w)
        base = torch.rand((3, bh, bw), generator=gen, device=dev)
        yi = torch.arange(h, device=dev) * bh // h
        xi = torch.arange(w, device=dev) * bw // w
        out += amp * base.index_select(1, yi).index_select(2, xi)
        size *= 2
        amp *= 0.85
    out -= out.min()
    return out * (255.0 / out.max())


def _field(h: int, w: int, params: torch.Tensor, waves: int, lo: float,
           hi: float, cycles: Tuple[float, float]) -> torch.Tensor:
    """(h, w) float32: a slant plus ``waves`` sinusoids of ``cycles``
    periods a frame, stretched to [lo, hi].  ``params`` holds 2 + 4 *
    waves uniforms in [0, 1)."""
    dev = params.device
    p = params.tolist()
    y = (torch.arange(h, dtype=torch.float32, device=dev) / h)[:, None]
    x = (torch.arange(w, dtype=torch.float32, device=dev) / w)[None, :]
    f = (2 * p[0] - 1) * x + (2 * p[1] - 1) * y
    c0, c1 = cycles
    for k in range(waves):
        a, fx, fy, ph = p[2 + 4 * k:6 + 4 * k]
        fx, fy = c0 + (c1 - c0) * fx, c0 + (c1 - c0) * fy
        f = f + (0.5 + a) * torch.sin(2 * math.pi * (fx * x + fy * y + ph))
    f = (f - f.min()) / (f.max() - f.min())
    return lo + (hi - lo) * f


def make_pair(h: int, w: int, gen: torch.Generator,
              disparity: Mapping[str, object]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right), each (h, w, 3) uint8 on the generator's device."""
    dev = gen.device
    s = w / float(disparity["at_width"])
    dh_lo, dh_hi = (s * v for v in disparity["h_px"])
    dv_lo, dv_hi = (s * v for v in disparity["v_px"])
    cycles = tuple(disparity["cycles"])
    waves = int(disparity["h_waves"])
    tex = octave_texture(h, w, gen)
    params = torch.rand(2 + 4 * waves + 6, generator=gen, device=dev)
    dh = _field(h, w, params[:2 + 4 * waves], waves, dh_lo, dh_hi, cycles)
    dv = _field(h, w, params[2 + 4 * waves:], 1, dv_lo, dv_hi, cycles)
    # right(u, v) = tex(u - dh, v - dv), bilinear, border clamped
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    grid = torch.stack([(xs - dh) * (2.0 / w) - 1.0,
                        (ys - dv) * (2.0 / h) - 1.0], dim=-1)
    right = F.grid_sample(tex[None], grid[None], mode="bilinear",
                          padding_mode="border", align_corners=False)[0]

    def u8(img: torch.Tensor) -> torch.Tensor:
        return img.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)

    return u8(tex).contiguous(), u8(right).contiguous()


def make_pool(n: int, pairs: int, frame: Tuple[int, int], seed: int,
              disparity: Mapping[str, object], device, inputs: str = "host"
              ) -> List[Tuple[object, object]]:
    """``n`` distinct pool entries, each a left and a right uint8 image:
    (H, W, 3), or (pairs, H, W, 3) where ``pairs`` > 1 (a batch of
    distinct pairs).  Drawn on ``device``, one pair at a time, in a fixed
    order; with ``inputs`` "host" then copied to host numpy arrays once,
    with "device" kept on ``device`` as tensors."""
    if inputs not in ("host", "device"):
        raise ValueError(f"inputs {inputs!r} is neither 'host' nor 'device'")
    gen = generator(seed, device)
    h, w = frame
    pool = []
    for _ in range(n):
        made = [make_pair(h, w, gen, disparity) for _ in range(pairs)]
        entry = []
        for side in (0, 1):
            img = torch.stack([m[side] for m in made])
            if inputs == "host":
                img = img.cpu().numpy()
            entry.append(img[0] if pairs == 1 else img)
        pool.append(tuple(entry))
    return pool
