"""Accuracy evaluation harness: end-point-error metrics + synthetic scenes.

The reference is evaluated on the Glasgow 80-pair stereo database
(README.md:32-36) by visual inspection; this module adds the quantitative
harness the reference lacks:

* ``epe_metrics`` — sub-pixel end-point error statistics between a
  disparity result and ground truth (or a second engine's result);
* ``synthetic_scene`` — procedurally generated stereo pairs with exact
  dense two-axis ground truth (textured fronto-parallel planes, slanted
  planes, and sinusoidal warps), standing in for the external database in
  an offline environment;
* ``evaluate_engine`` — run an engine over a scene suite and report EPE.

Use with the real Glasgow database by pointing ``evaluate_pairs`` at a
manifest; ground-truth-free A/B comparison between two configurations
(e.g. nearest vs bilinear, card vs CPU) uses one engine's output as the
reference field.

The port's copy of ``ug_stereomatcher_tpu/eval.py``: the scene
generators are the same NumPy code with the same seeds, so both packages
make the same arrays bit for bit; results may be tensors on any device
and come to the host through ``device.to_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ug_stereomatcher_tpu_torch.device import to_numpy


@dataclasses.dataclass
class EpeReport:
    """End-point-error statistics over the evaluated region."""
    mean_epe: float
    median_epe: float
    rms_epe: float
    bad_0_5: float     # fraction with EPE > 0.5 px
    bad_1_0: float
    bad_3_0: float
    mean_abs_h: float
    mean_abs_v: float
    pixels: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def epe_metrics(disp_h, disp_v, gt_h, gt_v, margin: int = 12,
                mask=None) -> EpeReport:
    """Sub-pixel end-point error of a two-axis disparity field.

    margin crops image borders (the reference algorithm's boundary drift
    region); mask optionally selects evaluated pixels."""
    dh, dv, gh, gv = (np.asarray(to_numpy(a), dtype=np.float64)
                      for a in (disp_h, disp_v, gt_h, gt_v))
    sl = (slice(margin, -margin or None), slice(margin, -margin or None))
    eh = dh[sl] - gh[sl]
    ev = dv[sl] - gv[sl]
    if mask is not None:
        m = to_numpy(mask)[sl].astype(bool)
        eh, ev = eh[m], ev[m]
    epe = np.sqrt(eh ** 2 + ev ** 2)
    if epe.size == 0:
        # NaN stats make automated gates direction-dependent (nan < x is
        # always False) — fail loudly instead
        raise ValueError(
            "epe_metrics: no pixels to evaluate (margin crop and/or mask "
            "selected an empty region)")
    return EpeReport(
        mean_epe=float(epe.mean()),
        median_epe=float(np.median(epe)),
        rms_epe=float(np.sqrt((epe ** 2).mean())),
        bad_0_5=float((epe > 0.5).mean()),
        bad_1_0=float((epe > 1.0).mean()),
        bad_3_0=float((epe > 3.0).mean()),
        mean_abs_h=float(np.abs(eh).mean()),
        mean_abs_v=float(np.abs(ev).mean()),
        pixels=int(epe.size),
    )


# ----------------------------------------------------------------------
# Synthetic scenes with dense exact ground truth
# ----------------------------------------------------------------------

def _textured_base(h: int, w: int, rng: np.random.RandomState,
                   smooth: int = 3) -> np.ndarray:
    tex = rng.rand(h, w, 3).astype(np.float32) * 255
    for _ in range(smooth):
        tex[1:-1] = (tex[:-2] + tex[1:-1] + tex[2:]) / 3
        tex[:, 1:-1] = (tex[:, :-2] + tex[:, 1:-1] + tex[:, 2:]) / 3
    return tex


def synthetic_scene(kind: str, height: int, width: int,
                    seed: int = 0, magnitude: float = 4.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Generate (left, right, gt_h, gt_v) with EXACT dense ground truth:
    right(x + d(x)) == left(x) for the returned d at every left pixel.

    kinds: 'constant' (fronto-parallel plane), 'slant' (disparity ramp),
    'sine' (smooth two-axis warp), 'vertical' (pure vertical shift),
    'step' (fronto-parallel depth discontinuity: d jumps from
    magnitude/4 to magnitude at mid-width — the hardest case for a
    smoothing-regularised matcher; the correspondence construction below
    keeps the ground truth exact even across the jump, so epe_metrics
    scores it directly and callers can mask the +-few-px band around the
    discontinuity where the plus-shaped smoothing necessarily blurs)."""
    rng = np.random.RandomState(seed)
    pad = int(np.ceil(abs(magnitude))) + 4
    base = _textured_base(height + 2 * pad, width + 2 * pad, rng)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)

    if kind == "constant":
        gt_h = np.full((height, width), magnitude, np.float32)
        gt_v = np.zeros((height, width), np.float32)
    elif kind == "vertical":
        gt_h = np.zeros((height, width), np.float32)
        gt_v = np.full((height, width), magnitude / 2, np.float32)
    elif kind == "slant":
        gt_h = (magnitude * xs / max(1, width - 1)).astype(np.float32)
        gt_v = np.zeros((height, width), np.float32)
    elif kind == "sine":
        gt_h = (magnitude / 2 * (1 + np.sin(2 * np.pi * xs / width))
                ).astype(np.float32)
        gt_v = (magnitude / 4 * np.sin(2 * np.pi * ys / height)
                ).astype(np.float32)
    elif kind == "step":
        gt_h = np.where(xs < width // 2, magnitude / 4, magnitude
                        ).astype(np.float32)
        gt_v = np.zeros((height, width), np.float32)
    else:
        raise ValueError(f"unknown scene kind {kind!r}")

    # EXACT ground truth: build LEFT by warping the base at (x + d(x)),
    # keep RIGHT as a plain crop — then right(x + d(x)) == left(x) holds
    # with d evaluated at the left pixel, which is precisely what
    # epe_metrics scores.  (The previous construction sampled d at the
    # destination pixel, biasing the "exact" gt by O(d * grad d): up to
    # 0.13 px on the sine scene — at the scale the harness measures.)
    right = base[pad:pad + height, pad:pad + width]
    sx = xs + pad + gt_h
    sy = ys + pad + gt_v
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    ax = (sx - x0)[..., None]
    ay = (sy - y0)[..., None]
    b = base
    left = ((1 - ax) * (1 - ay) * b[y0, x0]
            + ax * (1 - ay) * b[y0, x0 + 1]
            + (1 - ax) * ay * b[y0 + 1, x0]
            + ax * ay * b[y0 + 1, x0 + 1])
    return (left.astype(np.uint8), right.astype(np.uint8),
            gt_h, gt_v)


DEFAULT_SUITE = (
    ("constant", 3.0), ("vertical", 2.0), ("slant", 4.0), ("sine", 4.0),
    ("step", 4.0),
)


# ----------------------------------------------------------------------
# Real-scene stressor families: occlusion + photometric asymmetry.  The
# reference's evaluation domain is cluttered real scenes (the Glasgow
# clothing database, the reference's README.md:37-40) — occluded
# regions where one eye sees background the other cannot, and eyes that
# never photometrically agree.  The clean invertible warps above never
# exercise either; these two families do, with exact ground truth and an
# exact occlusion mask.
# ----------------------------------------------------------------------

def occlusion_scene(height: int, width: int, seed: int = 0,
                    fg_disp: int = 8, bg_disp: int = 0,
                    strip: Tuple[float, float] = (0.35, 0.55)
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
    """Two-layer scene: a foreground vertical strip at integer disparity
    ``fg_disp`` over a background at ``bg_disp``.  Returns
    ``(left, right, gt_h, gt_v, occluded)`` where ``occluded`` marks the
    LEFT-image background pixels whose correspondent in the right image
    is covered by the foreground — the classic occlusion band of width
    ``fg_disp - bg_disp`` px at the strip's right edge, where no correct
    match exists (MatchLib.cu:790-878's confidence model should go low
    there; nothing can go *right*).

    Correspondence contract for NON-occluded pixels, exact (integer
    disparities, no resampling): ``right[:, x + d(x)] == left[:, x]``.
    Foreground occupies left columns [x0, x1) and right columns
    [x0+fg_disp, x1+fg_disp)."""
    if fg_disp <= bg_disp:
        raise ValueError("occlusion needs fg_disp > bg_disp")
    rng = np.random.RandomState(seed)
    pad = int(abs(fg_disp) + abs(bg_disp)) + 4
    bg = _textured_base(height, width + 2 * pad, rng)
    fg = _textured_base(height, width + 2 * pad, rng)
    x0 = int(strip[0] * width)
    x1 = int(strip[1] * width)
    xs = np.arange(width)

    in_fg_left = (xs >= x0) & (xs < x1)
    left = np.where(in_fg_left[None, :, None], fg[:, pad:pad + width],
                    bg[:, pad:pad + width])
    gt_h = np.where(in_fg_left, float(fg_disp), float(bg_disp)
                    ).astype(np.float32)
    gt_h = np.broadcast_to(gt_h, (height, width)).copy()
    gt_v = np.zeros((height, width), np.float32)

    in_fg_right = (xs >= x0 + fg_disp) & (xs < x1 + fg_disp)
    right = np.where(in_fg_right[None, :, None],
                     fg[:, pad - fg_disp:pad - fg_disp + width],
                     bg[:, pad - bg_disp:pad - bg_disp + width])

    # left bg pixel x maps to right column x + bg_disp; occluded when the
    # foreground covers that column in the right image
    target = xs + bg_disp
    occluded = (~in_fg_left) & (target >= x0 + fg_disp) & (
        target < x1 + fg_disp)
    occluded = np.broadcast_to(occluded, (height, width)).copy()
    return (left.astype(np.uint8), right.astype(np.uint8),
            gt_h, gt_v, occluded)


def photometric_scene(height: int, width: int, seed: int = 0,
                      magnitude: float = 4.0, kind: str = "sine",
                      gain: float = 1.15, bias: float = 8.0,
                      noise_sigma: float = 3.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """A clean exact-ground-truth scene whose RIGHT eye is photometrically
    perturbed: per-image gain/bias (exposure/vignetting mismatch between
    cameras) plus iid Gaussian sensor noise.  Ground truth is the clean
    scene's — the correspondence is unchanged, only the photometry lies.
    The NCC^2-ratio correlation is gain-invariant in the limit (both
    numerator and denominator scale with the local energy), so the
    matcher should degrade gracefully, not collapse."""
    left, right, gt_h, gt_v = synthetic_scene(kind, height, width,
                                              seed=seed,
                                              magnitude=magnitude)
    rng = np.random.RandomState(seed + 1)
    noisy = (right.astype(np.float32) * gain + bias
             + rng.randn(*right.shape).astype(np.float32) * noise_sigma)
    return (left, np.clip(noisy, 0, 255).astype(np.uint8), gt_h, gt_v)


@dataclasses.dataclass
class StressReport:
    """Occlusion-family result: accuracy away from the occlusion plus the
    confidence model's discriminative value on it."""
    matched_epe: EpeReport        # EPE on never-occluded pixels
    mean_conf_matched: float      # confidence where a true match exists
    mean_conf_occluded: float     # confidence where no match exists
    occluded_pixels: int

    def as_dict(self) -> Dict[str, object]:
        return {"matched_epe": self.matched_epe.as_dict(),
                "mean_conf_matched": self.mean_conf_matched,
                "mean_conf_occluded": self.mean_conf_occluded,
                "occluded_pixels": self.occluded_pixels}


def evaluate_occlusion(engine, height: int = 192, width: int = 256,
                       seed: int = 0, fg_disp: int = 8, bg_disp: int = 0,
                       margin: int = 16, guard: int = 4) -> StressReport:
    """Run the occlusion family: EPE masked to never-occluded pixels
    (``guard`` px dilation around the occlusion band and the disparity
    step excluded — the plus-smoothing necessarily blurs both), plus
    mean confidence on occluded vs matched pixels.  The confidence gate
    is the first test anywhere of the model's discriminative value: the
    reference computes it (MatchLib.cu:884-933) but never evaluates
    it."""
    left, right, gt_h, gt_v, occ = occlusion_scene(
        height, width, seed=seed, fg_disp=fg_disp, bg_disp=bg_disp)
    res = engine.match(left, right)
    conf = to_numpy(res.confidence)

    # dilate the exclusion zone: occlusion band + fg disparity edges
    bad = _dilate(occ | _disparity_edges(gt_h), guard)

    matched = epe_metrics(res.disparity_h, res.disparity_v, gt_h, gt_v,
                          margin=margin, mask=~bad)
    sl = (slice(margin, -margin or None), slice(margin, -margin or None))
    occ_in = occ[sl]
    bad_in = bad[sl]
    conf_in = conf[sl]
    return StressReport(
        matched_epe=matched,
        mean_conf_matched=float(conf_in[~bad_in].mean()),
        mean_conf_occluded=float(conf_in[occ_in].mean()),
        occluded_pixels=int(occ_in.sum()))


def _dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    """4-neighbour binary dilation (pure numpy; no scipy dependency)."""
    m = mask.copy()
    for _ in range(iterations):
        grown = m.copy()
        grown[1:] |= m[:-1]
        grown[:-1] |= m[1:]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        m = grown
    return m


def _disparity_edges(gt_h: np.ndarray) -> np.ndarray:
    """Pixels adjacent to a ground-truth disparity discontinuity."""
    e = np.zeros_like(gt_h, dtype=bool)
    dx = np.abs(np.diff(gt_h, axis=1)) > 0.5
    e[:, :-1] |= dx
    e[:, 1:] |= dx
    return e


def evaluate_engine(engine, height: int = 192, width: int = 256,
                    suite: Sequence[Tuple[str, float]] = DEFAULT_SUITE,
                    seed: int = 0, margin: int = 16
                    ) -> Dict[str, EpeReport]:
    """Run an engine over the synthetic suite; returns per-scene EPE."""
    out: Dict[str, EpeReport] = {}
    for kind, mag in suite:
        left, right, gt_h, gt_v = synthetic_scene(kind, height, width,
                                                  seed=seed, magnitude=mag)
        res = engine.match(left, right)
        out[kind] = epe_metrics(res.disparity_h, res.disparity_v,
                                gt_h, gt_v, margin=margin)
    return out


def accuracy_table(height: int = 192, width: int = 256,
                   interps: Sequence[str] = ("nearest", "bilinear"),
                   suite: Sequence[Tuple[str, float]] = DEFAULT_SUITE,
                   seed: int = 0, margin: int = 16,
                   device: str = "cuda",
                   ) -> Dict[str, Dict[str, EpeReport]]:
    """The nearest-vs-bilinear A/B table of docs/ACCURACY.md, reproducibly:
    one engine per interp mode on ``device`` over the full synthetic suite.
    ``python -m ug_stereomatcher_tpu_torch eval --markdown`` prints it;
    tests/test_torch_eval.py holds it to the per-scene gates of
    tests/test_eval_cli.py."""
    from ug_stereomatcher_tpu_torch.config import MatcherConfig
    from ug_stereomatcher_tpu_torch.engine import StereoEngine
    out: Dict[str, Dict[str, EpeReport]] = {}
    for interp in interps:
        eng = StereoEngine(MatcherConfig(interp=interp), device=device)
        out[interp] = evaluate_engine(eng, height=height, width=width,
                                      suite=suite, seed=seed, margin=margin)
    return out


_SCENE_LABEL = {
    "constant": "constant 3px shift", "vertical": "vertical 1px shift",
    "slant": "slanted ramp 0-4px", "sine": "sinusoidal 2-axis warp",
}


def format_accuracy_markdown(tables: Dict[str, Dict[str, EpeReport]]) -> str:
    """Render :func:`accuracy_table` output as the ACCURACY.md tables."""
    lines: List[str] = []
    for interp, reports in tables.items():
        lines.append(f"## interp=\"{interp}\"")
        lines.append("")
        lines.append("| scene | median EPE (px) | mean EPE | >1px |")
        lines.append("|---|---|---|---|")
        for kind, r in reports.items():
            lines.append(f"| {_SCENE_LABEL.get(kind, kind)} | "
                         f"{r.median_epe:.3f} | {r.mean_epe:.3f} | "
                         f"{100 * r.bad_1_0:.1f}% |")
        lines.append("")
    return "\n".join(lines)


def evaluate_pairs(engine, manifest_path: str, gt_loader: Callable[[int],
                   Tuple[np.ndarray, np.ndarray]],
                   margin: int = 16) -> List[EpeReport]:
    """Evaluate over a real stereo-pair manifest (e.g. the Glasgow 80-pair
    database) given a ground-truth loader ``gt_loader(pair_index) ->
    (gt_h, gt_v)``."""
    from ug_stereomatcher_tpu_torch.io.image import load_image
    from ug_stereomatcher_tpu_torch.io.manifest import load_image_list
    reports = []
    for idx, (lp, rp) in enumerate(load_image_list(manifest_path).pairs()):
        res = engine.match(load_image(lp), load_image(rp))
        gt_h, gt_v = gt_loader(idx)
        reports.append(epe_metrics(res.disparity_h, res.disparity_v,
                                   gt_h, gt_v, margin=margin))
    return reports
