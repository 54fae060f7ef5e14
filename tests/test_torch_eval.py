"""The port's evaluation harness against the JAX package's on the CPU.

The scene generators are the same seeded NumPy code, so the two packages
make the same arrays bit for bit; ``epe_metrics`` gives the same report
on the same arrays and on CPU tensors.  The port's accuracy table at
192 x 256 passes the per-scene gates of tests/test_eval_cli.py, with
bilinear ahead of nearest on every scene; early exit (on the
per-iteration route, where the port's levels can stop), the occlusion
and the photometric families pass the gates the JAX package's tests
apply.  ``evaluate_engine`` at 64 x 96 agrees with the JAX engine's
report: bilinear median EPE within 0.002 px, nearest within 0.03 px and
its share of pixels above 1 px within 0.01 (a nearest warp flips gather
indices on float noise, so whole matches are compared by statistics,
never bit for bit).
"""

import numpy as np
import pytest
import torch

from tests import test_eval_cli as jax_tests
from ug_stereomatcher_tpu import eval as jev
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.engine import StereoEngine as JaxEngine
from ug_stereomatcher_tpu_torch import StereoEngine
from ug_stereomatcher_tpu_torch import eval as tev
from ug_stereomatcher_tpu_torch.config import MatcherConfig

SCENES = ["constant", "vertical", "slant", "sine", "step"]
# the JAX package's gates: interp -> scene -> (median EPE, bad_1_0) maxima,
# and interp -> (occlusion matched, photometric) median EPE maxima
_GATES = jax_tests._GATES
STRESS_GATES = jax_tests.TestStressFamilies._GATES
# |median EPE (port) - median EPE (JAX)| and |bad_1_0 (port) - (JAX)|
EPE_TOL = {"nearest": (0.03, 0.01), "bilinear": (0.002, 0.01)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the engine's many small CPU ops run as fast on
    one as on eight here, and the test workers share the machine's cores
    (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def engine(interp, **kw):
    return StereoEngine(MatcherConfig(interp=interp), device="cpu", **kw)


# ------------------------------------------------------------- scenes
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", SCENES)
def test_synthetic_scene_equals_jax(kind, seed):
    got = tev.synthetic_scene(kind, 40, 56, seed=seed, magnitude=3.5)
    ref = jev.synthetic_scene(kind, 40, 56, seed=seed, magnitude=3.5)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_occlusion_and_photometric_scenes_equal_jax(seed):
    for got, ref in ((tev.occlusion_scene(48, 64, seed=seed, fg_disp=6),
                      jev.occlusion_scene(48, 64, seed=seed, fg_disp=6)),
                     (tev.photometric_scene(48, 64, seed=seed),
                      jev.photometric_scene(48, 64, seed=seed))):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_unknown_scene_kind_raises():
    with pytest.raises(ValueError, match="unknown scene kind"):
        tev.synthetic_scene("spiral", 16, 16)


# -------------------------------------------------------- epe_metrics
@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_epe_metrics_equals_jax(as_tensor, masked):
    rng = np.random.RandomState(5)
    dh, dv, gh, gv = (rng.randn(40, 50).astype(np.float32) * 2
                      for _ in range(4))
    mask = rng.rand(40, 50) > 0.3 if masked else None
    ref = jev.epe_metrics(dh, dv, gh, gv, margin=4, mask=mask)
    args = [dh, dv, gh, gv]
    if as_tensor:
        args = [torch.from_numpy(a) for a in args]
        mask = None if mask is None else torch.from_numpy(mask)
    assert tev.epe_metrics(*args, margin=4, mask=mask).as_dict() == \
        ref.as_dict()


def test_epe_metrics_empty_region_raises():
    d = np.zeros((10, 10), np.float32)
    with pytest.raises(ValueError, match="no pixels"):
        tev.epe_metrics(d, d, d, d, margin=5)


# ------------------------------------------------------ accuracy gates
@pytest.fixture(scope="module")
def ab_table():
    return tev.accuracy_table(height=192, width=256, device="cpu")


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("scene", SCENES)
def test_accuracy_table_scene_gate(ab_table, interp, scene):
    r = ab_table[interp][scene]
    med_max, bad1_max = _GATES[interp][scene]
    assert r.median_epe < med_max, (interp, scene, r.as_dict())
    assert r.bad_1_0 < bad1_max, (interp, scene, r.as_dict())


def test_bilinear_beats_nearest_on_every_scene(ab_table):
    for scene in SCENES:
        assert (ab_table["bilinear"][scene].median_epe
                < ab_table["nearest"][scene].median_epe), scene


def test_accuracy_markdown_lists_every_scene(ab_table):
    md = tev.format_accuracy_markdown(ab_table)
    assert md == jev.format_accuracy_markdown(ab_table)
    for label in ("constant 3px shift", "sinusoidal 2-axis warp", "step"):
        assert md.count(f"| {label} |") == 2


@pytest.mark.parametrize("interp,thr", [("nearest", 0.1),
                                        ("bilinear", 0.02)])
def test_early_exit_holds_suite_accuracy(interp, thr):
    # resident_max_pixels=0: every level per iteration, where it can stop
    eng = StereoEngine(MatcherConfig(interp=interp, early_exit_delta=thr),
                       device="cpu", resident_max_pixels=0)
    for scene, r in tev.evaluate_engine(eng, height=192, width=256).items():
        med_max, bad1_max = _GATES[interp][scene]
        assert r.median_epe < med_max, (interp, thr, scene, r.as_dict())
        assert r.bad_1_0 < max(bad1_max, 0.02), (interp, thr, scene,
                                                 r.as_dict())


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_occlusion_gates(interp):
    r = tev.evaluate_occlusion(engine(interp))
    med_max, _ = STRESS_GATES[interp]
    assert r.matched_epe.median_epe < med_max, r.as_dict()
    assert r.matched_epe.bad_1_0 < 0.02, r.as_dict()
    assert r.mean_conf_occluded < r.mean_conf_matched - 0.05, r.as_dict()
    assert r.mean_conf_matched > 0.9, r.as_dict()
    assert r.occluded_pixels == 160 * 8


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_photometric_gates(interp):
    left, right, gt_h, gt_v = tev.photometric_scene(192, 256)
    res = engine(interp).match(left, right)
    rep = tev.epe_metrics(res.disparity_h, res.disparity_v, gt_h, gt_v,
                          margin=16)
    _, med_max = STRESS_GATES[interp]
    assert rep.median_epe < med_max, rep.as_dict()
    assert rep.bad_1_0 < 0.02, rep.as_dict()


# ------------------------------------------------ against the JAX engine
SUITE = (("constant", 3.0), ("sine", 4.0))


def assert_reports_agree(interp, jax_engine):
    """evaluate_engine of the port's engine and of ``jax_engine`` at 64 x
    96 agree within EPE_TOL[interp]."""
    ref = jev.evaluate_engine(jax_engine, height=64, width=96, suite=SUITE)
    got = tev.evaluate_engine(engine(interp), height=64, width=96,
                              suite=SUITE)
    med_tol, bad_tol = EPE_TOL[interp]
    for scene in ref:
        g, r = got[scene], ref[scene]
        assert g.pixels == r.pixels
        assert abs(g.median_epe - r.median_epe) <= med_tol, (
            scene, g.as_dict(), r.as_dict())
        assert abs(g.bad_1_0 - r.bad_1_0) <= bad_tol, (
            scene, g.as_dict(), r.as_dict())


def test_evaluate_engine_agrees_with_jax_nearest():
    """Nearest here; bilinear in tests/test_torch_pipeline.py, whose JAX
    bilinear engine at 64 x 96 it shares (one JAX compile per file)."""
    assert_reports_agree("nearest", JaxEngine(JaxConfig(interp="nearest")))


def test_evaluate_pairs_on_a_synthetic_manifest(tmp_path):
    """evaluate_pairs over a .txt manifest of .npy pairs with the scenes'
    ground truth equals evaluate_engine on the same scenes."""
    suite = (("constant", 3.0), ("vertical", 2.0))
    paths, gts = [], []
    for i, (kind, mag) in enumerate(suite):
        left, right, gh, gv = tev.synthetic_scene(kind, 64, 96,
                                                  magnitude=mag)
        for side, img in (("l", left), ("r", right)):
            p = tmp_path / f"{side}{i}.npy"
            np.save(p, img)
            paths.append(str(p))
        gts.append((gh, gv))
    man = tmp_path / "pairs.txt"
    man.write_text("\n".join(paths))
    eng = engine("bilinear")
    got = tev.evaluate_pairs(eng, str(man), lambda i: gts[i])
    ref = tev.evaluate_engine(eng, height=64, width=96, suite=suite)
    assert got == [ref[k] for k, _ in suite]
