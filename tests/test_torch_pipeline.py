"""The port's host layers against the JAX package's on the CPU: io, the
native runtime, capture, BatchRunner, DisparityService, EngineSupervisor,
MatcherConfig.from_file and the command line.

Files the two packages write from the same arrays are compared byte for
byte; the runner's dumps are compared with the JAX runner's under the
repo's free-running rule for whole matches (median |d| < 1e-3 and under
2 % of pixels beyond 0.02: tests/test_torch_match.py), on bilinear 64 x
96 scenes where the JAX and the port engines stay within it.
"""

import io as std_io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tests.test_torch_eval import assert_reports_agree
from ug_stereomatcher_tpu import io as jio
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.engine import StereoEngine as JaxEngine
from ug_stereomatcher_tpu.io import viz as jviz
from ug_stereomatcher_tpu.native import bindings as jnative
from ug_stereomatcher_tpu.pipeline import BatchRunner as JaxRunner
from ug_stereomatcher_tpu.pipeline import ImageListCapture as JaxCapture
from ug_stereomatcher_tpu_torch import StereoEngine, geom, native
from ug_stereomatcher_tpu_torch import io as tio
from ug_stereomatcher_tpu_torch.cli import main
from ug_stereomatcher_tpu_torch.config import TPU_ONLY_FIELDS, MatcherConfig
from ug_stereomatcher_tpu_torch.eval import synthetic_scene
from ug_stereomatcher_tpu_torch.io import viz
from ug_stereomatcher_tpu_torch.native import bindings
from ug_stereomatcher_tpu_torch.pipeline import (
    BatchRunner,
    CamerasSync,
    DisparityService,
    EngineSupervisor,
    ImageListCapture,
)
from ug_stereomatcher_tpu_torch.pipeline.messages import (
    GetDisparitiesRequest,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOVEA3 = MatcherConfig(fovea_level=3)

CAMERA_XML = """<?xml version="1.0"?>
<opencv_storage>
<camera_name>{name}</camera_name>
<width>{w}</width>
<height>{h}</height>
<K type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>
<data>{K}</data></K>
<D type_id="opencv-matrix"><rows>1</rows><cols>5</cols><dt>d</dt>
<data>0. 0. 0. 0. 0.</data></D>
<P type_id="opencv-matrix"><rows>3</rows><cols>4</cols><dt>d</dt>
<data>{P}</data></P>
</opencv_storage>
"""


def write_rig(tmp_path, h=64, w=96, baseline=20.0):
    """Two camera XML files of a rectified toy rig; returns their paths."""
    K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]])
    paths = []
    for name, tx in (("left", 0.0), ("right", baseline)):
        P = np.c_[K, [tx, 0.0, 0.0]]
        p = tmp_path / f"cal_{name}.xml"
        p.write_text(CAMERA_XML.format(
            name=name, w=w, h=h, K=" ".join(map(str, K.ravel().tolist())),
            P=" ".join(map(str, P.ravel().tolist()))))
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the engine's many small CPU ops run as fast on
    one as on eight here, and the test workers share the machine's cores
    (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def engine(interp="nearest", cfg=None):
    return StereoEngine(cfg or MatcherConfig(interp=interp), device="cpu")


def scene_manifest(tmp_path, kinds, ext=".npy", h=64, w=96):
    """A .txt manifest of the synthetic scenes' pairs; returns its path
    and the scenes."""
    paths, scenes = [], []
    for i, (kind, mag) in enumerate(kinds):
        sc = synthetic_scene(kind, h, w, magnitude=mag)
        for side, img in (("l", sc[0]), ("r", sc[1])):
            p = str(tmp_path / f"{side}{i}{ext}")
            tio.save_image(p, img)
            paths.append(p)
        scenes.append(sc)
    man = tmp_path / "pairs.txt"
    man.write_text("\n".join(paths))
    return str(man), scenes


def assert_free_running_close(out, ref):
    d = np.abs(np.asarray(out, np.float64) - ref)
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02, (
        np.median(d), (d > 0.02).mean())


# ----------------------------------------------------------------- io
@pytest.mark.parametrize("ext", [".png", ".npy"])
def test_image_round_trip(tmp_path, ext):
    img = (np.random.RandomState(0).rand(8, 9, 3) * 255).astype(np.uint8)
    p = str(tmp_path / f"x{ext}")
    tio.save_image(p, torch.from_numpy(img))
    np.testing.assert_array_equal(tio.load_image(p), img)
    np.testing.assert_array_equal(jio.load_image(p), img)


@pytest.mark.parametrize("ext", [".tif", ".npy"])
def test_float_dump_equals_jax(tmp_path, ext):
    data = np.random.RandomState(1).rand(6, 7).astype(np.float32)
    a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    tio.save_float_tiff(a, torch.from_numpy(data))
    jio.save_float_tiff(b, data)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_manifests_xml_json_yaml_text(tmp_path):
    names = ["l1.png", "r1.png", "l2.png", "r2.png"]
    files = {
        "list.xml": ("<?xml version=\"1.0\"?>\n<opencv_storage>\n<images>\n"
                     + "\n".join(names) + "\n</images>\n</opencv_storage>\n"),
        "list.json": json.dumps(names),
        "list.yaml": "".join(f"- {n}\n" for n in names),
        "list.txt": "\n".join(names) + "\n\n",
    }
    for fname, text in files.items():
        p = tmp_path / fname
        p.write_text(text)
        il = tio.load_image_list(str(p))
        assert il.paths == names == jio.load_image_list(str(p)).paths
        assert il.pairs() == [("l1.png", "r1.png"), ("l2.png", "r2.png")]
    bad = tmp_path / "bad.xml"
    bad.write_text("<opencv_storage></opencv_storage>")
    with pytest.raises(ValueError, match="no <images>"):
        tio.load_image_list(str(bad))


def test_image_list_wrap_odd_and_skip():
    il = tio.ImageList(["l1", "r1", "l2", "r2"])
    assert il.next_pair() == ("l1", "r1")
    il.skip_pair()
    # past the end: the last pair repeats (settings.h:30-45)
    assert il.next_pair() == ("l2", "r2")
    assert il.next_pair() == ("l2", "r2")
    with pytest.raises(ValueError, match="whole left/right pairs"):
        tio.ImageList(["l1", "r1", "l2"])


def test_dumps_of_port_results(tmp_path):
    eng = engine(cfg=FOVEA3)
    left, right, _, _ = synthetic_scene("constant", 64, 96, magnitude=2.0)
    res = eng.match(left, right)
    paths = tio.save_disparity_maps(res, str(tmp_path / "d"), ext=".npy")
    for tag, plane in (("H", res.disparity_h), ("V", res.disparity_v),
                       ("C", res.confidence)):
        np.testing.assert_array_equal(np.load(paths[tag]), plane.numpy())
    st = eng.match_foveated(left, right)
    paths = tio.save_foveated_stack(st, str(tmp_path / "f"))
    assert sorted(paths) == ["FC", "FH", "FV"]
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(paths["FH"])),
                                  st.stack_h.numpy())


def test_viz_equals_jax_and_panel(tmp_path):
    rng = np.random.RandomState(2)
    d = (rng.randn(20, 30) * 3).astype(np.float32)
    d[0, 0] = np.nan
    c = rng.rand(20, 30).astype(np.float32)
    for vmin, vmax in ((None, None), (-2.0, None), (None, 5.0)):
        np.testing.assert_array_equal(
            viz.colorize_disparity(torch.from_numpy(d), vmin, vmax),
            jviz.colorize_disparity(d, vmin, vmax))
    np.testing.assert_array_equal(viz.colorize_confidence(torch.from_numpy(c)),
                                  jviz.colorize_confidence(c))
    res = engine().match(*synthetic_scene("constant", 48, 64)[:2])
    out = viz.render_panel(res, str(tmp_path / "p.npy"))
    assert np.load(out).shape == (48, 192, 3)


# ------------------------------------------------------------- native
def seeded_cloud(n=1000, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            (rng.rand(n, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize("kind", ["pcd", "ply", "ppm"])
def test_native_files_equal_jax_bindings(tmp_path, kind):
    assert native.available() and jnative.available()
    a, b = str(tmp_path / f"a.{kind}"), str(tmp_path / f"b.{kind}")
    if kind == "ppm":
        img = (np.random.RandomState(4).rand(5, 7, 3) * 255).astype(np.uint8)
        native.write_ppm(a, img)
        jnative.write_ppm(b, img)
        np.testing.assert_array_equal(native.read_ppm(a), img)
    else:
        xyz, rgb = seeded_cloud()
        getattr(native, f"write_{kind}")(a, xyz, rgb)
        getattr(jnative, f"write_{kind}")(b, xyz, rgb)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_native_fallbacks_write_the_same_bytes(tmp_path, monkeypatch):
    xyz, rgb = seeded_cloud()
    img = (np.random.RandomState(5).rand(4, 6, 3) * 255).astype(np.uint8)
    native.write_pcd(str(tmp_path / "n.pcd"), xyz, rgb)
    native.write_ply(str(tmp_path / "n.ply"), xyz, rgb)
    native.write_ppm(str(tmp_path / "n.ppm"), img)
    monkeypatch.setattr(bindings, "ensure_built", lambda: False)
    native.write_pcd(str(tmp_path / "f.pcd"), xyz, rgb)
    native.write_ply(str(tmp_path / "f.ply"), xyz, rgb)
    native.write_ppm(str(tmp_path / "f.ppm"), img)
    for ext in ("pcd", "ply", "ppm"):
        assert (open(tmp_path / f"n.{ext}", "rb").read()
                == open(tmp_path / f"f.{ext}", "rb").read()), ext
    np.testing.assert_array_equal(native.read_ppm(str(tmp_path / "f.ppm")),
                                  img)
    geom.save_pcd(str(tmp_path / "g.pcd"), geom.PointCloud(xyz=xyz, rgb=rgb))
    assert (open(tmp_path / "g.pcd", "rb").read()
            == open(tmp_path / "n.pcd", "rb").read())


@pytest.mark.parametrize("built", [True, False])
def test_ppm_header_comment_and_grayscale(tmp_path, monkeypatch, built):
    if not built:
        monkeypatch.setattr(bindings, "ensure_built", lambda: False)
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    f = tmp_path / "c.ppm"
    with open(f, "wb") as fh:
        fh.write(b"P6\n6 4 # scanner output\n255\n")
        fh.write(img.tobytes())
    np.testing.assert_array_equal(native.read_ppm(str(f)), img)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native.write_ppm(str(tmp_path / "x.ppm"), np.zeros((4, 6), np.uint8))


@pytest.mark.parametrize("built", [True, False])
def test_file_prefetcher_yields_files_in_order(tmp_path, monkeypatch, built):
    if not built:
        monkeypatch.setattr(bindings, "ensure_built", lambda: False)
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (100 + i))
        paths.append(str(p))
    pf = native.FilePrefetcher(paths, capacity=2)
    try:
        got = list(pf)
    finally:
        pf.close()
    assert got == [(i, bytes([i]) * (100 + i)) for i in range(5)]


def test_native_library_is_built_in_the_package():
    path = bindings.library_path()
    assert native.ensure_built() and path.is_file()
    assert path.parent.parent == bindings.BUILD_DIR
    assert path.parent.parent.parent.name == "ug_stereomatcher_tpu_torch"


# ------------------------------------------------------------ capture
def test_capture_with_xml_calibration(tmp_path):
    man, _ = scene_manifest(tmp_path, [("constant", 2.0), ("sine", 4.0)])
    cl, cr = write_rig(tmp_path)
    cap = ImageListCapture(man, camera_info_left=cl, camera_info_right=cr)
    f1 = cap.capture(CamerasSync(time_stamp=0.0, data="full"))
    assert f1.left.shape == (64, 96, 3) and f1.header.seq == 1
    assert f1.camera_info_left.K.shape == (3, 3)
    assert f1.camera_info_right.P[0, 3] == 20.0
    assert f1.camera_info_left.width == 96
    f2 = cap.capture()
    np.testing.assert_array_equal(cap.capture().left, f2.left)  # wrap
    with pytest.raises(ValueError, match="not supported"):
        cap.capture(CamerasSync(time_stamp=0.0, data="preview"))
    assert len(list(ImageListCapture(man))) == 2


# ------------------------------------------------------------- runner
@pytest.fixture(scope="module")
def jax_bilinear():
    """The JAX engine, bilinear, for 64 x 96 pairs (one compile)."""
    return JaxEngine(JaxConfig(interp="bilinear"))


def test_runner_dumps_match_jax_runner(tmp_path, jax_bilinear):
    man, _ = scene_manifest(tmp_path, [("sine", 4.0), ("slant", 4.0)])
    ours = BatchRunner(engine("bilinear"), out_dir=str(tmp_path / "t"),
                       dump_ext=".npy").run(ImageListCapture(man))
    theirs = JaxRunner(jax_bilinear, out_dir=str(tmp_path / "j")).run(
        JaxCapture(man))
    assert [r.index for r in ours] == [r.index for r in theirs] == [0, 1]
    for a, b in zip(ours, theirs):
        for tag in ("H", "V", "C"):
            from PIL import Image
            ref = np.asarray(Image.open(b.dump_paths[tag]))
            out = np.load(a.dump_paths[tag])
            assert out.dtype == np.float32 and out.shape == ref.shape
            assert_free_running_close(out, ref)


def test_evaluate_engine_agrees_with_jax_bilinear(jax_bilinear):
    """The bilinear case of tests/test_torch_eval.py's comparison of
    evaluate_engine with the JAX engine, on this file's JAX engine."""
    assert_reports_agree("bilinear", jax_bilinear)


@pytest.mark.parametrize("prefetch", [True, False])
def test_runner_dumps_clouds_and_timings(tmp_path, prefetch):
    man, scenes = scene_manifest(tmp_path, [("constant", 2.0),
                                            ("sine", 3.0)])
    calib = geom.StereoCalibration.from_xml(*write_rig(tmp_path))
    eng = engine()
    out = str(tmp_path / "out")
    res = BatchRunner(eng, calibration=calib, out_dir=out, save_clouds=True,
                      prefetch=prefetch, dump_ext=".npy").run(
        ImageListCapture(man))
    assert [r.index for r in res] == [0, 1]
    for r, (left, right, _, _) in zip(res, scenes):
        ref = eng.match(left, right)
        for tag, plane in (("H", ref.disparity_h), ("V", ref.disparity_v),
                           ("C", ref.confidence)):
            np.testing.assert_array_equal(np.load(r.dump_paths[tag]),
                                          plane.numpy())
        cloud = geom.disparity_to_pointcloud(calib, ref.disparity_h,
                                             ref.disparity_v, left)
        np.testing.assert_array_equal(r.cloud.xyz, cloud.xyz)
        pcd = os.path.join(out, f"cloud_{r.index}.pcd")
        geom.save_pcd(str(tmp_path / "ref.pcd"), cloud)
        assert open(pcd, "rb").read() == open(tmp_path / "ref.pcd",
                                              "rb").read()
        assert r.match_seconds > 0 and r.cloud_seconds > 0
        assert r.dump_seconds > 0


def test_runner_foveated_and_max_pairs(tmp_path):
    man, scenes = scene_manifest(tmp_path, [("constant", 2.0),
                                            ("sine", 3.0)])
    eng = engine(cfg=FOVEA3)
    res = BatchRunner(eng, foveated=True, out_dir=str(tmp_path / "o"),
                      dump_ext=".npy").run(ImageListCapture(man),
                                           max_pairs=1)
    assert len(res) == 1 and sorted(res[0].dump_paths) == ["FC", "FH", "FV"]
    ref = eng.match_foveated(*scenes[0][:2])
    np.testing.assert_array_equal(np.load(res[0].dump_paths["FH"]),
                                  ref.stack_h.numpy())


def test_runner_resume_skips_completed(tmp_path):
    """Checkpoint/resume as tests/test_service_throughput.py:46-76."""
    man, _ = scene_manifest(tmp_path, [("constant", 2.0), ("sine", 3.0)],
                            ext=".png", h=48, w=64)
    ck = str(tmp_path / "progress.jsonl")
    runner = BatchRunner(engine(), out_dir=str(tmp_path / "out"),
                         checkpoint_path=ck)
    assert len(runner.run(ImageListCapture(man))) == 2
    lines = open(ck).read().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["index"] == 0
    assert runner.run(ImageListCapture(man)) == []
    victim = json.loads(lines[1])["dump_paths"]["H"]
    os.remove(victim)
    assert [r.index for r in runner.run(ImageListCapture(man))] == [1]
    assert os.path.exists(victim)


def test_runner_propagates_capture_errors(tmp_path):
    man = tmp_path / "m.txt"
    man.write_text("missing_l.npy\nmissing_r.npy\n")
    with pytest.raises(FileNotFoundError):
        BatchRunner(engine()).run(ImageListCapture(str(man)))


# ------------------------------------------------- service, supervisor
def test_service_plain_response_equals_match():
    eng = engine()
    svc = DisparityService(eng)
    left, right, _, _ = synthetic_scene("constant", 48, 64, magnitude=2.0)
    rsp = svc(GetDisparitiesRequest(left=left, right=right))
    assert rsp.fdisp_h is None and rsp.disp_h.header.seq == 1
    ref = eng.match(left, right)
    for msg, plane in ((rsp.disp_h, ref.disparity_h),
                       (rsp.disp_v, ref.disparity_v),
                       (rsp.disp_c, ref.confidence)):
        assert isinstance(msg.image, np.ndarray)
        np.testing.assert_array_equal(msg.image, plane.numpy())
    svc(GetDisparitiesRequest(left=left, right=right))
    assert svc.requests_served == 2


def test_service_foveated_response_equals_match_foveated():
    eng = engine(cfg=FOVEA3)
    svc = DisparityService(eng, foveated=True)
    left, right, _, _ = synthetic_scene("sine", 96, 128)
    rsp = svc(GetDisparitiesRequest(left=left, right=right))
    assert rsp.disp_h is None
    ref = eng.match_foveated(left, right)
    fh, fw = FOVEA3.fovea_dims(96, 128)
    for msg, plane in ((rsp.fdisp_h, ref.stack_h), (rsp.fdisp_v, ref.stack_v),
                       (rsp.fdisp_c, ref.stack_c)):
        assert msg.image_stack.shape == (3 * fh, fw)
        assert (msg.num_levels, msg.roi_height, msg.roi_width,
                msg.im_height, msg.im_width) == (3, fh, fw, 96, 128)
        np.testing.assert_array_equal(msg.image_stack, plane.numpy())


class FlakyEngine:
    """An engine whose first ``fails`` calls raise ``exc``."""

    built = 0

    def __init__(self, exc, fails=1):
        FlakyEngine.built += 1
        self.exc, self.fails = exc, fails
        self.inner = engine()
        self.device = self.inner.device

    def match(self, left, right):
        if FlakyEngine.built <= self.fails:
            raise self.exc
        return self.inner.match(left, right)


def test_supervisor_retries_and_restarts_on_runtime_error():
    FlakyEngine.built = 0
    sup = EngineSupervisor(lambda: FlakyEngine(RuntimeError("lost")))
    left, right, _, _ = synthetic_scene("constant", 48, 64, magnitude=2.0)
    res = sup.match(left, right)
    assert res.disparity_h.shape == (48, 64)
    assert (sup.stats.frames, sup.stats.failures, sup.stats.restarts) == (
        1, 1, 1)
    assert sup.stats.mean_seconds > 0
    FlakyEngine.built = 0
    sup = EngineSupervisor(lambda: FlakyEngine(RuntimeError("x"), fails=9),
                           max_retries=1)
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        sup.match(left, right)
    assert (sup.stats.failures, sup.stats.restarts) == (2, 2)


@pytest.mark.parametrize("exc", [ValueError("bad input"), TypeError("t")])
def test_supervisor_does_not_retry_input_errors(exc):
    FlakyEngine.built = 0
    sup = EngineSupervisor(lambda: FlakyEngine(exc))
    with pytest.raises(type(exc)):
        sup.match(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3),
                                                          np.uint8))
    assert (sup.stats.failures, sup.stats.restarts) == (0, 0)
    with pytest.raises(ValueError, match="unknown mode"):
        sup.match(None, None, mode="preview")


def test_supervisor_modes_and_restart_every_frame():
    sup = EngineSupervisor(lambda: engine(cfg=FOVEA3),
                           restart_every_frame=True)
    left, right, _, _ = synthetic_scene("constant", 96, 128, magnitude=2.0)
    full = sup.match(left, right)
    st = sup.match(left, right, mode="foveated")
    hier = sup.match(left, right, mode="hierarchical")
    assert full.disparity_h.shape == hier.disparity_h.shape == (96, 128)
    assert st.num_levels == 3
    assert (sup.stats.frames, sup.stats.restarts) == (3, 3)


# ------------------------------------------------------ config files
def test_config_from_yaml_drops_tpu_only_fields(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("fovea_level: 3\ninterp: bilinear\nwarp_max_dx: 512\n"
                 "level_backend: xla\n")
    cfg = MatcherConfig.from_file(str(p))
    assert cfg == MatcherConfig(fovea_level=3, interp="bilinear")
    assert {"warp_max_dx", "level_backend"} <= TPU_ONLY_FIELDS
    j = tmp_path / "cfg.json"
    j.write_text(json.dumps({"level_cutoff": 9, "warp_backend": "xla"}))
    assert MatcherConfig.from_file(str(j)) == MatcherConfig(level_cutoff=9)


@pytest.mark.parametrize("text", ['{"fovae_level": 3}', "[1, 2]"])
def test_config_from_file_rejects_unknown_keys(tmp_path, text):
    p = tmp_path / "cfg.json"
    p.write_text(text)
    with pytest.raises(ValueError, match="unknown config fields|mapping"):
        MatcherConfig.from_file(str(p))


# ---------------------------------------------------------------- cli
def run_cli(*argv):
    buf = std_io.StringIO()
    with redirect_stdout(buf):
        rc = main([*argv, "--device", "cpu"])
    return rc, buf.getvalue().strip().splitlines()


@pytest.fixture
def pair_files(tmp_path):
    left, right, _, _ = synthetic_scene("constant", 64, 96, magnitude=2.0)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    tio.save_image(lp, left)
    tio.save_image(rp, right)
    return lp, rp


def test_cli_match_with_consistency_and_panel(tmp_path, pair_files):
    out = str(tmp_path / "out")
    rc, lines = run_cli("match", *pair_files, "-o", out, "--consistency",
                        "--panel")
    assert rc == 0
    payload = json.loads(lines[-1])
    for key in ("H", "V", "C", "mask", "panel"):
        assert os.path.exists(payload["outputs"][key]), key
    mask = np.load(payload["outputs"]["mask"])
    assert mask.dtype == bool and mask.shape == (64, 96)
    assert payload["consistent_fraction"] == round(float(mask.mean()), 4)


def test_cli_match_plain_and_foveated(tmp_path, pair_files):
    rc, lines = run_cli("match", *pair_files, "-o", str(tmp_path / "a"),
                        "--ext", ".npy", "--interp", "bilinear")
    assert rc == 0
    h = np.load(json.loads(lines[-1])["outputs"]["H"])
    ref = engine("bilinear").match(tio.load_image(pair_files[0]),
                                   tio.load_image(pair_files[1]))
    np.testing.assert_array_equal(h, ref.disparity_h.numpy())
    rc, lines = run_cli("match", *pair_files, "-o", str(tmp_path / "f"),
                        "--foveated", "--fovea-level", "3")
    assert rc == 0
    assert sorted(json.loads(lines[-1])["outputs"]) == ["FC", "FH", "FV"]


def test_cli_batch_and_cloud(tmp_path, pair_files):
    man = tmp_path / "list.txt"
    man.write_text("\n".join(pair_files))
    cl, cr = write_rig(tmp_path)
    rc, lines = run_cli("batch", str(man), "-o", str(tmp_path / "b"),
                        "--cal-left", cl, "--cal-right", cr,
                        "--save-clouds", "--ext", ".npy")
    assert rc == 0
    payload = json.loads(lines[-1])
    assert payload["pair"] == 0 and os.path.exists(payload["outputs"]["H"])
    assert os.path.exists(tmp_path / "b" / "cloud_0.pcd")
    for ext, sampling in ((".pcd", "2"), (".ply", "1")):
        out = str(tmp_path / f"c{ext}")
        rc, lines = run_cli("cloud", *pair_files, "--cal-left", cl,
                            "--cal-right", cr, "-o", out,
                            "--sampling", sampling)
        assert rc == 0
        payload = json.loads(lines[-1])
        assert payload["output"] == out
        assert payload["points"] == 64 * 96 // int(sampling) ** 2
        assert os.path.getsize(out) > 16 * payload["points"] // 2


def test_cli_eval_json_and_markdown():
    rc, lines = run_cli("eval", "--height", "64", "--width", "96",
                        "--interp", "nearest")
    assert rc == 0
    rows = [json.loads(line) for line in lines]
    assert {r["scene"] for r in rows} == {"constant", "vertical", "slant",
                                          "sine", "step"}
    assert all(r["interp"] == "nearest" for r in rows)
    rc, lines = run_cli("eval", "--height", "64", "--width", "96",
                        "--interp", "bilinear", "--markdown")
    assert rc == 0
    assert '## interp="bilinear"' in lines
    assert "| scene | median EPE (px) | mean EPE | >1px |" in lines


def test_cli_config_with_override(tmp_path, pair_files):
    cfgp = tmp_path / "cfg.yaml"
    cfgp.write_text("fovea_level: 6\nwarp_backend: pallas\n")
    rc, _ = run_cli("match", *pair_files, "-o", str(tmp_path / "o"),
                    "--config", str(cfgp), "--fovea-level", "3",
                    "--foveated")
    assert rc == 0


def test_cli_bad_args(tmp_path, pair_files, capsys):
    with pytest.raises(SystemExit):
        main(["match"])  # missing positional args
    for gone in (["bench"], ["match", *pair_files, "--warp-backend", "xla"]):
        with pytest.raises(SystemExit):
            main(gone)
    rc, _ = run_cli("match", *pair_files, "--foveated", "--panel")
    assert rc == 2
    assert "cannot be combined" in capsys.readouterr().err


def test_cli_module_entry_point(tmp_path):
    """python -m ug_stereomatcher_tpu_torch runs in a fresh process."""
    left, right, _, _ = synthetic_scene("constant", 48, 64, magnitude=2.0)
    np.save(tmp_path / "l.npy", left)
    np.save(tmp_path / "r.npy", right)
    out = tmp_path / "o"
    proc = subprocess.run(
        [sys.executable, "-m", "ug_stereomatcher_tpu_torch", "match",
         str(tmp_path / "l.npy"), str(tmp_path / "r.npy"), "-o", str(out),
         "--ext", ".npy", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(os.listdir(out)) == ["disparity_C.npy", "disparity_H.npy",
                                       "disparity_V.npy"]
    assert payload["outputs"]["H"].endswith("disparity_H.npy")
