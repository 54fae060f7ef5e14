"""The port's geometry against the JAX package on the CPU: calibration,
triangulation, the fovea map, undistortion, the four point-cloud
functions, the PCD and PLY files, and the cubic resample.

Triangulation runs in float32 in the JAX package's term order, but its
numerators and divisor reach 1e20-1e25 at pixel coordinates in the
hundreds or thousands and cancel, and XLA rounds its fused expression
differently from torch's one operation at a time: the two are compared
by relative quantiles (q50 <= 1e-5, q99 <= 1e-3 of |d| / |ref|), never by
maxima, and both against the float64 least-squares gold of
tests/test_geom.py.  The nearest range-map resize is exact; the bilinear
one takes host float64 taps and interpolates rows first where the JAX
package's float32 ``tex_gather`` interpolates per pixel, so it agrees to
rtol 1e-6.  The fovea map, the colours and the file bytes are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.gold import gold_ops
from tests.test_geom import make_rig as jax_rig
from tests.test_geom import scalar_gold_triangulate
from ug_stereomatcher_tpu import geom as jgeom
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.geom import undistort as jund
from ug_stereomatcher_tpu.ops import resample as jres
from ug_stereomatcher_tpu_torch import geom as tgeom
from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.geom import undistort as tund
from ug_stereomatcher_tpu_torch.ops import resample as tres
from ug_stereomatcher_tpu_torch.ops.cuda import resample as cres

CAL_XML = """<?xml version="1.0"?>
<opencv_storage>
<camera_name>{name}</camera_name>
<width>{w}</width>
<height>{h}</height>
<K type_id="opencv-matrix"><rows>3</rows><cols>3</cols><dt>d</dt>
<data>
  7323.0899280915291 0. 2464.5 0. 7318.25 1632.125 0. 0. 1.</data></K>
<D type_id="opencv-matrix"><rows>1</rows><cols>5</cols><dt>d</dt>
<data>
  -0.0558 0.5239 0. 0. 0.</data></D>
<P type_id="opencv-matrix"><rows>3</rows><cols>4</cols><dt>d</dt>
<data>
  {p}</data></P>
</opencv_storage>
"""


def port_rig(jrig):
    """The port's StereoCalibration of the same matrices."""
    return tgeom.StereoCalibration(
        left=tgeom.CameraCalibration(K=jrig.left.K, D=jrig.left.D,
                                     P=jrig.left.P),
        right=tgeom.CameraCalibration(K=jrig.right.K, D=jrig.right.D,
                                      P=jrig.right.P))


def assert_rel_quantiles(out, ref, q50=1e-5, q99=1e-3):
    out = np.asarray(out, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-12)
    assert np.quantile(rel, 0.5) <= q50, np.quantile(rel, 0.5)
    assert np.quantile(rel, 0.99) <= q99, np.quantile(rel, 0.99)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------- calibration
def test_calibration_from_xml_matches_jax(tmp_path):
    rig = jax_rig()
    paths = []
    for name, P in (("left_camera", rig.left.P), ("right_camera",
                                                  rig.right.P)):
        p = tmp_path / f"{name}.xml"
        p.write_text(CAL_XML.format(name=name, w=4928, h=3264, p=" ".join(
            repr(float(v)) for v in P.ravel())))
        paths.append(str(p))
    ref = jgeom.StereoCalibration.from_xml(*paths)
    out = tgeom.StereoCalibration.from_xml(*paths)
    for side in ("left", "right"):
        a, b = getattr(out, side), getattr(ref, side)
        for m in ("K", "D", "P"):
            np.testing.assert_array_equal(getattr(a, m), getattr(b, m))
            assert getattr(a, m).dtype == np.float64
        assert (a.width, a.height, a.name) == (b.width, b.height, b.name)
    assert out.left.K[0, 0] == 7323.0899280915291
    np.testing.assert_array_equal(out.right.P, rig.right.P)
    bad = tmp_path / "bad.xml"
    bad.write_text("<opencv_storage><K><rows>1</rows><cols>1</cols>"
                   "<data>1</data></K></opencv_storage>")
    with pytest.raises(ValueError, match="missing matrix"):
        tgeom.load_opencv_xml(str(bad))


# -------------------------------------------------------- triangulation
def rig_points(P1, P2, n, seed=11):
    """Pixel pairs of n seeded 3-D points seen by both cameras."""
    pts = np.random.RandomState(seed).rand(n, 3) * [2.0, 1.5, 3.0] \
        + [-1.0, -0.75, 2.0]
    hom = np.c_[pts, np.ones(n)]
    u1, u2 = hom @ P1.T, hom @ P2.T
    return pts, (u1[:, 0] / u1[:, 2], u1[:, 1] / u1[:, 2],
                 u2[:, 0] / u2[:, 2], u2[:, 1] / u2[:, 2])


@pytest.mark.parametrize("scale", [1.0, 7.7])
def test_triangulate_points_against_jax_and_gold(scale):
    """scale 7.7 takes the rig to 4928 x 3264 (coordinates in the
    thousands, the cancelling regime)."""
    rig = jax_rig()
    S = np.diag([scale, scale, 1.0])
    P1, P2 = S @ rig.left.P, S @ rig.right.P
    pts, coords = rig_points(P1, P2, 400)
    c32 = [np.asarray(c, np.float32) for c in coords]
    out = tgeom.triangulate_points(P1, P2, *(t(c) for c in c32))
    ref = jgeom.triangulate_points(P1, P2, *(jnp.asarray(c) for c in c32))
    assert all(o.dtype == torch.float32 for o in out)
    for o, r in zip(out, ref):
        assert_rel_quantiles(o.numpy(), np.asarray(r))
    gold = np.array([scalar_gold_triangulate(P1, P2, *(float(c[k])
                                                       for c in c32))
                     for k in range(len(pts))])
    assert_rel_quantiles(np.stack([o.numpy() for o in out], -1), gold,
                         q50=1e-4, q99=1e-2)
    # torch P1/P2 give the same as NumPy ones
    same = tgeom.triangulate_points(t(P1), t(P2), *(t(c) for c in c32))
    for a, b in zip(same, out):
        assert torch.equal(a, b)


def test_triangulate_disparity_and_range_map():
    rig = jax_rig()
    rng = np.random.RandomState(5)
    dh = (rng.rand(24, 32) * 3 + 3).astype(np.float32)
    dv = (rng.rand(24, 32) * 0.2).astype(np.float32)
    out = tgeom.triangulate_disparity(rig.left.P, rig.right.P, t(dh), t(dv))
    ref = jgeom.triangulate_disparity(rig.left.P, rig.right.P,
                                      jnp.asarray(dh), jnp.asarray(dv))
    for o, r in zip(out, ref):
        assert o.shape == (24, 32)
        assert_rel_quantiles(o.numpy(), np.asarray(r))
    z = tgeom.range_map(rig.left.P, rig.right.P, t(dh), t(dv))
    assert torch.equal(z, out[2])


# ------------------------------------------------------------ fovea map
@pytest.mark.parametrize("hw,fovea_level", [((3264, 4928), 7), ((72, 96), 3),
                                            ((240, 320), 4)])
def test_fovea_map_exact(hw, fovea_level):
    jcfg = JaxConfig(fovea_level=fovea_level)
    tcfg = MatcherConfig(fovea_level=fovea_level)
    xs = np.arange(0, 50, 0.75, dtype=np.float32)
    for src in range(fovea_level):
        for dest in (0, 1):
            assert tgeom.fovea_margins(tcfg, *hw, src, dest) == \
                jgeom.fovea_margins(jcfg, *hw, src, dest)
            a = tgeom.map_fovea_coords(tcfg, *hw, src, xs, xs[::-1], dest)
            b = jgeom.map_fovea_coords(jcfg, *hw, src, xs, xs[::-1], dest)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


# ------------------------------------------------------------ undistort
K = np.array([[700.0, 0, 320.0], [0, 690.0, 240.0], [0, 0, 1.0]])


@pytest.mark.parametrize("D", [[0.0] * 5, [-0.0558, 0.5239, 0.0, 0.0, 0.0],
                               [0.25, -0.1, 0.001, -0.002, 0.01]])
def test_undistort_matches_jax_and_round_trips(D):
    rng = np.random.RandomState(2)
    u = (rng.rand(50) * 600 + 20).astype(np.float32)
    v = (rng.rand(50) * 440 + 20).astype(np.float32)
    uu, vv = tund.undistort_pixels(t(u), t(v), K, np.array(D))
    ju, jv = jund.undistort_pixels(jnp.asarray(u), jnp.asarray(v), K,
                                   np.array(D))
    np.testing.assert_allclose(uu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(vv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-3)
    if not any(D):
        np.testing.assert_allclose(uu.numpy(), u, atol=1e-4)
    # distort the undistorted normalised points back: the input again
    xn = (uu - 320.0) / 700.0
    yn = (vv - 240.0) / 690.0
    xd, yd = tund.distort_normalized(xn, yn, D)
    jx, jy = jund.distort_normalized(jnp.asarray(xn.numpy()),
                                     jnp.asarray(yn.numpy()), np.array(D))
    np.testing.assert_allclose(xd.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(yd.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(xd.numpy() * 700.0 + 320.0, u, atol=2e-3)
    np.testing.assert_allclose(yd.numpy() * 690.0 + 240.0, v, atol=2e-3)


# ---------------------------------------------------------- point clouds
def cloud_inputs(h=20, w=30, seed=5):
    rng = np.random.RandomState(seed)
    dh = (rng.rand(h, w) * 3 + 3).astype(np.float32)
    dv = (rng.rand(h, w) * 0.4 - 0.2).astype(np.float32)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return dh, dv, img


def assert_cloud_close(out, ref):
    """NumPy clouds of one length: the colours exact, the points under
    the quantile rule."""
    assert isinstance(out.xyz, np.ndarray) and out.xyz.dtype == np.float32
    assert out.rgb.dtype == np.uint8
    assert out.xyz.shape == ref.xyz.shape
    np.testing.assert_array_equal(out.rgb, ref.rgb)
    assert_rel_quantiles(out.xyz, ref.xyz)


@pytest.mark.parametrize("sampling", [1, 3])
def test_disparity_to_pointcloud_matches_jax(sampling):
    rig = jax_rig()
    dh, dv, img = cloud_inputs()
    ref = jgeom.disparity_to_pointcloud(rig, dh, dv, img, sampling)
    for args in ((dh, dv, img),
                 (t(dh), t(dv), t(np.moveaxis(img, -1, 0).copy()))):
        out = tgeom.disparity_to_pointcloud(port_rig(rig), *args,
                                            sampling=sampling)
        assert_cloud_close(out, ref)


@pytest.mark.parametrize("src_level,sampling", [(0, 1), (1, 2)])
def test_foveated_disparity_to_pointcloud_matches_jax(src_level, sampling):
    rig = jax_rig()
    jcfg, tcfg = JaxConfig(fovea_level=3), MatcherConfig(fovea_level=3)
    H, W = 72, 96
    fh, fw = tcfg.fovea_dims(H, W)
    sh, sv, _ = cloud_inputs(3 * fh, fw, seed=9)
    img = cloud_inputs(H, W)[2]
    ref = jgeom.foveated_disparity_to_pointcloud(rig, jcfg, sh, sv, img,
                                                 src_level, sampling)
    out = tgeom.foveated_disparity_to_pointcloud(port_rig(rig), tcfg, t(sh),
                                                 t(sv), img, src_level,
                                                 sampling)
    assert len(out) == len(ref)
    assert_cloud_close(out, ref)


@pytest.mark.parametrize("method,z_rtol", [("nearest", 0.0),
                                           ("bilinear", 1e-6),
                                           ("cubic", None)])
@pytest.mark.parametrize("factor", [0.5, 0.2])
def test_resized_pointcloud_matches_jax(method, z_rtol, factor):
    """Z is the resized range map: a nearest resize of the same map is
    exact and a bilinear one within 1e-6, so Z follows the triangulation's
    quantile rule; cubic (plain torch in both) likewise."""
    rig = jax_rig()
    dh, dv, img = cloud_inputs(40, 60)
    ref = jgeom.resized_pointcloud(rig, dh, dv, img, factor, method)
    out = tgeom.resized_pointcloud(port_rig(rig), t(dh), t(dv), img, factor,
                                   method)
    assert len(out) == int(40 * factor) * int(60 * factor)
    assert_cloud_close(out, ref)
    # the resize alone, on one range map: exact (nearest) or within z_rtol
    z = tgeom.range_map(rig.left.P, rig.right.P, t(dh), t(dv))
    oh, ow = int(40 * factor), int(60 * factor)
    mine = tgeom.pointcloud._resize(z, oh, ow, 1.0 / factor, method).numpy()
    theirs = np.asarray(jres.subsample(jnp.asarray(z.numpy()), oh, ow,
                                       1.0 / factor, method=method))
    np.testing.assert_allclose(mine, theirs, rtol=z_rtol or 1e-6, atol=0)
    if method == "nearest":
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("map_rgb", [False, True])
def test_foveated_range_map_and_resized_cloud_match_jax(method, map_rgb):
    rig = jax_rig()
    jcfg, tcfg = JaxConfig(fovea_level=3), MatcherConfig(fovea_level=3)
    H, W = 72, 96
    fh, fw = tcfg.fovea_dims(H, W)
    sh, sv, _ = cloud_inputs(3 * fh, fw, seed=21)
    img = cloud_inputs(H, W)[2]
    rmap = tgeom.foveated_range_map(port_rig(rig), tcfg, t(sh), t(sv),
                                    (H, W), src_level=1)
    assert isinstance(rmap, np.ndarray) and rmap.dtype == np.float32
    assert_rel_quantiles(rmap, jgeom.foveated_range_map(
        rig, jcfg, sh, sv, (H, W), src_level=1))
    ref = jgeom.foveated_resized_pointcloud(
        rig, jcfg, sh, sv, img, 0, 0.5, map_rgb, method)
    out = tgeom.foveated_resized_pointcloud(
        port_rig(rig), tcfg, sh, sv, img, 0, 0.5, map_rgb, method)
    assert len(out) == int(fh * 0.5) * int(fw * 0.5)
    assert_cloud_close(out, ref)


@pytest.mark.parametrize("binary", [True, False])
def test_save_pcd_and_ply_byte_identical_to_jax(tmp_path, binary):
    rng = np.random.RandomState(7)
    cloud = tgeom.PointCloud(
        xyz=(rng.randn(37, 3) * 100).astype(np.float32),
        rgb=(rng.rand(37, 3) * 255).astype(np.uint8))
    ref = jgeom.PointCloud(xyz=cloud.xyz.copy(), rgb=cloud.rgb.copy())
    tgeom.save_pcd(str(tmp_path / "a.pcd"), cloud, binary=binary)
    jgeom.save_pcd(str(tmp_path / "b.pcd"), ref, binary=binary)
    assert (tmp_path / "a.pcd").read_bytes() == \
        (tmp_path / "b.pcd").read_bytes()
    tgeom.save_ply(str(tmp_path / "a.ply"), cloud)
    jgeom.save_ply(str(tmp_path / "b.ply"), ref)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    assert b"element vertex 37" in (tmp_path / "a.ply").read_bytes()


# ---------------------------------------------------------------- cubic
@pytest.mark.parametrize("shape,out_hw,scale", [
    ((13, 17), (6, 8), 2.0), ((20, 30), (4, 6), 5.0),
    ((9, 11), (13, 15), 1 / 1.41421356), ((3, 16, 24), (11, 16), 1.41421356)])
def test_cubic_subsample_matches_jax_and_gold(shape, out_hw, scale):
    img = (np.random.RandomState(1).rand(*shape) * 40).astype(np.float32)
    out = tres.subsample(t(img), *out_hw, scale, method="cubic")
    ref = np.asarray(jres.subsample(jnp.asarray(img), *out_hw, scale,
                                    method="cubic"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    planes = img.reshape((-1,) + shape[-2:])
    gold = np.stack([gold_ops.subsample_cubic(p, *out_hw, scale)
                     for p in planes]).reshape(out.shape)
    np.testing.assert_allclose(out.numpy(), gold, rtol=1e-4, atol=1e-4)


def test_cubic_resample_coords_window_and_scale():
    img = (np.random.RandomState(2).rand(2, 21, 27) * 9).astype(np.float32)
    coord = lambda v: v / 1.41421356  # noqa: E731
    full = tres.resample_coords(t(img), 30, 38, coord, 1.41421356, "cubic")
    ref = np.asarray(jres.resample_coords(jnp.asarray(img), 30, 38, coord,
                                          1.41421356, "cubic"))
    np.testing.assert_allclose(full.numpy(), ref, rtol=1e-6, atol=1e-5)
    win = tres.resample_coords(t(img), 10, 12, coord, 1.41421356, "cubic",
                               row_off=7, col_off=9)
    assert torch.equal(win, full[:, 7:17, 9:21])


def test_cubic_tex_gather_matches_jax_and_gold():
    rng = np.random.RandomState(3)
    img = (rng.rand(15, 19) * 50).astype(np.float32)
    x = (rng.rand(7, 9) * 23 - 2).astype(np.float32)
    y = (rng.rand(7, 9) * 19 - 2).astype(np.float32)
    out = tres.tex_gather(t(img), t(x), t(y), "cubic")
    ref = np.asarray(jres.tex_gather(jnp.asarray(img), jnp.asarray(x),
                                     jnp.asarray(y), "cubic"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    gold = np.array([[gold_ops.tex_cubic(img, float(x[i, j]), float(y[i, j]))
                      for j in range(9)] for i in range(7)])
    np.testing.assert_allclose(out.numpy(), gold, rtol=1e-4, atol=1e-4)
    up = tres.upsample_disp(t(img), 21, 27, 1 / 1.41421356, 1.41421356,
                            "cubic")
    jup = np.asarray(jres.upsample_disp(jnp.asarray(img), 21, 27,
                                        1 / 1.41421356, 1.41421356, "cubic"))
    np.testing.assert_allclose(up.numpy(), jup, rtol=1e-6, atol=1e-5)


def test_cubic_stays_refused_by_the_kernels_and_the_matcher():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cres.resample_tex(torch.zeros(1, 8, 8), 4, 4, lambda v: v * 2,
                          method="cubic")
    from ug_stereomatcher_tpu_torch.config import check_supported
    with pytest.raises(NotImplementedError, match="refuse"):
        check_supported(MatcherConfig(interp="cubic"))
