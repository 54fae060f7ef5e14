"""The port's row-sharded match (ug_stereomatcher_tpu_torch/parallel/) on
the CPU, against the port's unsharded engine and the JAX package.

The sharded code runs on a mesh of one repeated CPU device (``["cpu"] *
4``), as the JAX tests run on the virtual CPU devices of conftest.py.
Tolerances:

* every sharded stage against the port's unsharded one: bit for bit
  (each row-sharded form is an exact row slice of its unsharded form);
* the plain row-sharded forms against the JAX Pallas kernels run in
  interpret mode with ``row_halo=True``: the nearest warp bit for bit
  inside the TPU kernel's window (``warp_max_dy=8``,
  tests/test_sharding.py:124), the bilinear warp 1e-6, direction 5e-4 and
  smooth 1e-5 (the unsharded contracts of tests/test_torch_kernels.py);
* the sharded level against the JAX sharded level (fused body,
  interpret mode): 2e-4, the JAX package's own bound
  (tests/test_sharding.py:131).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from ug_stereomatcher_tpu import ops as J
from ug_stereomatcher_tpu import parallel as jpar
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.ops.pallas.direction import (
    HALO as JAX_DIR_HALO,
    fused_direction_update as p_direction,
)
from ug_stereomatcher_tpu.ops.pallas.smooth import (
    fused_smooth_average as p_smooth,
    smooth_halo_rows as jax_smooth_halo_rows,
)
from ug_stereomatcher_tpu.ops.pallas.warp import (
    warp_halo_rows,
    warp_windowed,
)
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch import pyramid as tpyr
from ug_stereomatcher_tpu_torch.ops.cuda import direction, smooth, warp
from ug_stereomatcher_tpu_torch.parallel import spatial

REPO = Path(__file__).resolve().parents[1]
CONSTS = (0.3, 0.2, 0.8, 0.9, 0.1)  # non-default on purpose
H, W, N_SHARDS = 40, 140, 4          # shards of 10 rows
SHARDS = {"top": 0, "middle": 1, "bottom": 3}


def mesh(pairs=1, rows=4):
    return par.make_mesh(pairs, rows, devices=["cpu"] * (pairs * rows))


def configs(**kw):
    """The same algorithm configuration in both packages."""
    jcfg = JaxConfig(**kw)
    return jcfg, MatcherConfig.from_reference(dataclasses.asdict(jcfg))


def t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def band(x, lo, hi):
    """Rows [lo, hi) of x (..., H, W), clamped to the image: the haloed
    block a row-sharded kernel takes."""
    return np.ascontiguousarray(
        x[..., np.clip(np.arange(lo, hi), 0, x.shape[-2] - 1), :])


def smooth_scene(rng, c, h, w):
    x = rng.rand(c, h, w).astype(np.float32) * 255
    for axis in (1, 2):
        x = 0.25 * np.roll(x, 1, axis) + 0.5 * x + 0.25 * np.roll(x, -1, axis)
    return x


# ------------------------------------- (a) the row-sharded kernel forms
@pytest.mark.parametrize("shard", sorted(SHARDS))
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_warp_row_halo_matches_pallas(shard, method):
    rng = np.random.RandomState(40 + SHARDS[shard])
    img = rng.rand(3, H, W).astype(np.float32)
    # inside the TPU kernel's window: |dv| <= VH - 1 = 7, |dh| <= 255
    dh = ((rng.rand(H, W) - 0.5) * 200).astype(np.float32)
    dv = ((rng.rand(H, W) - 0.5) * 12).astype(np.float32)
    a, b = spatial.row_splits(H, N_SHARDS)[SHARDS[shard]]
    vh = warp_halo_rows(8)
    ref = np.asarray(warp_windowed(
        jnp.asarray(band(img, a - vh, b + vh)), jnp.asarray(dh[a:b]),
        jnp.asarray(dv[a:b]), max_dy=8, interpret=True, row_halo=True,
        row0=a, global_h=H, method=method))
    out = warp.warp(t(img), t(dh[a:b]), t(dv[a:b]), method, row0=a)
    whole = warp.warp(t(img), t(dh), t(dv), method)
    assert torch.equal(out, whole[:, a:b])
    if method == "nearest":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shard", sorted(SHARDS))
def test_direction_row_halo_matches_pallas(shard):
    rng = np.random.RandomState(50 + SHARDS[shard])
    left = rng.rand(3, H, W).astype(np.float32) * 255
    warped = rng.rand(3, H, W).astype(np.float32) * 255
    bl2 = np.asarray(J.blur_gaussian_clamp(jnp.asarray(left * left)))
    disp = rng.rand(3, H, W).astype(np.float32) - 0.5
    a, b = spatial.row_splits(H, N_SHARDS)[SHARDS[shard]]
    replace = shard == "top"
    jh, th = JAX_DIR_HALO, direction.HALO
    ref = np.asarray(p_direction(
        jnp.asarray(band(left, a - jh, b + jh)),
        jnp.asarray(band(warped, a - jh, b + jh)), jnp.asarray(bl2[:, a:b]),
        jnp.asarray(disp[:, a:b]), 0.55, int(replace), tile_rows=16,
        tile_cols=128, consts=CONSTS, interpret=True, row_halo=True, row0=a,
        global_h=H))
    out = direction.fused_direction_update(
        t(band(left, a - th, b + th)), t(band(warped, a - th, b + th)),
        t(bl2[:, a:b]), t(disp[:, a:b]), 0.55, replace, CONSTS, row0=a,
        global_h=H)
    whole = direction.fused_direction_update(
        t(left), t(warped), t(bl2), t(disp), 0.55, replace, CONSTS)
    assert torch.equal(out, whole[:, a:b])
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("shard", sorted(SHARDS))
def test_smooth_row_halo_matches_pallas(shard):
    n = 5
    state = np.random.RandomState(60 + SHARDS[shard]).rand(
        3, H, W).astype(np.float32) + 0.05
    a, b = spatial.row_splits(H, N_SHARDS)[SHARDS[shard]]
    jh, th = jax_smooth_halo_rows(n), smooth.smooth_halo_rows(n)
    ref = np.asarray(p_smooth(
        jnp.asarray(band(state, a - jh, b + jh)), n_passes=n, tile_rows=16,
        tile_cols=128, interpret=True, row_halo=True, row0=a, global_h=H))
    out = smooth.fused_smooth_average(t(band(state, a - th, b + th)), n,
                                      row0=a, global_h=H)
    whole = smooth.fused_smooth_average(t(state), n)
    assert torch.equal(out, whole[:, a:b])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_row_halo_forms_check_their_bands():
    x = torch.zeros(3, 16, 20)
    with pytest.raises(ValueError, match="inside"):
        warp.warp(x, x[0, :6], x[0, :6], row0=12)
    with pytest.raises(ValueError, match="expected"):
        direction.fused_direction_update(x, x, x[:, :10], x[:, :10], 1.0,
                                         False, row0=2, global_h=16)
    with pytest.raises(ValueError, match="global_h"):
        smooth.fused_smooth_average(x, 2, row0=8, global_h=16)


# ------------------------------------------------------ halo primitives
@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_halo_pad_rows_reaches_past_neighbours(boundary):
    """A halo taller than a shard comes from several shards; outside the
    image it is zeros or the edge row."""
    x = torch.arange(3 * 13 * 5, dtype=torch.float32).reshape(3, 13, 5)
    blocks = spatial.RowBlocks.of(x).shard([torch.device("cpu")] * 4)
    assert [s.shape[-2] for s in blocks.shards] == [4, 4, 4, 1]
    pad = np.pad(x.numpy(), ((0, 0), (9, 9), (0, 0)),
                 mode="constant" if boundary == "zero" else "edge")
    for (a, b), got in zip(spatial.row_splits(13, 4),
                           spatial.halo_pad_rows(blocks, 9, boundary)):
        np.testing.assert_array_equal(got.numpy(), pad[:, a:b + 18])
    assert torch.equal(blocks.gather("cpu"), x)


def test_row_splits_needs_every_shard_non_empty():
    assert spatial.row_splits(30, 4) == [(0, 8), (8, 16), (16, 24), (24, 30)]
    with pytest.raises(ValueError, match="cannot row-shard H=9 over 4"):
        spatial.row_splits(9, 4)


# ------------------------ (b) the sharded level against match_level
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("level_index,is_coarsest", [(1, False), (6, True)])
def test_sharded_level_equals_match_level(interp, level_index, is_coarsest):
    """30 rows over 4 shards (8, 8, 8, 6); level 1 smooths 10 passes, so
    its 11-row halo reaches past the neighbouring shard; level 6 is the
    coarsest-replace path with 22 iterations."""
    rng = np.random.RandomState(70 + level_index)
    h, w = 30, 26
    left, right = (t(rng.rand(3, h, w).astype(np.float32) * 255)
                   for _ in range(2))
    disp = (t(rng.rand(3, h, w).astype(np.float32) - 0.5) if not is_coarsest
            else torch.zeros(3, h, w))
    cfg = MatcherConfig(interp=interp)
    ref = tmatch.match_level(left, right, disp, level_index, cfg, is_coarsest)
    out = par.sharded_match_level(left, right, disp, level_index, cfg,
                                  is_coarsest, mesh())
    assert [s.shape[-2] for s in out.shards] == [8, 8, 8, 6]
    assert torch.equal(out.gather("cpu"), ref)


# ---------------------- (c) the sharded level against the JAX package
def test_sharded_level_matches_jax_sharded_level():
    h, w = 64, 144
    rng = np.random.RandomState(107)
    left = rng.rand(3, h, w).astype(np.float32) * 255
    right = rng.rand(3, h, w).astype(np.float32) * 255
    disp = rng.rand(3, h, w).astype(np.float32) - 0.5
    jcfg, tcfg = configs(warp_max_dy=8)   # keep VH <= rows per shard
    mesh4 = JaxMesh(np.array(jax.devices()[:4]), axis_names=("rows",))
    ref = np.asarray(jpar.sharded_match_level(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp), 1, jcfg,
        False, mesh4, use_fused=True, interpret=True))
    out = par.sharded_match_level(t(left), t(right), t(disp), 1, tcfg, False,
                                  mesh()).gather("cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


# ------------------------------------- (d) pyramid, upsample and pair
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_sharded_pyramid_and_pair_equal_unsharded(interp):
    h, w = 64, 160
    rng = np.random.RandomState(117)
    left = t(smooth_scene(rng, 3, h, w))
    right = torch.roll(left, 2, -1)
    cfg = MatcherConfig(interp=interp)
    n = cfg.num_levels(h, w)
    m = mesh()
    lp, rp = tpyr.build_pyramid_pair(left, right, cfg, n)
    sp = par.sharded_build_pyramid(torch.cat([left, right]), cfg, n, m,
                                   min_rows_per_shard=8)
    # level 1 (45 rows) is row-sharded, level 2 (31 < 4 x 8 rows) whole
    assert [lv.sharded for lv in sp[:3]] == [False, True, False]
    for i, (lv, a, b) in enumerate(zip(sp, lp, rp)):
        assert torch.equal(lv.gather("cpu"), torch.cat([a, b])), i
    ref = tmatch.match_pyramid(lp, rp, cfg, (h, w))
    out = par.sharded_match_pair(left, right, cfg, m, min_rows_per_shard=8)
    assert len(out.levels) == n
    for i, (a, b) in enumerate(zip(out.levels, ref.levels)):
        assert torch.equal(a.gather("cpu"), b), i


@pytest.mark.parametrize("scale_conf", [True, False])
def test_sharded_upsample_equals_unsharded(scale_conf):
    cfg = MatcherConfig(interp="bilinear", scale_conf_on_upsample=scale_conf)
    disp = t((np.random.RandomState(402).rand(3, 33, 26).astype(np.float32)
              - 0.5) * 4)
    ref = tpyr.upsample_to_level(disp, 47, 37, cfg)
    m = mesh()
    for rows in (8, 64):   # row-sharded, and whole (too few rows)
        out = par.sharded_upsample_to_level(disp, 47, 37, cfg, m,
                                            min_rows_per_shard=rows)
        assert out.sharded == (rows == 8)
        assert torch.equal(out.gather("cpu"), ref)


# ------------------------------------------------------- (e) match_batch
@pytest.mark.parametrize("layout", ["hybrid", "round_robin", "no_mesh"])
def test_match_batch_equals_match_per_pair(layout):
    """B = 3 pairs: on a (2 pairs x 2 rows) mesh the second chunk holds one
    pair; on (2 x 1) pairs go round robin; without a mesh in turn."""
    rng = np.random.RandomState(80)
    b, h, w = 3, 48, 64
    left = smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
    right = np.roll(left, 1, axis=-1)
    eng = StereoEngine(device="cpu")
    m = {"hybrid": mesh(2, 2), "round_robin": mesh(2, 1),
         "no_mesh": None}[layout]
    res = eng.match_batch(left, right, mesh=m)
    assert res.disparity_h.shape == (b, h, w)
    assert eng.metrics["match_batch_s"] > 0
    if m is not None:   # the one-shot form, on (B, 3, H, W) float32
        assert torch.equal(par.batch_match(t(left), t(right), mesh=m),
                           res.triplet.transpose(0, 1))
    for i in range(b):
        single = eng.match(left[i], right[i])
        assert torch.equal(res.disparity_h[i], single.disparity_h), i
        assert torch.equal(res.disparity_v[i], single.disparity_v), i
        assert torch.equal(res.confidence[i], single.confidence), i


# ------------------------------------------------- (f) mesh and imports
def test_make_mesh_with_too_few_devices_raises():
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="needs 4 devices"):
            par.make_mesh(2, 2)   # the default devices are the CUDA cards
    with pytest.raises(ValueError, match="needs 4 devices"):
        par.make_mesh(2, 2, devices=["cpu"] * 3)
    m = par.make_mesh(2, 2, devices=["cpu"] * 4)
    assert m.shape == {"pairs": 2, "rows": 2}
    assert m.distinct_devices() == [torch.device("cpu")]
    assert par.mesh_shape_for(8, n_pairs=16) == (8, 1)
    p, r = par.mesh_shape_for(8, n_pairs=2)
    assert p * r == 8 and p <= 2


def test_parallel_imports_leave_jax_out():
    code = ("import sys, ug_stereomatcher_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ug_stereomatcher_tpu.'))"
            " or m == 'ug_stereomatcher_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for src in (REPO / "ug_stereomatcher_tpu_torch" / "parallel").glob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "ug_stereomatcher_tpu." not in \
            text.replace("ug_stereomatcher_tpu_torch.", ""), src.name
