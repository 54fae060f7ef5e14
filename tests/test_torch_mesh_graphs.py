"""The batch matcher's compile-once route (parallel/batch.py) and
profile_match's stages, on the CPU.

What runs here: which pairs of a batch go to which card's (or which
rows-group's, across cards) CUDA graph and which stay eager, on the CPU
(``card_plan``, on meshes of ``torch.device("cuda", k)`` objects, which
need no card), the mesh key and the matcher's graph key,
the engine's one matcher per key, and the CPU mesh route, which captures
nothing, against the per-pair match and the JAX package.  The graphs
themselves run on the card only (tests/test_torch_gpu.py).

Tolerances: the CPU mesh route (dp 2 x 1, sp 1 x 2 and hybrid 2 x 2 on
repeated CPU devices, modes 1 and 2, 72 x 96 with levels 0-2 row-sharded)
equals ``StereoEngine.match`` / ``match_foveated`` per pair bit for bit.
Against the JAX ``make_batch_matcher`` on the virtual CPU devices of
tests/conftest.py, on the same numpy inputs, the end-to-end maps are held
by tests/test_sharding.py's quantile rule (the free-running loop
amplifies float-contraction noise, so never by maxima): median |d| <
0.05 and a share of |d| > 0.5 under 0.05 (dp in mode 2, sp and hybrid
in mode 1, at 40 x 56).  profile_match on the
CPU stays eager, with its keys and its result (bit-equal to ``match``)
unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.parallel.batch import (
    make_batch_matcher as jax_batch_matcher,
)
from ug_stereomatcher_tpu.parallel.mesh import make_mesh as jax_mesh
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, scene
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch.graphs import graph_key
from ug_stereomatcher_tpu_torch.parallel.batch import (
    card_plan,
    make_batch_matcher,
)
from ug_stereomatcher_tpu_torch.parallel.mesh import Mesh, Slot, mesh_key

C0, C1, C2, C3 = (torch.device("cuda", k) for k in range(4))
H, W = 72, 96
FOVEA = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_process_mesh():
    return Mesh([[Slot(C0, 0, 0)], [Slot(C1, 1, 1)]])


# ------------------------------------------------------------ the card plan
# name -> (mesh, batch, rank, {card or cards: pairs}, eager pairs)
PLANS = {
    "repeated_card_sp": (lambda: par.make_mesh(1, 4, devices=[C0] * 4), 1,
                         0, {C0: [0]}, []),
    "repeated_card_hybrid": (lambda: par.make_mesh(2, 2, devices=[C0] * 4),
                             3, 0, {C0: [0, 1, 2]}, []),
    "dp_across_cards": (lambda: par.make_mesh(2, 1, devices=[C0, C1]), 5, 0,
                        {C0: [0, 2, 4], C1: [1, 3]}, []),
    "hybrid_across_cards": (lambda: par.make_mesh(
        2, 2, devices=[C0, C0, C1, C1]), 3, 0, {C0: [0, 2], C1: [1]}, []),
    "rows_across_cards": (lambda: par.make_mesh(1, 2, devices=[C0, C1]), 2,
                          0, {(C0, C1): [0, 1]}, []),
    "one_group_across_cards": (lambda: Mesh([[C0, C0], [C2, C3]]), 3, 0,
                               {C0: [0, 2], (C2, C3): [1]}, []),
    "cpu": (lambda: par.make_mesh(2, 2, devices=["cpu"] * 4), 3, 0, {},
            [0, 1, 2]),
    "two_processes_rank0": (two_process_mesh, 5, 0, {C0: [0, 2, 4]}, []),
    "two_processes_rank1": (two_process_mesh, 5, 1, {C1: [1, 3]}, []),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_card_plan(name):
    make, b, rank, cards, eager = PLANS[name]
    got_cards, got_eager = card_plan(make(), b, rank)
    assert got_cards == cards and list(got_cards) == list(cards)
    assert got_eager == eager


# ------------------------------------------------------------ the keys
def test_mesh_key_changes_with_shape_device_process_and_slot_order():
    base = par.make_mesh(2, 2, devices=[C0] * 4)
    assert mesh_key(base) == mesh_key(par.make_mesh(2, 2, devices=[C0] * 4))
    assert mesh_key(None) is None
    others = [
        par.make_mesh(1, 4, devices=[C0] * 4),             # shape
        par.make_mesh(4, 1, devices=[C0] * 4),
        par.make_mesh(2, 2, devices=[C0, C0, C0, C1]),     # a slot's device
        par.make_mesh(2, 2, devices=["cpu"] * 4),
        Mesh([[Slot(C0, 0, 1), Slot(C0, 0, 0)],            # slot order
              [Slot(C0, 0, 2), Slot(C0, 0, 3)]]),
        Mesh([[Slot(C0, 1, 0), Slot(C0, 1, 1)],            # the process
              [Slot(C0, 1, 2), Slot(C0, 1, 3)]]),
    ]
    keys = {mesh_key(m) for m in [base] + others}
    assert len(keys) == 1 + len(others)
    assert mesh_key(par.make_mesh(1, 2, devices=[C0, C1])) != mesh_key(
        par.make_mesh(1, 2, devices=[C1, C0]))


def test_matcher_key_changes_with_batch_shape_foveated_and_mesh():
    cfg = MatcherConfig(fovea_level=FOVEA)
    mesh = par.make_mesh(1, 4, devices=[C0] * 4)
    m = make_batch_matcher(cfg, mesh)
    shape = (2, 3, H, W)
    base = m.key(shape)
    assert base == make_batch_matcher(
        cfg, par.make_mesh(1, 4, devices=[C0] * 4)).key(shape)
    assert base == graph_key("match_batch", shape, cfg, None, False) + (
        mesh_key(mesh),)
    others = [m.key((3, 3, H, W)), m.key((2, 3, H + 8, W)),
              make_batch_matcher(cfg, mesh, foveated=True).key(shape),
              make_batch_matcher(cfg, par.make_mesh(
                  2, 2, devices=[C0] * 4)).key(shape),
              make_batch_matcher(cfg, None, C0).key(shape),
              make_batch_matcher(MatcherConfig(fovea_level=FOVEA,
                                               interp="bilinear"),
                                 mesh).key(shape)]
    assert len({base, *others}) == 1 + len(others)
    assert m.graphs == {} and m.route is None


# ------------------------------------------------------------ the engine
def pairs(b, seed=0, h=H, w=W):
    ps = [scene.make_pair(h, w, seed=seed + k) for k in range(b)]
    return tuple(np.stack([p[i] for p in ps]) for i in (0, 1))


def test_engine_keeps_one_matcher_per_key_and_captures_nothing():
    eng = StereoEngine(MatcherConfig(fovea_level=FOVEA), device="cpu")
    left, right = pairs(1, h=48, w=64)
    sp = par.make_mesh(1, 2, devices=["cpu"] * 2)
    calls = [(sp, False, 1), (sp, False, 1),
             (par.make_mesh(1, 2, devices=["cpu"] * 2), False, 1),
             (sp, True, 2), (par.make_mesh(2, 1, devices=["cpu"] * 2),
                             False, 3), (None, False, 4), (None, False, 4)]
    first = None
    for mesh, fov, n in calls:
        eng.match_batch(left, right, mesh=mesh, foveated=fov)
        assert len(eng.matchers) == n
        assert eng.metrics["match_batch_route"] == "eager"
        first = first or eng.matchers[(mesh_key(sp), False)]
        assert eng.matchers[(mesh_key(sp), False)] is first
    assert eng.graphs == {}
    assert all(m.graphs == {} for m in eng.matchers.values())


# --------------------------------------------------- the CPU mesh route
ROUTES = {"dp": (2, 1, 3), "sp": (1, 2, 1), "hybrid": (2, 2, 3)}


def planes(res, foveated, dim=1):
    names = (("stack_h", "stack_v", "stack_c") if foveated else
             ("disparity_h", "disparity_v", "confidence"))
    return torch.stack([getattr(res, n) for n in names], dim=dim)


@pytest.mark.parametrize("foveated", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cpu_mesh_route_equals_match_per_pair(route, foveated):
    p, r, b = ROUTES[route]
    cfg = MatcherConfig(fovea_level=FOVEA)
    eng = StereoEngine(cfg, device="cpu")
    mesh = par.make_mesh(p, r, devices=["cpu"] * (p * r))
    left, right = pairs(b, seed=10)
    out = planes(eng.match_batch(left, right, mesh=mesh, foveated=foveated),
                 foveated)
    matcher = eng.matchers[(mesh_key(mesh), foveated)]
    assert matcher.route == "eager" and matcher.graphs == {}
    for i in range(b):
        if foveated:
            ref = planes(eng.match_foveated(left[i], right[i]), True, 0)
        else:
            ref = eng.match(left[i], right[i]).triplet
        assert torch.equal(out[i], ref), (route, i)
    # the module matcher, float32 CHW input, the same bits
    lt, rt = (torch.from_numpy(x).permute(0, 3, 1, 2).float()
              for x in (left, right))
    assert torch.equal(make_batch_matcher(cfg, mesh, foveated=foveated)(
        lt, rt), out)


# route -> (JAX mesh shape, batch, foveated), at 40 x 56 (level 0
# row-sharded on two shards) to keep the JAX compiles short
JAX_CASES = {"dp": ((2, 1), 2, True), "sp": ((1, 2), 1, False),
             "hybrid": ((2, 2), 2, False)}
JH, JW = 40, 56


@pytest.mark.parametrize("route", sorted(JAX_CASES))
def test_cpu_mesh_route_against_jax_batch_matcher(route):
    (p, r), b, foveated = JAX_CASES[route]
    rng = np.random.RandomState(90 + p * 10 + r)
    base = rng.rand(b, 3, JH, JW + 8).astype(np.float32) * 255
    for _ in range(2):   # a smooth, matchable scene (test_sharding.py)
        base[..., 1:-1, :] = (base[..., :-2, :] + base[..., 1:-1, :]
                              + base[..., 2:, :]) / 3
        base[..., 1:-1] = (base[..., :-2] + base[..., 1:-1]
                           + base[..., 2:]) / 3
    left, right = base[..., 4:JW + 4], base[..., 2:JW + 2]
    left, right = np.ascontiguousarray(left), np.ascontiguousarray(right)
    out = make_batch_matcher(
        MatcherConfig(fovea_level=FOVEA), par.make_mesh(
            p, r, devices=["cpu"] * (p * r)), foveated=foveated)(
        torch.from_numpy(left), torch.from_numpy(right)).numpy()
    jfn = jax_batch_matcher(JaxConfig(fovea_level=FOVEA), JH, JW,
                            jax_mesh(p, r), foveated=foveated)
    ref = np.asarray(jfn(jnp.asarray(left), jnp.asarray(right)))
    assert out.shape == ref.shape
    for i in range(b):
        d = np.abs(out[i] - ref[i])
        assert np.median(d) < 0.05, (route, i, np.median(d))
        assert (d > 0.5).mean() < 0.05, (route, i, (d > 0.5).mean())


# ------------------------------------------------------- profile_match
def test_profile_match_on_cpu_stays_eager_with_its_keys():
    cfg = MatcherConfig(fovea_level=FOVEA, interp="bilinear")
    left, right = scene.make_pair(H, W, seed=4)
    n = cfg.num_levels(H, W)
    for gate in (None, 0):
        eng = StereoEngine(cfg, device="cpu", resident_max_pixels=gate)
        res, prof = eng.profile_match(left, right)
        assert torch.equal(res.triplet, eng.match(left, right).triplet)
        assert eng.graphs == {} and eng.metrics["profile"] is prof
        assert set(prof) == {"pyramid_build_s", "levels", "match_total_s",
                             "total_s"}
        assert sorted(prof["levels"]) == [f"level_{i:02d}" for i in range(n)]
        dims = cfg.dims_chain(H, W)
        for i in range(n):
            lvl = prof["levels"][f"level_{i:02d}"]
            want = {"match_s", "height", "width", "iterations"}
            assert set(lvl) == (want | {"upsample_s"} if i else want)
            assert (lvl["height"], lvl["width"]) == tuple(dims[i])
            assert lvl["iterations"] == cfg.iters_for_level(i)
            assert lvl["match_s"] >= 0
