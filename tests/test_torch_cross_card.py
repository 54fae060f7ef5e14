"""A rows-group across cards, on the CPU: the band plan, the card plan and
the band path end to end.

What runs here: the halo bands that ``halo_pad_rows`` writes into given
buffers (``RowBlocks.rows_into``: each piece copied straight to its
place, as between cards) against the padded whole image and against the
bands it allocates, bit for bit, on ``["cpu"] * k`` shards for k = 2, 3,
4 with halos of 1 and 2 rows and one taller than a shard, at both image
edges, with the ``"zero"`` and ``"clamp"`` boundaries; the band plan
(``_pieces``) of a halo over several shards; ``card_plan`` on meshes of
``torch.device("cuda", k)`` objects (which need no card): groups on one
card, on several cards, both, and across two ranks; a graph across cards
refusing a CPU peer; and a CPU rows mesh through the band path bit-equal
to ``StereoEngine.match`` / ``match_foveated`` per pair.  The graphs
themselves run on the card only (tests/test_torch_gpu.py).

Tolerance: every comparison is exact (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, scene
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch.graphs import CapturedCall
from ug_stereomatcher_tpu_torch.parallel import spatial
from ug_stereomatcher_tpu_torch.parallel.batch import card_plan
from ug_stereomatcher_tpu_torch.parallel.mesh import Mesh, Slot

C0, C1, C2, C3 = (torch.device("cuda", k) for k in range(4))
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the bands
def padded(x: torch.Tensor, halo: int, boundary: str) -> np.ndarray:
    """The whole image with ``halo`` rows of the boundary above and below."""
    return np.pad(x.numpy(), ((0, 0), (halo, halo), (0, 0)),
                  mode="constant" if boundary == "zero" else "edge")


@pytest.mark.parametrize("boundary", ["zero", "clamp"])
@pytest.mark.parametrize("halo", [1, 2, "tall"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_bands_equal_the_padded_image(k, halo, boundary):
    """Bands written into given buffers (every row overwritten: they start
    as NaN) equal the padded image's rows and halo_pad_rows's own bands,
    bit for bit, on every shard, the first and last at the image's
    edges; a second write into the same bands gives the same bits."""
    h = 3 * k + 2
    x = torch.from_numpy(np.random.RandomState(k).rand(3, h, 7)
                         .astype(np.float32))
    blocks = spatial.RowBlocks.of(x).shard([CPU] * k)
    hl = blocks.shards[0].shape[-2]
    halo = hl + 2 if halo == "tall" else halo
    pad = padded(x, halo, boundary)
    bands = [torch.full((3, s.shape[-2] + 2 * halo, 7), float("nan"))
             for s in blocks.shards]
    fresh = spatial.halo_pad_rows(blocks, halo, boundary)
    for _ in range(2):
        got = spatial.halo_pad_rows(blocks, halo, boundary, out=bands)
        assert all(g is b for g, b in zip(got, bands))
        for (a, b), band, new in zip(spatial.row_splits(h, k), got, fresh):
            np.testing.assert_array_equal(band.numpy(), pad[:, a:b + 2 * halo])
            assert torch.equal(band, new)


@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_rows_of_whole_and_sharded_arrays(boundary):
    """rows() of any window (inside, over an edge, over the whole image)
    from a sharded array and from a whole one: the padded image's rows;
    a window one shard holds is that shard's view."""
    x = torch.arange(2 * 11 * 4, dtype=torch.float32).reshape(2, 11, 4)
    pad = padded(x, 5, boundary)
    for arr in (spatial.RowBlocks.of(x).shard([CPU] * 3),
                spatial.RowBlocks.of(x)):
        for lo, hi in ((-5, 3), (2, 9), (8, 16), (-5, 16), (0, 11)):
            np.testing.assert_array_equal(
                arr.rows(lo, hi, CPU, boundary).numpy(),
                pad[:, lo + 5:hi + 5])
    sharded = spatial.RowBlocks.of(x[:1].contiguous()).shard([CPU] * 3)
    assert sharded.rows(4, 6, CPU).data_ptr() == \
        sharded.shards[1][..., 0:2, :].data_ptr()


def test_band_plan_of_a_halo_over_several_shards():
    """The rows [1, 8) of 12 rows in 4 shards of 3: the last two rows of
    shard 0, all of shard 1, the first two of shard 2."""
    assert spatial._pieces(12, 4, 1, 8) == ((0, 1, 3), (1, 0, 3), (2, 0, 2))
    assert spatial._pieces(12, 4, 3, 6) == ((1, 0, 3),)


def test_rows_outside_the_image_raise():
    blocks = spatial.RowBlocks.of(torch.zeros(1, 6, 2)).shard([CPU] * 2)
    with pytest.raises(ValueError, match="miss"):
        blocks.rows_into(torch.empty(1, 2, 2), 7)


# ------------------------------------------------------------ the card plan
def two_ranks():
    return Mesh([[Slot(C0, 0, 0), Slot(C1, 0, 1)],
                 [Slot(C2, 1, 2), Slot(C3, 1, 3)]])


# name -> (mesh, batch, rank, {card or cards: pairs}, eager pairs)
PLANS = {
    "rows_over_two_cards": (lambda: par.make_mesh(1, 2, devices=[C0, C1]),
                            3, 0, {(C0, C1): [0, 1, 2]}, []),
    "rows_over_four_cards": (lambda: par.make_mesh(
        1, 4, devices=[C0, C1, C2, C3]), 1, 0, {(C0, C1, C2, C3): [0]}, []),
    "rows_in_row_order": (lambda: par.make_mesh(1, 2, devices=[C1, C0]), 1,
                          0, {(C1, C0): [0]}, []),
    "two_shards_a_card": (lambda: Mesh([[C0, C0, C1, C1]]), 2, 0,
                          {(C0, C1): [0, 1]}, []),
    "hybrid_over_cards": (lambda: par.make_mesh(
        2, 2, devices=[C0, C1, C2, C3]), 5, 0,
        {(C0, C1): [0, 2, 4], (C2, C3): [1, 3]}, []),
    "groups_on_the_same_cards": (lambda: Mesh([[C0, C1], [C0, C1]]), 3, 0,
                                 {(C0, C1): [0, 1, 2]}, []),
    "one_card_and_several": (lambda: Mesh([[C0, C0], [C1, C2]]), 4, 0,
                             {C0: [0, 2], (C1, C2): [1, 3]}, []),
    "a_card_and_the_cpu": (lambda: Mesh([[C0, "cpu"], [C1, C1]]), 3, 0,
                           {C1: [1]}, [0, 2]),
    "two_ranks_rank0": (two_ranks, 4, 0, {(C0, C1): [0, 2]}, []),
    "two_ranks_rank1": (two_ranks, 4, 1, {(C2, C3): [1, 3]}, []),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_card_plan_across_cards(name):
    make, b, rank, cards, eager = PLANS[name]
    got_cards, got_eager = card_plan(make(), b, rank)
    assert got_cards == cards and list(got_cards) == list(cards)
    assert got_eager == eager


def test_a_graph_across_cards_needs_cuda_peers():
    with pytest.raises(ValueError, match="CUDA devices"):
        CapturedCall(lambda x: x, [(1,)], C0, [C1, CPU])
    with pytest.raises(ValueError, match="CUDA devices"):
        CapturedCall(lambda x: x, [(1,)], CPU)


# ------------------------------------------- a CPU rows mesh, end to end
H, W = 128, 160


@pytest.mark.parametrize("foveated", [False, True])
@pytest.mark.parametrize("rows", [3, 4])
def test_cpu_rows_mesh_equals_match_per_pair(rows, foveated):
    """1 x 3 and 1 x 4 rows meshes of the CPU (levels 0-2 row-sharded, a
    level's bands reused on every iteration) through the band path: each
    pair equal to match (match_foveated) bit for bit."""
    cfg = MatcherConfig(fovea_level=3)
    eng = StereoEngine(cfg, device="cpu")
    pairs = [scene.make_pair(H, W, seed=s) for s in (3, 4)]
    left, right = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    mesh = par.make_mesh(1, rows, devices=["cpu"] * rows)
    res = eng.match_batch(left, right, mesh=mesh, foveated=foveated)
    assert eng.metrics["match_batch_route"] == "eager"
    for i in range(2):
        if foveated:
            single = eng.match_foveated(left[i], right[i])
            got = torch.stack([res.stack_h[i], res.stack_v[i],
                               res.stack_c[i]])
            ref = torch.stack([single.stack_h, single.stack_v,
                               single.stack_c])
        else:
            got, ref = res.triplet[:, i], eng.match(left[i], right[i]).triplet
        assert torch.equal(got, ref), (rows, foveated, i)
