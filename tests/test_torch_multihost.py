"""The port's multi-process tier (parallel/multihost.py, the mesh's owners
and the pair batch across processes) against the JAX package's.

``pod_mesh`` is built over synthetic slots on the CPU, on every topology
of tests/test_multihost.py, and its grid of (process, id) must equal the
JAX ``pod_mesh`` grid on the same topology (the 8 virtual CPU devices,
whose host is ``id // n_local`` as in that file, and its ``_FakeDev``
objects).  One and two CPU processes in a gloo group then match one
batch of three pairs (with two, uneven shares), and each must get the
single-process match of every pair bit for bit.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from tests.test_multihost import _FakeDev
from ug_stereomatcher_tpu.parallel import multihost as jmh
from ug_stereomatcher_tpu_torch.parallel import Mesh, Slot, make_mesh
from ug_stereomatcher_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVS = jax.devices()
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slots(n, n_local):
    """n CPU slots, host i // n_local, id i (the virtual devices' ids)."""
    return [Slot(CPU, i // n_local, i) for i in range(n)]


def grid(mesh):
    return [[(s.process_index, s.id) for s in row] for row in mesh.slots]


def jax_grid(mesh, n_local=None):
    """(host, id) of a JAX mesh: the device's own process_index, or
    id // n_local for the virtual CPU devices (all of process 0)."""
    return [[(d.id // n_local if n_local else d.process_index, d.id)
             for d in row] for row in np.array(mesh.devices)]


# ------------------------------------------------ pod_mesh on topologies
@pytest.mark.parametrize("n_local,rows_per_host", [
    (8, None), (8, 4), (4, 2), (4, 4), (2, 1), (1, 1)])
def test_shapes_and_axes(n_local, rows_per_host):
    mesh = tmh.pod_mesh(rows_per_host, devices=slots(8, n_local),
                        n_local=n_local)
    rph = rows_per_host or n_local
    assert mesh.shape == {"pairs": 8 // rph, "rows": rph}


def test_rows_axis_stays_in_one_process():
    for n_local, rph in [(4, 2), (4, 4), (8, 2), (2, 2), (8, 8)]:
        mesh = tmh.pod_mesh(rph, devices=slots(8, n_local), n_local=n_local)
        for row in mesh.slots:
            ids = [s.id for s in row]
            assert len({s.process_index for s in row}) == 1, ids
            assert ids == list(range(ids[0], ids[0] + len(ids)))


def test_all_devices_used_once():
    for n_local, rph in [(4, 2), (8, 4), (2, 1)]:
        mesh = tmh.pod_mesh(rph, devices=slots(8, n_local), n_local=n_local)
        assert sorted(s.id for row in mesh.slots for s in row) == \
            list(range(8))


def test_non_divisor_rows_clamped_down():
    mesh = tmh.pod_mesh(3, devices=slots(8, 4), n_local=4)
    assert mesh.shape == {"pairs": 4, "rows": 2}


def test_oversized_rows_clamped_to_local():
    mesh = tmh.pod_mesh(16, devices=slots(8, 4), n_local=4)
    assert mesh.shape["rows"] == 4


def test_ragged_topology_truncated():
    mesh = tmh.pod_mesh(None, devices=slots(7, 4), n_local=4)
    assert mesh.shape == {"pairs": 1, "rows": 4}
    assert grid(mesh) == [[(0, i) for i in range(4)]]


def interleaved():
    """2 hosts x 4 chips listed h0, h1, h0, h1, ..."""
    out = []
    for i in range(4):
        out += [(0, i), (1, 4 + i)]
    return out


def test_groups_by_process_not_list_order():
    mesh = tmh.pod_mesh(2, devices=[Slot(CPU, p, i) for p, i in
                                    interleaved()], n_local=4)
    assert mesh.shape == {"pairs": 4, "rows": 2}
    for row in mesh.slots:
        assert len({s.process_index for s in row}) == 1, row


def test_within_host_id_order():
    topo = [(1, 7), (0, 2), (1, 5), (0, 0)]
    mesh = tmh.pod_mesh(2, devices=[Slot(CPU, p, i) for p, i in topo],
                        n_local=2)
    assert [[s.id for s in row] for row in mesh.slots] == [[0, 2], [5, 7]]


# The topologies of tests/test_multihost.py: (rows_per_host, n_devices,
# n_local) on the virtual devices, then the _FakeDev lists.
VIRTUAL = [(None, 8, 8), (4, 8, 8), (2, 8, 4), (4, 8, 4), (1, 8, 2),
           (1, 8, 1), (2, 8, 2), (8, 8, 8), (3, 8, 4), (16, 8, 4),
           (None, 7, 4)]
FAKE = {"interleaved": (2, interleaved(), 4),
        "within_host": (2, [(1, 7), (0, 2), (1, 5), (0, 0)], 2)}


@pytest.mark.parametrize("rph,n,n_local", VIRTUAL)
def test_grid_equals_jax_on_virtual_devices(rph, n, n_local):
    want = jax_grid(jmh.pod_mesh(rph, devices=DEVS[:n], n_local=n_local),
                    n_local)
    got = tmh.pod_mesh(rph, devices=slots(n, n_local), n_local=n_local)
    assert grid(got) == want


@pytest.mark.parametrize("name", sorted(FAKE))
def test_grid_equals_jax_on_fake_devices(name):
    rph, topo, n_local = FAKE[name]
    want = jax_grid(jmh.pod_mesh(rph, devices=[_FakeDev(p, i)
                                               for p, i in topo],
                                 n_local=n_local))
    got = tmh.pod_mesh(rph, devices=[Slot(CPU, p, i) for p, i in topo],
                       n_local=n_local)
    assert grid(got) == want


def test_n_local_defaults_to_this_process_slots(monkeypatch):
    """Without n_local, the slots that this process (rank 0 here) drives;
    without devices, one slot per card, and no card raises."""
    mesh = tmh.pod_mesh(devices=slots(8, 2))
    assert mesh.shape == {"pairs": 4, "rows": 2}
    assert mesh.local_pairs() == [0] and mesh.local_pairs(3) == [3]
    assert mesh.local_devices() == [CPU]
    with pytest.raises(ValueError, match="drives none"):
        tmh.pod_mesh(devices=[Slot(CPU, 1, 0)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.pod_mesh()


CARD_SLOTS = {
    # (world, cards a host, ranks a host) -> (device index, rank, id)
    "two_ranks_one_card": ((2, 1, 1), [(0, 0, 0), (0, 1, 1)]),
    "one_rank_per_host": ((2, 4, 1), [(i, r, 4 * r + i) for r in range(2)
                                       for i in range(4)]),
    "torchrun_two_per_host": ((4, 2, 2), [(r % 2, r, r) for r in range(4)]),
    "torchrun_four_cards_each": ((2, 8, 2), [(4 * r + i, r, 4 * r + i)
                                              for r in range(2)
                                              for i in range(4)]),
    "ranks_outnumber_cards": ((2, 1, 2), [(0, 0, 0), (0, 1, 1)]),
}


@pytest.mark.parametrize("name", sorted(CARD_SLOTS))
def test_card_slots(name):
    args, want = CARD_SLOTS[name]
    assert [(s.device, s.process_index, s.id)
            for s in tmh.card_slots(*args)] == [
        (torch.device("cuda", d), r, i) for d, r, i in want]


def test_torchrun_ranks_drive_their_own_cards(monkeypatch):
    """Under torchrun --nproc-per-node=2 on hosts of two cards, pod_mesh()
    gives rank r card r % 2 alone, so no two ranks of a host share one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(tmh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmh.dist, "get_world_size", lambda: 4)
    for rank in range(4):
        monkeypatch.setattr(tmh.dist, "get_rank", lambda: rank)
        mesh = tmh.pod_mesh()
        assert mesh.shape == {"pairs": 4, "rows": 1}
        assert grid(mesh) == [[(r, r)] for r in range(4)]
        assert mesh.local_pairs() == [rank]
        assert mesh.local_devices() == [torch.device("cuda", rank % 2)]


# ------------------------------------------------------- mesh owners
def test_make_mesh_owns_every_entry_in_this_process():
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    assert grid(mesh) == [[(0, 0), (0, 1)], [(0, 2), (0, 3)]]
    assert not mesh.spans_processes()
    assert mesh.local_pairs() == [0, 1] and mesh.process_indices() == [0]


def test_rows_group_across_processes_raises():
    with pytest.raises(ValueError, match="spans processes"):
        Mesh([[Slot(CPU, 0, 0), Slot(CPU, 1, 1)]])
    mesh = Mesh([[Slot(CPU, 0, 0)], [Slot(CPU, 1, 1)]])
    assert mesh.spans_processes() and mesh.owner(1) == 1


def test_mesh_across_processes_needs_a_process_group():
    from ug_stereomatcher_tpu_torch import MatcherConfig
    from ug_stereomatcher_tpu_torch.parallel import make_batch_matcher

    mesh = Mesh([[Slot(CPU, 0, 0)], [Slot(CPU, 1, 1)]])
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        make_batch_matcher(MatcherConfig(), mesh)


# ------------------------------------------------- distributed_config
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_config_unconfigured(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert tmh.distributed_config() == (None, {})
    assert tmh.initialize_distributed() is False


def test_config_from_environment(monkeypatch):
    for k, v in zip(ENV, ("10.0.0.1", "1234", "4", "2")):
        monkeypatch.setenv(k, v)
    assert tmh.distributed_config() == (
        "10.0.0.1:1234", {"num_processes": 4, "process_id": 2})


def test_config_explicit_arguments_win(monkeypatch):
    for k, v in zip(ENV, ("10.0.0.1", "1234", "4", "2")):
        monkeypatch.setenv(k, v)
    assert tmh.distributed_config("other:9", num_processes=2,
                                  process_id=0) == (
        "other:9", {"num_processes": 2, "process_id": 0})


def test_backend_choice_and_no_fallback(monkeypatch):
    """NCCL for a CUDA device, gloo for the CPU, an explicit backend
    wins; an NCCL start that fails raises and nothing retries on gloo."""
    calls = []

    def init(backend, **kw):
        calls.append((backend, kw))
        if backend == "nccl":
            raise RuntimeError("nccl failed to start")

    monkeypatch.setattr(tmh.dist, "init_process_group", init)
    monkeypatch.setattr(tmh.dist, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="nccl failed"):
        tmh.initialize_distributed("h:1", 2, 0)
    assert [c[0] for c in calls] == ["nccl"]
    assert tmh.initialize_distributed("h:1", 2, 1, device="cpu") is True
    assert calls[-1] == ("gloo", {"init_method": "tcp://h:1",
                                  "world_size": 2, "rank": 1})
    tmh.initialize_distributed("h:1", 2, 0, backend="gloo")
    assert calls[-1][0] == "gloo" and len(calls) == 3
    with pytest.raises(ValueError, match="RANK"):
        tmh.initialize_distributed("h:1", 2)


# ------------------------------------------- two processes over gloo
_WORKER = textwrap.dedent("""
    import os
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, scene
    from ug_stereomatcher_tpu_torch.parallel import (
        Slot, batch_match, initialize_distributed, pod_mesh)

    world = int(os.environ["WORLD_SIZE"])
    assert initialize_distributed(device="cpu") == (world > 1)
    assert dist.get_backend() == "gloo"
    rank = dist.get_rank()
    cpu = torch.device("cpu")
    pairs = [scene.make_pair(48, 64, seed=s) for s in range(3)]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])
    lt = torch.from_numpy(left).permute(0, 3, 1, 2).float()
    rt = torch.from_numpy(right).permute(0, 3, 1, 2).float()
    cfg = MatcherConfig(fovea_level=3)
    eng = StereoEngine(cfg, device="cpu")
    singles = [eng.match(left[i], right[i]).triplet for i in range(3)]
    stacks = [eng.match_foveated(left[i], right[i]) for i in range(3)]

    # one slot a process: with two, pairs 0 and 2 on rank 0, 1 on rank 1
    mesh = pod_mesh(devices=[Slot(cpu, r, r) for r in range(world)])
    assert mesh.shape == {"pairs": world, "rows": 1}, mesh.shape
    assert mesh.local_pairs() == [rank]
    assert mesh.spans_processes() == (world > 1)
    out = batch_match(lt, rt, cfg, mesh=mesh)
    assert out.shape == (3, 3, 48, 64), out.shape
    for i in range(3):
        assert torch.equal(out[i], singles[i]), ("mode 1", i)
    fov = eng.match_batch(left, right, mesh=mesh, foveated=True)
    for i in range(3):
        s = stacks[i]
        for got, want in ((fov.stack_h, s.stack_h), (fov.stack_v, s.stack_v),
                          (fov.stack_c, s.stack_c)):
            assert torch.equal(got[i], want), ("mode 2", i)
    # two slots a process, one rows-group each: the hybrid across them
    hyb = pod_mesh(devices=[Slot(cpu, r, 2 * r + k)
                            for r in range(world) for k in range(2)])
    assert hyb.shape == {"pairs": world, "rows": 2}, hyb.shape
    out = batch_match(lt, rt, cfg, mesh=hyb)
    for i in range(3):
        assert torch.equal(out[i], singles[i]), ("hybrid", i)
    dist.destroy_process_group()
    print("OK", rank, dist.is_initialized())
""")


@pytest.mark.parametrize("world", [1, 2])
def test_processes_over_gloo_match_the_whole_batch(tmp_path, world):
    """One or two CPU processes in one gloo group, three pairs (with two,
    shares of 2 and 1): on every rank the whole batch, mode 1, mode 2
    and the hybrid, equals the single-process match per pair bit for bit.
    Skips only where the machine refuses local sockets."""
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    except OSError as e:
        pytest.skip(f"local sockets refused: {e}")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
           "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env={**env, "RANK": str(r)}, cwd=str(tmp_path),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=120)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for out, rc in outs:
        if rc != 0 and ("PermissionError" in out
                        or "Operation not permitted" in out):
            pytest.skip(f"local sockets refused: {out[-300:]}")
    for r, (out, rc) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
        assert f"OK {r} False" in out, out[-3000:]
