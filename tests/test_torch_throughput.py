"""The port's scaling harness (parallel/throughput.py) and device trace
(profiling.device_trace): the TestThroughput cases of
tests/test_service_throughput.py on meshes of the CPU repeated, the mesh
shape of every point equal to the JAX harness's, and the trace written on
the CPU (the counterpart of tests/test_aux.py's device_trace case)."""

import json

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu.parallel import throughput as jtp
from ug_stereomatcher_tpu_torch import MatcherConfig
from ug_stereomatcher_tpu_torch.parallel import (
    make_batch_matcher,
    make_mesh,
    measure_throughput,
)
from ug_stereomatcher_tpu_torch.parallel import throughput as ttp
from ug_stereomatcher_tpu_torch.profiling import device_trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(n):
    return ["cpu"] * n


def test_scaling_on_cpu_mesh():
    pts = measure_throughput(height=48, width=64, device_counts=[1, 4],
                             repeats=2, devices=cpus(4))
    assert [p.n_devices for p in pts] == [1, 4]
    assert [p.batch for p in pts] == [1, 4]
    assert pts[0].pairs_per_second > 0 and pts[0].seconds_per_batch > 0
    assert pts[0].scaling_efficiency == 1.0
    assert pts[-1].mesh_shape == (4, 1)
    # the mesh repeats the CPU: only the one-device point is not
    assert [p.oversubscribed for p in pts] == [False, True]


def test_foveated_dp_scaling():
    pts = measure_throughput(height=48, width=64, device_counts=[1, 2],
                             repeats=1, cfg=MatcherConfig(fovea_level=3),
                             foveated=True, devices=cpus(2))
    assert pts[0].pairs_per_second > 0
    assert pts[-1].mesh_shape == (2, 1)
    with pytest.raises(ValueError, match="fovea_level"):
        measure_throughput(height=16, width=16, device_counts=[1],
                           foveated=True, devices=cpus(1))


def test_sp_mode_row_shards_one_pair():
    pts = measure_throughput(height=96, width=64, device_counts=[1, 4],
                             repeats=1, mode="sp", devices=cpus(4))
    assert [p.batch for p in pts] == [1, 1]
    assert pts[-1].mesh_shape == (1, 4)
    assert pts[-1].pairs_per_second > 0


def test_hybrid_mode_mesh_shape():
    pts = measure_throughput(height=96, width=64, device_counts=[1, 3, 4],
                             repeats=1, mode="hybrid", devices=cpus(4))
    assert [p.n_devices for p in pts] == [1, 4]   # odd counts dropped
    assert pts[-1].mesh_shape == (2, 2)
    assert pts[-1].batch == 2


def test_hybrid_equals_pairs_only_when_batch_lt_devices():
    """batch 2 on four devices: pairs only leaves two groups idle, the
    hybrid row-shards each pair over its rows-group.  In the JAX package
    the two partitionings agree under a quantile rule; here every sharded
    stage is an exact row slice of its unsharded one, so they agree bit
    for bit."""
    cfg = MatcherConfig()
    h, w = 128, 160
    rng = np.random.RandomState(0)
    base = rng.rand(2, 3, h // 8, w // 8).astype(np.float32) * 255
    lb = torch.from_numpy(np.kron(base, np.ones((1, 1, 8, 8), np.float32)))
    rb = torch.roll(lb, 2, dims=-1)
    dp = make_batch_matcher(cfg, make_mesh(4, 1, devices=cpus(4)))
    hyb = make_batch_matcher(cfg, make_mesh(2, 2, devices=cpus(4)))
    out_dp, out_hyb = dp(lb, rb), hyb(lb, rb)
    assert out_dp.shape == out_hyb.shape == (2, 3, h, w)
    assert torch.equal(out_dp, out_hyb)


@pytest.mark.parametrize("mode", ["dp", "sp", "hybrid"])
def test_mesh_shape_equals_jax(mode):
    for nd in range(1, 9):
        for ppd in (1, 2):
            assert ttp._mesh_shape(mode, nd, ppd) == \
                jtp._mesh_shape(mode, nd, ppd), (nd, ppd)
    with pytest.raises(ValueError, match="unknown scaling mode"):
        ttp._mesh_shape(mode + "x", 1, 1)


def test_measure_throughput_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_throughput(height=48, width=64)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with device_trace(str(tmp_path / "trace")):
        (x @ x).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(ev.get("name", "")) for ev in events)
