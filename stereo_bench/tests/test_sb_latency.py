"""The per-layer tail, entry.latency_ms_p95: nothing without requests,
the end-to-end metric's arithmetic on the same latencies, and a traced
CPU run of each cell that lists it reads it."""

import types

import pytest

from stereo_bench import spec, stats
from stereo_bench.tests.helpers import cpu_run

METRIC = "entry.latency_ms_p95"


@pytest.mark.parametrize("latencies", [None, []])
def test_no_request_reads_nothing(latencies):
    run = types.SimpleNamespace(pairs=0, latencies_s=latencies)
    assert spec.reader(METRIC)(run) is None
    assert spec.reader(METRIC)(types.SimpleNamespace(pairs=0)) is None


def test_the_same_percentile_as_the_end_to_end_metric():
    lat = [0.001 * (1 + (7 * i) % 40) for i in range(200)]
    run = types.SimpleNamespace(pairs=len(lat), latencies_s=lat)
    assert spec.reader(METRIC)(run) == \
        stats.window_metrics(lat, 1, 1.0)["latency_ms_p95"]


def _cells():
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == METRIC]
    return m["workloads"]


def test_listed_cells_have_no_end_to_end_tail():
    tails = {m["name"]: m for m in spec.benchmark()["end_to_end"]}
    assert not set(_cells()) & set(tails["latency_ms_p95"]["workloads"])


@pytest.mark.parametrize("cell", _cells())
def test_a_traced_cpu_run_reads_it(cell):
    res = cpu_run(cell, traced=True)
    assert res["metrics"][METRIC]["value"] > 0
    assert res["metrics"][METRIC]["unit"] == "ms"
