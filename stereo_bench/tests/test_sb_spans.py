"""The readers of the program's spans and capture counter: nothing with
nothing recorded, the right number from totals filled by hand, and, on
the card, a number for every metric a cell lists in its traced run,
with one request span per request the harness timed."""

import types

import pytest

from stereo_bench import harness, spec

SPAN_METRICS = ["entry.upload_ms_per_pair", "entry.copy_ms_per_pair",
                "entry.copy_ms_per_pair.resident", "entry.self_ms_per_pair",
                "entry.self_ms_per_pair.resident", "mesh.copy_ms_per_pair"]
COUNTERS = ["entry.graph_captures", "entry.graph_captures.resident"]
RUN = types.SimpleNamespace(trace=None, cards=[0], pairs=0, launches=0,
                            pairs_traced=0, least_s=0.0, power_limit=None)

# what a traced window of 2 requests of 4 pairs each might leave
TOTALS = {
    "entry.request": {"count": 2, "host_s": 0.5, "self_s": 0.002,
                      "device_s": 0, "pairs": 8},
    "entry.upload": {"count": 2, "host_s": 0.12, "self_s": 0.12,
                     "device_s": 0.11, "pairs": 0},
    "graph.load": {"count": 2, "host_s": 0.001, "self_s": 0.001,
                   "device_s": 0.004, "pairs": 0},
    "graph.clone": {"count": 2, "host_s": 0.001, "self_s": 0.001,
                    "device_s": 0.002, "pairs": 0},
    "mesh.scatter": {"count": 2, "host_s": 0.003, "self_s": 0.001,
                     "device_s": 0.016, "pairs": 0},
    "mesh.gather": {"count": 2, "host_s": 0.002, "self_s": 0.002,
                    "device_s": 0.008, "pairs": 0},
}
EXPECTED = {"entry.upload_ms_per_pair": 15.0,       # 120 ms / 8 pairs
            "entry.copy_ms_per_pair": 0.75,         # (4 + 2) ms / 8
            "entry.copy_ms_per_pair.resident": 0.75,
            "entry.self_ms_per_pair": 0.25,         # 2 ms / 8
            "entry.self_ms_per_pair.resident": 0.25,
            "mesh.copy_ms_per_pair": 3.0}           # (16 + 8) ms / 8


@pytest.fixture
def profiling():
    from ug_stereomatcher_tpu_torch import profiling
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    profiling.reset_spans()
    _build.reset_launch_counts()
    yield profiling
    profiling.reset_spans()
    _build.reset_launch_counts()


@pytest.mark.parametrize("metric", SPAN_METRICS + COUNTERS)
def test_nothing_recorded_reads_nothing(profiling, metric):
    assert spec.reader(metric)(RUN) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_from_totals_filled_by_hand(profiling, monkeypatch,
                                                 metric):
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {k: dict(v) for k, v in TOTALS.items()})
    assert spec.reader(metric)(RUN) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", COUNTERS)
def test_capture_counter_reads_the_window(profiling, monkeypatch, metric):
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    assert spec.reader(metric)(RUN) == 0
    _build.record_capture()
    assert spec.reader(metric)(RUN) == 1


def test_a_program_without_spans_reads_nothing(profiling, monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    for metric in SPAN_METRICS + COUNTERS:
        assert spec.reader(metric)(RUN) is None


CELLS = ["ugsm_mode1.single", "ugsm_foveated.single", "ugsm_mode1.batch8",
         "ugsm_mode1.single_resident", "ugsm_mode1.dp4"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_every_listed_span_metric(profiling, workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    over = {"frame": [480, 640], "pool": 2, "warmup_calls": 2,
            "sample": {"calls": 1, "within": 2}}
    res = harness.run(workload, 2 ** 31 + 29, 1.0, True, overrides=over,
                      log=lambda *a, **k: None)
    assert res["correct"] is True, res["check"]
    totals = profiling.span_totals()
    assert totals["entry.request"]["count"] == res["attempted"]
    listed = [m["name"] for m in cell.per_layer
              if m["name"] in SPAN_METRICS + COUNTERS]
    assert listed
    for name in listed:
        assert name in res["metrics"], name
        if name in COUNTERS:
            assert res["metrics"][name]["value"] == 0, name
        else:
            assert res["metrics"][name]["value"] > 0, name
