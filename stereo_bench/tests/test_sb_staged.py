"""The reader of the program's upload counter, entry.staged_share:
nothing with nothing recorded or a program without the counter, the
right share from counts filled by hand, and, on the card, 1.0 in every
cell that lists it, whose pairs are host arrays."""

import types

import pytest

from stereo_bench import harness, spec

METRIC = "entry.staged_share"
RUN = types.SimpleNamespace(trace=None, cards=[0], pairs=0, launches=0,
                            pairs_traced=0, least_s=0.0, power_limit=None)
ONE_REQUEST = {"entry.request": {"count": 1, "host_s": 0.05, "self_s": 0.001,
                                 "device_s": 0, "pairs": 1}}


@pytest.fixture
def program(monkeypatch):
    from ug_stereomatcher_tpu_torch import profiling
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    profiling.reset_spans()
    _build.reset_launch_counts()
    monkeypatch.setattr(profiling, "span_totals", lambda: ONE_REQUEST)
    yield _build
    profiling.reset_spans()
    _build.reset_launch_counts()


def test_no_request_span_reads_nothing(program, monkeypatch):
    from ug_stereomatcher_tpu_torch import profiling
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    program.record_upload("staged", 96)
    assert spec.reader(METRIC)(RUN) is None


def test_no_bytes_uploaded_reads_nothing(program):
    assert spec.reader(METRIC)(RUN) is None


@pytest.mark.parametrize("staged,pinned,share", [
    (96, 0, 1.0), (0, 96, 0.0), (48, 16, 0.75)])
def test_share_of_the_counted_bytes(program, staged, pinned, share):
    program.record_upload("staged", staged)
    program.record_upload("pinned", pinned)
    assert spec.reader(METRIC)(RUN) == pytest.approx(share)


def test_a_program_without_the_counter_reads_nothing(program, monkeypatch):
    program.record_upload("staged", 96)
    monkeypatch.delattr(program, "upload_bytes")
    assert spec.reader(METRIC)(RUN) is None


CELLS = ["ugsm_mode1.single", "ugsm_foveated.single", "ugsm_mode1.batch8",
         "ugsm_mode1.dp4"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_traced_host_cells_stage_every_byte(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    assert METRIC in [m["name"] for m in cell.per_layer]
    over = {"frame": [480, 640], "pool": 2, "warmup_calls": 2,
            "sample": {"calls": 1, "within": 2}}
    res = harness.run(workload, 2 ** 31 + 31, 1.0, True, overrides=over,
                      log=lambda *a, **k: None)
    assert res["correct"] is True, res["check"]
    assert res["metrics"][METRIC]["value"] == 1.0
