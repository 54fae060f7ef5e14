"""The port's spans (profiling.span) on the CPU.

Under ``torch.profiler`` an entry point leaves its spans in the exported
trace, nested in one another (``entry.request`` around ``entry.upload``,
the mesh's ``mesh.scatter`` and ``mesh.gather`` and ``entry.sync``), with
one request id in their args (recorded with ``record_shapes=True``) and
on the trace's clock: the request's own torch operators lie inside it.
``span_totals()`` counts each request once with the pairs it served,
self seconds are host seconds less the children's, and with tracing off
an entry point enters no ``record_function``, records no event, makes no
span and leaves the totals empty.  The device seconds, and the capture
counter on a real capture, are tested on the card
(tests/test_torch_gpu.py)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, profiling
from ug_stereomatcher_tpu_torch import scene
from ug_stereomatcher_tpu_torch.ops.cuda import _build
from ug_stereomatcher_tpu_torch.parallel import make_mesh

H, W = 64, 96
VIEWS = ("aten::select", "aten::slice", "aten::as_strided")
CFG = MatcherConfig(fovea_level=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def pair():
    return scene.make_pair(H, W)


@pytest.fixture(scope="module")
def engine():
    return StereoEngine(CFG, device="cpu")


def single(engine, pair):
    engine.match(*pair)


def mesh_batch(engine, pair):
    left, right = (np.stack([x] * 4) for x in pair)
    engine.match_batch(left, right,
                       mesh=make_mesh(4, 1, devices=["cpu"] * 4))


ENTRIES = {"match": (single, 1, ["entry.upload", "entry.sync"]),
           "match_batch_mesh": (mesh_batch, 4,
                                ["entry.upload", "mesh.scatter",
                                 "mesh.gather", "entry.sync"])}


def traced(fn, tmp_path):
    """Run ``fn`` under torch.profiler (inputs recorded) and return the
    exported trace's complete events."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_spans_nest_in_the_trace_with_one_request_id(
        entry, engine, pair, tmp_path):
    fn, pairs, children = ENTRIES[entry]
    events = traced(lambda: fn(engine, pair), tmp_path)
    (req,) = [e for e in events if e["name"] == profiling.REQUEST]
    assert req["args"]["pairs"] == pairs
    rid = req["args"]["request"]
    assert rid > 0
    end = req["ts"] + req["dur"]
    for name in children:
        spans = [e for e in events if e["name"] == name]
        assert spans, name
        for s in spans:
            assert req["ts"] <= s["ts"] and s["ts"] + s["dur"] <= end, name
            assert s["args"]["request"] == rid, name
    # the profiler's own operator events of the match lie inside it, all
    # but the views of the result that the entry point takes after it
    ops = [e for e in events if e["name"].startswith("aten::")
           and e["name"] not in VIEWS]
    assert ops and all(req["ts"] <= e["ts"] <= end for e in ops)
    totals = profiling.span_totals()
    assert totals[profiling.REQUEST]["count"] == 1
    assert totals[profiling.REQUEST]["pairs"] == pairs
    for name in children:
        assert totals[name]["count"] >= 1
        assert totals[name]["device_s"] == 0   # no card here


def test_two_requests_take_two_ids(engine, pair, tmp_path):
    events = traced(lambda: [single(engine, pair) for _ in range(2)],
                    tmp_path)
    ids = [e["args"]["request"] for e in events
           if e["name"] == profiling.REQUEST]
    up = [e["args"]["request"] for e in events
          if e["name"] == "entry.upload"]
    assert len(set(ids)) == 2 and sorted(up) == sorted(ids)
    assert profiling.span_totals()[profiling.REQUEST]["count"] == 2


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_tracing_off_records_nothing(entry, engine, pair, monkeypatch):
    made = []

    def counting(name):
        def fn(*args, **kwargs):
            made.append(name)
            raise AssertionError(f"{name} made with tracing off")
        return fn
    monkeypatch.setattr(profiling, "_Span", counting("span"))
    monkeypatch.setattr(profiling, "_annotation", counting("annotation"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", counting("event"))
    assert not profiling.tracing()
    ENTRIES[entry][0](engine, pair)
    assert made == [] and profiling.span_totals() == {}


def test_collecting_counts_host_self_and_pairs(monkeypatch):
    clock = iter([1.0, 1.5, 1.75, 2.0, 3.0, 4.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    assert not profiling.tracing()
    with profiling.collecting():
        assert profiling.tracing()
        with profiling.span("outer", pairs=2):         # 1.0 - 4.0
            with profiling.span("inner"):              # 1.5 - 1.75
                pass
            with profiling.span("inner"):              # 2.0 - 3.0
                pass
    assert not profiling.tracing()
    t = profiling.span_totals()
    assert t["outer"] == {"count": 1, "host_s": 3.0, "self_s": 1.75,
                          "device_s": 0, "pairs": 2}
    assert t["inner"] == {"count": 2, "host_s": 1.25, "self_s": 1.25,
                          "device_s": 0, "pairs": 0}


def test_start_and_stop_share_the_callers_clock_reads(monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: pytest.fail("the span read the clock"))
    with profiling.collecting():
        with profiling.span("request", pairs=1, start=10.0) as s:
            s.stop(10.25)
    assert profiling.span_totals()["request"]["host_s"] == 0.25


def test_request_span_and_timings_share_their_clock_reads(pair):
    eng = StereoEngine(CFG, device="cpu")
    with profiling.collecting():
        eng.match(*pair)
    req = profiling.span_totals()[profiling.REQUEST]
    assert req["count"] == 1
    assert req["host_s"] == eng.timings.total["match"]
    assert round(req["host_s"], 6) == eng.metrics["match_s"]


def test_cpu_devices_get_no_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: pytest.fail("an event on the CPU"))
    with profiling.collecting():
        with profiling.span("x", device=[torch.device("cpu"),
                                         torch.zeros(1)]):
            pass
    assert profiling.span_totals()["x"]["device_s"] == 0


def test_capture_counter_resets_with_the_launch_counts():
    _build.reset_launch_counts()
    _build.record_capture()
    _build.record_capture()
    assert _build.graph_captures() == 2
    _build.reset_launch_counts()
    assert _build.graph_captures() == 0
