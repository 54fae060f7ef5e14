"""The reduction of a trace to busy time, kernel time, copies and idle
gaps, on a hand-made trace."""

import pytest

from stereo_bench import trace


def ev(cat, name, ts, dur, dev=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0 if dev is None else dev, "tid": 1}
    if dev is not None:
        e["args"] = {"device": dev}
    return e


def events():
    return [
        ev("user_annotation", trace.WINDOW, 0, 1000),
        ev("user_annotation", trace.REQUEST, 0, 400),
        ev("user_annotation", trace.REQUEST, 500, 400),
        ev("user_annotation", trace.PAUSE, 900, 100),
        ev("cpu_op", "aten::copy_", 0, 100),
        ev("cpu_op", "cudaGraphLaunch", 100, 10),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 80, 0),
        ev("kernel", "smooth", 100, 200, 0),
        ev("kernel", "direction", 250, 100, 0),   # overlaps smooth
        ev("kernel", "smooth", 600, 100, 0),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 900, 50, 0),
        ev("kernel", "smooth", 100, 300, 1),
        ev("gpu_user_annotation", trace.REQUEST, 0, 900, 0),
    ]


def test_busy_kernel_and_copy_time():
    tr = trace.Trace(events(), [0, 1])
    assert tr.window_s == pytest.approx(900e-6)   # the pause cut out
    assert tr.requests == 2
    c0 = tr.cards[0]
    # union: 20-100, 100-350, 600-700; the DtoH lies in the pause
    assert c0["busy_s"] == pytest.approx(430e-6)
    assert c0["kernel_s"] == pytest.approx(400e-6)
    assert c0["h2d_s"] == pytest.approx(80e-6)
    assert tr.cards[1]["busy_s"] == pytest.approx(300e-6)
    assert tr.idle_pct(0) == pytest.approx(100 * (1 - 430 / 900))


def test_device_ops_and_idle_gaps_by_name():
    tr = trace.Trace(events(), [0])
    ops = dict(tr.device_ops)
    assert ops["smooth"] == pytest.approx(300e-6 + 300e-6)
    gaps = dict(tr.idle_gaps)
    # 0-20 under aten::copy_ (inside the first request); 350-600 has
    # no host event at its midpoint; 700-900 under the second request
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert gaps[trace.REQUEST] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(470e-6)


def test_merge_and_intersect():
    assert trace.merge([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert trace.intersect([(0, 10)], [(2, 3), (5, 7)]) == [(2, 3), (5, 7)]
