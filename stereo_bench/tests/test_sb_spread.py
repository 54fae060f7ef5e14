"""The spread arithmetic of ``python3 -m stereo_bench.spread``."""

import statistics

import pytest

from stereo_bench import spread


def test_range_leaves_out_the_farthest_run_where_that_narrows_it():
    # median 11: without 30 the range is 12 - 10
    assert spread.range_spread([10, 11, 12, 30, 11]) == pytest.approx(2 / 11)
    # two runs: nothing is left out
    assert spread.range_spread([10, 12]) == pytest.approx(2 / 11)
    assert spread.range_spread([5, 5, 5]) == 0.0


def test_iqr_is_pythons_quartiles_over_the_median():
    xs = [30.1, 31.0, 29.5, 33.2, 30.4, 28.9, 31.7]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert spread.iqr_spread(xs) == pytest.approx(
        (q3 - q1) / statistics.median(xs))


def test_summary_by_metric_and_set():
    runs = [{"set": s, "metrics": {"pairs_per_s": v, "setup_s": 10.0}}
            for s, vals in ((0, [40, 44, 42]), (1, [41, 43, 60]))
            for v in vals]
    runs.append({"set": 1, "rc": 1})     # a run with no line
    out = spread.summarise(runs)
    assert out["pairs_per_s"]["0"]["median"] == 42
    assert out["pairs_per_s"]["1"]["range"] == pytest.approx(2 / 43)
    assert out["setup_s"]["0"]["iqr"] == 0.0
