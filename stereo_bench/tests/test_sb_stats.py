"""The rate and the percentiles are taken over all requests."""

import numpy as np
import pytest

from stereo_bench import stats


def test_percentiles_over_every_request():
    lat = [0.010] * 190 + [0.050] * 10
    m = stats.window_metrics(lat, 1, 4.0)
    assert m["pairs_per_s"] == pytest.approx(200 / 4.0)
    assert m["latency_ms_p50"] == pytest.approx(10.0)
    # the 10 slowest of 200 lie beyond the 95th percentile's rank
    assert m["latency_ms_p95"] == pytest.approx(
        np.percentile([1e3 * t for t in lat], 95))
    assert 10.0 <= m["latency_ms_p95"] <= 50.0


def test_rate_counts_pairs_per_call():
    m = stats.window_metrics([0.1] * 30, 8, 3.0)
    assert m["pairs_per_s"] == pytest.approx(80.0)


@pytest.mark.parametrize("q", [0, 25, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(3).exponential(size=257))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))

