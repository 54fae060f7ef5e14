"""On the card: a short run of each one-card cell at a small frame comes
out correct, with a traced line.  Skips without a card (decided in the
fixture)."""

import pytest

from stereo_bench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ugsm_mode1.single",
                                      "ugsm_foveated.single",
                                      "ugsm_mode1.batch8",
                                      "ugsm_mode1.single_resident",
                                      "ugsm_mode1_bilinear_ee.single",
                                      "ugsm_mode1_bilinear_ee.single_resident"])
@pytest.mark.parametrize("traced", [False, True])
def test_short_run_on_the_card(card, workload, traced):
    over = {"frame": [480, 640], "pool": 2, "warmup_calls": 2,
            "sample": {"calls": 1, "within": 2}}
    res = harness.run(workload, 2 ** 31 + 7, 1.0, traced, overrides=over,
                      log=lambda *a, **k: None)
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    if traced:
        assert res["device"]["busy_s"] > 0
        (roof,) = [v["value"] for k, v in res["metrics"].items()
                   if k.startswith("kernels.roofline_pct")]
        assert 0 < roof < 100
