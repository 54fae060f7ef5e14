"""The port's bench (ug_stereomatcher_tpu_torch/bench.py) against the JAX
package's root bench.py, on the CPU.

The root bench imports only numpy at module level, so its modes, scene
and scaling headline can be held against the port's here.  The port's
latency lines run with BENCH_PLATFORM=cpu at 192 x 256 (the kernels'
plain versions) and must carry the JAX bench's metric names, units,
baselines and ``extra`` keys (less the compile-cache counters the port
has no counterpart of), with the value gates passed; the gate values of
mode 1 must agree with the JAX engine's on the same pair under quantile
tolerances (a nearest warp flips gather indices on float noise).  A
failed line, a failed scaling family or a missing card must give a
nonzero rc, never a CPU run.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from tests.test_bench_helpers import _FakeJax, _FakePoint
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.engine import StereoEngine as JaxEngine
from ug_stereomatcher_tpu_torch import bench, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 192, 256
# bench.py's _latency extra (:376-391) less its cache_* fields
LATENCY_EXTRA = {"height", "width", "repeats", "interp", "early_exit_delta",
                 "compile_plus_first_run_s", "all_runs_s", "host_path_s",
                 "device", "baseline_s"}
CPU_ENV = {"BENCH_PLATFORM": "cpu", "BENCH_H": str(H), "BENCH_W": str(W),
           "BENCH_REPEATS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the engine's many small CPU ops run as fast on
    one as on eight here, and the test workers share the machine's cores
    (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_main(env: dict):
    """bench.main() under ``env`` (other BENCH_* variables unset): (rc,
    the JSON lines it printed)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out):
            rc = bench.main()
    return rc, [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def latency_lines():
    """mode -> (rc, lines) of one CPU run of that mode, made once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = run_main({**CPU_ENV, "BENCH_MODE": mode})
        return cache[mode]
    return get


def run_cli(env: dict):
    return subprocess.run(
        [sys.executable, "-m", "ug_stereomatcher_tpu_torch", "bench"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("BENCH_")}, **env})


# ------------------------------------------------------------ the contract
def test_modes_equal_jax_bench():
    assert bench._MODES == jax_bench._MODES


@pytest.mark.parametrize("batch", [None, 3])
def test_scene_equals_jax_bench(batch):
    got = bench._make_pair(40, 56, batch=batch)
    ref = jax_bench._make_pair(40, 56, batch=batch)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_unknown_mode_rejected_before_the_device():
    r = run_cli({"BENCH_MODE": "bogus"})
    assert r.returncode == 2, r.stdout + r.stderr
    payload = json.loads(r.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "bench_env_FAILED"
    assert "bogus" in payload["error"]


def test_missing_card_fails_without_cpu_fallback():
    """No BENCH_PLATFORM=cpu and no card (hidden even where there is
    one): rc 1 and bench_env_FAILED naming the CUDA device, no line."""
    r = run_cli({"BENCH_MODE": "mode1", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["metric"] == "bench_env_FAILED"
    assert "CUDA" in payload["error"]


# --------------------------------------------------- the scaling headline
def _dp_fails(mode="dp", **kw):
    if mode == "dp":
        raise RuntimeError("dp exploded")
    return [_FakePoint(1, 1.0), _FakePoint(2, 0.9)]


def _all_measure(mode="dp", **kw):
    return [_FakePoint(1, 1.0), _FakePoint(2, 0.8)]


def _oversubscribed(mode="dp", **kw):
    return [_FakePoint(1, 1.0), _FakePoint(2, 0.9),
            _FakePoint(8, 0.4, oversubscribed=True)]


# tests/test_bench_helpers.py TestScalingHeadline: (BENCH_SCALING_MODES,
# fake measure_throughput, expected value, unit prefix, headline devices)
SCALING_CASES = {
    "dp_failure_yields_diagnostic": ("dp,sp", _dp_fails, 0, "dp_", None),
    "dp_less_run_labels_by_family": ("sp", _all_measure, 0.8, "sp_", 2),
    "dp_headline_skips_oversubscribed": ("dp", _oversubscribed, 0.9, "dp_",
                                         2),
}


@pytest.mark.parametrize("case", list(SCALING_CASES))
def test_scaling_headline_equals_jax_bench(case, monkeypatch):
    from ug_stereomatcher_tpu.parallel import throughput as jax_tp
    from ug_stereomatcher_tpu_torch.parallel import throughput as tp

    modes, fake, value, unit, devices = SCALING_CASES[case]
    monkeypatch.setattr(jax_tp, "measure_throughput", fake)
    monkeypatch.setattr(tp, "measure_throughput", fake)
    monkeypatch.setenv("BENCH_SCALING_MODES", modes)
    monkeypatch.setenv("BENCH_CPU_DEVICES", "2")
    monkeypatch.delenv("BENCH_H", raising=False)
    got = bench._scaling(64, 96, 1, torch.device("cpu"),
                         bench._card(torch.device("cpu")))
    ref = jax_bench._scaling(_FakeJax, 64, 96, 1)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert got[key] == ref[key], key
    assert got["value"] == value and got["unit"].startswith(unit)
    assert got["extra"]["curves"] == ref["extra"]["curves"]
    assert got["extra"].get("headline_devices") == devices
    assert got["extra"]["skipped_modes"] == ref["extra"]["skipped_modes"]


@pytest.mark.parametrize("fails", ["dp", "sp"])
def test_failed_scaling_family_fails_the_run(fails, monkeypatch):
    """A family that raises keeps its error in the curves and makes the
    run return 1, whether or not it is the headline's."""
    from ug_stereomatcher_tpu_torch.parallel import throughput as tp

    def fake(mode="dp", **kw):
        if mode == fails:
            raise RuntimeError(f"{mode} exploded")
        return [_FakePoint(1, 1.0), _FakePoint(2, 0.9)]
    monkeypatch.setattr(tp, "measure_throughput", fake)
    rc, lines = run_main({"BENCH_MODE": "scaling", "BENCH_PLATFORM": "cpu",
                          "BENCH_SCALING_MODES": "dp,sp",
                          "BENCH_CPU_DEVICES": "2"})
    assert rc == 1
    (line,) = lines
    assert "exploded" in line["extra"]["curves"][fails]["error"]
    assert line["value"] == (0 if fails == "dp" else 0.9)


# ------------------------------------------------------- the latency lines
@pytest.mark.parametrize("mode", ["mode1", "mode1_bilinear", "foveated",
                                  "mode1_ee"])
def test_latency_line_on_the_cpu(mode, latency_lines):
    rc, lines = latency_lines(mode)
    assert rc == 0, lines
    (line,) = lines
    baseline = 10.0 if mode.startswith("mode1") else 3.0
    assert line["metric"] == f"{mode}_disparity_latency_{H}x{W}"
    assert line["unit"] == "s/pair"
    assert line["vs_baseline"] == round(baseline / line["value"], 3)
    extra = line["extra"]
    assert LATENCY_EXTRA <= set(extra)
    assert extra["device"] == "cpu" and extra["baseline_s"] == baseline
    assert extra["interp"] == ("bilinear" if "bilinear" in mode
                               else "nearest")
    assert extra["early_exit_delta"] == (0.1 if mode == "mode1_ee" else None)
    assert line["value"] == min(extra["all_runs_s"])
    gate = bench.GATES[extra["interp"]]
    v = extra["values"]
    assert v["med_abs_dh_err"] < gate and v["mean_abs_dv"] < gate
    assert v["frac_dh_err_lt_1"] > bench.FRAC_GATE


# |med err| tolerance, |mean|dv|| tolerance, |frac| tolerance
JAX_TOL = {"nearest": (0.05, 0.02, 0.01), "bilinear": (0.005, 0.02, 0.01)}


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_gate_values_agree_with_jax_engine(interp, latency_lines):
    mode = "mode1" if interp == "nearest" else "mode1_bilinear"
    _, (line,) = latency_lines(mode)
    got = line["extra"]["values"]
    left, right = jax_bench._make_pair(H, W)
    res = JaxEngine(JaxConfig(interp=interp)).match(left, right)
    m = slice(min(64, H // 4, W // 4), -min(64, H // 4, W // 4))
    err = np.abs(np.asarray(res.disparity_h)[m, m] - 3.0)
    ref = {"med_abs_dh_err": float(np.median(err)),
           "frac_dh_err_lt_1": float((err < 1.0).mean()),
           "mean_abs_dv": float(np.abs(np.asarray(res.disparity_v)[m, m])
                                .mean())}
    tol_med, tol_dv, tol_frac = JAX_TOL[interp]
    assert abs(got["med_abs_dh_err"] - ref["med_abs_dh_err"]) <= tol_med
    assert abs(got["mean_abs_dv"] - ref["mean_abs_dv"]) <= tol_dv
    assert abs(got["frac_dh_err_lt_1"] - ref["frac_dh_err_lt_1"]) <= tol_frac


# ------------------------------------------------------- failure handling
ALL_ORDER = ["foveated", "throughput", "foveated_throughput",
             "mode1_bilinear", "foveated_bilinear", "mode1_ee",
             "mode1_bilinear_ee", "mode1"]


def _fake_all(monkeypatch, raising=()):
    """Stand-ins for the measured lines: metric = the mode's name."""
    def line(name):
        if name in raising:
            raise RuntimeError(f"{name} broke")
        return {"metric": name, "value": 1.0, "unit": "u",
                "vs_baseline": 1.0, "extra": {}}
    monkeypatch.setattr(bench, "_latency", lambda m, *a: line(m))
    monkeypatch.setattr(
        bench, "_throughput",
        lambda *a, foveated=False: line("foveated_throughput" if foveated
                                        else "throughput"))


@pytest.mark.parametrize("raising", [(), ("foveated",), ("mode1",)])
def test_all_prints_every_line_and_fails_on_any(raising, monkeypatch):
    _fake_all(monkeypatch, raising)
    rc, lines = run_main({"BENCH_MODE": "all", "BENCH_PLATFORM": "cpu"})
    assert rc == (1 if raising else 0)
    assert [x["metric"] for x in lines] == [
        f"{m}_FAILED" if m in raising else m for m in ALL_ORDER]
    side = lines[-1]["extra"]
    for m in ALL_ORDER[:-1]:
        if m in raising:
            assert side[m] == {"error": f"RuntimeError: {m} broke"}
        else:
            assert side[m]["metric"] == m


def test_failed_gate_fails_the_line(monkeypatch):
    """Gates measured against a shift the scene does not have: the line
    prints as failed, with its values, and the run returns 1."""
    monkeypatch.setattr(bench, "SHIFT_PX", 5)
    rc, lines = run_main({**CPU_ENV, "BENCH_H": "96", "BENCH_W": "128",
                          "BENCH_MODE": "mode1"})
    assert rc == 1
    (line,) = lines
    assert line["metric"] == "mode1_FAILED"
    assert line["error"].startswith("GateFailure: value gates failed")


def test_cli_bench_on_the_cpu(monkeypatch, capsys):
    """The flags override the environment (restored after the test)."""
    for k, v in {"BENCH_MODE": "all", "BENCH_H": "1", "BENCH_W": "1",
                 "BENCH_PLATFORM": "cuda", "BENCH_REPEATS": "1"}.items():
        monkeypatch.setenv(k, v)
    rc = cli.main(["bench", "--mode", "mode1", "--height", str(H),
                   "--width", str(W), "--device", "cpu"])
    assert rc == 0
    (out,) = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out)
    assert line["metric"] == f"mode1_disparity_latency_{H}x{W}"
    assert line["extra"]["device"] == "cpu"
