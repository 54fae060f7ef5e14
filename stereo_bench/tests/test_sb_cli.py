"""The command line: the last line's keys, and no result without a card
or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from stereo_bench import spec
from stereo_bench.tests.helpers import cpu_run

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def test_the_line_has_the_contract_keys_and_the_check_last():
    res = cpu_run("ugsm_mode1.single")
    assert set(res) == CONTRACT | {"check"}
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"pairs_per_s", "latency_ms_p50",
                                   "latency_ms_p95", "device_mem_peak_gib",
                                   "setup_s"}
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)


def test_a_traced_line_carries_only_per_layer_metrics():
    res = cpu_run("ugsm_mode1.single", traced=True)
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    assert set(res["metrics"]) <= names


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "stereo_bench", "--workload",
         "ugsm_mode1.single", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _cli(spec.ROOT, env)
    if p.returncode == 0:
        pytest.fail("ran without a card")
    assert p.stdout == ""


def test_no_program_no_result(tmp_path):
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cli(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""
