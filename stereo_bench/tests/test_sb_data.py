"""The cells, configurations, mixes and metrics are found by name from
data files, and a new cell is new files and entries only."""

import json
import shutil

import pytest

from stereo_bench import spec
from stereo_bench.tests.helpers import cpu_run

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_loads_its_files_by_name(workload):
    cell = spec.load(workload)
    assert cell.config["mode"] in ("match", "match_foveated")
    assert cell.traffic["entry"] in ("one_pair", "match_batch")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"])), m["name"]


def test_every_metric_has_a_reader_and_a_layer():
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert [w["chips"] for w in BENCH["workloads"]].count(4) <= 1
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.load(open(spec.ROOT / c["file"]))["reduced"] == \
            c["reduced"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_throwaway_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric reader
    and their entries as new data, and run the new cell unchanged."""
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE)
    pkg = tmp_path / spec.PACKAGE
    cfg = json.load(open(pkg / "configs" / "ugsm_mode1.json"))
    cfg["matcher"]["interp"] = "bilinear"
    json.dump(cfg, open(pkg / "configs" / "throwaway.json", "w"))
    mix = json.load(open(pkg / "traffic" / "single.json"))
    mix["pool"] = 3
    json.dump(mix, open(pkg / "traffic" / "throwaway_mix.json", "w"))
    (pkg / "metrics" / "throwaway.pairs.py").write_text(
        "def read(run):\n    return float(run.pairs)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "throwaway", "source": "x",
                             "file": f"{spec.PACKAGE}/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.pairs", "unit": "pairs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry", "moves": "pairs_per_s",
                               "workloads": ["throwaway.cell"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = spec.load("throwaway.cell", tmp_path)
    assert cell.config["matcher"]["interp"] == "bilinear"
    assert cell.traffic["pool"] == 3
    res = cpu_run("throwaway.cell", traced=True, root=tmp_path)
    assert res["correct"] is True
    assert res["metrics"]["throwaway.pairs"]["value"] == res["attempted"]
    # the cells already there do not see the new metric
    assert "throwaway.pairs" not in [
        m["name"] for m in spec.load("ugsm_mode1.single",
                                     tmp_path).per_layer]


def test_a_declaration_the_harness_would_not_keep_is_refused(tmp_path):
    """A mix with another loop, or a configuration whose guarantees its
    matcher contradicts, does not load."""
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pkg = tmp_path / spec.PACKAGE
    mix = json.load(open(pkg / "traffic" / "single.json"))
    mix["loop"]["clients"] = 4
    json.dump(mix, open(pkg / "traffic" / "single.json", "w"))
    with pytest.raises(ValueError, match="closed"):
        spec.load("ugsm_mode1.single", tmp_path)
    mix["loop"]["clients"] = 1
    json.dump(mix, open(pkg / "traffic" / "single.json", "w"))
    cfg = json.load(open(pkg / "configs" / "ugsm_foveated.json"))
    cfg["matcher"]["early_exit_delta"] = 0.02
    json.dump(cfg, open(pkg / "configs" / "ugsm_foveated.json", "w"))
    with pytest.raises(ValueError, match="schedule"):
        spec.load("ugsm_foveated.single", tmp_path)


def test_a_batch_sample_takes_one_pair_from_each_stratum():
    from stereo_bench import harness
    traffic = spec.load("ugsm_mode1.batch8").traffic
    for seed in (1, 2 ** 31 + 5, 9100000011):
        picks = harness.sampled(traffic, seed)
        assert len(picks) == traffic["sample"]["calls"]
        for call, pairs in picks.items():
            assert 0 <= call < traffic["sample"]["within"]
            assert [p // 2 for p in pairs] == [0, 1, 2, 3]
    assert harness.sampled(traffic, 1) == harness.sampled(traffic, 1)
    single = spec.load("ugsm_mode1.single").traffic
    assert all(p == [0] for p in harness.sampled(single, 3).values())
