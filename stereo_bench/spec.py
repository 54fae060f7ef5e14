"""The benchmark's data, found by name: a cell of ``BENCHMARK.json``, its
configuration file, its traffic mix (``stereo_bench/traffic/<mix>.json``)
and the readers of its per-layer metrics
(``stereo_bench/metrics/<metric>.py``).  A later cell, configuration,
mix or metric is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent.name
# the one loop the harness drives: a rig waits for a pair's answer
# before it sends the next
LOOP = {"kind": "closed", "clients": 1}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def frame(self):
        return tuple(self.traffic.get("frame") or self.config["frame"])

    @property
    def foveated(self) -> bool:
        return self.config["mode"] == "match_foveated"


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its data files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the cells are "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    with open(root / cfgs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(root / PACKAGE / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    _check_declared(w["config"], config, w["traffic"], traffic)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                root=root)


def _check_declared(cname: str, config: dict, mix: str, traffic: dict
                    ) -> None:
    """Refuse a declaration that the harness would not keep: a loop
    other than LOOP, guarantees that the matcher's fields contradict
    (the harness runs with TF32 as ``guarantees["tf32"]`` says), an
    early-exit schedule without the gate of the levels that may exit,
    or an iteration count that the sample cannot judge (a batch call's
    count covers every pair of the call, so every pair is judged)."""
    if traffic.get("loop") != LOOP:
        raise ValueError(f"traffic {mix!r}: the harness drives {LOOP}, "
                         f"not {traffic.get('loop')}")
    g, m = config["guarantees"], config["matcher"]
    if g["dtype"] != m["dtype"]:
        raise ValueError(f"configuration {cname!r}: guarantees dtype "
                         f"{g['dtype']} but the matcher's is {m['dtype']}")
    schedule = "fixed" if m["early_exit_delta"] is None else "early_exit"
    if g["schedule"] != schedule:
        raise ValueError(f"configuration {cname!r}: schedule "
                         f"{g['schedule']!r} against early_exit_delta "
                         f"{m['early_exit_delta']}")
    if schedule == "early_exit" and not isinstance(
            g.get("exit_levels_above_px"), int):
        raise ValueError(f"configuration {cname!r}: an early-exit schedule "
                         f"states exit_levels_above_px")
    if "iterations_gap" in config["limits"] and \
            traffic["entry"] == "match_batch" and \
            traffic["sample"].get("pairs", traffic["pairs_per_call"]) < \
            traffic["pairs_per_call"]:
        raise ValueError(f"traffic {mix!r}: iterations_gap compares a "
                         f"call's count, so its sample judges every pair")


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[object], Optional[float]]:
    """The ``read(run)`` function of ``<package>/metrics/<metric>.py``."""
    path = root / PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_metric_{metric.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
