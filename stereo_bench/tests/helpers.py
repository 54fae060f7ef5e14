"""Small CPU runs of the harness for the tests."""

import json
import shutil

from stereo_bench import harness, spec

TINY = {"frame": [64, 96], "pool": 2, "warmup_calls": 1,
        "sample": {"calls": 1, "within": 1}}
TINY_FOVEATED = dict(TINY, frame=[96, 128])


def cpu_run(workload, seed=7, seconds=0.3, traced=False, overrides=None,
            **kw):
    """One run of ``workload`` on the CPU at a tiny frame (the look for a
    card skipped, the plain versions run)."""
    over = dict(TINY_FOVEATED if "foveated" in workload else TINY)
    over.update(overrides or {})
    return harness.run(workload, seed, seconds, traced, device="cpu",
                       overrides=over, log=lambda *a, **k: None, **kw)


def with_cell(tmp_path, name, config, traffic, chips):
    """A copy of the benchmark under ``tmp_path`` with one more cell."""
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE)
    bench = spec.benchmark()
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": chips,
                               "why": "a test"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    return tmp_path
