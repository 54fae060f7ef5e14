"""The benchmark of ug_stereomatcher_tpu_torch, the PyTorch and CUDA port.

``python3 -m stereo_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line (README.md)."""
