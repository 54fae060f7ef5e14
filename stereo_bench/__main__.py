"""``python3 -m stereo_bench``: one run of one cell (stereo_bench.run)."""

import time

T0 = time.perf_counter()

from stereo_bench.run import main  # noqa: E402

raise SystemExit(main(t0=T0))
