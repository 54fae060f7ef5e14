"""device.idle_pct.resident: device.idle_pct in the cells whose inputs already lie on the
card, where it moves the resident end-to-end metrics (the same reader)."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("device.idle_pct.py")))["read"]
