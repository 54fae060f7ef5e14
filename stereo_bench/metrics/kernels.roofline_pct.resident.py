"""kernels.roofline_pct.resident: kernels.roofline_pct in the cells whose inputs already lie on the
card, where it moves the resident end-to-end metrics (the same reader)."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("kernels.roofline_pct.py")))["read"]
