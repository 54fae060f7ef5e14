"""level.iterations_per_pair.resident: level.iterations_per_pair in the cells whose inputs already lie on the
card, where it moves the resident end-to-end metrics (the same reader)."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("level.iterations_per_pair.py")))["read"]
