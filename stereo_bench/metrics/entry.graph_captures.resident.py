"""entry.graph_captures.resident: entry.graph_captures in the cells whose inputs already lie on the
card, where it moves the resident end-to-end metrics (the same reader)."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("entry.graph_captures.py")))["read"]
