"""The command line of one run: parse, run, print the line, exit.

Exit codes: 0 a run that printed its line (``correct`` may be false);
2 no card, or fewer cards than the cell asks for; 3 the program could
not be imported; 4 a module of JAX or of the JAX package was loaded;
1 any other failure.  Only code 0 prints a result."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m stereo_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    try:
        from stereo_bench import harness

        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t0=t0)
    except ImportError as exc:
        print(f"stereo_bench: cannot import the program: {exc!r}",
              file=sys.stderr)
        return 3
    except RuntimeError as exc:
        if type(exc).__name__ != "NoChip":
            raise
        print(f"stereo_bench: {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"stereo_bench: loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
