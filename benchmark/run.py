#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result as one JSON line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of part of the window.  The numbers compared for
``correct`` come last on standard error and last in the line.  Exits
non-zero, printing no result, without the cards, without the program, or
when the process holds JAX or the JAX package once the run is over.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.prepare_environment()
    spec = harness.load_spec()
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    t_import = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(entry["chips"])):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"{args.workload}: set-up's start: the harness {t_import - T0:.4f}"
          f" s, import torch {t_torch - t_import:.4f} s, the card's count "
          f"{time.perf_counter() - t_torch:.4f} s", file=sys.stderr)
    line = harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t0=T0, spec=spec)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
