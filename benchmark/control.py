#!/usr/bin/env python3
"""Take the readings that a cell's limits of ``correct`` are set from.

    python benchmark/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--faults unchanged half_batch altered \\
        --fault-seeds 11] [--seconds 1]

On the card, in one process: for each of ``--seeds`` a run of the cell
with a short window (``--seconds``; an ``invert`` run still runs one
whole job) and the same comparison as the benchmark's runs; for each of
``--control-seeds`` the same with the control in the program's place:
the plain reference computed in bfloat16, the precision below the
configuration's float32; and for each of ``--fault-seeds`` a run with
each of ``--faults`` (``benchmark/faults.py``) planted under the program.
Prints one JSON line a run and, last, the largest reading of the program
and the smallest of the control and of each fault for each number
compared.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness, programs  # noqa: E402


def readings(args, device="cuda", spec=None, root=harness.HERE):
    """Yield (who, seed, line) for every run asked for."""
    import torch

    spec = harness.load_spec(root.parent) if spec is None else spec
    found = harness.find_cell(spec, args.workload, root)
    runs = [("program", s) for s in args.seeds] + [
        ("control", s) for s in args.control_seeds] + [
        (f"fault:{f}", s) for s in args.fault_seeds for f in args.faults]
    for who, seed in runs:
        program = None
        if who == "control":
            program = programs.Reference(found["config"], found["cell"],
                                         torch.bfloat16)
        patch = faults.Patch()
        if who.startswith("fault:"):
            faults.FAULTS[who[len("fault:"):]](patch)
        try:
            line = harness.run(args.workload, seed, args.seconds, False,
                               device=device, program=program, spec=spec,
                               root=root)
        finally:
            patch.undo()
        if device == "cuda":
            torch.cuda.empty_cache()
        yield who, seed, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 3
    seen = {}
    for who, seed, line in readings(args):
        values = {k: c["value"] for k, c in line["checks"].items()}
        print(json.dumps({"who": who, "seed": seed, "readings": values,
                          "correct": line["correct"],
                          "metrics": line["metrics"]}), flush=True)
        for k, v in values.items():
            seen.setdefault(who, {}).setdefault(k, []).append(v)
    # the program's largest (a NaN is the largest); the control's and each
    # fault's smallest number (a NaN gives none and sets no upper end)
    high = {k: math.nan if any(map(math.isnan, v)) else max(v)
            for k, v in seen.get("program", {}).items()}
    low = {who: {k: min((x for x in v if not math.isnan(x)), default=None)
                 for k, v in got.items()}
           for who, got in seen.items() if who != "program"}
    print(json.dumps({"workload": args.workload, "program_max": high,
                      "control_min": low.get("control", {}),
                      "fault_min": {w[len("fault:"):]: v
                                    for w, v in low.items()
                                    if w.startswith("fault:")},
                      "seconds": time.perf_counter() - T0}), flush=True)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
