"""Tiny copies of the benchmark's cells for the CPU tests.

``tiny_root(tmp)`` lays out a benchmark folder under ``tmp``: the real
traffic kinds and metrics, and each configuration and cell cut to a size
the CPU runs in seconds (8² and 4³ meshes, 4 scenarios, 2 steps), with the
real cells' limits.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

HERE = harness.HERE
TINY_CELLS = {2: [8, 8], 3: [4, 4, 4]}
# forcing amplitudes at which the default step stays stable on the tiny
# meshes (the step grows with the element size)
TINY_FORCING = {2: 20.0, 3: 300.0}


def spec() -> dict:
    return harness.load_spec()


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "benchmark"
    for d in ("traffic", "metrics"):
        shutil.copytree(HERE / d, root / d)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for src in (HERE / "configs").glob("*.json"):
        c = json.loads(src.read_text())
        c["mesh"]["cells"] = TINY_CELLS[len(c["mesh"]["cells"])]
        c["data_iters"] = 300
        (root / "configs" / src.name).write_text(json.dumps(c))
    for src in (HERE / "workloads").glob("*.json"):
        c = json.loads(src.read_text())
        dim = len(json.loads((HERE / "configs" / f"{c['config']}.json")
                             .read_text())["mesh"]["cells"])
        c["forcing"]["amplitude"] = TINY_FORCING[dim]
        B = c["batch"]
        c["batch"] = 4
        if "job" in c:
            c["steps"] = 2
            if c["job"]["objective"] == "batch_mean":
                # the same step a scenario: lr · 2/(B·nodes) held
                c["job"]["lr"] *= 4 / B
        c["trace"] = {"skip": 1, "units": 1}
        (root / "workloads" / src.name).write_text(json.dumps(c))
    return root


def run(root: Path, name: str, seed: int = 2 ** 31 + 5, trace=False,
        program=None, seconds=0.0) -> dict:
    return harness.run(name, seed, seconds, trace, device="cpu",
                       program=program, spec=spec(), root=root,
                       log=lambda *a: None)
