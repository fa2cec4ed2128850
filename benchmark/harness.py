"""The benchmark's harness: finds a cell's files by name, runs the cell and
assembles its result line.

Everything a cell needs is found from the names in ``BENCHMARK.json``:

* the cell: ``benchmark/workloads/<workload>.json`` (its configuration,
  traffic mix and kind, sizes, sampling, trace span and the limits of
  ``correct``);
* its configuration: ``benchmark/configs/<config>.json``;
* its traffic kind: the module ``benchmark/traffic/<kind>.py`` (``setup``,
  ``unit_work``, ``warm``, ``window``, ``release``, ``check``; the
  state ``setup`` returns may give ``reference_s``, the seconds the
  reference spent on the inputs, which ``setup_s`` leaves out);
* each per-layer metric: the module ``benchmark/metrics/<metric>.py``
  (``read(ctx)`` returns a number, or None where it finds nothing).

An end-to-end metric reports the quantity its traffic kind measures under
the name's part before the first dot: ``solves_per_s.host_paced`` is the
forward kind's ``solves_per_s``, held to a bound of its own, for cells
whose runs spread differently from the others'.

A later cell, configuration, traffic kind or metric is new files and new
entries; no file here changes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / ".bench_cache"
#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "difffe_tpu")


def prepare_environment() -> None:
    """Kernel and build caches at fixed paths inside the checkout (set
    before torch is imported)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list:
    """Names in ``modules`` whose top-level package, the part before the
    first dot taken whole, is JAX's or the JAX package's."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_spec(root: Path = CHECKOUT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def read_json(kind: str, name: str, root: Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as fh:
        return json.load(fh)


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module of this package (a name may
    hold dots, so it is loaded from its path)."""
    qual = f"{__package__}.{kind}._{name.replace('.', '_').replace('-', '_')}"
    if qual in sys.modules:
        return sys.modules[qual]
    spec = importlib.util.spec_from_file_location(
        qual, root / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str, root: Path = HERE) -> dict:
    """The workload ``name``: its ``BENCHMARK.json`` entry, cell file,
    configuration and traffic kind."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = read_json("workloads", name, root)
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: the cell file's {key} "
                             f"{cell[key]!r} is not BENCHMARK.json's "
                             f"{entry[key]!r}")
    return {"name": name, "entry": entry, "cell": cell,
            "config": read_json("configs", cell["config"], root),
            "kind": load_module("traffic", cell["kind"], root)}


def _applies(metric: dict, name: str, reported) -> bool:
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def end_to_end_for(spec: dict, name: str) -> list:
    return [m for m in spec["end_to_end"] if _applies(m, name, ())]


def per_layer_for(spec: dict, name: str) -> list:
    reported = {m["name"] for m in end_to_end_for(spec, name)}
    return [m for m in spec["per_layer"] if _applies(m, name, reported)]


class _EventClock:
    """Times on the card's clock: CUDA events on the current stream."""

    def __init__(self, torch):
        self.torch = torch

    def mark(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def wait(e):
        e.synchronize()

    @staticmethod
    def seconds(a, b):
        return a.elapsed_time(b) * 1e-3


class _HostClock:
    mark = staticmethod(time.perf_counter)

    @staticmethod
    def wait(_):
        pass

    @staticmethod
    def seconds(a, b):
        return b - a


class Tracer:
    """Profiles ``units`` consecutive units (jobs or calls) of the window,
    after the first ``skip``, each inside the annotation the trace reader
    takes as the window; the trace is written once the window closed."""

    def __init__(self, torch, enabled: bool, skip: int, units: int, path):
        self.torch, self.enabled = torch, enabled
        self.skip, self.units, self.path = skip, units, Path(path)
        self.seen = self.traced = 0
        self.prof = None
        self.stopped = False

    def warm(self, device) -> None:
        """One short session, so that the profiler's own start-up (CUPTI)
        falls in set-up and not in the traced window."""
        if not self.enabled:
            return
        with self._profile():
            self.torch.ones(4, device=device).add_(1)
            self._sync()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts, record_shapes=True)

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def unit(self):
        """Wraps one unit; yields whether it is traced."""
        idx, self.seen = self.seen, self.seen + 1
        if self.enabled and idx == self.skip:
            self._sync()
            self.prof = self._profile()
            self.prof.start()
        if self.prof is None or self.stopped:
            yield False
            return
        with self.torch.profiler.record_function("bench.unit"):
            yield True
        self.traced += 1
        if self.traced == self.units:
            self._stop()

    def _stop(self):
        self._sync()
        self.prof.stop()
        self.stopped = True

    def write(self):
        """Stop if still running and write the trace; its path, or None
        where no unit was traced."""
        if self.prof is None:
            return None
        if not self.stopped:
            self._stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        return self.path


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not read")


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None, program=None,
        spec: dict | None = None, root: Path = HERE, log=None) -> dict:
    """Run one cell and return its result line (a dict, ``checks`` last).

    ``program``: what the traffic drives (default: the port on the
    configuration's mesh); the control and the fault tests put another in
    its place.  ``device``: "cuda" for a measured run, "cpu" for the tests
    (no device numbers are then read)."""
    import torch

    from . import programs
    from . import trace as trace_mod

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    marks = [("start", time.perf_counter())]
    spec = load_spec(root.parent) if spec is None else spec
    found = find_cell(spec, name, root)
    cell, config, kind = found["cell"], found["config"], found["kind"]
    cuda = device == "cuda"
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if cuda:
        torch.cuda.set_device(dev.index or 0)
        torch.zeros(1, device=dev)          # the CUDA context
    marks.append(("context", time.perf_counter()))

    def synchronize():
        if cuda:
            torch.cuda.synchronize()

    if program is None:
        program = programs.Port(config, dev)
    marks.append(("program", time.perf_counter()))
    ctx = types.SimpleNamespace(
        cell=cell, config=config, seed=int(seed), device=dev,
        program=program, synchronize=synchronize,
        event_clock=(lambda: _EventClock(torch)) if cuda
        else (lambda: _HostClock()))
    state = kind.setup(ctx)
    synchronize()
    reference_s = float(getattr(state, "reference_s", 0.0))
    marks.append(("inputs", time.perf_counter()))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tcfg = cell["trace"]
    tracer = Tracer(torch, trace, int(tcfg["skip"]), int(tcfg["units"]),
                    CACHE / "traces" / f"{name}.json")
    tracer.warm(dev)
    kind.warm(state)
    synchronize()
    marks.append(("warm", time.perf_counter()))
    # the reference's observations are the yardstick's work, not set-up
    setup_s = marks[-1][1] - t0 - reference_s
    result = kind.window(state, seconds, tracer)
    synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    phases = ", ".join(f"{n} {b - a:.4f}" for (_, a), (n, b)
                       in zip([("", t0)] + marks, marks))
    log(f"{name}: {result['note']}; set-up {setup_s:.4f} s (phases, s: "
        f"{phases}; the reference's observations {reference_s:.4f} of "
        f"the inputs' are not counted); memory peak {peak} B")

    line = {"correct": False, "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": {},
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev)
                       if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": peak}}
    path = tracer.write()
    if not trace:
        values = dict(result["metrics"], setup_s=setup_s)
        for m in end_to_end_for(spec, name):
            line["metrics"][m["name"]] = {
                "value": values[m["name"].split(".", 1)[0]],
                "unit": m["unit"]}
    elif path is not None:
        tr = trace_mod.load(path)
        mctx = types.SimpleNamespace(
            trace=tr, cell=cell, config=config,
            work=kind.unit_work(state),
            host_s=list(getattr(state, "host_s", [])))
        for m in per_layer_for(spec, name):
            value = load_module("metrics", m["name"], root).read(mctx)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        line["device"]["busy_s"] = tr.busy_s
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
        log(f"{name}: traced {tr.units} units, {len(tr.kernels)} kernels, "
            f"busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s")
    if cuda:
        line["card"] = _power_limit()

    kind.release(state)
    program = ctx.program = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = kind.check(state)
    log(f"{name}: the reference's check took "
        f"{time.perf_counter() - t_check:.3f} s")
    limits = cell["limits"]
    checks = {}
    for key, value in readings.items():
        checks[key] = {"value": value, "limit": float(limits[key])}
    line["correct"] = all(not math.isnan(c["value"])
                          and c["value"] <= c["limit"]
                          for c in checks.values())
    line["checks"] = checks
    return line
