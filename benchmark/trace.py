"""Reading a ``torch.profiler`` Chrome trace into what the per-layer metrics
need: the traced window, the device's busy time, each kernel with the
program op it ran under, the program ops' calls with their arguments, and
the idle gaps with what the host was doing in them.

A kernel belongs to the op under which it was launched: its CUPTI
correlation id names the runtime (or driver) call that launched it, and the
host events enclosing that call on its thread are the launch's stack.  The
traced window is the span of the ``UNIT`` annotations the harness puts
around each traced job or call.
"""

from __future__ import annotations

import collections
import dataclasses
import json

UNIT = "bench.unit"
OP_PREFIX = "difffe::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Kernel:
    name: str
    start: float        # µs
    end: float
    op: str | None      # the outermost program op it ran under


@dataclasses.dataclass
class OpCall:
    name: str
    concrete_inputs: list
    input_dims: list


class _Sweep:
    """The host events of one thread, for asking which enclose each of
    many times, in one pass (events on a thread nest)."""

    def __init__(self, events):
        # outer events first where two start together
        self.events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))

    def stacks(self, times):
        """For each time, the events enclosing it, outermost first."""
        order = sorted(range(len(times)), key=lambda k: times[k])
        out = [None] * len(times)
        stack, i = [], 0
        for k in order:
            t = times[k]
            while i < len(self.events) and self.events[i]["ts"] <= t:
                e = self.events[i]
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                    stack.pop()
                stack.append(e)
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
                stack.pop()
            out[k] = [e for e in stack if e["ts"] + e["dur"] >= t]
        return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


@dataclasses.dataclass
class Trace:
    window: tuple           # (start, end) µs
    units: int              # traced jobs or calls
    kernels: list           # Kernel, those that start in the window
    device_busy: list       # merged device intervals clipped to the window
    op_calls: list          # OpCall, outermost program ops in the window
    gaps: list              # (start, end, host activity)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.device_busy) * 1e-6

    def device_ops(self, top=10):
        """[name, seconds] of the kernels that took most time, by name."""
        total = collections.Counter()
        for k in self.kernels:
            total[k.name[:120]] += (k.end - k.start) * 1e-6
        return [[n, s] for n, s in total.most_common(top)]

    def idle_gaps(self, top=10):
        """[activity, seconds]: the idle time by what the host was doing
        in it (the innermost host event), with the number of gaps."""
        total, count = collections.Counter(), collections.Counter()
        for a, b, what in self.gaps:
            total[what] += (b - a) * 1e-6
            count[what] += 1
        return [[f"{w} (x{count[w]})", s] for w, s in total.most_common(top)]


def load(path) -> Trace:
    with open(path) as fh:
        return parse(json.load(fh))


def parse(data) -> Trace:
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    units = [e for e in spans if e["name"] == UNIT
             and e.get("cat") == "user_annotation"]
    if not units:
        raise ValueError("the trace holds no traced unit")
    w0 = min(e["ts"] for e in units)
    w1 = max(e["ts"] + e["dur"] for e in units)
    main_tid = units[0]["tid"]

    host = collections.defaultdict(list)
    for e in spans:
        if e.get("cat") in HOST_CATS:
            host[e["tid"]].append(e)
    launches = {}
    for e in spans:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    by_ext = {}
    for e in spans:
        if e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                by_ext.setdefault(ext, e)

    device = [e for e in spans if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    kern = [e for e in device if e.get("cat") == "kernel"
            and w0 <= e["ts"] < w1]
    # each kernel's launch: (thread, time) on the host
    where = []
    for e in kern:
        args = e.get("args", {})
        src = launches.get(args.get("correlation"))
        if src is None:
            src = by_ext.get(args.get("External id"))
        where.append(None if src is None else (src["tid"], src["ts"]))
    stacks = {}
    for tid in {w[0] for w in where if w is not None}:
        idx = [k for k, w in enumerate(where) if w is not None
               and w[0] == tid]
        got = _Sweep(host.get(tid, [])).stacks([where[k][1] for k in idx])
        for k, s in zip(idx, got):
            stacks[k] = s
    kernels = []
    for k, e in enumerate(kern):
        ops = [h["name"] for h in stacks.get(k, [])
               if h["name"].startswith(OP_PREFIX)]
        kernels.append(Kernel(e["name"], e["ts"], e["ts"] + e["dur"],
                              ops[0] if ops else None))

    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in device)
    holes, t = [], w0
    for a, b in busy:
        if a > t:
            holes.append((t, a))
        t = max(t, b)
    if t < w1:
        holes.append((t, w1))
    main = _Sweep(host.get(main_tid, []))
    mids = main.stacks([(a + b) / 2.0 for a, b in holes])
    gaps = []
    for (a, b), s in zip(holes, mids):
        inner = [h["name"] for h in s if h["name"] != UNIT]
        gaps.append((a, b, inner[-1] if inner else "host outside any op"))

    ops = [e for e in host.get(main_tid, [])
           if e.get("cat") == "cpu_op" and e["name"].startswith(OP_PREFIX)
           and w0 <= e["ts"] < w1]
    calls = []
    for e, s in zip(ops, main.stacks([e["ts"] for e in ops])):
        outer = [h for h in s if h["name"].startswith(OP_PREFIX)]
        if outer and outer[0] is not e:
            continue            # an op called inside another counts once
        args = e.get("args", {})
        calls.append(OpCall(e["name"], args.get("Concrete Inputs", []),
                            args.get("Input Dims", [])))
    return Trace((w0, w1), len(units), kernels, busy, calls, gaps)
