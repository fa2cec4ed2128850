"""Timing, tracing and speed-of-light helpers on the card.

PyTorch counterpart of ``difffe_tpu/utils/profiling.py``:

* ``timeit_chained`` — ``length`` data-chained steps (step N+1 consumes
  step N's carry, so no launch can be skipped or overlapped with an
  identical one), CUDA events around the loop and one
  ``torch.cuda.synchronize()`` at its end.  This is the only timing the
  port's figures use; repeated identical calls time the launch queue,
  not the device.
* ``timeit_torch`` — ``timeit_jax``'s counterpart: ``iters`` calls with one
  trailing synchronization, then a per-call minimum of a few synchronized
  calls.  A quick look at a callable, never a figure.
* ``trace`` — a ``torch.profiler`` capture that writes a Chrome trace
  into a directory.
* ``roofline`` — achieved FLOP/s and bytes/s of a timing against the
  card's published peaks, and which of the two ceilings the work sits
  under.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class TimingResult:
    mean_s: float
    min_s: float
    iters: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def throughput(self, items: int) -> float:
        """items processed per second at the mean latency."""
        return items / self.mean_s


def _sync() -> None:
    """Wait for the card's queued work (CPU ops have finished on return)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit_torch(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                 **kwargs) -> TimingResult:
    """Time ``fn(*args, **kwargs)``: ``warmup`` calls (builds, caches),
    then ``iters`` calls with one trailing synchronization (the mean), and
    the minimum of ``min(iters, 5)`` calls synchronized one by one.

    Repeated identical calls can overlap on the card, so this is a quick
    look, not a device time: figures come from :func:`timeit_chained`.
    """
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()

    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    mean = (time.perf_counter() - t0) / iters

    best = float("inf")
    for _ in range(min(iters, 5)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return TimingResult(mean_s=mean, min_s=best, iters=iters)


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write ``logdir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, profile_memory=with_memory) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Published peaks of one card (NVIDIA's data sheet, dense rates without
# sparsity), which assume its full power limit.
CHIP_PEAKS = {
    # name: ({dtype: peak TFLOP/s}, HBM GB/s, power limit W)
    "h100_sxm": ({"f32": 67.0, "tf32": 495.0, "bf16": 989.0}, 3350.0,
                 700.0),
}


@dataclasses.dataclass(frozen=True)
class Roofline:
    achieved_tflops: float
    achieved_gbps: float
    flops_fraction: float
    bandwidth_fraction: float
    bound: str  # 'compute' | 'memory'


def roofline(timing: TimingResult, flops: float, bytes_moved: float,
             chip: str = "h100_sxm", dtype: str = "f32") -> Roofline:
    """Judge work of ``flops`` operations moving ``bytes_moved`` bytes in
    ``timing.min_s`` against ``chip``'s peaks for ``dtype`` ('f32' outside
    the tensor cores, 'tf32' or 'bf16' on them).  A card set below the
    power limit in ``CHIP_PEAKS`` runs slower than these peaks."""
    if chip not in CHIP_PEAKS:
        raise ValueError(f"unknown chip {chip!r}; known: {sorted(CHIP_PEAKS)}")
    peaks, peak_gbps, _ = CHIP_PEAKS[chip]
    if dtype not in peaks:
        raise ValueError(f"no {dtype!r} peak for {chip}; known: "
                         f"{sorted(peaks)}")
    peak_tflops = peaks[dtype]
    t = timing.min_s
    achieved_tflops = flops / t / 1e12
    achieved_gbps = bytes_moved / t / 1e9
    ai = flops / max(bytes_moved, 1.0)  # arithmetic intensity
    ridge = peak_tflops * 1e12 / (peak_gbps * 1e9)
    return Roofline(
        achieved_tflops=achieved_tflops,
        achieved_gbps=achieved_gbps,
        flops_fraction=achieved_tflops / peak_tflops,
        bandwidth_fraction=achieved_gbps / peak_gbps,
        bound="memory" if ai < ridge else "compute",
    )


def timeit_chained(step_fn: Callable, x0, length: int = 32,
                   repeats: int = 3, args=()) -> TimingResult:
    """Per-step device time of ``step_fn(carry, *args) -> carry`` chained
    ``length`` times, over ``repeats`` timed runs after one warm-up run.

    Needs a CUDA card: a measurement that finds none raises instead of
    timing the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("timeit_chained measures the CUDA device and "
                           "none is available")

    def run():
        c = x0
        for _ in range(length):
            c = step_fn(c, *args)
        return c

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / length)
    return TimingResult(mean_s=sum(times) / len(times), min_s=min(times),
                        iters=length * repeats)
