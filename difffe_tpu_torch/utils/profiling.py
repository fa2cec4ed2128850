"""Honest device timing on the card.

PyTorch counterpart of ``timeit_chained`` in
``difffe_tpu/utils/profiling.py``: ``length`` data-chained steps (step
N+1 consumes step N's carry, so no launch can be skipped or overlapped
with an identical one), CUDA events around the loop and one
``torch.cuda.synchronize()`` at its end.  This is the only timing the
port's benchmarks use; repeated identical calls time the launch queue,
not the device.
"""

from __future__ import annotations

import dataclasses
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
