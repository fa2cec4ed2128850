"""Utilities of the PyTorch port: checkpointing, profiling, configs,
metrics, debug guards.

The names of ``difffe_tpu/utils/__init__.py``, with ``timeit_torch`` in
the place of ``timeit_jax``."""

from .checkpoint import CheckpointManager
from .debug import check_deterministic, golden_compare, nan_guard
from .config import BASELINE_CONFIGS, ScenarioConfig
from .metrics import MetricsLogger
from .profiling import Roofline, TimingResult, roofline, timeit_torch, trace

__all__ = [
    "CheckpointManager",
    "check_deterministic",
    "golden_compare",
    "nan_guard",
    "BASELINE_CONFIGS",
    "ScenarioConfig",
    "MetricsLogger",
    "Roofline",
    "TimingResult",
    "roofline",
    "timeit_torch",
    "trace",
]
