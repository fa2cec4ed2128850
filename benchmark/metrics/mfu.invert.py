"""The traced jobs' share of the card's float32 peak (two CG solves a step
and the eval; moves ``grad_solves_per_s``)."""

from benchmark.metrics._read import mfu as read  # noqa: F401
