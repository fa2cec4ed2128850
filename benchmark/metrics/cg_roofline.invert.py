"""The CG kernels' share of their roofline in the invert cells (moves
``grad_solves_per_s``)."""

from benchmark.metrics._read import cg_roofline as read  # noqa: F401
