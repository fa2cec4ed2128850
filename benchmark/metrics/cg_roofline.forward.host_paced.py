"""The CG kernels' share of their roofline in the forward cells whose
rate the host paces (moves ``solves_per_s.host_paced``)."""

from benchmark.metrics._read import cg_roofline as read  # noqa: F401
