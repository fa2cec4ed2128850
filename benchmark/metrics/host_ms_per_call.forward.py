"""The host's median time in one solve call until it returns (moves
``solve_ms_p95``)."""

from benchmark.metrics._read import host_ms_per_call as read  # noqa: F401
