"""The host's median time in one solve call until it returns, in the
forward cells whose rate the host paces (moves
``solve_ms_p95.host_paced``)."""

from benchmark.metrics._read import host_ms_per_call as read  # noqa: F401
