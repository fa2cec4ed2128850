"""The device's idle share of the traced calls in the forward cells whose
rate the host paces (moves ``solves_per_s.host_paced``)."""

from benchmark.metrics._read import idle_pct as read  # noqa: F401
