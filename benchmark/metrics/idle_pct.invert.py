"""The device's idle share of the traced jobs (moves
``grad_solves_per_s``)."""

from benchmark.metrics._read import idle_pct as read  # noqa: F401
