"""The traced calls' share of the card's float32 peak in the forward cells
whose rate the host paces (moves ``solves_per_s.host_paced``)."""

from benchmark.metrics._read import mfu as read  # noqa: F401
