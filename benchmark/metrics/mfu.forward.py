"""The traced calls' share of the card's float32 peak (one CG solve a call;
moves ``solves_per_s``)."""

from benchmark.metrics._read import mfu as read  # noqa: F401
