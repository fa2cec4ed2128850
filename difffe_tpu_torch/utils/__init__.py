"""Utilities of the PyTorch port: honest device timing (profiling.py),
scenario configs (config.py) and the metrics stream (metrics.py)."""
