"""Numerical operators of the PyTorch port."""
