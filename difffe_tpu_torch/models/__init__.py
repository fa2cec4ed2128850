"""Neural surrogates (models/neural.py)."""
