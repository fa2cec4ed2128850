"""Probes: scripts that measure one question about a kernel on the card.
Nothing in the package imports them."""
