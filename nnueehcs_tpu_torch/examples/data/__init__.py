"""Counterparts of ``examples/data/``."""
