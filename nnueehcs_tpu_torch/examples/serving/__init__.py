"""Counterparts of ``examples/serving/``."""
