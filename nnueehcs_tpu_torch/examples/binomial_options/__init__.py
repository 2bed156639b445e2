"""Counterparts of ``examples/binomial_options/``."""
