"""Counterparts of ``examples/bo_driven/``."""
