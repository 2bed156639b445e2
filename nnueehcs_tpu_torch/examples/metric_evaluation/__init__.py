"""Counterparts of ``examples/metric_evaluation/``."""
