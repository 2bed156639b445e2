"""Utilities: device timing (``timing``) and profiling (``profiling``)."""
from .timing import device_sync, timed_passes

__all__ = ['device_sync', 'timed_passes']
