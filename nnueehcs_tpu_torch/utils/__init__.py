"""Utilities: device timing."""
from .timing import device_sync, timed_passes

__all__ = ['device_sync', 'timed_passes']
