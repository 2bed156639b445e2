"""Kernels and their plain PyTorch versions."""
from . import fused_ensemble

__all__ = ['fused_ensemble']
