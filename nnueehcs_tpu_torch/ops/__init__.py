"""Kernels and their plain PyTorch versions."""
from . import fused_anchored
from . import fused_ensemble
from . import fused_mc_dropout
from . import kde

__all__ = ['fused_anchored', 'fused_ensemble', 'fused_mc_dropout', 'kde']
