"""Kernels and their plain PyTorch versions, and the loss registry."""
from . import fused_anchored
from . import fused_ensemble
from . import fused_mc_dropout
from . import fused_train
from . import kde
from . import losses

__all__ = ['fused_anchored', 'fused_ensemble', 'fused_mc_dropout',
           'fused_train', 'kde', 'losses']
