"""Kernels and their plain PyTorch versions, the attribution probes of
kernels 1 and 3, and the loss registry."""
from . import ablate_epoch
from . import ablate_forward
from . import fused_anchored
from . import fused_ensemble
from . import fused_mc_dropout
from . import fused_train
from . import kde
from . import losses

__all__ = ['ablate_epoch', 'ablate_forward', 'fused_anchored',
           'fused_ensemble', 'fused_mc_dropout', 'fused_train', 'kde',
           'losses']
