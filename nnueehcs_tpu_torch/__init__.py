"""nnueehcs_tpu_torch: the PyTorch/CUDA port of nnueehcs_tpu.

A second package beside the JAX one, ported slice by slice. It imports
torch, numpy and the standard library only, never jax or nnueehcs_tpu. This
slice serves a deep ensemble: the architecture-list network builder, the
MLP and ensemble wrappers and builders, ``model.pth`` bundles, the bucketed
``Predictor``, and the fused ensemble UE pass as a hand-written CUDA kernel
for Hopper (``ops/csrc/fused_ensemble.cu``) beside its plain PyTorch
version. Entry points take ``device`` (default ``'cuda'``) and never fall
back to the CPU on their own.
"""

__version__ = '0.1.0'

from . import convert
from . import model_builder
from . import models
from . import nn
from . import ops
from . import serving
from . import training
from . import utils
