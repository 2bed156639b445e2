"""nnueehcs_tpu_torch: the PyTorch/CUDA port of nnueehcs_tpu.

A second package beside the JAX one, ported slice by slice. It imports
torch, numpy and the standard library only, never jax or nnueehcs_tpu. It
serves trained bundles of every UQ method: the architecture-list network
builder, the MLP, ensemble, MC-dropout, Δ-UQ, PAGER, KDE, kNN-KDE and MVE
wrappers and builders, ``model.pth`` bundles and the bucketed
``Predictor``. It trains the ensemble, MLP, MVE, KDE, kNN-KDE and MC-dropout
models (``training.Trainer``). The fused UE passes, the KDE density and the
whole training epoch are hand-written CUDA kernels for Hopper
(``ops/csrc/*.cu``: ensemble, MC dropout, anchored, KDE, training), each
beside its plain PyTorch version. It runs the BO experiment loop
(``driver.run_bo_experiment``, ``python -m nnueehcs_tpu_torch.driver``):
the datasets (``data_utils``, ``datagen``, the native delimited parser),
the metrics (``evaluation``, ``classification``), the BO engine (``bo``),
the results tree (``utility``) and a reader and writer of the configs'
YAML subset (``config``). The user entry points of ``examples/`` (the HTTP
server, the post-hoc metric and classification tools, collate, the
workflow drivers, the data generator) are ported under ``examples/``,
profiling helpers on ``torch.profiler`` under ``utils/profiling.py``.
Entry points take ``device`` (default ``'cuda'``) and never fall back to
the CPU on their own.
"""

__version__ = '0.1.0'

from . import bo
from . import classification
from . import config
from . import convert
from . import data_utils
from . import datagen
from . import evaluation
from . import model_builder
from . import models
from . import nn
from . import ops
from . import serving
from . import training
from . import utility
from . import utils
