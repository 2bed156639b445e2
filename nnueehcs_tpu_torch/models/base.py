"""Model wrapper base: the uniform ``model(x, return_ue=False)`` contract.

Counterpart of ``nnueehcs_tpu/models/base.py``. Training side: the
trainer differentiates :meth:`WrappedModelBase.training_loss` (the network
in training mode, the loss named by ``train_config['loss']``) and scores
:meth:`WrappedModelBase.validation_loss` through the evaluation path, the
serving kernels on the card. A network is built in evaluation mode; the
trainer switches modes explicitly. Evaluation side: a call
casts float64 input to float32, pads the batch up to a power-of-two bucket
(256 .. 2^19 rows) by repeating its first row, chunks anything larger than
2^19 rows, runs :meth:`WrappedModelBase.eval_output` and trims the padding.
Forward passes are row-independent, so the padding changes no answer; the
buckets keep the set of shapes the device sees small.

Precision: ``set_precision`` takes the JAX package's names. ``'bf16'``,
``'bf16-mixed'`` and ``'bf16-true'`` all mean bf16 GEMM operands with fp32
accumulation, everything else fp32 (``Network.compute_dtype``, the kernels'
bf16 forms); fp32 is the default, and a ``'16'`` (fp16) precision raises
``ValueError``, as in JAX. A call returns fp32 in either precision.
"""
from __future__ import annotations

import copy

import torch

from .. import convert
from ..ops.losses import get_loss_fn

training_defaults = {
    'learning_rate': 1e-3,
    'batch_size': 32,
    'num_workers': 1,
    'num_epochs': 10,
    'loss': 'l1_loss',
}

_MIN_BUCKET = 256
_MAX_BUCKET = 1 << 19

_FP32_PRECISIONS = (None, '32', '32-true', 32)
BF16_PRECISIONS = ('bf16', 'bf16-mixed', 'bf16-true')


def _bucket_size(n: int) -> int:
    b = _MIN_BUCKET
    while b < n and b < _MAX_BUCKET:
        b *= 2
    return b


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist. There is
    no fallback to the CPU: pass ``device='cpu'`` to run there."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the CPU")
    return dev


def _tuplify(t):
    """Pickle round-trips may turn tuples into lists; restore tuples."""
    if isinstance(t, (list, tuple)):
        return tuple(_tuplify(x) for x in t)
    return t


class WrappedModelBase:
    """Base for the UQ model wrappers."""

    uq_method = 'mlp'

    def __init__(self, net, train_config=None, validation_config=None):
        self.net = net.eval()
        self.train_config = copy.deepcopy(training_defaults)
        self.validation_config = copy.deepcopy(training_defaults)
        self.train_config.update(train_config or {})
        self.validation_config.update(validation_config or self.train_config)
        self.set_precision(self.train_config.get('precision'))
        self.loss = get_loss_fn(self.train_config['loss'])
        self.dtype = torch.float32
        self._folded = None
        self._folded_key = None

    def set_precision(self, precision):
        """Set the compute precision: under a bf16 name the activations and
        GEMM operands run in bf16 (every dot accumulating in fp32) while
        the parameters stay fp32 master weights; outputs stay fp32. The
        folded kernel weights are rebuilt on the next call."""
        if precision in BF16_PRECISIONS:
            compute_dtype = torch.bfloat16
        elif precision in _FP32_PRECISIONS:
            compute_dtype = None
        else:
            raise ValueError(f'Unsupported precision {precision!r}; the '
                             "options are '32-true' (default) and "
                             "'bf16-mixed'")
        self.precision = precision
        self.net.compute_dtype = compute_dtype
        return self

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def to(self, device):
        """Place the model on ``device`` (a CUDA device must exist)."""
        self.net.to(resolve_device(device))
        return self

    def eval(self):
        """No-op kept for the JAX package's API (the metrics call it): the
        network is in evaluation mode outside the trainer's steps."""
        return self

    def init(self, generator: torch.Generator):
        """Draw fresh parameters from ``generator``."""
        self.net.reset_parameters(generator)
        return self

    def _params_key(self):
        # data_ptr changes when tensors move or are replaced, _version on
        # every in-place write (load_arrays, optimiser steps); the compute
        # dtype picks the weights' form
        return (self.net.compute_dtype,) + tuple(
            (t.data_ptr(), t._version)
            for t in (*self.net.parameters(), *self.net.buffers()))

    def _folded_weights(self, prepare):
        """``prepare(self.net)`` (folded, packed weights for a kernel, or
        None), rebuilt only when the parameters, the BN state or the
        precision change."""
        key = self._params_key()
        if key != self._folded_key:
            self._folded = prepare(self.net)
            self._folded_key = key
        return self._folded

    def get_callbacks(self):
        return []

    # ----------------------------------------------------------------- training
    def train_output(self, x, generator=None):
        """The network's output in its current mode (the trainer puts it in
        training mode); ``generator`` feeds the Dropout layers."""
        return self.net(x, generator)

    def train_targets(self, y):
        return y

    def training_loss(self, batch, generator=None):
        """The loss the trainer differentiates. In training mode the
        network's BatchNorm layers move their running statistics."""
        x, y = batch
        return self.loss(self.train_output(x, generator), self.train_targets(y))

    def validation_loss(self, batch, seed: int = 0):
        """The training loss of the evaluation-mode prediction, as the
        reference's validation step computes it; ``seed`` is the sampling
        seed of a stochastic evaluation (MC dropout), unused here."""
        x, y = batch
        with torch.no_grad():
            return self.loss(self.eval_output(x), y)

    # ------------------------------------------------------------- pure eval
    def eval_output(self, x, return_ue: bool = False):
        if return_ue:
            raise NotImplementedError(
                f'{type(self).__name__} does not define an uncertainty estimate')
        return self.net(x)

    def __call__(self, x, return_ue: bool = False):
        x = torch.as_tensor(x, device=self.device)
        if x.dtype == torch.float64:
            x = x.to(self.dtype)
        squeeze_batch = x.dim() == 1
        if squeeze_batch:
            x = x[None]
        n = x.shape[0]
        if n > _MAX_BUCKET:
            outputs = [self(x[i:i + _MAX_BUCKET], return_ue=return_ue)
                       for i in range(0, n, _MAX_BUCKET)]
            if isinstance(outputs[0], tuple):
                return tuple(torch.cat([o[i] for o in outputs])
                             for i in range(len(outputs[0])))
            return torch.cat(outputs)
        bucket = _bucket_size(n)
        if bucket != n:
            # pad with the first row repeated to keep values in-distribution
            x = torch.cat([x, x[:1].expand((bucket - n,) + x.shape[1:])])
        with torch.no_grad():
            out = self.eval_output(x.contiguous(), return_ue=return_ue)

        def trim(o):
            o = o[:n].float()
            return o[0] if squeeze_batch else o
        if isinstance(out, tuple):
            return tuple(trim(o) for o in out)
        return trim(out)

    # ----------------------------------------------------------- checkpoints
    def config_dict(self) -> dict:
        return {
            'class': type(self).__name__,
            'uq_method': self.uq_method,
            'architecture': self.net.architecture,
            'train_config': self.train_config,
            'validation_config': self.validation_config,
        }

    def arrays_dict(self) -> dict:
        """Weights as numpy arrays in the JAX package's layout, plus the
        model's own arrays (anchors, for instance)."""
        params, state = convert.to_pytrees(self.net)
        return {'params': params, 'state': state, **self._extra_arrays()}

    def _extra_arrays(self) -> dict:
        return {}

    def load_arrays(self, arrays: dict):
        convert.load_pytrees(self.net, _tuplify(arrays['params']),
                             _tuplify(arrays['state']))
        self._load_extra_arrays(arrays)

    def _load_extra_arrays(self, arrays: dict):
        pass
