"""Model wrapper base: the uniform ``model(x, return_ue=False)`` contract.

Counterpart of ``nnueehcs_tpu/models/base.py``, evaluation side. A call
casts float64 input to float32, pads the batch up to a power-of-two bucket
(256 .. 2^19 rows) by repeating its first row, chunks anything larger than
2^19 rows, runs :meth:`WrappedModelBase.eval_output` and trims the padding.
Forward passes are row-independent, so the padding changes no answer; the
buckets keep the set of shapes the device sees small.
"""
from __future__ import annotations

import copy

import torch

from .. import convert

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
_BF16_PRECISIONS = ('bf16', 'bf16-mixed', 'bf16-true')


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
        self.dtype = torch.float32

    def set_precision(self, precision):
        """Only fp32 is ported; bf16 compute is a later item."""
        if precision in _BF16_PRECISIONS:
            raise NotImplementedError(f'precision {precision!r}: only fp32 '
                                      'evaluation is ported')
        if precision not in _FP32_PRECISIONS:
            raise ValueError(f'Unsupported precision {precision!r}')
        self.precision = precision
        return self

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def to(self, device):
        """Place the model on ``device`` (a CUDA device must exist)."""
        self.net.to(resolve_device(device))
        return self

    def init(self, generator: torch.Generator):
        """Draw fresh parameters from ``generator``."""
        self.net.reset_parameters(generator)
        return self

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
            o = o[:n]
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
        """Weights as numpy arrays in the JAX package's layout."""
        params, state = convert.to_pytrees(self.net)
        return {'params': params, 'state': state}

    def load_arrays(self, arrays: dict):
        convert.load_pytrees(self.net, _tuplify(arrays['params']),
                             _tuplify(arrays['state']))
