"""Model wrapper base: the uniform ``model(x, return_ue=False)`` contract.

Counterpart of ``nnueehcs_tpu/models/base.py``. Training side: the
trainer differentiates :meth:`WrappedModelBase.training_loss` (the network
in training mode, the loss named by ``train_config['loss']``) and scores
a validation pass through the evaluation path, the serving kernels on the
card: :meth:`WrappedModelBase.validation_losses` scores every full batch
from one evaluation of all their rows (the JAX trainer's scanned
validation; rows are independent in evaluation mode, so a batch's loss is
the one :meth:`WrappedModelBase.validation_loss` gives it alone), and
``validation_loss`` scores a partial tail batch. A network is built in evaluation mode; the
trainer switches modes explicitly. Evaluation side: a call
casts float64 input to float32, pads the batch up to a power-of-two bucket
(256 .. 2^19 rows) by repeating its first row, chunks anything larger than
2^19 rows, runs :meth:`WrappedModelBase.eval_output` and trims the padding.
Forward passes are row-independent, so the padding changes no answer; the
buckets keep the set of shapes the device sees small. The buckets are
sized for rows of features; an NCHW image holds more activations a row, so
its largest bucket and its chunks hold proportionally fewer images
(:meth:`WrappedModelBase.max_rows`).

Meshes (:mod:`~nnueehcs_tpu_torch.parallel`): ``attach_mesh(mesh)``, as
in the JAX package, shards evaluation. Every rank calls the model with the
same request (one program on every rank, as JAX's one controller sees
it): the bucket rounds up to a multiple of ``dp``, each rank runs the
model's usual path (its kernel on the card) on its ``bucket / dp`` rows
(:meth:`WrappedModelBase.eval_rows`), and an all-gather over ``dp``
returns the whole answer on every rank. An ensemble on a ``member`` axis
holds its rank's members and merges their statistics
(:mod:`~nnueehcs_tpu_torch.models.ensemble`); KDE and kNN-KDE split their
corpus over ``dp`` (:mod:`~nnueehcs_tpu_torch.models.kde`).

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
from ..parallel.mesh import local_rows, placed

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
    #: activations in one row of the largest bucket: the buckets are sized
    #: for rows of features at width 128 (2^19 rows, 256 MiB of fp32 a
    #: layer, as the JAX package sizes them)
    ROW_ELEMENTS = 128

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
        self._row_elements = {}
        self._mesh = None

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

    # ------------------------------------------------------------- sharding
    @property
    def mesh(self):
        """The attached :class:`~nnueehcs_tpu_torch.parallel.Mesh`, or
        None."""
        return self._mesh

    def attach_mesh(self, mesh):
        """Shard evaluation over ``mesh`` (see the module docstring): the
        model's ``member``-sharded state, if any, goes to this rank's
        slice. The model must already be on the mesh's device (when it
        names one): another device raises ``ValueError``, as a model is
        never moved off its card. Every rank of the mesh attaches it, with
        the same model."""
        placed(mesh, self.device)
        self._mesh = mesh
        self._shard_members()
        return self

    def _shard_members(self):
        """Hold this rank's part of a member-stacked model (ensembles)."""

    def _dp(self) -> int:
        return 1 if self._mesh is None else self._mesh.axis_size('dp')

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

    def _row_sample(self, x):
        """One row of ``x`` as the network takes it."""
        return x[:1]

    def row_elements(self, x):
        """The most activations one row of ``x`` holds at any layer of the
        network (every member's, for a stacked network), from an
        evaluation-mode forward of one row (kept per sample shape)."""
        key = tuple(x.shape[1:])
        if key not in self._row_elements:
            sizes, training = [], self.net.training
            hooks = [layer.register_forward_hook(
                lambda mod, args, out: sizes.append(out.numel()))
                for layer in self.net.layers]
            try:
                with torch.no_grad():
                    self.net.eval()(self._row_sample(x))
            finally:
                self.net.train(training)
                for hook in hooks:
                    hook.remove()
            self._row_elements[key] = max(sizes)
        return self._row_elements[key]

    def max_rows(self, x) -> int:
        """Most rows of ``x`` one forward takes: the largest bucket for
        rows of features; for images (NCHW), a power of two of them that
        holds no more activations at the network's widest layer than that
        bucket of ROW_ELEMENTS-wide rows."""
        if x.dim() <= 2:
            return _MAX_BUCKET
        rows = _MAX_BUCKET * self.ROW_ELEMENTS // max(self.row_elements(x),
                                                      self.ROW_ELEMENTS)
        return 1 << max(rows.bit_length() - 1, 0)

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
            return self.validation_score(self.validation_output(x), y)

    def validation_output(self, x, row0: int = 0, seeds=None,
                          rows_per_seed: int = 1):
        """The prediction a validation loss scores for rows ``x``: the
        evaluation-mode output. ``row0``, ``seeds`` and ``rows_per_seed``
        place ``x`` in a batched pass for a stochastic evaluation (MC
        dropout's seed table); unused here."""
        return self.eval_output(x)

    def validation_score(self, pred, y, batched: bool = False):
        """The validation loss of ``pred`` against ``y``; with ``batched``,
        one loss for each batch of the leading axis."""
        return self.loss(pred, y, batched=batched)

    def validation_rows(self, x) -> int:
        """Most rows of ``x`` one evaluation of a batched validation pass
        takes: the model call's chunk."""
        return self.max_rows(x)

    def validation_losses(self, xs, ys, seeds=None):
        """``(nb,)``: the validation losses of the ``nb`` batches of ``xs``
        ``(nb, bs, ...)`` against ``ys`` ``(nb, bs, ...)``, each equal in
        value to :meth:`validation_loss` of its batch, from one evaluation
        of all ``nb * bs`` rows (one more only past
        :meth:`validation_rows`). ``seeds``: each batch's sampling seed
        (MC dropout's), unused here."""
        nb, bs = xs.shape[:2]
        x = xs.reshape((nb * bs,) + xs.shape[2:])
        limit = self.validation_rows(x)
        with torch.no_grad():
            pred = torch.cat([
                self.validation_output(x[lo:lo + limit], lo, seeds, bs)
                for lo in range(0, x.shape[0], limit)])
            return self.validation_score(
                pred.reshape((nb, bs) + pred.shape[1:]), ys, batched=True)

    # ------------------------------------------------------------- pure eval
    def eval_rows(self, x, lo: int, hi: int, return_ue: bool = False):
        """The answer for rows ``lo .. hi - 1`` of the padded bucket ``x``
        (all of it without a dp mesh; every rank holds the whole bucket).
        Rows are independent, so by default it is :meth:`eval_output` of
        those rows."""
        rows = x if (lo, hi) == (0, x.shape[0]) else x[lo:hi]
        return self.eval_output(rows, return_ue=return_ue)

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
        n, limit = x.shape[0], self.max_rows(x)
        if n > limit:
            outputs = [self(x[i:i + limit], return_ue=return_ue)
                       for i in range(0, n, limit)]
            if isinstance(outputs[0], tuple):
                return tuple(torch.cat([o[i] for o in outputs])
                             for i in range(len(outputs[0])))
            return torch.cat(outputs)
        bucket = min(_bucket_size(n), limit)
        dp = self._dp()
        # the padded batch must divide evenly over the dp axis
        bucket = -(-bucket // dp) * dp
        if bucket != n:
            # pad with the first row repeated to keep values in-distribution
            x = torch.cat([x, x[:1].expand((bucket - n,) + x.shape[1:])])
        lo, hi = local_rows(bucket, self._mesh)
        with torch.no_grad():
            out = self.eval_rows(x.contiguous(), lo, hi, return_ue)
        if dp > 1:
            gather = lambda o: self._mesh.all_gather(o, 'dp')  # noqa: E731
            out = tuple(map(gather, out)) if isinstance(out, tuple) \
                else gather(out)

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
