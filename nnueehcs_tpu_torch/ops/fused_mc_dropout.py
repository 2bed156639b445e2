"""Fused MC-dropout evaluation: the dropout masks, the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``nnueehcs_tpu/ops/fused_ensemble.py`` (``_fused_mc_kernel``
and ``fused_mc_dropout_eval``). The network is folded once (eval BatchNorm
into the Linears, a Dropout recorded before the Linear it feeds); a UE pass
runs one dropout-free forward as the shift ``c``, then ``S`` forwards with
keep masks, and takes mean and unbiased std over the ``S`` samples from
sums shifted by ``c``.

The TPU kernel draws its masks from the chip's hardware PRNG. The port
draws them from a counter-based hash instead, the lowbias32 finalizer of
``nnueehcs_tpu/ops/fused_train.py``: the bits for (call seed, sample,
Dropout module index, row, column) are a pure function of those five
numbers, so the kernel, :func:`fused_mc_forward_plain` and
:func:`mc_forward_modules` draw the same masks and agree to round-off, and
a row's answer does not depend on the rows padded around it. A row's index
is ``row0`` plus its index in ``x``: a rank that evaluates rows ``lo ..``
of a dp-sharded request passes ``row0=lo`` and draws, bit for bit, the
masks of the unsharded call. A seed table (``seeds``, ``rows_per_seed``)
gives each run of ``rows_per_seed`` rows its own seed: row ``R`` (counted
from ``row0`` as above) draws with ``seeds[R // rows_per_seed]`` at row
``R % rows_per_seed``, so one call over a batched validation pass draws,
bit for bit, the masks of one call a batch with that batch's seed. A
value is
kept when the top 24 bits of its draw fall below ``keep * 2^24``, and kept
values are scaled by ``1/keep``; rate 1 drops everything (zeros, not NaN).

In bf16 (the weights' ``compute_dtype``, the JAX kernel's
``compute_dtype=bfloat16`` form) the masks and their scale are applied in
fp32 and the activation is rounded to bf16 only at the next dot; the
dropout-free shift pass runs in bf16 too. ``fused_mc_forward.launches``
counts the fp32 kernel's launches, ``.launches_bf16`` the bf16 form's.

The fp32 kernel runs its products as 3xTF32 on the tensor cores and splits
a tile's samples into ``fused_eval_chain.GROUPS`` groups, each shifted by
its own first sample and merged by Chan's formula in group order; it has
no dropout-free pass. Its answers differ from the plain version's by
round-off only, within the tests' tolerances.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..nn.layers import Dropout, Linear
from .fused_eval_chain import launch_args
from .fused_ensemble import (FusedWeights, _check_widths, check_weights_dtype,
                             check_x, compute_dtype_of, device_values,
                             fold_mc_dropout_params, shifted_stats)

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for uint32 values held in int64 tensors (or Python
    ints), split in 16-bit halves so no product leaves int64's range."""
    return (((x & 0xFFFF) * c) + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def lowbias32(x):
    """The lowbias32 integer finalizer on uint32 values (int64 tensors or
    Python ints); the CUDA kernel computes the same in uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mask_stream(seed: int, sample: int, key: int) -> int:
    """The per-(call seed, sample, Dropout module index) stream word."""
    return lowbias32((lowbias32((seed + _mul32(sample, 0x9E3779B9)) & _M32)
                      + _mul32(key, 0x85EBCA6B)) & _M32)


def mc_call_seed(base_seed: int, index: int) -> int:
    """The kernel seed of the ``index``-th model call after ``reseed(base)``."""
    return lowbias32((lowbias32(base_seed & _M32) + _mul32(index, 0x632BE5AB))
                     & _M32)


def keep_threshold(p: float) -> tuple[int, float]:
    """``(threshold, scale)`` of a Dropout with rate ``p``: keep a value when
    the top 24 bits of its draw are below ``threshold``, and scale kept
    values by ``scale`` (float32 ``1/keep``). ``threshold`` is -1 when
    ``p <= 0`` (no mask)."""
    if p <= 0.0:
        return -1, 1.0
    if p >= 1.0:
        return 0, 0.0
    keep = float(np.float32(1.0 - p))
    return min(math.ceil(keep * (1 << 24)), 1 << 24), float(np.float32(1.0 / keep))


def dropout_scale(seed: int, sample: int, key: int, threshold: int,
                  scale: float, rows: int, cols: int, device, row0: int = 0,
                  seeds=None, rows_per_seed: int = 1):
    """``(rows, cols)`` float32 multipliers (``scale`` or 0) of one mask,
    for the rows ``row0 .. row0 + rows - 1``: drawn with ``seed``, or
    with a seed table ``seeds`` (a sequence of uint32 values, one for each
    ``rows_per_seed`` rows; ``seed`` unused), row ``R`` with
    ``seeds[R // rows_per_seed]`` at row ``R % rows_per_seed``."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    if seeds is None:
        stream = mask_stream(seed, sample, key)
    else:
        group = r // rows_per_seed
        table = torch.as_tensor(seeds, dtype=torch.int64, device=device)
        stream = mask_stream(table[group] & _M32, sample, key)[:, None]
        r = r - group * rows_per_seed
    r = _mul32(r & _M32, 0xC2B2AE35)
    c = _mul32(torch.arange(cols, dtype=torch.int64, device=device), 0x27D4EB2F)
    bits = lowbias32((stream + r[:, None] + c[None, :]) & _M32)
    keep = (bits >> 8) < threshold
    return torch.where(keep, torch.full((), scale, dtype=torch.float32,
                                        device=device),
                       torch.zeros((), dtype=torch.float32, device=device))


# The operations one mask element costs, counted from dropout_scale (the
# stream and row terms are per row, shared by every column): the column
# term's add; lowbias32's three shifts, three xors and two multiplies; the
# threshold test's shift and compare. By the SM pipes that can run them:
# shifts and xors only the ALU pipe, multiplies only the FMA pipe (IMAD),
# an add or a compare (the sign of a subtraction) either. Row 2b's bound in
# chip_smoke.py counts these.
MASK_HASH_OPS = {'alu': 7, 'fma': 2, 'either': 2}


class McWeights(FusedWeights):
    """Folded weights of one MC-dropout network, packed as for the ensemble
    kernel with one member, plus per-Linear dropout parameters:
    ``drop_thresh`` (int32, -1 where no Dropout precedes the Linear),
    ``drop_scale`` (float32 ``1/keep``) and ``drop_key`` (int32 module index
    of the Dropout, the hash's layer word)."""

    def __init__(self, folded, drops, keys, compute_dtype=torch.float32):
        super().__init__(folded, compute_dtype)
        device = self.w_all.device
        pairs = [keep_threshold(p) for p in drops]
        self.thresholds = tuple(t for t, _ in pairs)
        self.scales = tuple(s for _, s in pairs)
        self.keys = tuple(keys)
        self.drop_thresh = device_values(self.thresholds, torch.int32, device)
        self.drop_scale = device_values(self.scales, torch.float32, device)
        self.drop_key = device_values(self.keys, torch.int32, device)


def prepare_mc_weights(net):
    """Fold and pack an MC-dropout network once per parameter version, in
    the network's compute dtype.
    Returns None when the TPU kernel would not take it either (not a
    ``[Dropout?, Linear, BatchNorm1d?, ReLU?]*`` chain, or a width over
    128)."""
    result = fold_mc_dropout_params(net)
    if result is None or not _check_widths(result[0]):
        return None
    folded, drops = result
    linear_at = [i for i, layer in enumerate(net.layers)
                 if isinstance(layer, Linear)]
    keys = [i - 1 if p > 0.0 else -1 for i, p in zip(linear_at, drops)]
    return McWeights(folded, drops, keys, compute_dtype_of(net))


def _seed_tensor(seeds, device):
    """A seed table as an int64 tensor on ``device`` (copied without a
    wait), once for every mask of a call; None stays None."""
    return None if seeds is None else device_values(list(seeds),
                                                    torch.int64, device)


def _sample_stats(forward, num_samples):
    """Mean and unbiased std over ``forward(s)`` for samples ``s`` in
    ``0 .. num_samples-1``, from sums shifted by ``forward(None)``, the
    dropout-free pass."""
    c = forward(None)
    s1 = torch.zeros_like(c)
    s2 = torch.zeros_like(c)
    for s in range(num_samples):
        d = forward(s) - c
        s1 = s1 + d
        s2 = s2 + d * d
    return shifted_stats(s1, s2, c, num_samples)


def fused_mc_forward_plain(mw: McWeights, x, num_samples: int, seed: int,
                           row0: int = 0, seeds=None, rows_per_seed: int = 1):
    """The kernel's function in plain tensor ops: the dropout-free forward
    as the shift, then ``num_samples`` masked forwards, then the shifted
    statistics over the samples. ``x`` is ``(B, in_dim)``, its first row
    row ``row0`` of the masks; ``seeds``: a seed table, as
    :func:`dropout_scale` reads it."""
    rows = x.shape[0]
    last = mw.num_layers - 1
    seeds = _seed_tensor(seeds, x.device)

    def forward(sample):
        h = x
        for l, relu in enumerate(mw.relus):
            if sample is not None and mw.thresholds[l] >= 0:
                h = h * dropout_scale(seed, sample, mw.keys[l],
                                      mw.thresholds[l], mw.scales[l], rows,
                                      h.shape[1], x.device, row0, seeds,
                                      rows_per_seed)
            w, b = mw.ws[l][0], mw.b_all[l, 0]
            if l == last:
                w, b = w[:, :mw.out_dim], b[:mw.out_dim]
            h = torch.addmm(b, mw.round(h), w.float())
            if relu:
                h = torch.relu(h)
        return h

    return _sample_stats(forward, num_samples)


def mc_forward_modules(net, x, num_samples: int, seed: int, row0: int = 0,
                       seeds=None, rows_per_seed: int = 1):
    """The same statistics through the network's modules, for a network
    the fold does not take (a CNN among them): each Dropout multiplies by
    the hash mask keyed by its module index (an NCHW activation's columns
    are its flattened C x H x W elements), every other layer runs as it
    is; ``x``'s first row is row ``row0`` of the masks, drawn with
    ``seed`` or the seed table ``seeds`` (:func:`dropout_scale`). Under a compute
    dtype the walk runs in it, as ``Network`` does (x cast on entry, a
    masked activation returned in its dtype, the output back in fp32)."""
    cd = getattr(net, 'compute_dtype', None)
    seeds = _seed_tensor(seeds, x.device)

    def forward(sample):
        h = x if cd is None else x.to(cd)
        for i, layer in enumerate(net.layers):
            if isinstance(layer, Dropout):
                threshold, scale = keep_threshold(layer.p)
                if sample is not None and threshold >= 0:
                    mask = dropout_scale(seed, sample, i, threshold, scale,
                                         h.shape[0], h[0].numel(), x.device,
                                         row0, seeds, rows_per_seed)
                    h = (h * mask.reshape(h.shape)).to(h.dtype)
            else:
                h = layer(h)
        return h.to(x.dtype)

    return _sample_stats(forward, num_samples)


def check_seed_table(seeds, rows_per_seed: int, row0: int, rows: int):
    """Raise ``ValueError`` unless ``seeds`` (None, or a sequence of uint32
    values one for each ``rows_per_seed`` rows) covers rows ``row0 ..
    row0 + rows - 1``."""
    if seeds is None:
        return
    if rows_per_seed < 1:
        raise ValueError(f'rows_per_seed must be at least 1, got '
                         f'{rows_per_seed}')
    if rows and (row0 + rows - 1) // rows_per_seed >= len(seeds):
        raise ValueError(f'{len(seeds)} seeds of {rows_per_seed} rows do not '
                         f'cover rows {row0} .. {row0 + rows - 1}')
    if any(not 0 <= s < 1 << 32 for s in seeds):
        raise ValueError('seeds must be uint32 values')


def _check_inputs(mw: McWeights, x, num_samples):
    check_x(x, mw.in_dim)
    check_weights_dtype(mw)
    if num_samples < 1:
        raise ValueError(f'num_samples must be at least 1, got {num_samples}')
    for t in (mw.w_all, mw.b_all, mw.relu_flags, mw.drop_thresh,
              mw.drop_scale, mw.drop_key):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'folded weights must be contiguous on {x.device}')


def fused_mc_forward(mw: McWeights, x, num_samples: int, seed: int,
                     row0: int = 0, seeds=None, rows_per_seed: int = 1):
    """``(mean, std)``, each ``(B, out_dim)``, over ``num_samples`` dropout
    samples drawn with call seed ``seed``, or with the seed table
    ``seeds`` (a sequence of uint32 values, one for each ``rows_per_seed``
    rows, :func:`dropout_scale`), ``x``'s first row row ``row0`` of the
    masks: the CUDA kernel of the weights'
    compute dtype for a CUDA tensor, :func:`fused_mc_forward_plain` for a
    CPU tensor. ``fused_mc_forward.launches`` counts the fp32 kernel's
    launches, ``.launches_bf16`` the bf16 form's."""
    _check_inputs(mw, x, num_samples)
    seed &= _M32
    if not 0 <= row0 < 1 << 32:
        raise ValueError(f'row0 must be a uint32, got {row0}')
    check_seed_table(seeds, rows_per_seed, row0, x.shape[0])
    if x.device.type == 'cpu':
        return fused_mc_forward_plain(mw, x, num_samples, seed, row0, seeds,
                                      rows_per_seed)
    if x.device.type != 'cuda':
        raise ValueError(f'no fused MC-dropout kernel for device {x.device}')
    rows = x.shape[0]
    mean = torch.empty((rows, mw.out_dim), dtype=torch.float32,
                       device=x.device)
    std = torch.empty_like(mean)
    if rows == 0:
        return mean, std
    from ._build import library
    lib = library()
    bf16 = mw.compute_dtype == torch.bfloat16
    # the table's uint32 bits as int32, copied without a wait
    table = None if seeds is None else device_values(
        [s - (1 << 32) if s >= 1 << 31 else s for s in seeds], torch.int32,
        x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [x.data_ptr(), rows, mw.in_dim, None, mw.b_all.data_ptr(), mw.num_layers, mw.relu_flags.data_ptr(),
                mw.drop_thresh.data_ptr(), mw.drop_scale.data_ptr(),
                mw.drop_key.data_ptr(), num_samples, seed, row0,
                None if table is None else table.data_ptr(), rows_per_seed,
                mw.out_dim, mean.data_ptr(), std.data_ptr()]
        # both forms take the chain as its image (bf16, or fp32's 3xTF32
        # hi and lo parts) and the launch layout of .fused_eval_chain
        image, layout = launch_args('mc', mw, rows, x.device)
        args[3] = image.data_ptr()
        entry = lib.nnueehcs_fused_mc_dropout_bf16 if bf16 else \
            lib.nnueehcs_fused_mc_dropout_f32
        err = entry(*args, layout, stream)
    if err != 0:
        raise RuntimeError(f'fused MC-dropout kernel launch failed: CUDA '
                           f'error {err}')
    if bf16:
        fused_mc_forward.launches_bf16 += 1
    else:
        fused_mc_forward.launches += 1
    return mean, std


fused_mc_forward.launches = 0
fused_mc_forward.launches_bf16 = 0
