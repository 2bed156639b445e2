"""Fused deep-ensemble evaluation: BatchNorm folding, the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``nnueehcs_tpu/ops/fused_ensemble.py`` (``_fused_kernel`` and
the functions that fold and drive it). Eval-mode BatchNorm is folded into
the preceding Linear (``W' = W * gamma/sigma``, ``b' = (b - mu) * gamma/sigma
+ beta``), leaving a Linear(+ReLU) chain. Each member runs the chain; the
mean and unbiased std over members come from sums shifted by member 0's
output, so the one-pass variance does not cancel when ``|mean| >> std``.

:func:`fused_forward_prefolded` is the entry point: on a CUDA tensor it
launches the hand-written kernel (``csrc/fused_ensemble.cu``), on a CPU
tensor it runs :func:`fused_forward_plain`, which computes the same
function with plain tensor ops. It never falls back from one to the other.
"""
from __future__ import annotations

import torch

from ..nn.layers import BatchNorm1d, Linear, ReLU

WIDTH = 128        # every layer is padded to 128 output columns


def _fold_linear_chain(net):
    """Fold a ``[Linear, BatchNorm1d?, ReLU?]*`` chain into a list of
    ``(w (..., in, out), b (..., out), relu_after)``, keeping leading member
    axes. Returns None when the layers do not match that pattern (a Dropout
    anywhere, for instance)."""
    layers = list(net.layers)
    folded = []
    i = 0
    while i < len(layers):
        layer = layers[i]
        if not isinstance(layer, Linear):
            return None
        w = layer.weight.detach().transpose(-1, -2)
        b = layer.bias.detach() if layer.bias is not None else \
            w.new_zeros(w.shape[:-2] + (w.shape[-1],))
        j = i + 1
        if j < len(layers) and isinstance(layers[j], BatchNorm1d):
            bn = layers[j]
            inv = torch.rsqrt(bn.running_var + bn.eps)
            scale = inv * bn.weight.detach() if bn.affine else inv
            w = w * scale.unsqueeze(-2)
            b = (b - bn.running_mean) * scale
            if bn.affine:
                b = b + bn.bias.detach()
            j += 1
        relu = j < len(layers) and isinstance(layers[j], ReLU)
        folded.append((w, b, relu))
        i = j + 1 if relu else j
    return folded


def _check_widths(folded) -> bool:
    """The TPU kernel's rule: activations live as 128-wide tiles, so every
    layer's output and every input but the first must fit 128. The input
    may be any width: the kernel stages x in 32-column chunks."""
    return all(w.shape[-1] <= WIDTH and (idx == 0 or w.shape[-2] <= WIDTH)
               for idx, (w, _, _) in enumerate(folded))


class FusedWeights:
    """Folded weights of a stacked ensemble, zero-padded to 128 columns and
    packed as the kernel reads them: ``w_all`` holds layer 0 as
    ``(M, in_dim, 128)`` followed by layers 1.. as ``(M, 128, 128)``;
    ``b_all`` is ``(L, M, 128)``; ``relu_flags`` is ``(L,)`` int32, 1 where
    a ReLU follows the layer. ``ws[l]`` is a view of layer l."""

    def __init__(self, folded):
        w0 = folded[0][0]
        self.num_members = w0.shape[0]
        self.in_dim = w0.shape[1]
        self.out_dim = folded[-1][0].shape[-1]
        self.relus = tuple(relu for _, _, relu in folded)
        # multiply-adds per row per member, at the real (unpadded) widths
        self.macs_per_row = sum(w.shape[-2] * w.shape[-1] for w, _, _ in folded)
        ws, bs = [], []
        for idx, (w, b, _) in enumerate(folded):
            rows = self.in_dim if idx == 0 else WIDTH
            w_p = w.new_zeros((self.num_members, rows, WIDTH))
            w_p[:, :w.shape[-2], :w.shape[-1]] = w
            b_p = b.new_zeros((self.num_members, WIDTH))
            b_p[:, :b.shape[-1]] = b
            ws.append(w_p)
            bs.append(b_p)
        self.w_all = torch.cat([w.reshape(-1) for w in ws]).contiguous()
        self.b_all = torch.stack(bs).contiguous()
        self.relu_flags = torch.tensor(self.relus, dtype=torch.int32,
                                       device=w0.device)
        self.ws = [v.view_as(w) for v, w in zip(
            self.w_all.split([w.numel() for w in ws]), ws)]

    @property
    def num_layers(self):
        return len(self.relus)


def prepare_fused_weights(net):
    """Fold and pack a stacked-ensemble network once per parameter version.
    Returns None when the network does not fit the fused kernel."""
    folded = _fold_linear_chain(net)
    if not folded or folded[0][0].dim() != 3 or not _check_widths(folded):
        return None
    return FusedWeights(folded)


def shifted_stats(s1, s2, c, n):
    """Mean and unbiased std from shifted sums ``s1 = sum(h - c)`` and
    ``s2 = sum((h - c)^2)`` over ``n`` members."""
    m1 = s1 / n
    mean = c + m1
    var = torch.clamp(s2 - n * m1 * m1, min=0.0) / max(n - 1, 1)
    return mean, torch.sqrt(var)


def fused_forward_plain(fw: FusedWeights, x):
    """The kernel's function in plain tensor ops: a per-member loop over the
    folded chain, then the shifted statistics. ``x`` is ``(B, in_dim)``."""
    c = s1 = s2 = None
    last = fw.num_layers - 1
    for m in range(fw.num_members):
        h = x
        for l, relu in enumerate(fw.relus):
            w, b = fw.ws[l][m], fw.b_all[l, m]
            if l == last:
                w, b = w[:, :fw.out_dim], b[:fw.out_dim]
            h = torch.addmm(b, h, w)
            if relu:
                h = torch.relu(h)
        if m == 0:
            c, s1, s2 = h, torch.zeros_like(h), torch.zeros_like(h)
        else:
            d = h - c
            s1 = s1 + d
            s2 = s2 + d * d
    return shifted_stats(s1, s2, c, fw.num_members)


def _check_inputs(fw: FusedWeights, x):
    if x.dtype == torch.bfloat16:
        raise NotImplementedError('the fused ensemble kernel is fp32 only')
    if x.dtype != torch.float32:
        raise TypeError(f'expected float32 input, got {x.dtype}')
    if x.dim() != 2 or x.shape[1] != fw.in_dim:
        raise ValueError(f'expected x of shape (B, {fw.in_dim}), '
                         f'got {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    for t in (fw.w_all, fw.b_all):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError('folded weights must be contiguous float32 on '
                             f'{x.device}')
    if fw.relu_flags.device != x.device:
        raise ValueError(f'ReLU flags must be on {x.device}')


def fused_forward_prefolded(fw: FusedWeights, x):
    """``(mean, std)``, each ``(B, out_dim)``, of the ensemble on ``x``: the
    CUDA kernel for a CUDA tensor, :func:`fused_forward_plain` for a CPU
    tensor. ``fused_forward_prefolded.launches`` counts kernel launches."""
    _check_inputs(fw, x)
    if x.device.type == 'cpu':
        return fused_forward_plain(fw, x)
    if x.device.type != 'cuda':
        raise ValueError(f'no fused ensemble kernel for device {x.device}')
    rows = x.shape[0]
    mean = torch.empty((rows, fw.out_dim), dtype=torch.float32,
                       device=x.device)
    std = torch.empty_like(mean)
    if rows == 0:
        return mean, std
    from ._build import library
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.nnueehcs_fused_ensemble_f32(
            x.data_ptr(), rows, fw.in_dim, fw.w_all.data_ptr(),
            fw.b_all.data_ptr(), fw.num_members, fw.num_layers,
            fw.relu_flags.data_ptr(), fw.out_dim, mean.data_ptr(),
            std.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused ensemble kernel launch failed: CUDA error '
                           f'{err}')
    fused_forward_prefolded.launches += 1
    return mean, std


fused_forward_prefolded.launches = 0
