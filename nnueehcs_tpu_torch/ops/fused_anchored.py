"""Fused anchored (Δ-UQ / PAGER) evaluation: the layer-0 split, the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``nnueehcs_tpu/ops/fused_anchored.py`` (``_anchored_kernel``
and the functions that prepare and drive it). An anchored forward feeds
``concat([a, x - a])`` to the first Linear, which decomposes exactly as
``x @ W_bot + a @ (W_top - W_bot)``. So a UE pass computes
``u = x @ W_bot + b0`` once per row, adds ``v_j = a_j @ (W_top - W_bot)``
for each anchor j, applies layer 0's ReLU and runs the rest of the folded
chain; mean and unbiased std over the k anchors come from sums shifted by
anchor 0's output.

:func:`fused_anchored_stats` is the entry point: on a CUDA tensor it
launches the hand-written kernel (``csrc/fused_anchored.cu``), on a CPU
tensor it runs :func:`fused_anchored_plain`. It never falls back from one
to the other.

In bf16 (the weights' ``compute_dtype``, the JAX kernel's
``compute_dtype=bfloat16`` form) ``W_bot`` and the later layers are bf16,
``u = bf16(x) @ W_bot + b0`` is fp32, ``v_j`` stays fp32 (unrounded
anchors, the fp32 ``W_top - W_bot``), and ``h = u + v_j`` is rounded only
at the next dot, as every later activation is.
``fused_anchored_stats.launches`` counts the fp32 kernel's launches,
``.launches_bf16`` the bf16 form's.
"""
from __future__ import annotations

import torch

from .fused_ensemble import (WIDTH, FusedWeights, _fold_linear_chain,
                             check_weights_dtype, check_x, compute_dtype_of,
                             shifted_stats)


class AnchoredWeights(FusedWeights):
    """Folded weights of an anchored network, packed as for the ensemble
    kernel with one member, layer 0 being ``W_bot`` (``(d, 128)``, the
    x-part of the first Linear) with its bias; ``w0d`` is
    ``W_top - W_bot`` (``(d, width0)``, unpadded, fp32 in every compute
    dtype) and ``relus[0]`` the ReLU that follows layer 0 once ``v_j`` is
    added."""

    def __init__(self, folded, compute_dtype=torch.float32):
        w0, b0, relu0 = folded[0]
        d = w0.shape[-2] // 2
        w_top, w_bot = w0[..., :d, :], w0[..., d:, :]
        super().__init__([(w_bot, b0, relu0), *folded[1:]], compute_dtype)
        self.w0d = (w_top - w_bot)[0].contiguous()
        self.width0 = w0.shape[-1]
        # multiply-adds per row: layer 0 once (x @ W_bot; v is per anchor),
        # layers 1.. once per anchor
        self.macs_once = d * self.width0
        self.macs_per_anchor = self.macs_per_row - self.macs_once


def prepare_fused_anchored(net):
    """Fold and split an anchored network once per parameter version, in
    the network's compute dtype. Returns None when the TPU kernel would not
    take it: not a Dropout-free
    ``[Linear, BatchNorm1d?, ReLU?]*`` chain of at least two Linears, an odd
    first-layer input, or a layer wider than 128."""
    result = _fold_linear_chain(net)
    if result is None:
        return None
    folded, _ = result
    if len(folded) < 2 or folded[0][0].dim() != 2:
        return None
    w0 = folded[0][0]
    if w0.shape[0] % 2 or w0.shape[1] > WIDTH:
        return None
    if any(w.shape[0] > WIDTH or w.shape[1] > WIDTH for w, _, _ in folded[1:]):
        return None
    return AnchoredWeights([(w[None], b[None], relu) for w, b, relu in folded],
                           compute_dtype_of(net))


def anchor_rows(aw: AnchoredWeights, anchors):
    """``v = anchors @ (W_top - W_bot)`` as a ``(k, 128)`` float32 array,
    zero past layer 0's width; computed in float64, so no TF32 setting
    touches the anchor offsets that feed every later layer."""
    v = torch.matmul(anchors.double(), aw.w0d.double()).float()
    v_pad = v.new_zeros((v.shape[0], WIDTH))
    v_pad[:, :v.shape[1]] = v
    return v_pad


def fused_anchored_plain(aw: AnchoredWeights, x, v):
    """The kernel's function in plain tensor ops: ``u`` once, then one
    forward per anchor row of ``v`` (``(k, 128)``), then the shifted
    statistics with anchor 0 as the shift. ``x`` is ``(B, d)``."""
    last = aw.num_layers - 1
    u = torch.addmm(aw.b_all[0, 0], aw.round(x), aw.ws[0][0].float())
    c = s1 = s2 = None
    for j in range(v.shape[0]):
        h = u + v[j]
        if aw.relus[0]:
            h = torch.relu(h)
        for l in range(1, aw.num_layers):
            w, b = aw.ws[l][0], aw.b_all[l, 0]
            if l == last:
                w, b = w[:, :aw.out_dim], b[:aw.out_dim]
            h = torch.addmm(b, aw.round(h), w.float())
            if aw.relus[l]:
                h = torch.relu(h)
        if j == 0:
            c, s1, s2 = h, torch.zeros_like(h), torch.zeros_like(h)
        else:
            d = h - c
            s1 = s1 + d
            s2 = s2 + d * d
    return shifted_stats(s1, s2, c, v.shape[0])


def _check_inputs(aw: AnchoredWeights, x, anchors):
    check_x(x, aw.in_dim)
    check_weights_dtype(aw)
    if anchors.dim() != 2 or anchors.shape[1] != aw.in_dim \
            or anchors.shape[0] < 1:
        raise ValueError(f'expected anchors of shape (k >= 1, {aw.in_dim}), '
                         f'got {tuple(anchors.shape)}')
    for t in (aw.w_all, aw.b_all, aw.relu_flags, aw.w0d, anchors):
        if t.device != x.device:
            raise ValueError(f'weights and anchors must be on {x.device}')


def fused_anchored_stats(aw: AnchoredWeights, x, anchors, n_anchors=None):
    """``(mean, std)``, each ``(B, out_dim)``, over the anchored passes of
    the first ``n_anchors`` anchors (all of them when None): the CUDA kernel
    of the weights' compute dtype for a CUDA tensor,
    :func:`fused_anchored_plain` for a CPU tensor.
    ``fused_anchored_stats.launches`` counts the fp32 kernel's launches,
    ``.launches_bf16`` the bf16 form's."""
    a = anchors if n_anchors is None else anchors[:n_anchors]
    _check_inputs(aw, x, a)
    v = anchor_rows(aw, a)
    if x.device.type == 'cpu':
        return fused_anchored_plain(aw, x, v)
    if x.device.type != 'cuda':
        raise ValueError(f'no fused anchored kernel for device {x.device}')
    rows = x.shape[0]
    mean = torch.empty((rows, aw.out_dim), dtype=torch.float32,
                       device=x.device)
    std = torch.empty_like(mean)
    if rows == 0:
        return mean, std
    from ._build import library
    lib = library()
    bf16 = aw.compute_dtype == torch.bfloat16
    launch = lib.nnueehcs_fused_anchored_bf16 if bf16 else \
        lib.nnueehcs_fused_anchored_f32
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), rows, aw.in_dim, aw.w_all.data_ptr(),
            aw.b_all.data_ptr(), aw.num_layers, aw.relu_flags.data_ptr(),
            v.data_ptr(), v.shape[0], aw.out_dim, mean.data_ptr(),
            std.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused anchored kernel launch failed: CUDA error '
                           f'{err}')
    if bf16:
        fused_anchored_stats.launches_bf16 += 1
    else:
        fused_anchored_stats.launches += 1
    return mean, std


fused_anchored_stats.launches = 0
fused_anchored_stats.launches_bf16 = 0
