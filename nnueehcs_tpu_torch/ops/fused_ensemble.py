"""Fused deep-ensemble evaluation: BatchNorm folding, the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``nnueehcs_tpu/ops/fused_ensemble.py`` (``_fused_kernel`` and
the functions that fold and drive it; the MC-dropout kernel that shares
the fold is in :mod:`.fused_mc_dropout`). Eval-mode BatchNorm is folded into
the preceding Linear (``W' = W * gamma/sigma``, ``b' = (b - mu) * gamma/sigma
+ beta``), leaving a Linear(+ReLU) chain. Each member runs the chain; the
mean and unbiased std over members come from sums shifted by member 0's
output, so the one-pass variance does not cancel when ``|mean| >> std``.

:func:`fused_forward_prefolded` is the entry point: on a CUDA tensor it
launches the hand-written kernel (``csrc/fused_ensemble.cu``), on a CPU
tensor it runs :func:`fused_forward_plain`, which computes the same
function with plain tensor ops. It never falls back from one to the other.

The precision lives in the folded weights (:class:`FusedWeights`
``compute_dtype``), as in the JAX package's cache: fp32, or bf16, the JAX
kernel's ``compute_dtype=bfloat16`` form (the fold in fp32, then the weights
rounded to bf16; x and each hidden activation rounded to bf16 at the next
dot, products accumulated in fp32; biases, the last layer's output and the
statistics in fp32). x stays fp32 in both: the kernel rounds it itself.
``launches`` counts the fp32 kernel's launches, ``launches_bf16`` the bf16
form's.
"""
from __future__ import annotations

import torch

from ..nn.layers import BatchNorm1d, Dropout, Linear, ReLU

WIDTH = 128        # every layer is padded to 128 output columns
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)   # the kernels' forms


def _fold_linear_chain(net, allow_dropout: bool = False):
    """Fold a ``[Dropout?, Linear, BatchNorm1d?, ReLU?]*`` chain into
    ``(folded, drops)``: ``folded`` is a list of ``(w (..., in, out),
    b (..., out), relu_after)``, keeping leading member axes, and
    ``drops[i]`` is the dropout probability applied before Linear ``i``
    (0.0 where there is none). Returns None when the layers do not match
    that pattern, or hold a Dropout and ``allow_dropout`` is False."""
    layers = list(net.layers)
    folded, drops = [], []
    i = 0
    while i < len(layers):
        p_drop = 0.0
        if isinstance(layers[i], Dropout):
            if not allow_dropout:
                return None
            p_drop = float(layers[i].p)
            i += 1
        if i >= len(layers) or not isinstance(layers[i], Linear):
            return None
        layer = layers[i]
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
        drops.append(p_drop)
        i = j + 1 if relu else j
    return folded, drops


def fold_mc_dropout_params(net):
    """Fold a single-member MC-dropout network, adding a member axis of 1:
    ``(folded, drops)``, or None when the network is not such a chain."""
    result = _fold_linear_chain(net, allow_dropout=True)
    if result is None:
        return None
    folded, drops = result
    return [(w[None], b[None], relu) for w, b, relu in folded], drops


def _check_widths(folded) -> bool:
    """The TPU kernel's rule: activations live as 128-wide tiles, so every
    layer's output and every input but the first must fit 128. The input
    may be any width: the kernel stages x in 32-column chunks."""
    return all(w.shape[-1] <= WIDTH and (idx == 0 or w.shape[-2] <= WIDTH)
               for idx, (w, _, _) in enumerate(folded))


class FusedWeights:
    """Folded weights of a stacked ensemble, zero-padded to 128 columns and
    packed as the kernel reads them: ``w_all`` holds layer 0 as
    ``(M, in_dim, 128)`` followed by layers 1.. as ``(M, 128, 128)``, in
    ``compute_dtype`` (the fold is fp32; bf16 rounds its result); ``b_all``
    is ``(L, M, 128)`` fp32; ``relu_flags`` is ``(L,)`` int32, 1 where a
    ReLU follows the layer. ``ws[l]`` is a view of layer l."""

    def __init__(self, folded, compute_dtype=torch.float32):
        self.compute_dtype = compute_dtype
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
        self.w_all = torch.cat([w.reshape(-1) for w in ws]).contiguous().to(
            compute_dtype)
        self.b_all = torch.stack(bs).contiguous()
        self.relu_flags = torch.tensor(self.relus, dtype=torch.int32,
                                       device=w0.device)
        self.ws = [v.view_as(w) for v, w in zip(
            self.w_all.split([w.numel() for w in ws]), ws)]

    @property
    def num_layers(self):
        return len(self.relus)

    def round(self, h):
        """``h`` (fp32) rounded to the compute dtype, as a dot's input; the
        identity in fp32."""
        if self.compute_dtype == torch.float32:
            return h
        return h.to(self.compute_dtype).float()


def compute_dtype_of(net):
    """The network's compute dtype (``Network.compute_dtype``), fp32 when
    it has none."""
    return getattr(net, 'compute_dtype', None) or torch.float32


def prepare_fused_weights(net):
    """Fold and pack a stacked-ensemble network once per parameter version,
    in the network's compute dtype. Returns None when the network does not
    fit the fused kernel."""
    result = _fold_linear_chain(net)
    if result is None:
        return None
    folded, _ = result
    if not folded or folded[0][0].dim() != 3 or not _check_widths(folded):
        return None
    return FusedWeights(folded, compute_dtype_of(net))


def shifted_stats(s1, s2, c, n):
    """Mean and unbiased std from shifted sums ``s1 = sum(h - c)`` and
    ``s2 = sum((h - c)^2)`` over ``n`` members."""
    m1 = s1 / n
    mean = c + m1
    var = torch.clamp(s2 - n * m1 * m1, min=0.0) / max(n - 1, 1)
    return mean, torch.sqrt(var)


def fused_forward_plain(fw: FusedWeights, x):
    """The kernel's function in plain tensor ops: a per-member loop over the
    folded chain, then the shifted statistics. ``x`` is ``(B, in_dim)``.
    In bf16 each dot takes bf16-rounded operands up-cast to fp32, so its
    products are exact and its sums fp32, as the kernel's."""
    c = s1 = s2 = None
    last = fw.num_layers - 1
    for m in range(fw.num_members):
        h = fw.round(x)
        for l, relu in enumerate(fw.relus):
            w, b = fw.ws[l][m], fw.b_all[l, m]
            if l == last:
                w, b = w[:, :fw.out_dim], b[:fw.out_dim]
            h = torch.addmm(b, h, w.float())
            if relu:
                h = torch.relu(h)
            if l != last:
                h = fw.round(h)
        if m == 0:
            c, s1, s2 = h, torch.zeros_like(h), torch.zeros_like(h)
        else:
            d = h - c
            s1 = s1 + d
            s2 = s2 + d * d
    return shifted_stats(s1, s2, c, fw.num_members)


def check_weights_dtype(fw: FusedWeights):
    """Refuse folded weights whose compute dtype no kernel form takes, or
    whose packed arrays do not hold it (``w_all`` in the compute dtype,
    ``b_all`` fp32)."""
    if fw.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f'no kernel form for compute dtype '
                         f'{fw.compute_dtype}; the forms are {COMPUTE_DTYPES}')
    if fw.w_all.dtype != fw.compute_dtype or fw.b_all.dtype != torch.float32:
        raise ValueError(f'folded weights must be {fw.compute_dtype} (w_all) '
                         f'and float32 (b_all), got {fw.w_all.dtype} and '
                         f'{fw.b_all.dtype}')


def check_x(x, in_dim):
    """x must be a contiguous fp32 ``(B, in_dim)`` tensor, whatever the
    weights' compute dtype: a bf16 kernel rounds x itself."""
    if x.dtype != torch.float32:
        raise TypeError(f'expected float32 input, got {x.dtype}')
    if x.dim() != 2 or x.shape[1] != in_dim:
        raise ValueError(f'expected x of shape (B, {in_dim}), '
                         f'got {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')


def _check_inputs(fw: FusedWeights, x):
    check_x(x, fw.in_dim)
    check_weights_dtype(fw)
    for t in (fw.w_all, fw.b_all):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError('folded weights must be contiguous on '
                             f'{x.device}')
    if fw.relu_flags.device != x.device:
        raise ValueError(f'ReLU flags must be on {x.device}')


def fused_forward_prefolded(fw: FusedWeights, x):
    """``(mean, std)``, each ``(B, out_dim)``, of the ensemble on ``x``: the
    CUDA kernel of the weights' compute dtype for a CUDA tensor,
    :func:`fused_forward_plain` for a CPU tensor.
    ``fused_forward_prefolded.launches`` counts the fp32 kernel's launches,
    ``.launches_bf16`` the bf16 form's."""
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
    bf16 = fw.compute_dtype == torch.bfloat16
    launch = lib.nnueehcs_fused_ensemble_bf16 if bf16 else \
        lib.nnueehcs_fused_ensemble_f32
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), rows, fw.in_dim, fw.w_all.data_ptr(),
            fw.b_all.data_ptr(), fw.num_members, fw.num_layers,
            fw.relu_flags.data_ptr(), fw.out_dim, mean.data_ptr(),
            std.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused ensemble kernel launch failed: CUDA error '
                           f'{err}')
    if bf16:
        fused_forward_prefolded.launches_bf16 += 1
    else:
        fused_forward_prefolded.launches += 1
    return mean, std


fused_forward_prefolded.launches = 0
fused_forward_prefolded.launches_bf16 = 0
