"""Fused whole-epoch training: the plan, the flat buffers, the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``nnueehcs_tpu/ops/fused_train.py`` (``_epoch_kernel`` and
the functions that lay out and drive it). One call trains a
[Dropout?, Linear, BatchNorm1d?, ReLU?]* chain (every block but the last
with BatchNorm, widths <= 128) for ``S`` steps on pre-gathered batches.
Each step: every member's training-mode forward (BatchNorm on batch
statistics, running-stat EMA with the unbiased variance), the joint-mean
or per-member l1/mse loss or the MVE Gaussian NLL, a hand-written backward
from the x-hat, 1/sigma and dropout masks that the forward saved, clip by
global norm, bias-corrected Adam, decayed weights and ``theta -= lr * u``.
(The TPU kernel recomputes each member's forward in its backward, because
its VMEM holds one member's activations at a time; the results are the
same, since theta does not change between the two.)

Parameters, both Adam moments and the gradient live in flat ``(rows, 128)``
float32 buffers with the JAX package's row layout (:class:`FusedTrainPlan`,
:func:`pack_tree`), so every buffer compares with the JAX one element by
element. In the bf16-mixed form (``plan.bf16``, the JAX plan's) the three
products of a block (the forward ``h W``, the weight gradient ``a^T d`` and
the input gradient ``d W^T``) round both operands to bf16 and sum their
exact products in fp32; ``d`` is rounded at both backward products while
the weight gradient and the propagated ``d`` stay fp32, and everything else
(BatchNorm and its EMA, the loss, masks, clip and Adam) is fp32 as in the
fp32 form. Dropout masks come from the same stateless lowbias32 hash of
(epoch seed, step, member, Dropout slot, row, column) as the TPU kernel,
so the two packages draw identical masks.

:func:`fused_epoch` is the entry point: on CUDA tensors it launches the
hand-written kernel (``csrc/fused_train.cu``, or for a bf16-mixed plan its
bf16 form ``csrc/fused_train_bf16.cu``), on CPU tensors it runs
:func:`fused_epoch_reference`, which does the kernel's arithmetic step by
step in tensor ops. It never falls back from one to the other. Both update
``theta``, ``m``, ``v`` and ``sigma`` in place (the JAX version donates
them).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.layers import BatchNorm1d, Dropout, Linear, ReLU
from .fused_mc_dropout import _M32, _mul32, lowbias32

LANES = 128
LOSSES = ('l1_loss', 'mse_loss', 'gaussian_nll')
# per-step salt strides of the dropout hash (the JAX kernel's); the step
# stride differs from the trainer's per-epoch seed stride (7919)
SALT_STEP, SALT_MEMBER, SALT_SLOT = 1225253, 131071, 524287


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


@dataclasses.dataclass(frozen=True)
class _Lin:
    """Static layout of one (Dropout?)->Linear(+BatchNorm)(+ReLU) block
    inside a member's slab (row offsets relative to the slab)."""
    layer: int            # index of the Linear in net.layers
    bn_layer: int         # index of the BatchNorm1d, or -1
    w_off: int
    in_rows: int          # padded rows of W (128 for hidden, pad8(d) first)
    in_w: int             # true input width
    out_w: int            # true output width
    b_off: int            # bias row
    g_off: int            # BN scale row, or -1
    be_off: int           # BN bias row, or -1
    mean_off: int         # BN running-mean row in the sigma slab, or -1
    var_off: int          # BN running-var row, or -1
    zh_idx: int           # x-hat slot, or -1
    relu: bool
    mask_idx: int = -1    # dropout-mask slot, or -1


@dataclasses.dataclass(frozen=True)
class FusedTrainPlan:
    lins: Tuple[_Lin, ...]
    slab_rows: int        # padded rows per member in theta/m/v/g
    sig_rows: int         # padded rows per member in sigma
    num_members: int
    batch: int
    in_pad: int           # padded input width (pad8)
    out_pad: int          # padded target width (pad8)
    n_bn: int
    bn_eps: float
    bn_mom: float
    loss: str             # 'l1_loss' | 'mse_loss' | 'gaussian_nll'
    per_member: bool
    clip: Optional[float]
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8
    # bf16-mixed: both operands of each of the three products rounded to
    # bf16, accumulated in fp32; weights, BatchNorm, loss and Adam stay fp32
    bf16: bool = False
    # parameters with a leading member axis (ensembles) or a single net
    member_stacked: bool = True
    n_drop: int = 0       # dropout-mask slots

    @property
    def total_rows(self) -> int:
        return self.slab_rows * self.num_members

    @property
    def total_sig_rows(self) -> int:
        return self.sig_rows * self.num_members

    @property
    def single_sweep(self) -> bool:
        """The loss decouples across members (per-member loss, or one
        net): each member's loss and backward follow its own forward, with
        no joint loss sweep over every member first."""
        return self.per_member or self.num_members == 1

    @property
    def loss_div(self) -> float:
        """Mean divisor: B * out_w for the element-wise losses, B for the
        Gaussian NLL (one likelihood term per row)."""
        B, ow = self.batch, self.lins[-1].out_w
        return float(B) if self.loss == 'gaussian_nll' else float(B * ow)

    def macs_per_row(self) -> int:
        """Multiply-adds of one member's forward per row, at true widths."""
        return sum(L.in_w * L.out_w for L in self.lins)


def plan_fused_train(net, num_members: int, batch: int, *,
                     loss: str = 'l1_loss', per_member: bool = False,
                     clip: Optional[float] = None, weight_decay: float = 0.0,
                     bf16: bool = False,
                     member_stacked: bool = True) -> Optional[FusedTrainPlan]:
    """The static layout, or None when the network or the configuration is
    outside the kernel's family: [Dropout?, Linear, BatchNorm1d?, ReLU?]*
    with BatchNorm on every block but the last, none on the last, widths
    <= 128, a bias on every Linear, one eps/momentum for every BatchNorm,
    batch a multiple of 8 and >= 8, and a supported loss (the MVE NLL needs
    a 2-wide head). The JAX package's rules, without its VMEM budget: the
    CUDA kernel keeps the buffers in device memory. ``bf16`` selects the
    bf16-mixed form (the trainer's ``precision: 'bf16-mixed'``)."""
    if loss not in LOSSES:
        return None
    if batch < 2 or batch % 8 != 0:
        return None
    layers = list(net.layers)
    lins = []
    row = sig_row = zh = n_drop = 0
    i = 0
    while i < len(layers):
        has_drop = isinstance(layers[i], Dropout)
        if has_drop:
            i += 1
            if i >= len(layers):
                return None
        lay = layers[i]
        if not isinstance(lay, Linear) or lay.bias is None:
            return None
        in_w, out_w = lay.in_features, lay.out_features
        if out_w > LANES or in_w > LANES:
            return None
        in_rows = _pad8(in_w) if not lins else LANES
        j = i + 1
        bn_layer = g_off = be_off = mean_off = var_off = zh_idx = -1
        if j < len(layers) and isinstance(layers[j], BatchNorm1d):
            bn = layers[j]
            if not bn.affine or bn.num_features != out_w:
                return None
            bn_layer = j
            j += 1
        relu = j < len(layers) and isinstance(layers[j], ReLU)
        if relu:
            j += 1
        if j < len(layers) and bn_layer < 0:
            # the backward re-derives each block's input from the previous
            # block's saved x-hat: BatchNorm on every block but the last
            return None
        if relu and bn_layer < 0:
            return None
        w_off = row
        row += in_rows
        b_off = row
        row += 1
        if bn_layer >= 0:
            g_off, be_off = row, row + 1
            row += 2
            mean_off, var_off = sig_row, sig_row + 1
            sig_row += 2
            zh_idx = zh
            zh += 1
        mask_idx = -1
        if has_drop:
            # one slot per Dropout layer; its rate is a runtime input
            mask_idx = n_drop
            n_drop += 1
        lins.append(_Lin(i, bn_layer, w_off, in_rows, in_w, out_w, b_off,
                         g_off, be_off, mean_off, var_off, zh_idx, relu,
                         mask_idx))
        i = j
    if not lins or lins[-1].bn_layer >= 0 or lins[-1].relu:
        return None
    if loss == 'gaussian_nll' and lins[-1].out_w != 2:
        return None
    if not member_stacked and num_members != 1:
        return None
    bns = [layers[L.bn_layer] for L in lins if L.bn_layer >= 0]
    bn_eps = float(bns[0].eps) if bns else 1e-5
    bn_mom = float(bns[0].momentum) if bns else 0.1
    if any(b.eps != bn_eps or b.momentum != bn_mom for b in bns):
        return None
    return FusedTrainPlan(
        lins=tuple(lins), slab_rows=_pad8(row), sig_rows=_pad8(max(sig_row, 1)),
        num_members=num_members, batch=batch, in_pad=_pad8(lins[0].in_w),
        out_pad=_pad8(lins[-1].out_w), n_bn=max(zh, 1), bn_eps=bn_eps,
        bn_mom=bn_mom, loss=loss, per_member=per_member,
        clip=float(clip) if clip else None,
        weight_decay=float(weight_decay or 0.0), bf16=bool(bf16),
        member_stacked=bool(member_stacked), n_drop=n_drop)


# ---------------------------------------------------------------------------
# the flat buffers <-> trees in the JAX layout
# ---------------------------------------------------------------------------
def _leaf(plan: FusedTrainPlan, leaf, device):
    """A tree leaf as a float32 tensor with a leading member axis."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.tensor(np.asarray(leaf), dtype=torch.float32)
    leaf = leaf.detach().to(device=device, dtype=torch.float32)
    return leaf if plan.member_stacked else leaf[None]


def _unstack(plan: FusedTrainPlan, a):
    return a if plan.member_stacked else a[0]


def pack_tree(plan: FusedTrainPlan, tree, device='cpu') -> torch.Tensor:
    """A params-shaped tree (per layer ``{'w': (M, in, out), 'b'}`` or
    ``{'scale', 'bias'}``, numpy or tensors) -> flat ``(total_rows, 128)``
    float32 buffer, rows as the JAX ``pack_tree`` lays them out."""
    M = plan.num_members
    out = torch.zeros((M, plan.slab_rows, LANES), dtype=torch.float32,
                      device=device)
    for L in plan.lins:
        out[:, L.w_off:L.w_off + L.in_w, :L.out_w] = _leaf(
            plan, tree[L.layer]['w'], device)
        out[:, L.b_off, :L.out_w] = _leaf(plan, tree[L.layer]['b'], device)
        if L.bn_layer >= 0:
            out[:, L.g_off, :L.out_w] = _leaf(plan, tree[L.bn_layer]['scale'],
                                              device)
            out[:, L.be_off, :L.out_w] = _leaf(plan, tree[L.bn_layer]['bias'],
                                               device)
    return out.reshape(M * plan.slab_rows, LANES)


def unpack_tree(plan: FusedTrainPlan, theta, num_layers: int) -> tuple:
    """Flat buffer -> params tree of ``num_layers`` entries (views)."""
    th = theta.reshape(plan.num_members, plan.slab_rows, LANES)
    tree = [{} for _ in range(num_layers)]
    for L in plan.lins:
        tree[L.layer] = {
            'w': _unstack(plan, th[:, L.w_off:L.w_off + L.in_w, :L.out_w]),
            'b': _unstack(plan, th[:, L.b_off, :L.out_w])}
        if L.bn_layer >= 0:
            tree[L.bn_layer] = {
                'scale': _unstack(plan, th[:, L.g_off, :L.out_w]),
                'bias': _unstack(plan, th[:, L.be_off, :L.out_w])}
    return tuple(tree)


def pack_state(plan: FusedTrainPlan, state, device='cpu') -> torch.Tensor:
    """A state tree (``{'mean', 'var'}`` per BatchNorm) -> flat
    ``(total_sig_rows, 128)`` buffer."""
    M = plan.num_members
    out = torch.zeros((M, plan.sig_rows, LANES), dtype=torch.float32,
                      device=device)
    for L in plan.lins:
        if L.bn_layer >= 0:
            out[:, L.mean_off, :L.out_w] = _leaf(
                plan, state[L.bn_layer]['mean'], device)
            out[:, L.var_off, :L.out_w] = _leaf(
                plan, state[L.bn_layer]['var'], device)
    return out.reshape(M * plan.sig_rows, LANES)


def unpack_state(plan: FusedTrainPlan, sigma, num_layers: int) -> tuple:
    sg = sigma.reshape(plan.num_members, plan.sig_rows, LANES)
    tree = [{} for _ in range(num_layers)]
    for L in plan.lins:
        if L.bn_layer >= 0:
            tree[L.bn_layer] = {
                'mean': _unstack(plan, sg[:, L.mean_off, :L.out_w]),
                'var': _unstack(plan, sg[:, L.var_off, :L.out_w])}
    return tuple(tree)


def drop_rates(net) -> torch.Tensor:
    """Per-slot dropout probabilities in block order, the runtime companion
    of a plan's ``n_drop`` slots (one zero when there is none)."""
    rates = [float(l.p) for l in net.layers if isinstance(l, Dropout)]
    return torch.tensor(rates or [0.0], dtype=torch.float32)


def gather_epoch_batches(plan: FusedTrainPlan, x, y, idx_flat):
    """The epoch's batches ``x[idx]``, ``y[idx]`` padded to the kernel's
    ``(S, B, in_pad)`` and ``(S, B, out_pad)``."""
    S = idx_flat.shape[0] // plan.batch
    xb = x[idx_flat].to(torch.float32)
    yb = y[idx_flat].to(torch.float32)
    if yb.dim() == 1:
        yb = yb[:, None]
    xb = torch.nn.functional.pad(xb, (0, plan.in_pad - xb.shape[1]))
    yb = torch.nn.functional.pad(yb, (0, plan.out_pad - yb.shape[1]))
    return (xb.reshape(S, plan.batch, plan.in_pad).contiguous(),
            yb.reshape(S, plan.batch, plan.out_pad).contiguous())


def anchor_permutations(generator: torch.Generator, steps: int,
                        batch: int) -> torch.Tensor:
    """``(steps, 2, batch)`` int64: for each step, the two independent
    permutations of its batch that anchor the two halves of a Δ-UQ/PAGER
    batch (``a1 = x[perm[s, 0]]``, ``a2 = x[perm[s, 1]]``), drawn from
    ``generator`` on its device (the argsort of uniform float64 draws). The
    JAX package draws them with ``jax.random.permutation``; the port's
    stream is its own."""
    u = torch.rand((steps, 2, batch), generator=generator,
                   dtype=torch.float64, device=generator.device)
    return u.argsort(dim=-1)


def gather_anchored_epoch_batches(plan: FusedTrainPlan, x, y, idx_flat,
                                  perms):
    """The Δ-UQ/PAGER stochastic-centering batches of an epoch: step ``s``
    takes the ``(B, d)`` batch ``x[idx]`` to ``(2B, 2d) = [[a1, x - a1];
    [a2, x - a2]]`` with ``a1``, ``a2`` the batch permuted by
    ``perms[s, 0]`` and ``perms[s, 1]`` (:func:`anchor_permutations`), and
    its targets to ``[y; y]``, padded to the kernel's ``(S, 2B, in_pad)``
    and ``(S, 2B, out_pad)``. ``plan.batch`` is the doubled batch."""
    B = plan.batch // 2
    S = idx_flat.shape[0] // B
    xb = x[idx_flat].to(torch.float32).reshape(S, B, -1)
    yb = y[idx_flat].to(torch.float32)
    if yb.dim() == 1:
        yb = yb[:, None]
    yb = yb.reshape(S, B, -1)
    d = xb.shape[-1]
    halves = []
    for j in range(2):
        a = torch.gather(xb, 1, perms[:, j, :, None].expand(S, B, d))
        halves.append(torch.cat([a, xb - a], dim=-1))
    xs = torch.nn.functional.pad(torch.cat(halves, dim=1),
                                 (0, plan.in_pad - 2 * d))
    ys = torch.nn.functional.pad(torch.cat([yb, yb], dim=1),
                                 (0, plan.out_pad - yb.shape[-1]))
    return xs.contiguous(), ys.contiguous()


# ---------------------------------------------------------------------------
# float32 constants as the JAX kernel rounds them (Python floats there)
# ---------------------------------------------------------------------------
def _f32(v) -> float:
    return float(np.float32(v))


def _constants(plan: FusedTrainPlan) -> dict:
    B, M = plan.batch, plan.num_members
    return {
        'bn_eps': _f32(plan.bn_eps), 'mom': _f32(plan.bn_mom),
        'one_minus_mom': _f32(1 - plan.bn_mom), 'unbias': _f32(B / (B - 1)),
        'inv_members': _f32(1.0 / M), 'loss_div': _f32(plan.loss_div),
        'sweep_div': _f32(plan.loss_div * M),
        'clip': _f32(plan.clip) if plan.clip is not None else 0.0,
        'wd': _f32(plan.weight_decay), 'b1': _f32(plan.b1),
        'b2': _f32(plan.b2), 'one_minus_b1': _f32(1.0 - plan.b1),
        'one_minus_b2': _f32(1.0 - plan.b2), 'adam_eps': _f32(plan.adam_eps),
        'ln_b1': _f32(np.log(plan.b1)), 'ln_b2': _f32(np.log(plan.b2)),
    }


def dropout_mask(seed: int, step: int, member: int, slot: int, rate,
                 rows: int, cols: int, device) -> torch.Tensor:
    """The ``(rows, cols)`` float32 mask (``1/keep`` or 0) of one Dropout
    slot: lowbias32 of ``salt*0x9E3779B9 + r*0x85EBCA6B + c*0xC2B2AE35`` with
    ``salt = seed + step*1225253 + member*131071 + slot*524287``, all mod
    2^32; keep where the top 24 bits over 2^24 fall below ``1 - rate``."""
    salt = (seed + step * SALT_STEP + member * SALT_MEMBER
            + slot * SALT_SLOT) & _M32
    r = _mul32(torch.arange(rows, dtype=torch.int64, device=device),
               0x85EBCA6B)
    c = _mul32(torch.arange(cols, dtype=torch.int64, device=device),
               0xC2B2AE35)
    bits = lowbias32((_mul32(salt, 0x9E3779B9) + r[:, None] + c[None, :])
                     & _M32)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    keep = 1.0 - rate.to(device=device, dtype=torch.float32)
    return torch.where(u < keep, 1.0 / keep, torch.zeros((), device=device))


def _loss_and_grad(plan: FusedTrainPlan, k: dict, pred, ypad):
    """``(sum of loss terms, dL/dpred over the mean divisor)`` for a
    ``(B, 128)`` prediction whose padded lanes are zero."""
    div = k['loss_div']
    if plan.loss == 'gaussian_nll':
        mu, raw, y0 = pred[:, 0], pred[:, 1], ypad[:, 0]
        var = torch.clamp(raw, min=0.0) + torch.log1p(torch.exp(-raw.abs())) \
            + _f32(1e-6)
        inv = 1.0 / var
        diff = mu - y0
        sq = diff * diff
        terms = 0.5 * torch.log(var) + 0.5 * sq * inv
        sig = 1.0 / (1.0 + torch.exp(-raw))
        grad = torch.zeros_like(pred)
        grad[:, 0] = diff * inv / div
        grad[:, 1] = 0.5 * (inv - sq * inv * inv) * sig / div
        return terms.sum(), grad
    diff = pred - ypad
    if plan.loss == 'l1_loss':
        # +1 at diff == 0 (jax.grad(abs)), on true lanes only
        lane = (torch.arange(LANES, device=pred.device)
                < plan.lins[-1].out_w).to(torch.float32)
        return diff.abs().sum(), torch.where(diff >= 0.0, lane, -lane) / div
    return (diff * diff).sum(), 2.0 * diff / div


def _saved(plan):
    return {'zh': [None] * plan.n_bn, 'inv': [None] * plan.n_bn,
            'mask': [None] * max(plan.n_drop, 1)}


def _mm(plan, a, b):
    """``a @ b`` in the plan's form: fp32, or (bf16-mixed) both operands
    rounded to bf16 and their exact products summed in fp32, as the JAX
    kernel's ``astype(bfloat16)`` dot with ``preferred_element_type``
    float32."""
    if plan.bf16:
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return a @ b


def _forward(plan, k, th, sg, x, i, m, seed, drops, saved):
    """One member's training-mode forward on the flat buffers, with the
    running-stat EMA; fills ``saved`` (x-hat, 1/sigma and masks per slot)
    for the backward."""
    base, sbase = m * plan.slab_rows, m * plan.sig_rows
    h = x
    for L in plan.lins:
        if L.mask_idx >= 0:
            mask = dropout_mask(seed, i, m, L.mask_idx, drops[L.mask_idx],
                                h.shape[0], h.shape[1], h.device)
            saved['mask'][L.mask_idx] = mask
            h = h * mask
        W = th[base + L.w_off:base + L.w_off + L.in_rows]
        z = _mm(plan, h, W) + th[base + L.b_off]
        if L.bn_layer >= 0:
            mu = z.mean(0)
            c = z - mu
            var = (c * c).mean(0)
            inv = torch.rsqrt(var + k['bn_eps'])
            zh = c * inv
            saved['zh'][L.zh_idx] = zh
            saved['inv'][L.zh_idx] = inv
            mo, vo = sbase + L.mean_off, sbase + L.var_off
            sg[mo] = k['one_minus_mom'] * sg[mo] + k['mom'] * mu
            sg[vo] = k['one_minus_mom'] * sg[vo] + k['mom'] * (
                var * k['unbias'])
            h = zh * th[base + L.g_off] + th[base + L.be_off]
        else:
            h = z
        if L.relu:
            h = torch.relu(h)
    return h


def _backward(plan, k, th, g, x, m, d, saved, signs=None):
    """The reverse pass of one member, writing its gradient rows into g
    and, when given, its ReLU decisions into ``signs`` (n_bn, B, 128)."""
    B = plan.batch
    base = m * plan.slab_rows
    lins = plan.lins
    for li in range(len(lins) - 1, -1, -1):
        L = lins[li]
        if L.relu:
            act = saved['zh'][L.zh_idx] * th[base + L.g_off] \
                + th[base + L.be_off]
            if signs is not None:
                signs[L.zh_idx] = act > 0.0
            d = d * (act > 0.0).to(torch.float32)
        if L.bn_layer >= 0:
            zh = saved['zh'][L.zh_idx]
            g[base + L.g_off] = (d * zh).sum(0)
            g[base + L.be_off] = d.sum(0)
            dzh = d * th[base + L.g_off]
            s1 = dzh.sum(0)
            s2 = (dzh * zh).sum(0)
            d = (saved['inv'][L.zh_idx] / B) * (B * dzh - s1 - zh * s2)
        if li == 0:
            a = x
            if L.mask_idx >= 0:
                a = a * saved['mask'][L.mask_idx][:, :a.shape[1]]
        else:
            P = lins[li - 1]
            a = saved['zh'][P.zh_idx] * th[base + P.g_off] \
                + th[base + P.be_off]
            if P.relu:
                a = torch.relu(a)
            if L.mask_idx >= 0:
                a = a * saved['mask'][L.mask_idx]
        g[base + L.w_off:base + L.w_off + L.in_rows] = _mm(plan, a.T, d)
        g[base + L.b_off] = d.sum(0)
        if li > 0:
            d = _mm(plan, d, th[base + L.w_off:base + L.w_off + L.in_rows].T)
            if L.mask_idx >= 0:
                d = d * saved['mask'][L.mask_idx]


def _adam(plan, k, theta, m, v, g, lr, t):
    """Clip by global norm, bias-corrected Adam, decayed weights and
    ``theta -= lr * u``, in place over the whole flat buffers."""
    dev = theta.device
    scale = torch.ones((), device=dev)
    if plan.clip is not None:
        gn = torch.sqrt((g * g).sum())
        scale = torch.where(gn < k['clip'], scale, k['clip'] / gn)
    tf = torch.tensor(float(t), dtype=torch.float32, device=dev)
    c1 = 1.0 - torch.exp(tf * k['ln_b1'])
    c2 = 1.0 - torch.exp(tf * k['ln_b2'])
    gs = g * scale
    m.copy_(k['b1'] * m + k['one_minus_b1'] * gs)
    v.copy_(k['b2'] * v + k['one_minus_b2'] * gs * gs)
    u = (m / c1) / (torch.sqrt(v / c2) + k['adam_eps'])
    if plan.weight_decay:
        u = u + k['wd'] * theta
    theta.copy_(theta - lr * u)


def fused_epoch_reference(plan: FusedTrainPlan, theta, m, v, sigma, xs, ys,
                          lr, step0, seed=0, drops=None, signs=None):
    """The kernel's epoch in plain tensor ops, step by step and member by
    member, in the kernel's order of operations; updates the buffers in
    place and returns ``(theta, m, v, sigma, losses[S])``. ``signs``, when
    given, is an ``(S, M, n_bn, B, 128)`` uint8 tensor that receives each
    ReLU decision of the backward, as the kernel writes it."""
    drops = _drop_tensor(plan, drops, theta.device)
    k = _constants(plan)
    S, M = xs.shape[0], plan.num_members
    g = torch.zeros_like(theta)
    lr = torch.tensor(float(lr), dtype=torch.float32, device=theta.device)
    losses = torch.empty(S, dtype=torch.float32, device=theta.device)
    for i in range(S):
        x, y = xs[i], ys[i]
        ypad = torch.nn.functional.pad(y, (0, LANES - y.shape[1]))
        saved = [_saved(plan) for _ in range(M)]
        if not plan.single_sweep:
            # the joint-mean loss couples members: every member's forward
            # first, then one loss on their mean prediction
            predsum = None
            for mi in range(M):
                h = _forward(plan, k, theta, sigma, x, i, mi, seed, drops,
                             saved[mi])
                predsum = h if predsum is None else predsum + h
            term, dpred = _loss_and_grad(plan, k, predsum * k['inv_members'],
                                         ypad)
            loss_t = term / k['loss_div']
            dpred = dpred * k['inv_members']
        loss_sum = torch.zeros((), device=theta.device)
        for mi in range(M):
            if plan.single_sweep:
                h = _forward(plan, k, theta, sigma, x, i, mi, seed, drops,
                             saved[mi])
                term, d = _loss_and_grad(plan, k, h, ypad)
                loss_sum = loss_sum + term
                d = d * k['inv_members']
            else:
                d = dpred
            _backward(plan, k, theta, g, x, mi, d, saved[mi],
                      None if signs is None else signs[i, mi])
        if plan.single_sweep:
            loss_t = loss_sum / k['sweep_div']
        _adam(plan, k, theta, m, v, g, lr, step0 + i + 1)
        losses[i] = loss_t
    return theta, m, v, sigma, losses


def _drop_tensor(plan, drops, device):
    n = max(plan.n_drop, 1)
    if drops is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    drops = torch.as_tensor(drops, dtype=torch.float32).reshape(-1)
    if drops.numel() != n:
        raise ValueError(f'expected {n} dropout rates, got {drops.numel()}')
    return drops.to(device)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
# the int and float configuration arrays of nnueehcs_fused_train_f32, in
# the order of the kernel's Config enums (csrc/fused_train.cu)
INT_FIELDS = ('S', 'B', 'in_pad', 'out_pad', 'M', 'slab_rows', 'sig_rows',
              'n_lins', 'n_bn', 'n_drop', 'loss', 'single_sweep', 'clip_on',
              'step0', 'seed', 'has_wd')
FLOAT_FIELDS = ('lr', 'bn_eps', 'mom', 'one_minus_mom', 'unbias',
                'inv_members', 'loss_div', 'sweep_div', 'clip', 'wd', 'b1',
                'b2', 'one_minus_b1', 'one_minus_b2', 'adam_eps', 'ln_b1',
                'ln_b2')
LIN_FIELDS = ('w_off', 'in_rows', 'in_w', 'out_w', 'b_off', 'g_off', 'be_off',
              'mean_off', 'var_off', 'zh_idx', 'relu', 'mask_idx')


def lin_table(plan: FusedTrainPlan, device) -> torch.Tensor:
    """The plan's blocks as an ``(n_lins, 12)`` int32 table, as the kernel
    reads it."""
    rows = [[int(getattr(L, f)) for f in LIN_FIELDS] for L in plan.lins]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def kernel_config(plan: FusedTrainPlan, S: int, lr, step0, seed,
                  single_sweep: bool):
    """The int and float configuration arrays of the training kernels' C
    entries (``INT_FIELDS`` and ``FLOAT_FIELDS`` order)."""
    k = _constants(plan)
    ints = {'S': S, 'B': plan.batch, 'in_pad': plan.in_pad,
            'out_pad': plan.out_pad, 'M': plan.num_members,
            'slab_rows': plan.slab_rows, 'sig_rows': plan.sig_rows,
            'n_lins': len(plan.lins), 'n_bn': plan.n_bn,
            'n_drop': plan.n_drop, 'loss': LOSSES.index(plan.loss),
            'single_sweep': int(single_sweep),
            'clip_on': int(plan.clip is not None), 'step0': int(step0),
            'seed': int(seed) & _M32, 'has_wd': int(bool(plan.weight_decay))}
    floats = dict(k, lr=_f32(lr))
    iconf = (ctypes.c_longlong * len(INT_FIELDS))(*[ints[f] for f in INT_FIELDS])
    fconf = (ctypes.c_float * len(FLOAT_FIELDS))(*[floats[f]
                                                   for f in FLOAT_FIELDS])
    return iconf, fconf


def kernel_buffers(lib, plan: FusedTrainPlan, theta) -> dict:
    """The device buffers the training kernels take besides the caller's:
    the block table, the per-member scratch, the zeroed gradient, the loss
    sweep's predictions and the terms/partials pair."""
    M, B, device = plan.num_members, plan.batch, theta.device
    return {
        'lins': lin_table(plan, device),
        'scratch': torch.empty(M * lib.nnueehcs_fused_train_scratch_floats(
            B, plan.n_bn, plan.n_drop), dtype=torch.float32, device=device),
        'g': torch.zeros_like(theta),
        'preds': torch.empty((M, B, LANES), dtype=torch.float32,
                             device=device),
        'small': torch.zeros(2 * M, dtype=torch.float32, device=device)}


def _check_buffers(plan: FusedTrainPlan, theta, m, v, sigma, xs, ys):
    R, G, S = plan.total_rows, plan.total_sig_rows, xs.shape[0]
    want = {'theta': (R, LANES), 'm': (R, LANES), 'v': (R, LANES),
            'sigma': (G, LANES), 'xs': (S, plan.batch, plan.in_pad),
            'ys': (S, plan.batch, plan.out_pad)}
    got = {'theta': theta, 'm': m, 'v': v, 'sigma': sigma, 'xs': xs,
           'ys': ys}
    for name, t in got.items():
        if t.dtype == torch.bfloat16:
            raise NotImplementedError('the fused training kernel is fp32 '
                                      'only')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: expected float32, got {t.dtype}')
        if t.device != theta.device:
            raise ValueError(f'{name} is on {t.device}, theta on '
                             f'{theta.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if tuple(t.shape) != want[name]:
            raise ValueError(f'{name}: expected shape {want[name]}, got '
                             f'{tuple(t.shape)}')


def _check_signs(plan: FusedTrainPlan, signs, S, device):
    want = (S, plan.num_members, plan.n_bn, plan.batch, LANES)
    if signs.dtype != torch.uint8 or tuple(signs.shape) != want \
            or signs.device != device or not signs.is_contiguous():
        raise ValueError(f'signs: expected a contiguous uint8 tensor of shape '
                         f'{want} on {device}')


def fused_epoch(plan: FusedTrainPlan, theta, m, v, sigma, xs, ys, lr, step0,
                seed=0, drops=None, signs=None):
    """Train one epoch of ``S = xs.shape[0]`` steps: the CUDA kernel for
    CUDA tensors, :func:`fused_epoch_reference` for CPU tensors. ``lr`` is
    a runtime scalar, ``step0`` the Adam step count before the epoch,
    ``seed`` the epoch's dropout seed and ``drops`` the per-slot dropout
    rates (:func:`drop_rates`). Updates ``theta``, ``m``, ``v`` and
    ``sigma`` in place; returns them and the per-step losses. ``signs``
    (a diagnostic, null on the training path) is an ``(S, M, n_bn, B,
    128)`` uint8 tensor that receives each ReLU decision of the backward.
    ``fused_epoch.launches`` counts the calls that launched the fp32
    kernel, ``fused_epoch.launches_bf16`` those that launched its bf16 form
    (``plan.bf16``; the buffers stay fp32 in both)."""
    _check_buffers(plan, theta, m, v, sigma, xs, ys)
    if signs is not None:
        _check_signs(plan, signs, xs.shape[0], theta.device)
    if theta.device.type == 'cpu':
        return fused_epoch_reference(plan, theta, m, v, sigma, xs, ys, lr,
                                     step0, seed, drops, signs)
    if theta.device.type != 'cuda':
        raise ValueError(f'no fused training kernel for device '
                         f'{theta.device}')
    device = theta.device
    S = xs.shape[0]
    losses = torch.empty(S, dtype=torch.float32, device=device)
    if S == 0:
        return theta, m, v, sigma, losses
    from ._build import library
    lib = library()
    iconf, fconf = kernel_config(plan, S, lr, step0, seed, plan.single_sweep)
    bufs = kernel_buffers(lib, plan, theta)
    drops = _drop_tensor(plan, drops, device)
    entry = lib.nnueehcs_fused_train_bf16 if plan.bf16 \
        else lib.nnueehcs_fused_train_f32
    with torch.cuda.device(device):
        err = entry(
            iconf, fconf, theta.data_ptr(), m.data_ptr(), v.data_ptr(),
            sigma.data_ptr(), bufs['g'].data_ptr(), xs.data_ptr(),
            ys.data_ptr(), losses.data_ptr(), bufs['lins'].data_ptr(),
            drops.data_ptr(), bufs['scratch'].data_ptr(),
            bufs['preds'].data_ptr(), bufs['small'].data_ptr(),
            None if signs is None else signs.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused training kernel launch failed: CUDA error '
                           f'{err}')
    if plan.bf16:
        fused_epoch.launches_bf16 += 1
    else:
        fused_epoch.launches += 1
    return theta, m, v, sigma, losses


fused_epoch.launches = 0
fused_epoch.launches_bf16 = 0
