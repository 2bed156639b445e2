"""Attribution probe of the fused training epoch (kernel 3): the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of the TPU probe ``experiments/grid_r5/attrib_train.py``
``ablate_epoch``: kernel 3 without dropout, always with the joint-mean loss
sweep, with parts of each step carved off (``mode``) and three fix
candidates that leave the function as it is (``unroll``, ``gn_fused``,
``opt_chunk``). It takes the port's :class:`~.fused_train.FusedTrainPlan`
and flat buffers, as :func:`~.fused_train.fused_epoch` does, and updates
them in place as that does.

On CUDA tensors :func:`ablate_epoch` launches ``csrc/ablate_train.cu``,
which runs kernel 3's own device code (``fused_train.cuh``); on CPU
tensors it runs :func:`ablate_epoch_reference`. It never falls back from
one to the other. ``ablate_epoch.launches`` counts the calls that launched
the kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from . import fused_train as ft

MODES = ('prod', 'no_opt', 'no_bwd', 'fwd1', 'empty')


def probe_plan(plan: ft.FusedTrainPlan) -> ft.FusedTrainPlan:
    """``plan`` as the probe runs it: no dropout slot, joint-mean loss."""
    return dataclasses.replace(
        plan, lins=tuple(dataclasses.replace(L, mask_idx=-1)
                         for L in plan.lins),
        n_drop=0, per_member=False)


def _check(plan, theta, xs, mode, unroll, opt_chunk, norms):
    if plan.bf16:
        raise ValueError('ablate_epoch: the probe is fp32 only (as the TPU '
                         'probe), got a bf16-mixed plan')
    if mode not in MODES:
        raise ValueError(f'ablate_epoch: mode {mode!r} is not one of {MODES}')
    if norms is not None and (
            mode not in ('prod', 'no_opt') or norms.shape != xs.shape[:1]
            or norms.dtype != torch.float32 or norms.device != theta.device):
        raise ValueError(f'ablate_epoch: norms must be a float32 '
                         f'({xs.shape[0]},) tensor beside theta, in mode '
                         f'prod or no_opt')
    if unroll < 1 or xs.shape[0] % unroll:
        raise ValueError(f'ablate_epoch: unroll {unroll} must divide the '
                         f'{xs.shape[0]} steps')
    if opt_chunk is not None and opt_chunk < 1:
        raise ValueError(f'ablate_epoch: opt_chunk {opt_chunk}')


def ablate_epoch_reference(plan: ft.FusedTrainPlan, theta, m, v, sigma, xs,
                           ys, lr, step0, mode='prod', unroll=1,
                           gn_fused=False, opt_chunk=None, norms=None):
    """:func:`ablate_epoch` in plain tensor ops, step by step, in kernel
    3's order of operations (:func:`~.fused_train.fused_epoch_reference`'s
    pieces). ``unroll``, ``gn_fused`` and ``opt_chunk`` change how the
    kernel runs, not what it computes, so they are checked and change
    nothing here."""
    ft._check_buffers(plan, theta, m, v, sigma, xs, ys)
    _check(plan, theta, xs, mode, unroll, opt_chunk, norms)
    plan = probe_plan(plan)
    k = ft._constants(plan)
    S, M, device = xs.shape[0], plan.num_members, theta.device
    drops = ft._drop_tensor(plan, None, device)
    g = torch.zeros_like(theta)
    lr_t = torch.tensor(float(lr), dtype=torch.float32, device=device)
    losses = torch.empty(S, dtype=torch.float32, device=device)
    for i in range(S):
        x, y = xs[i], ys[i]
        if mode == 'empty':
            losses[i] = x[0, 0]
            continue
        ypad = torch.nn.functional.pad(y, (0, ft.LANES - y.shape[1]))
        saved = [ft._saved(plan) for _ in range(M)]
        if mode == 'fwd1':
            h = ft._forward(plan, k, theta, sigma, x, i, 0, 0, drops,
                            saved[0])
            term, _ = ft._loss_and_grad(plan, k, h, ypad)
            losses[i] = term / k['loss_div']
            continue
        predsum = None
        for mi in range(M):
            h = ft._forward(plan, k, theta, sigma, x, i, mi, 0, drops,
                            saved[mi])
            predsum = h if predsum is None else predsum + h
        term, dpred = ft._loss_and_grad(plan, k, predsum * k['inv_members'],
                                        ypad)
        losses[i] = term / k['loss_div']
        if mode == 'no_bwd':
            continue
        dpred = dpred * k['inv_members']
        for mi in range(M):
            ft._backward(plan, k, theta, g, x, mi, dpred, saved[mi])
        if norms is not None:
            norms[i] = torch.sqrt((g * g).sum())
        if mode == 'prod':
            ft._adam(plan, k, theta, m, v, g, lr_t, step0 + i + 1)
    return theta, m, v, sigma, losses


def ablate_epoch(plan: ft.FusedTrainPlan, theta, m, v, sigma, xs, ys, lr,
                 step0, mode='prod', unroll=1, gn_fused=False,
                 opt_chunk=None, norms=None):
    """``S = xs.shape[0]`` steps of kernel 3 without dropout and always
    with the joint-mean loss sweep (JAX ``ablate_epoch``), carved by
    ``mode``: ``'prod'`` (the whole step), ``'no_opt'`` (no optimizer:
    theta, m and v stay as given), ``'no_bwd'`` (the loss sweep and the
    loss only), ``'fwd1'`` (member 0's forward, with its BatchNorm EMA, and
    the loss of its output) or ``'empty'`` (``losses[s] = xs[s, 0, 0]``,
    nothing else). ``sigma`` moves in every mode but ``'empty'``. Fix
    candidates: ``unroll`` K (dividing S) replays a CUDA graph of K steps
    S/K times; ``gn_fused`` takes each member's sum of g^2 as its backward
    writes g; ``opt_chunk`` rows of 128 per optimizer block (``None``:
    kernel 3's grid). With ``norms``, a float32 ``(S,)`` tensor, each
    step's global gradient norm (the clip's input) is written there, in
    modes ``'prod'`` and ``'no_opt'``: on the card as the optimizer forms
    it from the members' partial sums, by one more small launch a step.
    Updates the buffers in place; returns them and the per-step losses."""
    ft._check_buffers(plan, theta, m, v, sigma, xs, ys)
    _check(plan, theta, xs, mode, unroll, opt_chunk, norms)
    if theta.device.type == 'cpu':
        return ablate_epoch_reference(plan, theta, m, v, sigma, xs, ys, lr,
                                      step0, mode, unroll, gn_fused,
                                      opt_chunk, norms)
    if theta.device.type != 'cuda':
        raise ValueError(f'no training ablation kernel for device '
                         f'{theta.device}')
    device = theta.device
    S = xs.shape[0]
    losses = torch.empty(S, dtype=torch.float32, device=device)
    if S == 0:
        return theta, m, v, sigma, losses
    from ._build import library
    lib = library()
    plan = probe_plan(plan)
    iconf, fconf = ft.kernel_config(plan, S, lr, step0, 0, False)
    bufs = ft.kernel_buffers(lib, plan, theta)
    drops = ft._drop_tensor(plan, None, device)
    step_base = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.nnueehcs_ablate_train_f32(
            iconf, fconf, theta.data_ptr(), m.data_ptr(), v.data_ptr(),
            sigma.data_ptr(), bufs['g'].data_ptr(), xs.data_ptr(),
            ys.data_ptr(), losses.data_ptr(), bufs['lins'].data_ptr(),
            drops.data_ptr(), bufs['scratch'].data_ptr(),
            bufs['preds'].data_ptr(), bufs['small'].data_ptr(),
            MODES.index(mode), int(bool(gn_fused)),
            0 if opt_chunk is None else opt_chunk * ft.LANES, unroll,
            step_base.data_ptr(),
            None if norms is None else norms.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'training ablation kernel failed: CUDA error '
                           f'{err}')
    ablate_epoch.launches += 1
    return theta, m, v, sigma, losses


ablate_epoch.launches = 0
