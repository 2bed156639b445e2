#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nnueehcs_tpu_torch``) on one card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from the sources in the checkout (one
nvcc per source, all at once), holds each kernel against its plain PyTorch
version, serves requests through the port's ``Predictor`` for seven models
at the flagship width (5 inputs, 7 Linear layers 128 wide, weights and
corpora drawn from ``--seed``): the 8-member ensemble, MC dropout (128
samples, p = 0.1), Δ-UQ and PAGER (229 anchors), KDE and kNN-KDE (k = 220)
on a 16,384 x 5 corpus, and MVE. It checks every answer against the
unfused computation on the card, checks that each model's requests
launched its kernel exactly as often as they should (and no kernel for
kNN-KDE and MVE, which have none), and times each kernel beside its plain
version, a PyTorch yardstick and its roofline bound, and the kernel-free
kNN-KDE and MVE paths end to end. It then trains: the training kernel
against its plain version at the flagship shape (four loss and model
cases), ``Trainer.fit`` of the flagship ensemble for 3 epochs of 1,000
steps (``examples/bo_driven/config.yaml``: batch 128, lr 5e-5, clip 5,
l1, joint mean) on 160,000 rows drawn from ``--seed``, whose saved bundle
must reload, serve and reproduce its logged validation loss, one epoch each
of MVE and MC dropout, and the kernel's epoch time (one thread-block
cluster of ``fused_train.CLUSTER`` blocks per member; its registers and
spills from ptxas) beside its plain version, a PyTorch yardstick, its
bound, the attribution probe's one-block form of the same step and a
single net's epoch. Last it runs the attribution entry point
(``nnueehcs_tpu_torch.attrib``): both batteries of the CUDA probes of
kernels 1 and 3 at the flagship shape (262,144 rows; 500 steps of batch
128), every probe held to its plain version and every form of kernel 1's
math to kernel 1 bit for bit before it is timed, kernel 3 held step by
step to its plain version at every batch of the batch scaling and timed
beside its probe, and the training battery again for kernel 3's bf16
form, with the serving and training phases checked to have launched no
probe. The bf16 forms of kernels 1, 2 and 5 and of the packed probe are
held to their plain
versions at the same shapes (1, 2 and 5 also on a chain twelve Linears
deep, which their wgmma forms stream through a ring of shared-memory
slots; 1b, one thread-block cluster of member blocks, also at 1 to 32
members, a +1e3 mean and requests of 1 and 300 rows, and twice on the
same rows, bit for bit; the build phase checks that both forms of each
compile without spills and with HGMMA instructions, and that the MC
kernel's mask loop spends a plausible number of SASS instructions a hash;
row 2b's bound counts the hash's operations from its function, by integer
pipe; the KDE kernel is also held at every d from 1 to 8 and for one
query, and row 4's bound is counted by pipe), the seven models are served again after
``set_precision('bf16-mixed')`` (the JAX package's ``eval_precision``, a
bf16 evaluation of an fp32-trained model), each answer held to the plain
bf16 function on the card against its bf16-vs-fp32 gap, with each
kernel's bf16 form launched exactly as often as its fp32 form was and no
fp32 form at all, and each bf16 form is timed. Training in bf16-mixed:
the training kernel's bf16 form is held to its plain version step by step
on the four cases at the flagship shape (the bf16 bars against each step's
bf16-vs-fp32 gap) and over one epoch's loss curve, and both forms step by
step at the plan the Δ-UQ and PAGER fits give it (one net, 256 anchored
rows of 10 features); ``Trainer.fit`` of the
flagship trial with ``precision: 'bf16-mixed'`` for 3 epochs must launch
the bf16 form once an epoch and no fp32 form, and its bundle must reload
in bf16, serve through kernel 1's bf16 form and reproduce its logged
validation loss; Δ-UQ and PAGER (229 anchors) train for 2 epochs in fp32
and in bf16, epoch 0 step by step while their hooks capture the anchors,
epoch 1 through the training kernel at the doubled batch, with every
launch count checked; the bf16 form's epoch is timed beside its plain
version, an autocast yardstick and its bound. It prints one JSON line per
phase, then the card's ``nvidia-smi`` name and power limit, then a
``{"kernels": [...]}`` line (fifteen kernels: the ten fp32 ones, then the
five bf16 forms), and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a card it exits non-zero before doing
anything.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import time

import csv
import os

import numpy as np
import torch
import torch.nn.functional as F

from nnueehcs_tpu_torch.model_builder import (DeltaUQMLPModelBuilder,
                                              EnsembleModelBuilder,
                                              KDEModelBuilder,
                                              KNNKDEModelBuilder,
                                              MCDropoutModelBuilder,
                                              MVEModelBuilder,
                                              PAGERModelBuilder)
from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.attrib import (TOL_MEAN, TOL_STD, TOL_TRAIN,
                                       bf16_close, bf16_peak, bound, check,
                                       event_ms, flip_reach, nvidia_smi,
                                       peaks, separate_relu,
                                       stepwise_vs_plain, train_flops,
                                       train_rest_flops)
from nnueehcs_tpu_torch.convert import tensor_trees
from nnueehcs_tpu_torch.ops import _build
from nnueehcs_tpu_torch.ops import ablate_epoch as ae
from nnueehcs_tpu_torch.ops import ablate_forward as af
from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
from nnueehcs_tpu_torch.ops import fused_train as ft
from nnueehcs_tpu_torch.ops.fused_anchored import (anchor_rows,
                                                   fused_anchored_plain,
                                                   fused_anchored_stats,
                                                   prepare_fused_anchored)
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   fused_forward_prefolded,
                                                   prepare_fused_weights)
from nnueehcs_tpu_torch.ops.fused_mc_dropout import (MASK_HASH_OPS,
                                                     fused_mc_forward,
                                                     fused_mc_forward_plain,
                                                     prepare_mc_weights)
from nnueehcs_tpu_torch.ops.kde import (_log_norm_const, bandwidth_value,
                                        centre, kde_bound_terms, kde_logpdf,
                                        kde_logpdf_plain, knn_kde_density)
from nnueehcs_tpu_torch.sass import eval_chain_sass
from nnueehcs_tpu_torch.serving import DEFAULT_BUCKETS, Predictor
from nnueehcs_tpu_torch.training import (ArrayDataset, DataLoader,
                                         EarlyStopping, ModelSavingCallback,
                                         Trainer, load_model)
from nnueehcs_tpu_torch.utils.timing import timed_passes

# flagship surrogate (bench.py): 8 members, 5 inputs, 6 x [Linear 128 ->
# BatchNorm1d -> ReLU], then Linear 128 -> 1
IN_DIM, WIDTH, MEMBERS = 5, 128, 8
FLAGSHIP = [{'Linear': {'args': [IN_DIM, WIDTH]}}, {'BatchNorm1d': {'args': [WIDTH]}},
            {'ReLU': {'inplace': True}}]
for _ in range(5):
    FLAGSHIP += [{'Linear': {'args': [WIDTH, WIDTH]}},
                 {'BatchNorm1d': {'args': [WIDTH]}}, {'ReLU': {'inplace': True}}]
FLAGSHIP += [{'Linear': {'args': [WIDTH, 1]}}]
# an input wider than the 128-wide tiles, which the kernel stages in chunks
WIDE_IN = 200
WIDE_INPUT = [{'Linear': {'args': [WIDE_IN, WIDTH]}},
              {'BatchNorm1d': {'args': [WIDTH]}}, {'ReLU': {}},
              {'Linear': {'args': [WIDTH, 1]}}]
# with one hidden Linear, so the MC-dropout builder puts a Dropout before it
WIDE_INPUT_MC = WIDE_INPUT[:3] + FLAGSHIP[3:6] + WIDE_INPUT[3:]
# the flagship block twelve Linears deep: too deep for the bf16 eval kernels
# to hold in shared memory, so they stream it through their ring
DEEP_RING = FLAGSHIP[:3] + FLAGSHIP[3:6] * 10 + FLAGSHIP[-1:]
# the grid's UQ passes (bench.py): MC dropout with 128 samples at p = 0.1;
# Δ-UQ (and PAGER) with 229 anchors and anchored_batch_size 229
MC_SAMPLES, MC_P = 128, 0.1
ANCHORS = 229
# the bench's KDE workload (bench.py:189-193): a 16,384 x 5 fit corpus and
# rtol 1000; kNN-KDE with k = 220, the median k of the 83 committed kNN
# bundles; MVE with min_variance 1e-7 (bench.py:187)
KDE_FIT_ROWS, KDE_RTOL, KNN_K, MVE_MIN_VARIANCE = 16_384, 1000, 220, 1e-7
# (queries, references, features) of the other KDE kernel cases: the
# committed minibude corpus shape with a ragged query count, and a wide d
# whose sizes are multiples of no tile
MINIBUDE_KDE = (100_003, 45_824, 6)
WIDE_KDE = (10_000, 3_001, 37)
OFFSET_KDE = (20_000, KDE_FIT_ROWS, IN_DIM)
KDE_RAGGED = (1_001, 3_001)          # (queries, references) at each d <= 8
EXTRA_SEED = 101                     # the generator of the cases above
KDE_LIBRARY_CHUNK = 4096             # references per yardstick chunk

DEVICE = 'cuda'
ROWS = 262_144                       # the bench's evaluation batch
REQUESTS = (1, 300, 4096, 65_536, 262_144)
ANCHORED_ROWS = 65_536               # the bench's Δ-UQ shape, 65536 x 229
MODEL_REQUESTS = (1, 300, 4096, 65_536)
# kernel 1b's other member counts (the BO range is 2-32, and 1)
ENSEMBLE_MEMBERS = (1, 2, 3, 12, 32)
# the plain MC version hashes every mask element in int64 tensor ops, too
# slow for 15 timed passes at ROWS; its timing runs at this many rows
MC_PLAIN_TIMING_ROWS = 16_384
PASS_GROUP = 16                      # passes or anchors per yardstick GEMM
WARMUP, TRIALS = 5, 10               # the bench's timing protocol
# kernel vs plain: TOL_MEAN and TOL_STD (tests/test_fused_ensemble.py's)
# and TOL_TRAIN (tests/test_torch_fused_train.py's, tighter than
# tests/test_fused_train.py:97-115; absolute) come from attrib
# KDE log density: float32 round-off in the decomposition |x|^2 + |y|^2 -
# 2 x.y, scaled by gamma (tests/test_torch_kde.py); a density score
# -exp(log p) carries it through exp: 1e-4 + 1e-5 |log p| relative, under
# 2e-4 for |log p| <= 10
TOL_LOGPDF = {'rtol': 1e-5, 'atol': 1e-4}
TOL_SCORE = {'rtol': 2e-4, 'atol': 1e-30}
# training: the flagship trial (examples/bo_driven/config.yaml) on
# 160,000 rows split 128,000 / 32,000, 3 epochs of 1,000 steps of 128 rows
TRAIN_ROWS, TRAIN_SPLIT, TRAIN_BATCH = 160_000, 128_000, 128
TRAIN_CONFIG = {'max_epochs': 3, 'limit_train_batches': 1000,
                'limit_val_batches': 100, 'log_every_n_steps': 5,
                'gradient_clip_val': 5}
TRAIN_MODEL_CONFIG = {'loss': 'l1_loss', 'learning_rate': 5e-5,
                      'weight_decay': 0, 'batch_size': TRAIN_BATCH}
TRAIN_DIR = os.path.join('build', 'chip_smoke_train')
TRAIN_CHECK_STEPS, TRAIN_STEP0 = 8, 5    # kernel vs plain: steps, Adam count
STEPWISE_STEPS = 64                      # the as-built case, one step a call
# kernel fit vs per-step fit: 100 steps, the first 20 held to TOL_CROSS.
# Two float32 trajectories part exponentially (Adam from zero moments and
# ReLU flips amplify round-off): ~1e-6 apart at step 10, ~1e-3 by step
# 100, on the card and between the CPU's own two paths alike.
CROSS_STEPS, CROSS_CHECKED = 100, 20
TOL_CROSS = {'rtol': 0.0, 'atol': 1e-4}
EPOCH_STEPS = 1000                       # a flagship epoch
PLAIN_TRAIN_STEPS = 100                  # the plain epoch is timed on 100
# kernel 3's bf16 form against its plain version: each case step by step
# (attrib.stepwise_vs_plain_bf16's bars), and the joint case's loss curve
# over a whole epoch, every step within the curve's largest bf16-vs-fp32 gap
# (after a flipped rounding the two bf16 trajectories part: on the card,
# the first 16 steps of the curve reached 0.56 of the gap's rms)
STEPWISE_BF16_STEPS = 16
BF16_CURVE_STEPS = 64
# Δ-UQ and PAGER fits: 229 anchors, epoch 0 step by step (the anchor hook
# reads its batches), epoch 1 through the kernel at the doubled batch; 250
# steps an epoch (1,000 per-step steps took 17-22 s a fit on the card)
ANCHORED_FIT_EPOCHS, ANCHORED_FIT_STEPS = 2, 250
# the plain bf16 epoch (about 53 ms a step, host-bound) is timed on 20 steps
PLAIN_BF16_STEPS = 20
KERNELS = [{
    'name': 'fused_ensemble',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_ensemble.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_ensemble.py:195',
}, {
    'name': 'fused_mc_dropout',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_mc_dropout.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_ensemble.py:460',
}, {
    'name': 'fused_anchored',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_anchored.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_anchored.py:141',
}, {
    'name': 'kde',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/kde.cu',
    'replaces': 'nnueehcs_tpu/ops/kde.py:117',
}, {
    'name': 'fused_train',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_train.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_train.py:386',
}, {
    'name': 'ablate_forward',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_chain.cu',
    'replaces': 'experiments/grid_r5/attrib_eval.py:52',
}, {
    'name': 'xt_forward',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_chain.cu',
    'replaces': 'experiments/grid_r5/attrib_eval.py:135',
}, {
    'name': 'narrow_forward',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_chain.cu',
    'replaces': 'experiments/grid_r5/attrib_eval2.py:52',
}, {
    'name': 'ablate_epoch',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_train.cu',
    'replaces': 'experiments/grid_r5/attrib_train.py:52',
}, {
    'name': 'packed_forward',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_chain.cu',
    'replaces': 'experiments/grid_r4/kernel_variants.py:37',
}, {
    'name': 'fused_ensemble_bf16',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_ensemble.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_ensemble.py:195',
}, {
    'name': 'fused_mc_dropout_bf16',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_mc_dropout.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_ensemble.py:460',
}, {
    'name': 'fused_anchored_bf16',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_anchored.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_anchored.py:141',
}, {
    'name': 'packed_forward_bf16',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/ablate_chain.cu',
    'replaces': 'experiments/grid_r4/kernel_variants.py:37',
}, {
    'name': 'fused_train_bf16',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_train_bf16.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_train.py:386',
}]
# each kernel's launch count: (wrapper, attribute); a wrapper counts its
# fp32 and bf16 forms apart
WRAPPERS = {'fused_ensemble': (fused_forward_prefolded, 'launches'),
            'fused_mc_dropout': (fused_mc_forward, 'launches'),
            'fused_anchored': (fused_anchored_stats, 'launches'),
            'kde': (kde_logpdf, 'launches'),
            'fused_train': (ft.fused_epoch, 'launches'),
            'ablate_forward': (af.ablate_forward, 'launches'),
            'xt_forward': (af.xt_forward, 'launches'),
            'narrow_forward': (af.narrow_forward, 'launches'),
            'ablate_epoch': (ae.ablate_epoch, 'launches'),
            'packed_forward': (af.packed_forward, 'launches'),
            'fused_ensemble_bf16': (fused_forward_prefolded, 'launches_bf16'),
            'fused_mc_dropout_bf16': (fused_mc_forward, 'launches_bf16'),
            'fused_anchored_bf16': (fused_anchored_stats, 'launches_bf16'),
            'packed_forward_bf16': (af.packed_forward, 'launches_bf16'),
            'fused_train_bf16': (ft.fused_epoch, 'launches_bf16')}
BF16_OF = {'fused_ensemble': 'fused_ensemble_bf16',
           'fused_mc_dropout': 'fused_mc_dropout_bf16',
           'fused_anchored': 'fused_anchored_bf16', 'kde': 'kde'}
# the attribution phase: the probes' battery variant that stands for each
# probe in the kernels line, and the gates whose errors it reports
PROBE_VARIANTS = {'ablate_forward': 'prod', 'xt_forward': 'xT input',
                  'narrow_forward': 'narrow-both', 'packed_forward': 'packed'}
PROBE_GATES = {
    'ablate_forward': ('prod', 'io_floor', 'one_out', 'gemm_only', 'no_epi',
                       'members=1', 'members=2', 'members=4', 'layers=1',
                       'layers=3', 'layers=5'),
    'xt_forward': ('xT input', 'xT+outT'),
    'narrow_forward': ('narrow-in', 'narrow-out', 'narrow-both'),
    'packed_forward': ('packed',)}
ATTRIB_STEPS = attrib.STEPS                  # attrib_train.py's 500 steps
ATTRIB_TRAIN_REPS = 3                        # epochs per training variant
PLAIN_ABLATE_STEPS = 20                      # the plain epoch, scaled
# MUFU ex2 results per SM per clock, and 32-bit integer operations (add,
# multiply-add, shift, compare, bitwise) per SM per clock (CUDA programming
# guide, arithmetic instruction throughput, compute capability 9.0). IMAD
# and IMUL run on the FMA pipe, the other integer operations on the ALU
# pipe (Nsight Compute kernel profiling guide, "Pipelines"), 64 a clock
# each; the four schedulers of an SM issue 128 thread instructions a clock,
# which the two pipes together never exceed.
EX2_PER_SM_PER_CLOCK = 16
INT_PIPE_PER_SM_PER_CLOCK = 64


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def compare(name, got, want, tol):
    """Raise unless ``got`` matches ``want`` within ``tol``; return the max
    absolute error."""
    check(got.shape == want.shape, f'{name}: shape {tuple(got.shape)} != '
                                   f'{tuple(want.shape)}')
    check(bool(torch.isfinite(got).all()), f'{name}: non-finite values')
    err = (got - want).abs()
    bad = err > tol['atol'] + tol['rtol'] * want.abs()
    check(not bool(bad.any()), f'{name}: {int(bad.sum())} values off by up to '
                               f'{float(err.max()):.3e} (tolerance {tol})')
    return float(err.max())


def randomize_bn(model, generator):
    """Give every BatchNorm non-trivial running statistics and affine
    parameters, so the fold does real work."""
    with torch.no_grad():
        for layer in model.net.layers:
            if hasattr(layer, 'running_var'):
                shape = layer.running_var.shape
                for t, v in ((layer.running_mean, torch.randn(shape, generator=generator) * 0.3),
                             (layer.running_var, torch.rand(shape, generator=generator) + 0.5),
                             (layer.weight, torch.rand(shape, generator=generator) + 0.5),
                             (layer.bias, torch.randn(shape, generator=generator) * 0.1)):
                    t.copy_(v)


def build_model(seed, layers=FLAGSHIP, members=MEMBERS):
    model = EnsembleModelBuilder(layers, {'num_models': members}, seed=seed,
                                 device=DEVICE).build()
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    return model


def build_mc(seed, layers=FLAGSHIP, p=MC_P):
    model = MCDropoutModelBuilder(layers, {'num_samples': MC_SAMPLES,
                                           'dropout_percent': p},
                                  seed=seed, device=DEVICE).build()
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    model.reseed(seed)
    return model


def build_anchored(builder, seed, estimator='std', layers=FLAGSHIP):
    model = builder(layers, {'estimator': estimator, 'num_anchors': ANCHORS,
                               'anchored_batch_size': ANCHORS},
                    seed=seed, device=DEVICE).build()
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    rng = np.random.default_rng(seed + 2)
    model.anchors = rng.normal(size=(ANCHORS, IN_DIM)).astype(np.float32)
    if builder is PAGERModelBuilder:
        # targets of a trained model sit near its own predictions: take the
        # prediction for each anchor anchored at itself
        with torch.no_grad():
            a = model.anchors
            model.anchors_Y = model.net(
                torch.cat([a, a - a], dim=1))[:, :1].cpu().numpy()
    return model


def build_density(builder, descr, seed, corpus=None):
    """A KDE, kNN-KDE or MVE model at the flagship width, fitted on
    ``corpus`` (numpy) where it has one."""
    model = builder(FLAGSHIP, descr, seed=seed, device=DEVICE).build()
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    if corpus is not None:
        model.fit_kde(corpus)
    return model


def reference_density(model, x):
    """The prediction through the modules and the density score from the
    plain KDE (or the kNN top-k, which has no kernel), or MVE's sigma."""
    with torch.no_grad():
        out = model.net(x)
    if model.uq_method == 'kde':
        return out, -torch.exp(kde_logpdf_plain(*centre(x, model.kde.data),
                                                model.kde.bandwidth_))
    if model.uq_method == 'knn_kde':
        return out, -knn_kde_density(x, model._fit_data,
                                     model._bandwidth_value, model.k)
    return out[:, :1], torch.sqrt(F.softplus(out[:, 1:2])
                                  + model.min_variance)


def kde_library(x, data, h):
    """Yardstick only: the KDE log density as a chain of PyTorch calls per
    4,096-reference chunk (``addmm`` for the cross term, TF32 off; clamp
    and scale; ``logsumexp``; a running ``logaddexp``), queries in tiles
    that keep each (rows, chunk) buffer near 1 GiB."""
    xc, dc = centre(x, data)
    n, d = dc.shape
    gamma = 1.0 / (2.0 * h * h)
    x2, y2 = (xc * xc).sum(1, keepdim=True), (dc * dc).sum(1)
    rows = (1 << 28) // KDE_LIBRARY_CHUNK
    out = []
    for i in range(0, xc.shape[0], rows):
        lse = None
        for j in range(0, n, KDE_LIBRARY_CHUNK):
            y = dc[j:j + KDE_LIBRARY_CHUNK]
            sq = torch.addmm(x2[i:i + rows] + y2[j:j + KDE_LIBRARY_CHUNK],
                             xc[i:i + rows], y.T, alpha=-2.0)
            part = torch.logsumexp(sq.clamp_(min=0.0).mul_(-gamma), dim=1)
            lse = part if lse is None else torch.logaddexp(lse, part)
        out.append(lse)
    return torch.cat(out) + _log_norm_const(n, d, h)


def reference_ue(model, x):
    """The unfused network, member by member through the modules."""
    with torch.no_grad():
        out = model.net(x)
    return out.mean(0), out.std(0, correction=1)


def reference_anchored(model, x):
    """Anchored passes through the modules (and PAGER's score)."""
    with torch.no_grad():
        mean, spread = model.anchored_stats_modules(x, model.anchors,
                                                    model.num_anchors)
        if hasattr(model, 'anchors_Y'):
            p = model.prediction_matrix(x, model.anchors[:model.num_anchors])
            y = model.anchors_Y[:model.num_anchors].reshape(1, -1)
            spread = torch.maximum(spread,
                                   (p - y).abs().amax(dim=1, keepdim=True))
    return mean, spread


def library_chain(fw, x):
    """Yardstick only: the same function as one batched GEMM per layer; in
    bf16 (bf16 weights) each hidden layer is a bf16 ``baddbmm`` (bias
    added in bf16), the last layer an fp32 one on the bf16 activations."""
    last = fw.num_layers - 1
    bf16 = fw.compute_dtype == torch.bfloat16
    h = (x.bfloat16() if bf16 else x).expand(fw.num_members, *x.shape)
    for l, relu in enumerate(fw.relus):
        w, b = fw.ws[l], fw.b_all[l]
        if l == last:
            w, b = w[:, :, :fw.out_dim], b[:, :fw.out_dim]
            h = torch.baddbmm(b.unsqueeze(1), h.float(), w.float())
        else:
            h = torch.baddbmm(b.to(w.dtype).unsqueeze(1), h, w)
        if relu:
            h = torch.relu(h)
    std, mean = torch.std_mean(h, dim=0, correction=1)
    return mean, std


def chain(fw, h, first=0):
    """The folded chain from layer ``first`` on, one GEMM per layer, the
    hidden ones in the weights' dtype (bf16: bias added in bf16), the last
    one in fp32."""
    last = fw.num_layers - 1
    for l in range(first, fw.num_layers):
        w, b = fw.ws[l][0], fw.b_all[l, 0]
        if l == last:
            w, b = w[:, :fw.out_dim], b[:fw.out_dim]
            h = torch.addmm(b, h.float(), w.float())
        else:
            h = torch.addmm(b.to(w.dtype), h.to(w.dtype), w)
        if fw.relus[l]:
            h = torch.relu(h)
    return h


def mc_gemm_only(mw, x, samples):
    """A GEMM-only reference for the MC kernel, not the same function: the
    1 + S passes without masks, PASS_GROUP passes per GEMM, summed."""
    total = None
    for start in range(0, samples + 1, PASS_GROUP):
        g = min(PASS_GROUP, samples + 1 - start)
        h = chain(mw, x.repeat(g, 1)).view(g, *x.shape[:1], mw.out_dim).sum(0)
        total = h if total is None else total + h
    return total


def anchored_library(aw, x, anchors):
    """Yardstick only: the anchored UE pass as one GEMM chain over all
    anchored rows concat([a, x - a]) (PASS_GROUP anchors at a time), with
    shifted sums against anchor 0; in bf16 the first GEMM takes the
    anchored rows and the whole first weight in bf16."""
    dtype = aw.compute_dtype
    w_bot = aw.ws[0][0].float()
    w_top = w_bot.clone()
    w_top[:, :aw.width0] += aw.w0d
    w_full = torch.cat([w_top, w_bot]).to(dtype)             # (2d, 128)
    c = s1 = s2 = None
    for start in range(0, anchors.shape[0], PASS_GROUP):
        a = anchors[start:start + PASS_GROUP]
        inp = torch.cat([a[:, None].expand(-1, *x.shape),
                         x[None] - a[:, None]], dim=-1).reshape(-1, 2 * x.shape[1])
        h = torch.addmm(aw.b_all[0, 0].to(dtype), inp.to(dtype), w_full)
        if aw.relus[0]:
            h = torch.relu(h)
        h = chain(aw, h, first=1).view(a.shape[0], x.shape[0], aw.out_dim)
        if c is None:
            c, s1, s2 = h[0], torch.zeros_like(h[0]), torch.zeros_like(h[0])
        d = h - c
        s1 = s1 + d.sum(0)
        s2 = s2 + (d * d).sum(0)
    n = anchors.shape[0]
    m1 = s1 / n
    return c + m1, torch.sqrt(torch.clamp(s2 - n * m1 * m1, min=0) / (n - 1))


def reset_launches():
    for wrapper, attr in WRAPPERS.values():
        setattr(wrapper, attr, 0)


def read_launches():
    return {name: getattr(w, attr) for name, (w, attr) in WRAPPERS.items()}


def serve(name, model, requests, rng, reference, kernel, tol_ue=TOL_STD,
          judge=None, phase='serving'):
    """Drive ``Predictor`` on ``model``: warm-up, then one request of each
    size. Launch counts are set to 0 just before and read just after;
    ``kernel`` must have launched once per bucket in the warm-up and once
    per chunk of each request, and no other kernel at all (with ``kernel``
    None, no kernel at all). ``reference(x, call_index)`` gives the unfused
    answer on the card for a request that was the model's
    ``call_index``-th call; ``judge(x, call_index, mean, ue)``, when given,
    checks an answer instead and returns its errors."""
    x_requests = [rng.normal(size=(n, IN_DIM)).astype(np.float32)
                  for n in requests]
    reset_launches()
    start = time.perf_counter()
    predictor = Predictor(model, buckets=DEFAULT_BUCKETS, device=DEVICE)
    warmup_s = time.perf_counter() - start
    answers, latencies, calls = [], [], []
    for x in x_requests:
        calls.append(getattr(model, '_eval_calls', None))
        start = time.perf_counter()
        answers.append(predictor.predict(x))
        latencies.append(time.perf_counter() - start)
    launches = read_launches()
    expected = {k: 0 for k in WRAPPERS}
    if kernel is not None:
        # warm-up drives each bucket once; a request runs once per chunk of
        # up to the largest bucket
        expected[kernel] = len(DEFAULT_BUCKETS) + sum(
            -(-n // DEFAULT_BUCKETS[-1]) for n in requests)
    check(launches == expected, f'{name}: launches {launches} on the serving '
                                f'path, expected {expected}')
    errs = []
    for x, call, (mean, ue) in zip(x_requests, calls, answers):
        xd = torch.from_numpy(x).to(DEVICE)
        if judge is not None:
            errs.append({'rows': len(x), **judge(xd, call, mean, ue)})
            continue
        ref_mean, ref_ue = reference(xd, call)
        errs.append({'rows': len(x),
                     'mean': compare(f'{name} {len(x)}-row mean',
                                     torch.from_numpy(mean), ref_mean.cpu(),
                                     TOL_MEAN),
                     'ue': compare(f'{name} {len(x)}-row ue',
                                   torch.from_numpy(ue), ref_ue.cpu(), tol_ue)})
    torch.cuda.synchronize()
    emit(phase, model=name, warmup_s=warmup_s, request_rows=list(requests),
         request_s=latencies, launches=launches, expected_launches=expected,
         max_abs_err_vs_unfused=errs)
    return predictor, launches[kernel] if kernel is not None else 0


def ptxas_report(log):
    """Registers, spills and stack per compiled kernel from -Xptxas -v."""
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            current = m.group(1)
            continue
        if current is None:
            continue
        entry = report.setdefault(current, {})
        if m := re.search(r'Used (\d+) registers', line):
            entry['registers'] = int(m.group(1))
        if m := re.search(r'(\d+) bytes smem', line):
            entry['static_smem_bytes'] = int(m.group(1))
        if m := re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                          r'(\d+) bytes spill loads', line):
            entry.update(stack_bytes=int(m.group(1)),
                         spill_store_bytes=int(m.group(2)),
                         spill_load_bytes=int(m.group(3)))
    return {k: v for k, v in report.items() if 'registers' in v}


def cluster_kernels(report, source):
    """Registers and spills of the training kernel's cluster form compiled
    from ``source`` (``fused_train`` or ``fused_train_bf16``), by kernel
    and residency."""
    out = {}
    for name, entry in report.items():
        m = re.search(r'(\d+)_' + source + r'_cu_\w+?(cluster_\w+?_kernel)'
                      r'ILb([01])ELb([01])E', name)
        if m:
            where = 'resident' if m.group(4) == '1' else 'device'
            out[f'{m.group(2)}<{where}>'] = {
                k: entry.get(k) for k in ('registers', 'spill_store_bytes',
                                          'spill_load_bytes')}
    return out


def hash_clocks(ops):
    """Least SM clocks that one mask element's operations ``ops``
    (``fused_mc_dropout.MASK_HASH_OPS``) take: the ALU and the FMA pipe at
    INT_PIPE_PER_SM_PER_CLOCK each, the operations either can run split
    between them to balance them."""
    return min(max(ops['alu'] + k, ops['fma'] + ops['either'] - k)
               for k in range(ops['either'] + 1)) / INT_PIPE_PER_SM_PER_CLOCK


def smooth_target(x):
    """The training target: a smooth function of the 5 inputs."""
    return (np.sin(x[:, :1]) + 0.5 * x[:, 1:2] * x[:, 2:3]
            + 0.1 * x[:, 3:4] ** 2 - 0.3 * x[:, 4:5]).astype(np.float32)


def train_plan(model, loss='l1_loss', per_member=False, wd=0.0, bf16=False,
               batch=TRAIN_BATCH):
    """The training kernel's plan for ``model`` at ``batch`` rows, clip 5
    (its bf16-mixed form with ``bf16``)."""
    single = model.uq_method != 'ensemble'
    plan = ft.plan_fused_train(
        model.net, 1 if single else model.num_models, batch, loss=loss,
        per_member=per_member, clip=5.0, weight_decay=wd, bf16=bf16,
        member_stacked=not single)
    check(plan is not None, f'{model.uq_method}: the training plan rejected '
                            'the flagship network')
    return plan


def train_inputs(model, plan, rng, steps, anchored=False):
    """``model``'s parameters and BatchNorm state packed for ``plan``, Adam
    moments drawn from ``rng`` (non-zero), and ``steps`` batches of the
    smooth target; with ``anchored``, Δ-UQ's doubled batches of
    ``plan.batch / 2`` rows as the trainer gathers them, anchored by
    permutations drawn from a seed that ``rng`` gives."""
    params, state = tensor_trees(model.net)

    def moments(draw):
        return ft.pack_tree(plan, [
            {k: torch.as_tensor(draw(tuple(v.shape)), dtype=torch.float32)
             for k, v in p.items()} for p in params], DEVICE)
    bufs = [ft.pack_tree(plan, params, DEVICE),
            moments(lambda shape: rng.normal(size=shape) * 1e-3),
            moments(lambda shape: rng.uniform(1e-8, 1e-6, size=shape)),
            ft.pack_state(plan, state, DEVICE)]
    rows = plan.batch // 2 if anchored else plan.batch
    x = rng.normal(size=(steps * rows, IN_DIM)).astype(np.float32)
    xt, yt = (torch.as_tensor(a, device=DEVICE) for a in (x, smooth_target(x)))
    idx = torch.arange(len(x), device=DEVICE)
    if anchored:
        perms = ft.anchor_permutations(torch.Generator(device=DEVICE)
                                       .manual_seed(int(rng.integers(1 << 31))),
                                       steps, rows)
        xs, ys = ft.gather_anchored_epoch_batches(plan, xt, yt, idx, perms)
    else:
        xs, ys = ft.gather_epoch_batches(plan, xt, yt, idx)
    return bufs, xs, ys


def library_epoch(model, xs, ys, lr, bf16=False):
    """Yardstick only: the flagship ensemble's epoch through PyTorch's own
    ops: a ``baddbmm`` member chain with ``F.batch_norm`` (per member and
    column, running statistics included) and autograd, ``clip_grad_norm_``
    and ``torch.optim.Adam(fused=True)`` at weight decay 0; with ``bf16``
    the forward under ``torch.autocast`` in bf16 (bf16 ``baddbmm``, fp32
    master weights). Returns a closure that runs it."""
    M = model.num_models
    lin = [l for l in model.net.layers if hasattr(l, 'in_features')]
    bns = [l for l in model.net.layers if hasattr(l, 'running_var')]
    ws = [l.weight.detach().transpose(1, 2).contiguous().requires_grad_()
          for l in lin]
    bs = [l.bias.detach()[:, None].clone().requires_grad_() for l in lin]
    gs = [b.weight.detach().reshape(-1).clone().requires_grad_() for b in bns]
    betas = [b.bias.detach().reshape(-1).clone().requires_grad_() for b in bns]
    rms = [b.running_mean.reshape(-1).clone() for b in bns]
    rvs = [b.running_var.reshape(-1).clone() for b in bns]
    params = ws + bs + gs + betas
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0, fused=True)

    def run():
        for i in range(xs.shape[0]):
            B = xs.shape[1]
            with torch.autocast('cuda', dtype=torch.bfloat16, enabled=bf16):
                h = xs[i, :, :IN_DIM].expand(M, B, IN_DIM)
                for l in range(len(lin)):
                    h = torch.baddbmm(bs[l], h, ws[l])
                    if l < len(bns):
                        C = h.shape[-1]
                        h = F.batch_norm(
                            h.transpose(0, 1).reshape(B, M * C), rms[l],
                            rvs[l], gs[l], betas[l], training=True,
                            momentum=0.1, eps=1e-5)
                        h = torch.relu(h.reshape(B, M, C).transpose(0, 1))
                loss = F.l1_loss(h.float().mean(0), ys[i, :, :1])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(params, 5.0)
            opt.step()
    return run


def fit(name, model, x, y, epochs, seed, **config):
    """``Trainer.fit`` of ``model`` on the first TRAIN_SPLIT rows,
    validated on the rest (TRAIN_CONFIG updated by ``config``), with every
    launch count set to 0 just before and read just after. Returns
    (trainer, checkpoint callback, launches, seconds)."""
    train_dl = DataLoader(ArrayDataset(x[:TRAIN_SPLIT], y[:TRAIN_SPLIT]),
                          TRAIN_BATCH, shuffle=True, drop_last=True)
    val_dl = DataLoader(ArrayDataset(x[TRAIN_SPLIT:], y[TRAIN_SPLIT:]),
                        TRAIN_BATCH)
    saver = ModelSavingCallback(defer_serialization=True)
    trainer = Trainer(name, dict(TRAIN_CONFIG, max_epochs=epochs, seed=seed,
                                 **config),
                      callbacks=[EarlyStopping(), saver]
                      + model.get_callbacks(),
                      log_dir=TRAIN_DIR, version=f'seed_{seed}', device=DEVICE)
    reset_launches()
    start = time.perf_counter()
    trainer.fit(model, train_dl, val_dl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return trainer, saver, read_launches(), seconds


def in_bf16(model, prepare):
    """``prepare(model.net)`` under bf16-mixed; the model is left in fp32."""
    model.set_precision('bf16-mixed')
    weights = prepare(model.net)
    model.set_precision('32-true')
    return weights


def in_fp32(model, prepare):
    """``prepare(model.net)`` in fp32; the model is left in its precision."""
    precision = model.precision
    model.set_precision('32-true')
    weights = prepare(model.net)
    model.set_precision(precision)
    return weights


def bf16_judge(name, reference16, reference32):
    """A ``serve`` judge for a model in bf16: each answer against
    ``reference16(x, call)`` (the plain bf16 function on the card), within
    the bf16 bars of its gap to ``reference32(x, call)`` (the same model's
    fp32 function); an output whose fp32 reference is None does not depend
    on the precision (KDE's and kNN-KDE's density scores) and is held to
    TOL_SCORE."""
    def judge(x, call, mean, ue):
        out = {}
        for part, got, want, ref32 in zip(('mean', 'ue'), (mean, ue),
                                          reference16(x, call),
                                          reference32(x, call)):
            got = torch.from_numpy(got)
            label = f'{name} {x.shape[0]}-row {part}'
            if ref32 is None:
                out[part] = {'max_abs_err': compare(label, got, want.cpu(),
                                                    TOL_SCORE)}
            else:
                out[part] = bf16_close(label, got, want.cpu(), ref32.cpu())
        return out
    return judge


def check_launches(name, launches, **expected):
    want = {k: expected.get(k, 0) for k in WRAPPERS}
    check(launches == want, f'{name}: launches {launches}, expected {want}')


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return 2
    wall = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # true fp32 references
    torch.backends.cudnn.allow_tf32 = False
    # bf16 yardsticks accumulate in fp32, as the kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.default_rng(args.seed)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi('name,power.limit')
    peak_flops, peak_bytes, peak_source = peaks(kind)
    peak_bf16 = bf16_peak(kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_clock = nvidia_smi('clocks.max.sm')
    clock_mhz = re.match(r'\s*(\d+)', max_sm_clock)
    check(clock_mhz is not None, f'nvidia-smi gave no SM clock: {max_sm_clock}')
    clock_hz = int(clock_mhz.group(1)) * 1e6
    ex2_rate = EX2_PER_SM_PER_CLOCK * sms * clock_hz
    emit('device', kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         fp32_peak_flops=peak_flops, bf16_peak_flops=peak_bf16,
         peak_bytes_per_s=peak_bytes,
         peak_source=peak_source,
         sms=sms, max_sm_clock=max_sm_clock, ex2_per_s=ex2_rate)

    # 2. build
    info = _build.build_info()
    ptxas = ptxas_report(info.log)
    emit('build', seconds=info.seconds, library=str(info.path.name),
         ptxas=ptxas)
    check(all(cluster_kernels(ptxas, src) for src in ('fused_train',
                                                      'fused_train_bf16')),
          'ptxas reported no cluster kernel of the training sources')
    eval_chain = eval_chain_sass(info.path, ptxas)
    emit('build_eval_chain', **eval_chain)
    emit('build_kde', ptxas={k: v for k, v in ptxas.items() if 'kde' in k})

    # 3. kernel vs plain on the card, each kernel at the main path's shapes
    model = build_model(args.seed)
    fw = prepare_fused_weights(model.net)
    check(fw is not None, 'flagship ensemble did not fold')
    shifted = build_model(args.seed)
    with torch.no_grad():
        shifted.net.layers[-1].bias += 1e3          # |mean| >> std
    fw_shifted = prepare_fused_weights(shifted.net)
    fw_wide = prepare_fused_weights(build_model(args.seed, WIDE_INPUT).net)
    check(fw_wide is not None, f'{WIDE_IN}-input ensemble did not fold')
    errors = {}

    def kernel_vs_plain(kernel, case, rows, in_dim, run, plain, square=False):
        """Hold one kernel call against its plain version on the same x;
        ``square`` compares std^2 (the 'var' estimator)."""
        x = torch.as_tensor(rng.normal(size=(rows, in_dim)),
                            dtype=torch.float32, device=DEVICE)
        mean, std = run(x)
        ref_mean, ref_std = plain(x)
        torch.cuda.synchronize()
        if square:
            std, ref_std = std * std, ref_std * ref_std
        errs = {'mean': compare(f'{kernel} {case} mean', mean, ref_mean,
                                TOL_MEAN),
                'std': compare(f'{kernel} {case} std', std, ref_std, TOL_STD)}
        if case == 'flagship':
            errors[kernel] = max(errs.values())
        emit('kernel_vs_plain', kernel=kernel, case=case, rows=rows,
             max_abs_err=errs, tol_mean=TOL_MEAN, tol_std=TOL_STD)

    for case, weights, rows in (('flagship', fw, ROWS), ('ragged', fw, 1000),
                                ('mean_1e3', fw_shifted, 4096),
                                (f'input_{WIDE_IN}', fw_wide, 1000)):
        kernel_vs_plain('fused_ensemble', case, rows, weights.in_dim,
                        lambda x, w=weights: fused_forward_prefolded(w, x),
                        lambda x, w=weights: fused_forward_plain(w, x))

    mc_model = build_mc(args.seed)
    mw = mc_model.mc_weights()
    check(mw is not None, 'flagship MC-dropout network did not fold')
    mc_shifted = build_mc(args.seed)
    with torch.no_grad():
        mc_shifted.net.layers[-1].bias += 1e3
    mc_cases = (('flagship', mw, ROWS), ('ragged', mw, 1000),
                ('mean_1e3', mc_shifted.mc_weights(), 4096),
                ('p0', build_mc(args.seed, p=0.0).mc_weights(), 4096),
                (f'input_{WIDE_IN}',
                 build_mc(args.seed, WIDE_INPUT_MC).mc_weights(), 1000))
    for i, (case, weights, rows) in enumerate(mc_cases):
        check(weights is not None, f'MC case {case} did not fold')
        seed = 1000 + i
        kernel_vs_plain(
            'fused_mc_dropout', case, rows, weights.in_dim,
            lambda x, w=weights, s=seed: fused_mc_forward(w, x, MC_SAMPLES, s),
            lambda x, w=weights, s=seed: fused_mc_forward_plain(w, x,
                                                                MC_SAMPLES, s))

    dq_model = build_anchored(DeltaUQMLPModelBuilder, args.seed)
    aw = dq_model.anchored_weights()
    check(aw is not None, 'flagship Δ-UQ network did not fold')
    dq_shifted = build_anchored(DeltaUQMLPModelBuilder, args.seed)
    with torch.no_grad():
        dq_shifted.net.layers[-1].bias += 1e3
    aw_shifted = dq_shifted.anchored_weights()
    anchors = dq_model.anchors
    for case, weights, rows in (('flagship', aw, ANCHORED_ROWS),
                                ('ragged', aw, 1000),
                                ('mean_1e3', aw_shifted, 4096),
                                ('estimator_var', aw, 4096)):
        kernel_vs_plain(
            'fused_anchored', case, rows, IN_DIM,
            lambda x, w=weights: fused_anchored_stats(w, x, anchors),
            lambda x, w=weights: fused_anchored_plain(w, x,
                                                      anchor_rows(w, anchors)),
            square=case == 'estimator_var')

    def kde_case(case, rows, refs, d, offset=0.0, far=False, gen=rng):
        """Hold the KDE kernel against its plain version on one corpus and
        query set from ``rng``; ``far`` moves the queries 50 bandwidths
        past the corpus, where the log density must stay finite and the
        score -exp(log p) be exactly 0."""
        data = gen.normal(size=(refs, d)) + offset
        h = bandwidth_value('silverman', refs, d)
        x = gen.normal(size=(rows, d)) + offset
        if far:
            x[:, 0] += 2 * np.abs(data).max() + 50 * h
        x, data = (torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                   for a in (x, data))
        got = kde_logpdf(x, data, h)
        want = kde_logpdf_plain(*centre(x, data), h)
        torch.cuda.synchronize()
        err = compare(f'kde {case} log density', got, want, TOL_LOGPDF)
        fields = {}
        if far:
            score = float(torch.exp(got).max())
            check(score == 0.0, f'kde far_ood: score {score}, expected 0')
            fields = {'max_score': score, 'max_log_density': float(got.max())}
        if case == 'bench':
            errors['kde'] = err
        emit('kernel_vs_plain', kernel='kde', case=case, rows=rows,
             references=refs, features=d, max_abs_err=err, tol=TOL_LOGPDF,
             **fields)

    kde_case('bench', ROWS, KDE_FIT_ROWS, IN_DIM)
    kde_case('minibude', *MINIBUDE_KDE)
    kde_case('offset_1e3', *OFFSET_KDE, offset=1e3)
    kde_case('far_ood', *OFFSET_KDE, far=True)
    kde_case(f'd{WIDE_KDE[2]}', *WIDE_KDE)
    # every width of the tensor-core path (one or two k steps of 8), with
    # query and reference counts that are multiples of no tile, and one
    # query; these cases (and kernel 1b's besides the first three) draw from
    # their own generator, so every other phase keeps its inputs
    extra = np.random.default_rng(args.seed + EXTRA_SEED)
    for d in range(1, 9):
        kde_case(f'd{d}_ragged', *KDE_RAGGED, d, gen=extra)
    kde_case('one_query', 1, KDE_RAGGED[1], IN_DIM, gen=extra)

    # 3b. the bf16 forms against their plain versions at the same shapes,
    # each within the bf16 bars of the bf16-vs-fp32 gap on the same rows
    def bf16_vs_plain(kernel, case, rows, in_dim, run, plain, plain32,
                      gen=rng):
        x = torch.as_tensor(gen.normal(size=(rows, in_dim)),
                            dtype=torch.float32, device=DEVICE)
        got, want, ref32 = run(x), plain(x), plain32(x)
        torch.cuda.synchronize()
        errs = {part: bf16_close(f'{kernel} {case} {part}', g, w, r)
                for part, g, w, r in zip(('mean', 'std'), got, want, ref32)}
        if case == 'flagship':
            errors[kernel] = max(e['max_abs_err'] for e in errs.values())
        emit('kernel_vs_plain', kernel=kernel, case=case, rows=rows,
             bf16_vs_plain=errs)

    fw16 = in_bf16(model, prepare_fused_weights)
    check(fw16.w_all.dtype == torch.bfloat16, 'bf16 fold is not bf16')
    fw16_wide = in_bf16(build_model(args.seed, WIDE_INPUT),
                        prepare_fused_weights)
    # kernel 1b: the flagship is one resident cluster of 8 member blocks
    # with the most warpgroups; more members, or a chain too deep, take the
    # ring; requests of 1 and 300 rows; 1 to 32 members (the BO range)
    flag = ec.eval_layout('ensemble', fw16.in_dim, fw16.num_layers,
                          fw16.out_dim, ROWS, sms, members=MEMBERS)
    check(flag.resident and flag.cluster == MEMBERS
          and flag.warpgroups == ec.MAX_WARPGROUPS['ensemble'],
          f'1b flagship layout: {flag}')
    ens_deep = build_model(args.seed, DEEP_RING)
    ens_cases = [('flagship', fw16, fw, ROWS), ('ragged', fw16, fw, 1000),
                 (f'input_{WIDE_IN}', fw16_wide, fw_wide, 1000),
                 ('mean_1e3', in_bf16(shifted, prepare_fused_weights),
                  fw_shifted, 4096),
                 ('deep_12_linears_ring',
                  in_bf16(ens_deep, prepare_fused_weights),
                  prepare_fused_weights(ens_deep.net), 4096),
                 ('request_1', fw16, fw, 1), ('request_300', fw16, fw, 300)]
    for members in ENSEMBLE_MEMBERS:
        m = build_model(args.seed, members=members)
        ens_cases.append((f'members_{members}',
                          in_bf16(m, prepare_fused_weights),
                          prepare_fused_weights(m.net), 4096))
    for k, (case, w16, w32, rows) in enumerate(ens_cases):
        lay = ec.eval_layout('ensemble', w16.in_dim, w16.num_layers,
                             w16.out_dim, rows, sms, members=w16.num_members)
        emit('layout', kernel='fused_ensemble_bf16', case=case,
             members=w16.num_members, layers=w16.num_layers,
             resident=lay.resident, cluster=lay.cluster,
             warpgroups=lay.warpgroups, members_a_block=lay.members,
             slots=lay.slots, smem_bytes=lay.smem_bytes)
        bf16_vs_plain('fused_ensemble_bf16', case, rows, w16.in_dim,
                      lambda x, w=w16: fused_forward_prefolded(w, x),
                      lambda x, w=w16: fused_forward_plain(w, x),
                      lambda x, w=w32: fused_forward_plain(w, x),
                      gen=rng if k < 3 else extra)
    x_bits = torch.as_tensor(extra.normal(size=(ROWS, IN_DIM)),
                             dtype=torch.float32, device=DEVICE)
    first = [t.clone() for t in fused_forward_prefolded(fw16, x_bits)]
    again = fused_forward_prefolded(fw16, x_bits)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          '1b: two runs on the same rows gave different bits')
    emit('kernel_vs_plain', kernel='fused_ensemble_bf16',
         case='same_bits_twice', rows=ROWS, equal=True)
    mw16 = in_bf16(mc_model, prepare_mc_weights)
    mc_p0 = build_mc(args.seed, p=0.0)
    for i, (case, w16, w32, rows) in enumerate((
            ('flagship', mw16, mw, ROWS), ('ragged', mw16, mw, 1000),
            ('p0', in_bf16(mc_p0, prepare_mc_weights), mc_p0.mc_weights(),
             4096))):
        seed = 2000 + i
        bf16_vs_plain(
            'fused_mc_dropout_bf16', case, rows, IN_DIM,
            lambda x, w=w16, s=seed: fused_mc_forward(w, x, MC_SAMPLES, s),
            lambda x, w=w16, s=seed: fused_mc_forward_plain(w, x, MC_SAMPLES,
                                                            s),
            lambda x, w=w32, s=seed: fused_mc_forward_plain(w, x, MC_SAMPLES,
                                                            s))
    aw16 = in_bf16(dq_model, prepare_fused_anchored)
    for case, rows in (('flagship', ANCHORED_ROWS), ('ragged', 1000)):
        bf16_vs_plain(
            'fused_anchored_bf16', case, rows, IN_DIM,
            lambda x: fused_anchored_stats(aw16, x, anchors),
            lambda x: fused_anchored_plain(aw16, x,
                                           anchor_rows(aw16, anchors)),
            lambda x: fused_anchored_plain(aw, x, anchor_rows(aw, anchors)))
    # a chain too deep to stay in shared memory: both kernels' ring form
    mc_deep = build_mc(args.seed, DEEP_RING)
    dq_deep = build_anchored(DeltaUQMLPModelBuilder, args.seed,
                             layers=DEEP_RING)
    mw_deep16 = in_bf16(mc_deep, prepare_mc_weights)
    aw_deep16 = in_bf16(dq_deep, prepare_fused_anchored)
    aw_deep, mw_deep = dq_deep.anchored_weights(), mc_deep.mc_weights()
    for form, w in (('mc', mw_deep16), ('anchored', aw_deep16)):
        check(not ec.eval_layout(form, w.in_dim, w.num_layers, w.out_dim,
                                 4096, sms).resident,
              f'{form}: the {w.num_layers}-Linear chain is not a ring')
    bf16_vs_plain(
        'fused_mc_dropout_bf16', 'deep_12_linears_ring', 4096, IN_DIM,
        lambda x: fused_mc_forward(mw_deep16, x, MC_SAMPLES, 2100),
        lambda x: fused_mc_forward_plain(mw_deep16, x, MC_SAMPLES, 2100),
        lambda x: fused_mc_forward_plain(mw_deep, x, MC_SAMPLES, 2100))
    bf16_vs_plain(
        'fused_anchored_bf16', 'deep_12_linears_ring', 4096, IN_DIM,
        lambda x: fused_anchored_stats(aw_deep16, x, dq_deep.anchors),
        lambda x: fused_anchored_plain(aw_deep16, x,
                                       anchor_rows(aw_deep16, dq_deep.anchors)),
        lambda x: fused_anchored_plain(aw_deep, x,
                                       anchor_rows(aw_deep, dq_deep.anchors)))

    def train_case(case, model, loss, per_member=False, wd=0.0):
        """Hold the training kernel against its plain version for
        TRAIN_CHECK_STEPS steps from TRAIN_STEP0, on the same buffers, with
        the pre-ReLU values kept away from 0 (``separate_relu``)."""
        model = separate_relu(model, torch.Generator().manual_seed(
            int(rng.integers(1 << 31))))
        plan = train_plan(model, loss, per_member, wd)
        bufs, xs, ys = train_inputs(model, plan, rng, TRAIN_CHECK_STEPS)
        drops = ft.drop_rates(model.net).to(DEVICE)
        seed = int(rng.integers(1 << 31))
        got = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3,
                             TRAIN_STEP0, seed, drops)
        want = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs,
                                        ys, 1e-3, TRAIN_STEP0, seed, drops)
        torch.cuda.synchronize()
        errs = {name: compare(f'fused_train {case} {name}', g, w,
                              {'rtol': 0.0, 'atol': TOL_TRAIN[name]})
                for name, g, w in zip(TOL_TRAIN, got, want)}
        errors['fused_train'] = max(errors.get('fused_train', 0.0),
                                    *errs.values())
        emit('kernel_vs_plain', kernel='fused_train', case=case,
             members=plan.num_members, batch=plan.batch, loss=plan.loss,
             per_member=plan.per_member, weight_decay=plan.weight_decay,
             dropout_slots=plan.n_drop, steps=TRAIN_CHECK_STEPS,
             step0=TRAIN_STEP0, losses=want[4].tolist(), max_abs_err=errs,
             tol=TOL_TRAIN)

    train_case('joint_l1_clip5', build_model(args.seed), 'l1_loss')
    # the flagship as the main path builds it (BatchNorm scale 1, shift 0),
    # held step by step, each step from the plain version's state
    as_built = EnsembleModelBuilder(FLAGSHIP, {'num_models': MEMBERS},
                                    seed=args.seed, device=DEVICE).build()
    plan = train_plan(as_built)
    bufs, xs, ys = train_inputs(as_built, plan, rng, STEPWISE_STEPS)
    stepwise = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, TRAIN_STEP0,
                                 int(rng.integers(1 << 31)),
                                 ft.drop_rates(as_built.net).to(DEVICE))
    errors['fused_train'] = max(errors['fused_train'], *stepwise[
        'max_abs_err_outside_reach'].values())
    emit('kernel_vs_plain', kernel='fused_train',
         case='joint_l1_clip5_as_built_stepwise', members=plan.num_members,
         batch=plan.batch, loss=plan.loss, step0=TRAIN_STEP0, tol=TOL_TRAIN,
         **stepwise)
    train_case('per_member_mse_wd0.01', build_model(args.seed), 'mse_loss',
               per_member=True, wd=0.01)
    train_case('mve_gaussian_nll',
               build_density(MVEModelBuilder,
                             {'min_variance': MVE_MIN_VARIANCE}, args.seed),
               'gaussian_nll')
    mc_train = build_mc(args.seed)
    check(train_plan(mc_train).n_drop == 5, 'MC dropout: expected 5 slots')
    train_case(f'mc_dropout_p{MC_P}', mc_train, 'l1_loss')

    # 3c. kernel 3's bf16 form against its plain version at the flagship
    # shape, on the four cases, step by step from the plain version's state
    # (attrib.stepwise_vs_plain_bf16: the bf16 bars against each step's
    # plain bf16-vs-fp32 gap, ReLU decisions recorded by both)
    def train_case_bf16(case, model, loss, per_member=False, wd=0.0):
        plan = train_plan(model, loss, per_member, wd, bf16=True)
        bufs, xs, ys = train_inputs(model, plan, rng, STEPWISE_BF16_STEPS)
        out = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, TRAIN_STEP0,
                                int(rng.integers(1 << 31)),
                                ft.drop_rates(model.net).to(DEVICE))
        errors['fused_train_bf16'] = max(errors.get('fused_train_bf16', 0.0),
                                         *out['max_abs_err'].values())
        emit('kernel_vs_plain', kernel='fused_train_bf16', case=case,
             members=plan.num_members, batch=plan.batch, loss=plan.loss,
             per_member=plan.per_member, weight_decay=plan.weight_decay,
             dropout_slots=plan.n_drop, step0=TRAIN_STEP0, **out)

    train_case_bf16('joint_l1_clip5_as_built', as_built, 'l1_loss')
    train_case_bf16('per_member_mse_wd0.01', build_model(args.seed),
                    'mse_loss', per_member=True, wd=0.01)
    train_case_bf16('mve_gaussian_nll', build_density(
        MVEModelBuilder, {'min_variance': MVE_MIN_VARIANCE}, args.seed),
        'gaussian_nll')
    train_case_bf16(f'mc_dropout_p{MC_P}', build_mc(args.seed), 'l1_loss')
    # a whole epoch of the joint case at the trial's learning rate: a
    # loss-curve check only
    plan16 = train_plan(as_built, bf16=True)
    bufs, xs, ys = train_inputs(as_built, plan16, rng, BF16_CURVE_STEPS)
    seed = int(rng.integers(1 << 31))
    lr = TRAIN_MODEL_CONFIG['learning_rate']     # the flagship trial's
    curves = [run(plan, *[b.clone() for b in bufs], xs, ys, lr, TRAIN_STEP0,
                  seed)[4]
              for run, plan in ((ft.fused_epoch, plan16),
                                (ft.fused_epoch_reference, plan16),
                                (ft.fused_epoch_reference,
                                 train_plan(as_built)))]
    shares = bf16_close('fused_train_bf16 loss curve', *curves, gate=False)
    apart = (curves[0] - curves[1]).abs()
    gap = (curves[1] - curves[2]).abs()
    check(float(apart.max()) <= float(gap.max()),
          f'fused_train_bf16 loss curve: {float(apart.max()):.3e} from the '
          f'plain bf16 curve, past its gap to fp32 ({float(gap.max()):.3e})')
    emit('kernel_vs_plain', kernel='fused_train_bf16',
         case='joint_l1_clip5_as_built_loss_curve', steps=BF16_CURVE_STEPS,
         curve=shares, max_abs_diff=float(apart.max()),
         gap_max=float(gap.max()), abs_diff_at_step={k: float(apart[k - 1])
                                                     for k in (1, 16, 32, 64)})

    # 3d. both forms at the plan the Δ-UQ and PAGER fits give kernel 3
    # (5c): a single net as built, on the doubled batch of 2 x 128 rows of
    # 10 anchored features (in_pad 16) gathered as the trainer gathers
    # them, step by step from the plain version's state: fp32 to TOL_TRAIN
    # outside the reach of a flipped ReLU decision, bf16 to the bf16 bars
    dq_train = DeltaUQMLPModelBuilder(
        FLAGSHIP, {'num_anchors': ANCHORS, 'anchored_batch_size': ANCHORS},
        seed=args.seed, device=DEVICE).build()
    arng = np.random.default_rng(args.seed + 31)
    for bf16 in (False, True):
        plan = train_plan(dq_train, bf16=bf16, batch=2 * TRAIN_BATCH)
        check(plan.in_pad == 16, f'anchored plan: in_pad {plan.in_pad}')
        bufs, xs, ys = train_inputs(dq_train, plan, arng, STEPWISE_BF16_STEPS,
                                    anchored=True)
        out = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, TRAIN_STEP0,
                                int(arng.integers(1 << 31)),
                                ft.drop_rates(dq_train.net).to(DEVICE))
        kernel = 'fused_train_bf16' if bf16 else 'fused_train'
        errors[kernel] = max(errors[kernel], *out[
            'max_abs_err' if bf16 else 'max_abs_err_outside_reach'].values())
        emit('kernel_vs_plain', kernel=kernel,
             case='delta_uq_anchored_as_built_stepwise', members=1,
             batch=plan.batch, in_pad=plan.in_pad, loss=plan.loss,
             step0=TRAIN_STEP0, **out)

    # 4. the serving paths: builder -> Predictor -> model -> kernel, each
    # driven with every launch count at 0 just before and read just after
    predictor, ens_launches = serve(
        'ensemble', model, REQUESTS, rng,
        lambda x, _: reference_ue(model, x), 'fused_ensemble')
    mc_predictor, mc_launches = serve(
        'mc_dropout', mc_model, MODEL_REQUESTS, rng,
        lambda x, call: fused_mc_forward_plain(
            mw, x, MC_SAMPLES, mc_model.call_seed(call)), 'fused_mc_dropout')
    dq_predictor, dq_launches = serve(
        'delta_uq', dq_model, MODEL_REQUESTS, rng,
        lambda x, _: reference_anchored(dq_model, x), 'fused_anchored')
    pager = build_anchored(PAGERModelBuilder, args.seed + 7)
    _, pager_launches = serve(
        'pager', pager, MODEL_REQUESTS, rng,
        lambda x, _: reference_anchored(pager, x), 'fused_anchored')
    var_model = build_anchored(DeltaUQMLPModelBuilder, args.seed,
                               estimator='var')
    x = torch.as_tensor(rng.normal(size=(300, IN_DIM)), dtype=torch.float32,
                        device=DEVICE)
    got, want = var_model(x, return_ue=True), reference_anchored(var_model, x)
    emit('serving', model='delta_uq_var', rows=300, max_abs_err_vs_unfused={
        'mean': compare('var mean', got[0], want[0], TOL_MEAN),
        'ue': compare('var ue', got[1], want[1], TOL_STD)})
    corpus = rng.normal(size=(KDE_FIT_ROWS, IN_DIM)).astype(np.float32)
    kde_model = build_density(KDEModelBuilder, {'rtol': KDE_RTOL}, args.seed,
                              corpus)
    check(kde_model.kde.data.device == kde_model.device,
          'the KDE corpus is not on the model\'s device')
    kde_predictor, kde_launches = serve(
        'kde', kde_model, MODEL_REQUESTS, rng,
        lambda x, _: reference_density(kde_model, x), 'kde', TOL_SCORE)
    knn_model = build_density(KNNKDEModelBuilder, {'k': KNN_K}, args.seed,
                              corpus)
    knn_predictor, _ = serve(
        'knn_kde', knn_model, MODEL_REQUESTS, rng,
        lambda x, _: reference_density(knn_model, x), None, TOL_SCORE)
    mve_model = build_density(MVEModelBuilder,
                              {'min_variance': MVE_MIN_VARIANCE}, args.seed)
    mve_predictor, _ = serve(
        'mve', mve_model, MODEL_REQUESTS, rng,
        lambda x, _: reference_density(mve_model, x), None, TOL_MEAN)

    # 4b. serving in bf16-mixed: the seven models built as above (same
    # seeds, same BatchNorm statistics, anchors and corpus), switched with
    # set_precision('bf16-mixed') as the JAX package's eval_precision
    # switches an fp32-trained model for its evaluation, served with every launch count at 0 just
    # before and read just after; each answer against the plain bf16
    # function on the card, within the bf16 bars of its gap to the same
    # model's fp32 function; each kernel's bf16 form must launch as often
    # as its fp32 form did above, and no fp32 form at all
    def to_bf16(m):
        return m.set_precision('bf16-mixed')

    ens16 = to_bf16(build_model(args.seed))
    mc16 = to_bf16(build_mc(args.seed))
    dq16 = to_bf16(build_anchored(DeltaUQMLPModelBuilder, args.seed))
    pager16 = to_bf16(build_anchored(PAGERModelBuilder, args.seed + 7))
    kde16 = to_bf16(build_density(KDEModelBuilder, {'rtol': KDE_RTOL},
                                  args.seed, corpus))
    knn16 = to_bf16(build_density(KNNKDEModelBuilder, {'k': KNN_K},
                                  args.seed, corpus))
    mve16 = to_bf16(build_density(MVEModelBuilder,
                                  {'min_variance': MVE_MIN_VARIANCE},
                                  args.seed))

    def anchored16(m, m32):
        """Δ-UQ/PAGER in bf16: the kernel's plain bf16 function, and
        PAGER's score through the bf16 modules; the fp32 twin's unfused
        answer for the gap."""
        def ref16(x, _):
            w = m.anchored_weights()
            mean, spread = fused_anchored_plain(w, x,
                                                anchor_rows(w, m.anchors))
            if hasattr(m, 'anchors_Y'):
                with torch.no_grad():
                    p = m.prediction_matrix(x, m.anchors[:m.num_anchors])
                y = m.anchors_Y[:m.num_anchors].reshape(1, -1)
                spread = torch.maximum(spread,
                                       (p - y).abs().amax(dim=1, keepdim=True))
            return mean, spread
        return ref16, lambda x, _: reference_anchored(m32, x)

    def density16(m, m32):
        """KDE/kNN-KDE/MVE in bf16: the MLP through the bf16 modules; the
        density scores, which no precision touches, against the fp32
        twin's (TOL_SCORE)."""
        def ref32(x, _):
            pred, ue = reference_density(m32, x)
            return pred, None if m.uq_method in ('kde', 'knn_kde') else ue
        return (lambda x, _: reference_density(m, x)), ref32

    fp32_launches = {'ensemble': ens_launches, 'mc_dropout': mc_launches,
                     'delta_uq': dq_launches, 'pager': pager_launches,
                     'kde': kde_launches}
    bf16_launches, bf16_predictors = {}, {}
    for name, m, requests, kernel, (ref16, ref32) in (
            ('ensemble', ens16, REQUESTS, 'fused_ensemble_bf16', (
                lambda x, _: fused_forward_plain(ens16.fused_weights(), x),
                lambda x, _: fused_forward_plain(fw, x))),
            ('mc_dropout', mc16, MODEL_REQUESTS, 'fused_mc_dropout_bf16', (
                lambda x, call: fused_mc_forward_plain(
                    mc16.mc_weights(), x, MC_SAMPLES, mc16.call_seed(call)),
                lambda x, call: fused_mc_forward_plain(
                    mw, x, MC_SAMPLES, mc16.call_seed(call)))),
            ('delta_uq', dq16, MODEL_REQUESTS, 'fused_anchored_bf16',
             anchored16(dq16, dq_model)),
            ('pager', pager16, MODEL_REQUESTS, 'fused_anchored_bf16',
             anchored16(pager16, pager)),
            ('kde', kde16, MODEL_REQUESTS, 'kde', density16(kde16, kde_model)),
            ('knn_kde', knn16, MODEL_REQUESTS, None,
             density16(knn16, knn_model)),
            ('mve', mve16, MODEL_REQUESTS, None,
             density16(mve16, mve_model))):
        bf16_predictors[name], bf16_launches[name] = serve(
            name, m, requests, rng, None, kernel,
            judge=bf16_judge(name, ref16, ref32), phase='serving_bf16')
        if name in fp32_launches:
            check(bf16_launches[name] == fp32_launches[name],
                  f'{name}: {bf16_launches[name]} bf16 launches, '
                  f'{fp32_launches[name]} fp32 ones in the fp32 phase')

    # 5. training: Trainer.fit -> the training kernel every epoch, the
    # serving kernels for validation; then the bundle reloads and serves
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    x_all = np.random.default_rng(args.seed + 11).normal(
        size=(TRAIN_ROWS, IN_DIM)).astype(np.float32)
    y_all = smooth_target(x_all)
    val_rows = TRAIN_CONFIG['limit_val_batches'] * TRAIN_BATCH
    flagship = EnsembleModelBuilder(FLAGSHIP, {'num_models': MEMBERS},
                                    train_config=TRAIN_MODEL_CONFIG,
                                    seed=args.seed, device=DEVICE).build()
    trainer, saver, train_launches, fit_s = fit(
        'flagship_ensemble', flagship, x_all, y_all,
        TRAIN_CONFIG['max_epochs'], args.seed)
    epochs = TRAIN_CONFIG['max_epochs']
    check(trainer.fused_epochs_used == epochs,
          f'fused_epochs_used {trainer.fused_epochs_used}, expected {epochs}')
    check_launches('flagship fit', train_launches, fused_train=epochs,
                   fused_ensemble=epochs * TRAIN_CONFIG['limit_val_batches'])
    with open(os.path.join(trainer.logger.log_dir, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    per_epoch = [[float(r['train_loss']) for r in rows
                  if r['train_loss'] and int(r['epoch']) == e]
                 for e in range(epochs)]
    check(all(np.isfinite(v).all() and v for v in per_epoch),
          'non-finite or missing training losses in metrics.csv')
    epoch_means = [float(np.mean(v)) for v in per_epoch]
    check(epoch_means[-1] < epoch_means[0],
          f'training loss did not fall: epoch means {epoch_means}')
    val_losses = [float(r['val_loss']) for r in rows if r['val_loss']]
    best = load_model(os.path.join(trainer.logger.log_dir, 'model.pth'),
                      device='cuda')
    x_req = rng.normal(size=(4096, IN_DIM)).astype(np.float32)
    reset_launches()
    mean, std = Predictor(best, device=DEVICE).predict(x_req)
    check_launches('reloaded bundle serving', read_launches(),
                   fused_ensemble=len(DEFAULT_BUCKETS) + 1)
    ref_mean, ref_std = reference_ue(best, torch.from_numpy(x_req).to(DEVICE))
    serve_err = {'mean': compare('reloaded mean', torch.from_numpy(mean),
                                 ref_mean.cpu(), TOL_MEAN),
                 'ue': compare('reloaded ue', torch.from_numpy(std),
                               ref_std.cpu(), TOL_STD)}
    val_again = trainer.validate(best, DataLoader(ArrayDataset(
        x_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows],
        y_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows]), TRAIN_BATCH))
    check(abs(val_again - saver.best) <= 1e-5,
          f'reloaded val_loss {val_again} != logged best {saver.best}')
    train_rows = epochs * TRAIN_CONFIG['limit_train_batches'] * TRAIN_BATCH
    emit('training', model='ensemble', members=MEMBERS, epochs=epochs,
         steps_per_epoch=TRAIN_CONFIG['limit_train_batches'],
         batch=TRAIN_BATCH, rows=TRAIN_ROWS, split=TRAIN_SPLIT,
         fused_epochs_used=trainer.fused_epochs_used, launches=train_launches,
         train_loss_epoch_means=epoch_means, val_losses=val_losses,
         best_val_loss=saver.best, reloaded_val_loss=val_again,
         reloaded_serving_max_abs_err=serve_err, fit_s=fit_s,
         trainer_fit_time_s=trainer.fit_time, seconds_per_epoch=fit_s / epochs,
         trainer_e2e_rows_per_s=train_rows / fit_s)

    # the kernel's fit against the per-step path's (autograd through the
    # modules, no kernel 3) from the same init on the same batches
    cross = {}
    for path, fused in (('kernel', True), ('per_step', False)):
        one = EnsembleModelBuilder(FLAGSHIP, {'num_models': MEMBERS},
                                   train_config=TRAIN_MODEL_CONFIG,
                                   seed=args.seed, device=DEVICE).build()
        tr, _, launches, _ = fit(f'flagship_{path}', one, x_all, y_all, 1,
                                 args.seed, fused_epochs=fused,
                                 limit_train_batches=CROSS_STEPS,
                                 log_every_n_steps=1)
        check(tr.fused_epochs_used == int(fused),
              f'{path}: fused_epochs_used {tr.fused_epochs_used}')
        check_launches(f'{path} fit', launches, fused_train=int(fused),
                       fused_ensemble=TRAIN_CONFIG['limit_val_batches'])
        with open(os.path.join(tr.logger.log_dir, 'metrics.csv')) as f:
            logged = list(csv.DictReader(f))
        cross[path] = (torch.tensor([float(r['train_loss']) for r in logged
                                     if r['train_loss']], dtype=torch.float64),
                       tr.callback_metrics['val_loss'])
    check(len(cross['kernel'][0]) == len(cross['per_step'][0]) == CROSS_STEPS,
          f'expected {CROSS_STEPS} logged losses a fit')
    kernel_losses, step_losses = cross['kernel'][0], cross['per_step'][0]
    apart = (kernel_losses - step_losses).abs()
    emit('training', model='ensemble', check='kernel_vs_per_step_path',
         steps=CROSS_STEPS, checked_steps=CROSS_CHECKED, tol=TOL_CROSS,
         max_abs_err_checked=compare(
             'per-step vs kernel train_loss', kernel_losses[:CROSS_CHECKED],
             step_losses[:CROSS_CHECKED], TOL_CROSS),
         abs_diff_at_step={n: float(apart[n - 1]) for n in (
             1, 10, CROSS_CHECKED, CROSS_STEPS // 2, CROSS_STEPS)},
         max_abs_diff_after_checked=float(apart[CROSS_CHECKED:].max()),
         val_loss={k: v[1] for k, v in cross.items()})

    # one epoch each of MVE and MC dropout through the same kernel
    for name, builder, descr, kernel in (
            ('mve', MVEModelBuilder, {'min_variance': MVE_MIN_VARIANCE}, None),
            ('mc_dropout', MCDropoutModelBuilder,
             {'num_samples': MC_SAMPLES, 'dropout_percent': MC_P},
             'fused_mc_dropout')):
        one = builder(FLAGSHIP, descr, train_config=TRAIN_MODEL_CONFIG,
                      seed=args.seed, device=DEVICE).build()
        tr, _, launches, seconds = fit(name, one, x_all, y_all, 1, args.seed)
        check(tr.fused_epochs_used == 1, f'{name}: fused_epochs_used '
                                         f'{tr.fused_epochs_used}, expected 1')
        check_launches(f'{name} fit', launches, fused_train=1, **(
            {kernel: TRAIN_CONFIG['limit_val_batches']} if kernel else {}))
        losses = [float(r['train_loss']) for r in csv.DictReader(open(
            os.path.join(tr.logger.log_dir, 'metrics.csv'))) if r['train_loss']]
        check(np.isfinite(losses).all(), f'{name}: non-finite training losses')
        emit('training', model=name, epochs=1,
             fused_epochs_used=tr.fused_epochs_used, launches=launches,
             first_losses=losses[:3], last_losses=losses[-3:],
             val_loss=tr.callback_metrics['val_loss'], fit_s=seconds)

    # 5b. training in bf16-mixed: the flagship trial with precision
    # 'bf16-mixed' -> kernel 3's bf16 form every epoch, kernel 1b for
    # validation; the saved bundle reloads in bf16, serves through kernel
    # 1b and reproduces its logged validation loss
    flagship16 = EnsembleModelBuilder(FLAGSHIP, {'num_models': MEMBERS},
                                      train_config=TRAIN_MODEL_CONFIG,
                                      seed=args.seed, device=DEVICE).build()
    trainer16, saver16, train16_launches, fit16_s = fit(
        'flagship_ensemble_bf16', flagship16, x_all, y_all, epochs,
        args.seed, precision='bf16-mixed')
    check(trainer16.fused_epochs_used == epochs,
          f'bf16 fit: fused_epochs_used {trainer16.fused_epochs_used}')
    check_launches('flagship bf16 fit', train16_launches,
                   fused_train_bf16=epochs, fused_ensemble_bf16=epochs
                   * TRAIN_CONFIG['limit_val_batches'])
    with open(os.path.join(trainer16.logger.log_dir, 'metrics.csv')) as f:
        rows16 = list(csv.DictReader(f))
    means16 = [float(np.mean([float(r['train_loss']) for r in rows16
                              if r['train_loss'] and int(r['epoch']) == e]))
               for e in range(epochs)]
    check(np.isfinite(means16).all() and means16[-1] < means16[0],
          f'bf16 training loss did not fall: epoch means {means16}')
    best16 = load_model(os.path.join(trainer16.logger.log_dir, 'model.pth'),
                        device='cuda')
    check(best16.precision == 'bf16-mixed'
          and best16.fused_weights().w_all.dtype == torch.bfloat16,
          'the bf16 bundle did not reload in bf16')
    reset_launches()
    mean16, std16 = Predictor(best16, device=DEVICE).predict(x_req)
    check_launches('reloaded bf16 bundle serving', read_launches(),
                   fused_ensemble_bf16=len(DEFAULT_BUCKETS) + 1)
    x_dev = torch.from_numpy(x_req).to(DEVICE)
    fw16_best = best16.fused_weights()
    fw32_best = in_fp32(best16, prepare_fused_weights)
    serve16_err = {part: bf16_close(f'reloaded bf16 {part}',
                                    torch.from_numpy(got), want.cpu(),
                                    ref.cpu())
                   for part, got, want, ref in zip(
                       ('mean', 'ue'), (mean16, std16),
                       fused_forward_plain(fw16_best, x_dev),
                       fused_forward_plain(fw32_best, x_dev))}
    val16_again = trainer16.validate(best16, DataLoader(ArrayDataset(
        x_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows],
        y_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows]), TRAIN_BATCH))
    check(abs(val16_again - saver16.best) <= 1e-5,
          f'reloaded bf16 val_loss {val16_again} != logged {saver16.best}')
    emit('training_bf16', model='ensemble', precision='bf16-mixed',
         members=MEMBERS, epochs=epochs,
         steps_per_epoch=TRAIN_CONFIG['limit_train_batches'],
         batch=TRAIN_BATCH, fused_epochs_used=trainer16.fused_epochs_used,
         launches=train16_launches, train_loss_epoch_means=means16,
         fp32_train_loss_epoch_means=epoch_means,
         val_losses=[float(r['val_loss']) for r in rows16 if r['val_loss']],
         best_val_loss=saver16.best, reloaded_val_loss=val16_again,
         reloaded_serving=serve16_err, fit_s=fit16_s,
         seconds_per_epoch=fit16_s / epochs,
         trainer_e2e_rows_per_s=train_rows / fit16_s)

    # 5c. Δ-UQ and PAGER: 229 anchors, epoch 0 step by step while the hook
    # captures the anchors, epoch 1 through kernel 3 at the doubled batch
    # (256 rows of 10 anchored features), in fp32 and in bf16-mixed;
    # validation through kernel 5 (5b in bf16) over every anchor
    for name, builder in (('delta_uq', DeltaUQMLPModelBuilder),
                          ('pager', PAGERModelBuilder)):
        for precision in ('32-true', 'bf16-mixed'):
            bf16 = precision == 'bf16-mixed'
            one = builder(FLAGSHIP, {'num_anchors': ANCHORS,
                                     'anchored_batch_size': ANCHORS},
                          train_config=TRAIN_MODEL_CONFIG, seed=args.seed,
                          device=DEVICE).build()
            tr, _, launches, seconds = fit(
                f'{name}_{precision}', one, x_all, y_all,
                ANCHORED_FIT_EPOCHS, args.seed, precision=precision,
                limit_train_batches=ANCHORED_FIT_STEPS)
            check(tr.fused_epochs_used == ANCHORED_FIT_EPOCHS - 1,
                  f'{name} {precision}: fused_epochs_used '
                  f'{tr.fused_epochs_used}')
            suffix = '_bf16' if bf16 else ''
            check_launches(f'{name} {precision} fit', launches, **{
                'fused_train' + suffix: ANCHORED_FIT_EPOCHS - 1,
                'fused_anchored' + suffix: ANCHORED_FIT_EPOCHS
                * TRAIN_CONFIG['limit_val_batches']})
            check(tuple(one.anchors.shape) == (ANCHORS, IN_DIM)
                  and (name == 'delta_uq'
                       or tuple(one.anchors_Y.shape) == (ANCHORS, 1)),
                  f'{name}: anchors not captured')
            with open(os.path.join(tr.logger.log_dir, 'metrics.csv')) as f:
                logged = [float(r['train_loss']) for r in csv.DictReader(f)
                          if r['train_loss']]
            check(np.isfinite(logged).all() and logged,
                  f'{name} {precision}: non-finite training losses')
            val_again = tr.validate(one, DataLoader(ArrayDataset(
                x_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows],
                y_all[TRAIN_SPLIT:TRAIN_SPLIT + val_rows]), TRAIN_BATCH))
            logged_val = tr.callback_metrics['val_loss']
            check(abs(val_again - logged_val) <= 1e-5,
                  f'{name} {precision}: val_loss {val_again} != logged '
                  f'{logged_val}')
            emit('training', model=name, precision=precision,
                 epochs=ANCHORED_FIT_EPOCHS, anchors=ANCHORS,
                 steps_per_epoch=ANCHORED_FIT_STEPS,
                 kernel_batch=2 * TRAIN_BATCH,
                 fused_epochs_used=tr.fused_epochs_used, launches=launches,
                 first_losses=logged[:3], last_losses=logged[-3:],
                 val_loss=logged_val, revalidated=val_again, fit_s=seconds)

    # 6. timing at the bench's shapes
    kernels, kernels_bf16 = [], []

    def record(index, launches, kernel_t, plain_t, flops, moved, library_ms,
               exps=0, into=kernels, peak=peak_flops, extra_s=0.0,
               exp_rate=ex2_rate, counted=None, **extra):
        """``counted``: (bound_ms, bound_by) counted by pipe, in place of
        the bound of ``flops``, ``exps`` and ``moved``."""
        bound_ms, bound_by = counted or bound(flops, moved, peak, peak_bytes,
                                              exps, exp_rate, extra_s)
        ms = kernel_t['median_ms']
        emit('timing', kernel=KERNELS[index]['name'], kernel_ms=kernel_t,
             plain=plain_t, flops=flops, bytes=moved, bound_ms=bound_ms,
             bound_by=bound_by, kernel_share_of_bound=bound_ms / ms, **extra,
             clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))
        into.append(dict(
            KERNELS[index], launches=launches,
            max_abs_err=errors[KERNELS[index]['name']], ms=ms,
            plain_ms=plain_t['median_ms'], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms))

    def e2e_median_s(pred, rows):
        x_host = rng.normal(size=(rows, IN_DIM)).astype(np.float32)
        return float(np.median(timed_passes(lambda: pred.predict(x_host),
                                            WARMUP, TRIALS)))

    x = torch.as_tensor(rng.normal(size=(ROWS, IN_DIM)), dtype=torch.float32,
                        device=DEVICE)
    lib_mean, lib_std = library_chain(fw, x)
    ref_mean, ref_std = fused_forward_plain(fw, x)
    compare('library mean', lib_mean, ref_mean, TOL_MEAN)
    compare('library std', lib_std, ref_std, TOL_STD)
    kernel_t = event_ms(lambda: fused_forward_prefolded(fw, x))
    plain_t = event_ms(lambda: fused_forward_plain(fw, x))
    library_t = event_ms(lambda: library_chain(fw, x))
    kernel_t2 = event_ms(lambda: fused_forward_prefolded(fw, x))
    e2e_s = e2e_median_s(predictor, ROWS)
    record(0, ens_launches, kernel_t, plain_t,
           2.0 * ROWS * fw.num_members * fw.macs_per_row,
           4.0 * (x.numel() + fw.w_all.numel() + fw.b_all.numel()
                  + 2 * ROWS * fw.out_dim),
           library_t['median_ms'], rows=ROWS, kernel_again=kernel_t2,
           library_baddbmm=library_t, predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)

    x_plain = x[:MC_PLAIN_TIMING_ROWS].contiguous()
    kernel_t = event_ms(lambda: fused_mc_forward(mw, x, MC_SAMPLES, 7))
    plain_t = event_ms(lambda: fused_mc_forward_plain(mw, x_plain, MC_SAMPLES, 7))
    gemm_t = event_ms(lambda: mc_gemm_only(mw, x, MC_SAMPLES))
    e2e_s = e2e_median_s(mc_predictor, ROWS)
    record(1, mc_launches, kernel_t, plain_t,
           2.0 * ROWS * (MC_SAMPLES + 1) * mw.macs_per_row,
           4.0 * (x.numel() + mw.w_all.numel() + mw.b_all.numel()
                  + 2 * ROWS * mw.out_dim),
           None, rows=ROWS, samples=MC_SAMPLES, p=MC_P,
           plain_rows=MC_PLAIN_TIMING_ROWS, gemm_only_reference=gemm_t,
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels[-1]['plain_rows'] = MC_PLAIN_TIMING_ROWS
    kernels[-1]['gemm_only_reference_ms'] = gemm_t['median_ms']

    xa = x[:ANCHORED_ROWS].contiguous()
    lib_mean, lib_std = anchored_library(aw, xa, anchors)
    ref_mean, ref_std = fused_anchored_plain(aw, xa, anchor_rows(aw, anchors))
    compare('anchored library mean', lib_mean, ref_mean, TOL_MEAN)
    compare('anchored library std', lib_std, ref_std, TOL_STD)
    kernel_t = event_ms(lambda: fused_anchored_stats(aw, xa, anchors))
    plain_t = event_ms(lambda: fused_anchored_plain(aw, xa,
                                                    anchor_rows(aw, anchors)))
    library_t = event_ms(lambda: anchored_library(aw, xa, anchors))
    e2e_s = e2e_median_s(dq_predictor, ANCHORED_ROWS)
    record(2, dq_launches + pager_launches, kernel_t, plain_t,
           2.0 * ANCHORED_ROWS * (aw.macs_once + ANCHORS * aw.macs_per_anchor),
           4.0 * (xa.numel() + aw.w_all.numel() + aw.b_all.numel()
                  + ANCHORS * WIDTH + 2 * ANCHORED_ROWS * aw.out_dim),
           library_t['median_ms'], rows=ANCHORED_ROWS, anchors=ANCHORS,
           library_gemm_chain=library_t, predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ANCHORED_ROWS / e2e_s)

    data = kde_model.kde.data
    h = kde_model.kde.bandwidth_
    lib = kde_library(x, data, h)
    compare('kde library log density', lib,
            kde_logpdf_plain(*centre(x, data), h), TOL_LOGPDF)
    kernel_t = event_ms(lambda: kde_logpdf(x, data, h))
    plain_t = event_ms(lambda: kde_logpdf_plain(*centre(x, data), h))
    library_t = event_ms(lambda: kde_library(x, data, h))
    kernel_t2 = event_ms(lambda: kde_logpdf(x, data, h))
    e2e_s = e2e_median_s(kde_predictor, ROWS)
    pairs = ROWS * KDE_FIT_ROWS
    # the bound counted by pipe (ops/kde.py kde_bound_terms): the exponent's
    # dot on the tensor cores (dense TF32, half the bf16 rate) or FFMAs, a
    # share of the exps as FMA-pipe polynomials; beside it the bound of
    # earlier rows, every exp on MUFU or the fp32 FLOP
    kde_terms = kde_bound_terms(pairs, IN_DIM, sms, clock_hz, peak_bf16 / 2)
    kde_moved = 4.0 * (x.numel() + data.numel() + ROWS)
    old_bound_ms, _ = bound(pairs * (2.0 * IN_DIM + 6), kde_moved, peak_flops,
                            peak_bytes, pairs, ex2_rate)
    record(3, kde_launches, kernel_t, plain_t, pairs * (2.0 * IN_DIM + 6),
           kde_moved, library_t['median_ms'],
           counted=(max(kde_terms['ms'], 1e3 * kde_moved / peak_bytes),
                    'operations'),
           rows=ROWS, references=KDE_FIT_ROWS, kernel_again=kernel_t2,
           bound_by_pipe=kde_terms, bound_ms_every_exp_on_mufu=old_bound_ms,
           fp32_ms=1e3 * pairs * (2.0 * IN_DIM + 6) / peak_flops,
           ex2_ms=1e3 * pairs / ex2_rate, library_chain=library_t,
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels[-1].update(
        bound_terms_ms=kde_terms['pipes_ms'],
        bound_ms_every_exp_on_mufu=old_bound_ms,
        share_of_bound=kernels[-1]['bound_ms'] / kernels[-1]['ms'],
        ptxas={k: v for k, v in ptxas.items() if 'kde' in k})

    # the kernel-free paths: kNN-KDE's exact top-k and MVE's one pass
    knn_t = event_ms(lambda: knn_kde_density(x, knn_model._fit_data,
                                             knn_model._bandwidth_value,
                                             KNN_K))
    knn_e2e_s = e2e_median_s(knn_predictor, ROWS)
    mve_e2e_s = e2e_median_s(mve_predictor, ROWS)
    emit('timing_kernel_free', rows=ROWS, references=KDE_FIT_ROWS, k=KNN_K,
         knn_kde_density=knn_t, knn_predictor_e2e_median_s=knn_e2e_s,
         knn_predictor_e2e_samples_per_s=ROWS / knn_e2e_s,
         mve_predictor_e2e_median_s=mve_e2e_s,
         mve_predictor_e2e_samples_per_s=ROWS / mve_e2e_s,
         clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))

    # the bf16 forms at the same shapes: bound by the dense bf16
    # tensor-core peak; weights move as bf16
    def moved16(w, x_numel, out_rows, extra=0):
        return (4.0 * (x_numel + w.b_all.numel() + 2 * out_rows * w.out_dim
                       + extra) + 2.0 * w.w_all.numel())

    lib16 = library_chain(fw16, x)
    ref16 = fused_forward_plain(fw16, x)
    lib16_err = [float((a - b).abs().max()) for a, b in zip(lib16, ref16)]
    kernel_t = event_ms(lambda: fused_forward_prefolded(fw16, x))
    plain_t = event_ms(lambda: fused_forward_plain(fw16, x))
    library_t = event_ms(lambda: library_chain(fw16, x))
    e2e_s = e2e_median_s(bf16_predictors['ensemble'], ROWS)
    record(10, bf16_launches['ensemble'], kernel_t, plain_t,
           2.0 * ROWS * fw16.num_members * fw16.macs_per_row,
           moved16(fw16, x.numel(), ROWS), library_t['median_ms'],
           into=kernels_bf16, peak=peak_bf16, rows=ROWS,
           library_bf16_baddbmm=library_t, library_max_abs_diff=lib16_err,
           layout=dict(zip(ec.ENSEMBLE_FIELDS, ec.launch_args(
               'ensemble', fw16, ROWS, x.device)[1])),
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels_bf16[-1].update(
        share_of_bound=kernels_bf16[-1]['bound_ms'] / kernels_bf16[-1]['ms'],
        ptxas={k: v for k, v in eval_chain.items()
               if k.startswith('fused_ensemble')})

    kernel_t = event_ms(lambda: fused_mc_forward(mw16, x, MC_SAMPLES, 7))
    plain_t = event_ms(lambda: fused_mc_forward_plain(mw16, x_plain,
                                                      MC_SAMPLES, 7))
    gemm_t = event_ms(lambda: mc_gemm_only(mw16, x, MC_SAMPLES))
    e2e_s = e2e_median_s(bf16_predictors['mc_dropout'], ROWS)
    # beside the bf16 products, the mask hash: one for every masked element
    # (the inputs of the Linears a Dropout precedes, over every row and
    # sample), each the function's operations (MASK_HASH_OPS) on the
    # integer pipes; the mask loop's SASS instructions a hash beside it
    masked = sum(IN_DIM if layer == 0 else WIDTH
                 for layer, t in enumerate(mw16.thresholds) if t >= 0)
    hashes = ROWS * MC_SAMPLES * masked
    clocks = hash_clocks(MASK_HASH_OPS)
    hash_rate = sms * int(clock_mhz.group(1)) * 1e6 / clocks
    flops16 = 2.0 * ROWS * (MC_SAMPLES + 1) * mw16.macs_per_row
    record(11, bf16_launches['mc_dropout'], kernel_t, plain_t, flops16,
           moved16(mw16, x.numel(), ROWS), None, into=kernels_bf16,
           peak=peak_bf16, exps=hashes, exp_rate=hash_rate,
           rows=ROWS, samples=MC_SAMPLES, p=MC_P,
           plain_rows=MC_PLAIN_TIMING_ROWS, gemm_only_reference=gemm_t,
           masked_elements=hashes, hash_ops=MASK_HASH_OPS,
           hash_clocks_per_sm=clocks, hashes_per_s=hash_rate,
           products_ms=1e3 * flops16 / peak_bf16,
           hash_ms=1e3 * hashes / hash_rate,
           mask_loop=eval_chain['mask_loop'],
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels_bf16[-1].update(
        plain_rows=MC_PLAIN_TIMING_ROWS,
        gemm_only_reference_ms=gemm_t['median_ms'],
        bound_terms_ms={'bf16_products': 1e3 * flops16 / peak_bf16,
                        'mask_hash_int_ops': 1e3 * hashes / hash_rate},
        hash_ops=MASK_HASH_OPS,
        sass_instructions_per_hash=eval_chain['mask_loop']['per_marker'],
        share_of_bound=kernels_bf16[-1]['bound_ms'] / kernels_bf16[-1]['ms'],
        ptxas={k: v for k, v in eval_chain.items()
               if k.startswith('fused_mc')})

    lib16 = anchored_library(aw16, xa, anchors)
    ref16 = fused_anchored_plain(aw16, xa, anchor_rows(aw16, anchors))
    lib16_err = [float((a - b).abs().max()) for a, b in zip(lib16, ref16)]
    kernel_t = event_ms(lambda: fused_anchored_stats(aw16, xa, anchors))
    plain_t = event_ms(lambda: fused_anchored_plain(
        aw16, xa, anchor_rows(aw16, anchors)))
    library_t = event_ms(lambda: anchored_library(aw16, xa, anchors))
    e2e_s = e2e_median_s(bf16_predictors['delta_uq'], ANCHORED_ROWS)
    record(12, bf16_launches['delta_uq'] + bf16_launches['pager'], kernel_t,
           plain_t,
           2.0 * ANCHORED_ROWS * (aw16.macs_once
                                  + ANCHORS * aw16.macs_per_anchor),
           moved16(aw16, xa.numel(), ANCHORED_ROWS, ANCHORS * WIDTH),
           library_t['median_ms'], into=kernels_bf16, peak=peak_bf16,
           rows=ANCHORED_ROWS, anchors=ANCHORS,
           library_bf16_gemm_chain=library_t, library_max_abs_diff=lib16_err,
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ANCHORED_ROWS / e2e_s)
    kernels_bf16[-1].update(
        share_of_bound=kernels_bf16[-1]['bound_ms'] / kernels_bf16[-1]['ms'],
        ptxas={k: v for k, v in eval_chain.items()
               if k.startswith('fused_anchored')})
    e2e16 = {name: e2e_median_s(bf16_predictors[name], ROWS)
             for name in ('kde', 'knn_kde', 'mve')}
    emit('timing_bf16_kernel_free', rows=ROWS,
         predictor_e2e_median_s=e2e16,
         predictor_e2e_samples_per_s={k: ROWS / v for k, v in e2e16.items()},
         clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))

    # the training kernel: one flagship epoch of 1,000 steps
    plan = train_plan(flagship)
    bufs, xs, ys = train_inputs(flagship, plan, rng, EPOCH_STEPS)
    lr = TRAIN_MODEL_CONFIG['learning_rate']
    drops = ft.drop_rates(flagship.net).to(DEVICE)
    kernel_t = event_ms(lambda: ft.fused_epoch(plan, *bufs, xs, ys, lr,
                                               TRAIN_STEP0, 1, drops))
    # the plain version is ~50 times slower: timed on 100 steps, scaled
    plain_bufs = [b.clone() for b in bufs]
    plain_t = event_ms(lambda: ft.fused_epoch_reference(
        plan, *plain_bufs, xs[:PLAIN_TRAIN_STEPS], ys[:PLAIN_TRAIN_STEPS], lr,
        TRAIN_STEP0, 1, drops), warmup=1, trials=3)
    scale = EPOCH_STEPS / PLAIN_TRAIN_STEPS
    plain_scaled = {k: v * scale for k, v in plain_t.items()}
    library_t = event_ms(library_epoch(flagship, xs, ys, lr), warmup=1,
                         trials=3)
    # the probe's one-block form of the same step (the design the cluster
    # form replaced; fp32, no dropout) on the same epoch, between the
    # kernel's two timings
    probe_t = event_ms(lambda: ae.ablate_epoch(plan, *bufs, xs, ys, lr,
                                               TRAIN_STEP0),
                       warmup=1, trials=3)
    kernel_t2 = event_ms(lambda: ft.fused_epoch(plan, *bufs, xs, ys, lr,
                                                TRAIN_STEP0, 1, drops))
    # a single net's epoch (MC dropout: one cluster a step) beside the
    # 8-member one: per-cluster work against member count
    mc_one = build_mc(args.seed)
    mc_plan = train_plan(mc_one)
    mc_bufs, mc_xs, mc_ys = train_inputs(mc_one, mc_plan, rng, EPOCH_STEPS)
    mc_drops = ft.drop_rates(mc_one.net).to(DEVICE)
    single_t = event_ms(lambda: ft.fused_epoch(
        mc_plan, *mc_bufs, mc_xs, mc_ys, lr, TRAIN_STEP0, 1, mc_drops),
        warmup=1, trials=3)
    moved = 4.0 * (2 * (3 * plan.total_rows + plan.total_sig_rows) * 128
                   + xs.numel() + ys.numel() + EPOCH_STEPS)
    layout = ft.train_layout(plan)
    cluster_row = {'cluster': layout.cluster, 'resident': layout.resident,
                   'smem_bytes': layout.smem_bytes}
    record(4, train_launches['fused_train'], kernel_t, plain_scaled,
           train_flops(plan, EPOCH_STEPS), moved, library_t['median_ms'],
           members=MEMBERS, batch=TRAIN_BATCH, steps=EPOCH_STEPS,
           kernel_again=kernel_t2, plain_steps=PLAIN_TRAIN_STEPS,
           single_net_mc_dropout_epoch=single_t,
           probe_one_block_prod_epoch=probe_t, **cluster_row,
           plain_measured=plain_t, library_torch_ops=library_t,
           trainer_seconds_per_epoch=fit_s / epochs,
           trainer_e2e_rows_per_s=train_rows / fit_s)
    kernels[-1].update(
        plain_steps=PLAIN_TRAIN_STEPS, **cluster_row,
        share_of_bound=kernels[-1]['bound_ms'] / kernels[-1]['ms'],
        ptxas=cluster_kernels(ptxas, 'fused_train'),
        probe_one_block_ms=probe_t['median_ms'],
        single_net_ms=single_t['median_ms'])

    # kernel 3's bf16 form on the same epoch (its fp32 buffers): bound by
    # the products at the bf16 tensor-core peak plus the rest (BatchNorm,
    # ReLU, optimizer) at the fp32 peak; the plain version and the autocast
    # yardstick, host-bound loops of small ops, timed on 20 and 100 steps,
    # scaled
    plan16 = train_plan(flagship, bf16=True)
    kernel_t = event_ms(lambda: ft.fused_epoch(plan16, *bufs, xs, ys, lr,
                                               TRAIN_STEP0, 1, drops),
                        warmup=2, trials=5)
    plain_bufs = [b.clone() for b in bufs]
    plain_t = event_ms(lambda: ft.fused_epoch_reference(
        plan16, *plain_bufs, xs[:PLAIN_BF16_STEPS], ys[:PLAIN_BF16_STEPS],
        lr, TRAIN_STEP0, 1, drops), warmup=1, trials=3)
    plain_scaled = {k: v * EPOCH_STEPS / PLAIN_BF16_STEPS
                    for k, v in plain_t.items()}
    library_t = event_ms(library_epoch(flagship, xs[:PLAIN_TRAIN_STEPS],
                                       ys[:PLAIN_TRAIN_STEPS], lr, bf16=True),
                         warmup=1, trials=3)
    kernel_t2 = event_ms(lambda: ft.fused_epoch(plan16, *bufs, xs, ys, lr,
                                                TRAIN_STEP0, 1, drops),
                         warmup=2, trials=5)
    mc_plan16 = train_plan(mc_one, bf16=True)
    single16_t = event_ms(lambda: ft.fused_epoch(
        mc_plan16, *mc_bufs, mc_xs, mc_ys, lr, TRAIN_STEP0, 1, mc_drops),
        warmup=1, trials=3)
    rest_flops = train_rest_flops(plan16, EPOCH_STEPS)
    record(14, train16_launches['fused_train_bf16'], kernel_t, plain_scaled,
           train_flops(plan16, EPOCH_STEPS), moved,
           library_t['median_ms'] * scale, into=kernels_bf16, peak=peak_bf16,
           extra_s=rest_flops / peak_flops, members=MEMBERS,
           batch=TRAIN_BATCH, steps=EPOCH_STEPS, kernel_again=kernel_t2,
           plain_steps=PLAIN_BF16_STEPS, plain_measured=plain_t,
           fp32_rest_flops=rest_flops, single_net_mc_dropout_epoch=single16_t,
           **cluster_row, library_autocast_measured=library_t,
           library_steps=PLAIN_TRAIN_STEPS,
           trainer_seconds_per_epoch=fit16_s / epochs,
           trainer_e2e_rows_per_s=train_rows / fit16_s)
    # the one-block bf16 form is gone: its row keeps the probe's fp32
    # one-block epoch of the same plan, timed above, for the old design
    kernels_bf16[-1].update(
        plain_steps=PLAIN_BF16_STEPS, library_steps=PLAIN_TRAIN_STEPS,
        **cluster_row,
        share_of_bound=kernels_bf16[-1]['bound_ms'] / kernels_bf16[-1]['ms'],
        ptxas=cluster_kernels(ptxas, 'fused_train_bf16'),
        probe_one_block_fp32_ms=probe_t['median_ms'],
        single_net_ms=single16_t['median_ms'])

    # 7. attribution: the probes' entry point (nnueehcs_tpu_torch.attrib),
    # both batteries at the flagship shape, every launch count at 0 just
    # before and read just after; each battery holds every variant to its
    # plain version and each form of the production math to kernel 1 or 3
    # bit for bit before it times it
    reset_launches()
    fwd = attrib.forward_battery(DEVICE, args.seed, ROWS, reps=TRIALS)
    trn = attrib.train_battery(DEVICE, args.seed, ATTRIB_STEPS,
                               reps=ATTRIB_TRAIN_REPS)
    trn16 = attrib.train_battery(DEVICE, args.seed, ATTRIB_STEPS,
                                 reps=ATTRIB_TRAIN_REPS, bf16=True)
    attrib_launches = read_launches()
    probes = [k['name'] for k in KERNELS[5:10]] + ['packed_forward_bf16']
    check(all(attrib_launches[name] > 0 for name in probes),
          f'attribution: a probe never launched: {attrib_launches}')
    model_a, fw_a, x_a, x_pad, x_n8, x_t = attrib.forward_inputs(
        args.seed, DEVICE, ROWS)
    plains = {'ablate_forward': lambda: af.ablate_forward_plain(fw_a, x_pad),
              'xt_forward': lambda: af.xt_forward_plain(fw_a, x_t),
              'narrow_forward': lambda: af.narrow_forward_plain(fw_a, x_n8),
              'packed_forward': lambda: af.packed_forward_plain(fw_a, x_pad)}
    library_fwd = event_ms(lambda: library_chain(fw_a, x_a))
    for kernel in KERNELS[5:10]:
        name = kernel['name']
        if name == 'ablate_epoch':
            continue
        v = fwd['variants'][PROBE_VARIANTS[name]]
        plain_t = event_ms(plains[name])
        kernels.append(dict(
            kernel, launches=attrib_launches[name],
            max_abs_err=max(max(fwd['gates'][g]['max_abs_err'])
                            for g in PROBE_GATES[name]),
            ms=v['median_ms'], plain_ms=plain_t['median_ms'],
            bound_ms=v['bound_ms'], bound_by=v['bound_by'],
            library_ms=library_fwd['median_ms'],
            variant=PROBE_VARIANTS[name], rows=ROWS))
    # the plain epoch and the yardstick run host-bound loops of small ops:
    # timed on fewer steps, scaled to the battery's epoch
    _, plan_a, bufs_a, xs_a, ys_a = attrib.train_problem(
        args.seed, DEVICE, steps=PLAIN_ABLATE_STEPS)
    model_a, _, _, xs_l, ys_l = attrib.train_problem(
        args.seed, DEVICE, steps=PLAIN_TRAIN_STEPS)
    scale_plain = ATTRIB_STEPS / PLAIN_ABLATE_STEPS
    plain_t = event_ms(lambda: ae.ablate_epoch_reference(
        plan_a, *bufs_a, xs_a, ys_a, attrib.LR, 0), warmup=1, trials=3)
    library_t = event_ms(library_epoch(model_a, xs_l, ys_l, attrib.LR),
                         warmup=1, trials=3)
    v = trn['variants']['prod']
    kernels.insert(8, dict(
        KERNELS[8], launches=attrib_launches['ablate_epoch'],
        max_abs_err=max(max(g['max_abs_err'].values())
                        for g in trn['gates'].values() if 'max_abs_err' in g),
        ms=v['median_ms'], plain_ms=plain_t['median_ms'] * scale_plain,
        bound_ms=v['bound_ms'], bound_by=v['bound_by'],
        library_ms=library_t['median_ms'] * ATTRIB_STEPS / PLAIN_TRAIN_STEPS,
        variant='prod', steps=ATTRIB_STEPS, batch=TRAIN_BATCH,
        plain_steps=PLAIN_ABLATE_STEPS, library_steps=PLAIN_TRAIN_STEPS))
    emit('attribution', launches=attrib_launches,
         forward_decomposition=fwd['decomposition'],
         train_budget=trn['budget'],
         train_batch_scaling_us_per_step={
             b: r['us_per_step'] for b, r in trn['batch_scaling'].items()},
         train_batch_scaling_probe_us_per_step={
             b: r['us_per_step']
             for b, r in trn['batch_scaling_probe'].items()},
         train_bf16_us_per_step={
             'library fused_epoch':
                 trn16['variants']['library fused_epoch']['us_per_step'],
             **{b: r['us_per_step']
                for b, r in trn16['batch_scaling'].items()}},
         plain_epoch=plain_t, library_epoch=library_t,
         library_chain=library_fwd,
         clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))
    # the packed probe's bf16 form, timed in the battery ('packed bf16')
    fw16_a = in_bf16(model_a, prepare_fused_weights)
    v = fwd['variants']['packed bf16']
    plain_t = event_ms(lambda: af.packed_forward_plain(fw16_a, x_pad))
    library_t = event_ms(lambda: library_chain(fw16_a, x_a))
    kernels_bf16.insert(3, dict(
        KERNELS[13], launches=attrib_launches['packed_forward_bf16'],
        max_abs_err=max(fwd['gates']['packed bf16']['max_abs_err']),
        ms=v['median_ms'], plain_ms=plain_t['median_ms'],
        bound_ms=v['bound_ms'], bound_by=v['bound_by'],
        library_ms=library_t['median_ms'], variant='packed bf16', rows=ROWS))
    kernels += kernels_bf16
    check([k['name'] for k in kernels] == [k['name'] for k in KERNELS],
          'the kernels line is out of order')

    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)
    print(f'chip_smoke: {time.perf_counter() - wall:.1f} s', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
