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
128), every probe held to its plain version and every form of the
probes' FFMA math to the prod probe bit for bit (kernel 1 to its plain
version) before it is timed, kernel 3 held step by
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
pipe; the fp32 kernels 2 and 5, 3xTF32 wgmma products with a tile's
passes split over a cluster of 8 blocks, are checked for spills and HGMMA
instructions the same way, and their bounds counted by pipe: three TF32
products for each fp32 one at the TF32 peak, kernel 2's hash on the
integer pipes; the KDE kernel is also held at every d from 1 to 8 and for one
query, and row 4's bound is counted by pipe), the seven models are served again after
``set_precision('bf16-mixed')`` (the JAX package's ``eval_precision``, a
bf16 evaluation of an fp32-trained model), each answer held to the plain
bf16 function on the card against its bf16-vs-fp32 gap, with each
kernel's bf16 form launched exactly as often as its fp32 form was and no
fp32 form at all, and each bf16 form is timed. Training in bf16-mixed:
the training kernel's bf16 form is held to its plain version step by step
on the four cases at the flagship shape and on the MC-dropout flagship
with every pre-ReLU value kept away from 0 (64 steps; the bf16 bars
against each step's bf16-vs-fp32 gap, widened by how far two more correct
bf16 steps part on that step, the excursions past them capped) and
over one epoch's loss curve (its distance to the
plain bf16 curve against the host's plain bf16 curve's), and both forms step by
step at the plan the Δ-UQ and PAGER fits give it (one net, 256 anchored
rows of 10 features); ``Trainer.fit`` of the
flagship trial with ``precision: 'bf16-mixed'`` for 3 epochs must launch
the bf16 form once an epoch and no fp32 form, and its bundle must reload
in bf16, serve through kernel 1's bf16 form and reproduce its logged
validation loss; Δ-UQ and PAGER (229 anchors) train for 2 epochs in fp32
and in bf16, epoch 0 step by step while their hooks capture the anchors,
epoch 1 through the training kernel at the doubled batch, with every
launch count checked; the bf16 form's epoch is timed beside its plain
version, an autocast yardstick and its bound. Last, the ``bo_trial``
phase runs the system's main path, the BO experiment loop
(``nnueehcs_tpu_torch.driver.run_bo_experiment``: data, training,
evaluation, metrics, BO, results tree), on
``examples/bo_driven/config.yaml`` read by the port's YAML reader: the
flagship ensemble cell on binomial_options, 262,144 rows generated by the
port's ``datagen`` from ``--seed`` and written as a tab-delimited file, 2
epochs a trial, 2 trials, then a restart to 3 that must run the third
only, then one trial with ``eval_precision: 'bf16-mixed'``. Each run has
every launch count set to 0 just before and read just after: kernel 3
once an epoch, kernel 1 once a validation batch and as often as the
evaluation protocol and the configured metrics imply (its bf16 form for
the UE passes of the bf16 trial, and then no fp32 form beyond validation),
no other kernel; the native parser read every data file; each trial wrote
its files and no failed row. The first trial's recorded
``percentile_score`` must match a recomputation from its reloaded bundle's
UEs through kernel 1's plain version on the card, and the config's
``max_memory_usage`` metric on the bf16 trial's bundle must lie between 0
and the card's memory. Inside that phase's tree, the ``posthoc`` phase
runs the port's post-hoc tools (``nnueehcs_tpu_torch.examples``):
``evaluate_metrics`` with the config's ``evaluation.metrics`` (kernel 1
launched exactly as the metrics imply; every classification value
recomputed from the bundle's UEs through kernel 1's plain version),
``classify_posthoc`` (held the same way), ``collate`` (its summary
against ``trial_results.csv``) and ``metric_eval_driver`` with one task
(its rows equal to the direct run's but for the timed and memory
metrics). The ``http`` phase serves the trained 8-member ensemble and
MC-dropout bundles through the port's HTTP server on 127.0.0.1: answers
equal to ``Predictor.predict``'s bit for bit and to the kernel's plain
version within tolerance, 400 for a wrong shape, a profiled request whose
trace names the span and the kernel, the allocator's statistics read
through ``utils/profiling.py``, and p50/p99 latency at 1 and 4,096 rows. The ``workflow`` phase runs ``workflow_driver`` over the ensemble
and MC-dropout cells (subprocesses on the card) and
``mesh_workflow_driver`` over the MC cell on ``cuda:0`` (kernels 2 and 3
launched exactly). The ``cnn`` phase takes tests/test_cnn.py's CNN and
CNN-128 (two 3 x 3 convolutions 128 channels wide with BatchNorm2d, a
max pool, a 128-wide Linear block) on 1 x 8 x 8 images through the
ensemble, MC dropout, Δ-UQ and PAGER: one epoch of ``Trainer.fit`` each
(250 steps of 128 images for CNN-128), bundles reloaded to their logged
validation loss, then ``Predictor`` in fp32 and bf16-mixed against the
plain computation member by member and anchor by anchor, with every
launch count 0 (no kernel takes a Conv2d network), images/s and the
allocator's peak. The ``parallel`` phase runs ``nnueehcs_tpu_torch.parallel``:
a gloo world of two ranks both on ``cuda:0`` (``parallel.launch``; NCCL
refuses two ranks on one card) serves the flagship shapes dp-sharded
through ``Predictor(mesh=)`` (the ensemble and MC dropout in fp32 and
bf16-mixed, Δ-UQ, KDE and kNN-KDE on a corpus split over the ranks, and
the ensemble split 4 + 4 over ``member``), each answer held to the
unsharded call within the parity bars (MC dropout bit for bit), each
rank's share of a row-sharded answer equal bit for bit to its rows run
alone, every rank holding the same answer and launching its kernel
exactly once a bucket (kernel 4 on its corpus shard); probes which
collectives gloo takes on CUDA tensors; fits the flagship trial's
ensemble for 5 validated epochs of 20 steps on ``{'dp': 2}`` and
``{'member': 2}`` against the same fit unsharded (the first epoch's
losses and validation loss within stated bars, kernel 3 never
launched); then an NCCL world of one rank a visible card sums over its
group and serves a dp-sharded ensemble request. Kernels 2 and 2b are
also held to their plain versions with a nonzero ``row0`` (a rank's
first row). The ``bo_trial`` phase also runs one trial with
``whole_fit: true``, and the ``whole_fit`` phase fits the flagship trial
on that phase's ID rows with ``whole_fit`` true (every epoch of the fit
enqueued in one dispatch, under ``torch.cuda.set_sync_debug_mode('error')``)
and false from the same seed, 6 epochs in fp32 and in bf16-mixed, an
early stop and a plateau on 50-step epochs, Δ-UQ (229 anchors) and MC
dropout for 3 epochs: theta, m, v, sigma, every step's loss, the stop
epoch, the pinned best and the validation losses bit for bit, kernel 3
launched once an epoch that trained; it prints seconds
an epoch both ways beside kernel 3's and 3b's epochs, and what a stop
costs (a stopped kernel epoch's time and a validation pass's). The
``validation`` phase runs the trainer's validation pass at the flagship
trial's shape (100 batches of 128 rows) through kernels 1, 1b, 2, 2b, 5
and 5b: one launch over every batch (MC dropout's seed table, one seed a
batch) must give the outputs of one launch a batch bit for bit, and the
losses within 1e-6 relative, 2 and 2b also at 100 rows a batch; it times
each kernel on one batch and on the pass, beside their bounds and the
PyTorch yardstick, and the ``kernels`` line carries them under
``validation``. It prints one JSON line per
phase, then the card's ``nvidia-smi`` name and power limit, then a
``{"kernels": [...]}`` line (fifteen kernels: the ten fp32 ones, then the
five bf16 forms), and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a card it exits non-zero before doing
anything.
"""
from __future__ import annotations

import argparse
import copy
import json
import re
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

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
from nnueehcs_tpu_torch import config as config_reader
from nnueehcs_tpu_torch import datagen
from nnueehcs_tpu_torch.attrib import (BF16_WITNESS_SHARE, TOL_MEAN,
                                       TOL_STD, TOL_TRAIN,
                                       bf16_close, bf16_peak, bf16_verdict,
                                       bound, check,
                                       event_ms, flip_reach, nvidia_smi,
                                       peaks, separate_relu,
                                       stepwise_vs_plain,
                                       stepwise_vs_plain_bf16, train_flops,
                                       train_rest_flops)
from nnueehcs_tpu_torch.convert import load_pytrees, tensor_trees
from nnueehcs_tpu_torch.data_utils import get_dataset, prepare_dataset_for_use
from nnueehcs_tpu_torch.driver import run_bo_experiment
from nnueehcs_tpu_torch.classification import PercentileBasedIdOodClassifier
from nnueehcs_tpu_torch.evaluation import (ClassificationMetric,
                                           MaxMemoryUsageEvaluation,
                                           RuntimeEvaluation,
                                           UncertaintyEvaluationMetric,
                                           get_evaluator,
                                           get_uncertainty_evaluator)
from nnueehcs_tpu_torch.examples.bo_driven import classify_posthoc, collate
from nnueehcs_tpu_torch.examples.bo_driven import mesh_workflow_driver
from nnueehcs_tpu_torch.examples.bo_driven import workflow_driver
from nnueehcs_tpu_torch.examples.metric_evaluation import evaluate_metrics
from nnueehcs_tpu_torch.examples.metric_evaluation import metric_eval_driver
from nnueehcs_tpu_torch.examples.serving.serve import make_handler
from nnueehcs_tpu_torch.models import base as model_base
from nnueehcs_tpu_torch.models.delta_uq import anchored_input
from nnueehcs_tpu_torch.native import load_delimited
from nnueehcs_tpu_torch.nn.layers import Dropout
from nnueehcs_tpu_torch.nn.network import build_network
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
                                                     keep_threshold,
                                                     lowbias32, mask_stream,
                                                     prepare_mc_weights)
from nnueehcs_tpu_torch.ops.kde import (_log_norm_const, bandwidth_value,
                                        centre, kde_bound_terms, kde_logpdf,
                                        kde_logpdf_plain, knn_kde_density)
from nnueehcs_tpu_torch.sass import eval_chain_sass
from nnueehcs_tpu_torch.serving import DEFAULT_BUCKETS, Predictor
from nnueehcs_tpu_torch.training import (ArrayDataset, DataLoader,
                                         EarlyStopping, ModelSavingCallback,
                                         Trainer, load_model)
from nnueehcs_tpu_torch.training.whole_fit import weighted_mean
from nnueehcs_tpu_torch.utility import ResultsTable
from nnueehcs_tpu_torch.utils.profiling import (TRACE_FILE, annotate,
                                                device_memory_stats,
                                                live_array_bytes,
                                                profile_trace)
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
# the first row of a rank's share in the kernel-vs-plain row0 cases
MC_ROW0 = 3_000_017
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
# over a whole epoch, its largest distance to the plain bf16 curve within
# BF16_WITNESS_SHARE of the host's plain bf16 curve's (after a flipped
# rounding two correct bf16 trajectories part and the parting compounds;
# bf16_curve_bars)
STEPWISE_BF16_STEPS = 16
BF16_SEPARATE_STEPS = 64
BF16_CURVE_STEPS = 64
# Δ-UQ and PAGER fits: 229 anchors, epoch 0 step by step (the anchor hook
# reads its batches), epoch 1 through the kernel at the doubled batch; 250
# steps an epoch (1,000 per-step steps took 17-22 s a fit on the card)
ANCHORED_FIT_EPOCHS, ANCHORED_FIT_STEPS = 2, 250
# the plain bf16 epoch (about 53 ms a step, host-bound) is timed on 20 steps
PLAIN_BF16_STEPS = 20
# kernel 1 (fp32) also at a request's and the validation pass's rows, and
# at the member counts of the BO trials (bo_trial's 28, 3 and 15)
ENSEMBLE_ROWS = (1, 128, 4096, 12_800)
ENSEMBLE_MEMBERS = (3, 15, 28)
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
# the BO trial phase: the system's main path (run_bo_experiment) on the
# committed BO config, the flagship ensemble on binomial_options at the
# bench's 262,144 rows written as a tab-delimited file, 2 epochs a trial
BO_CONFIG = os.path.join('examples', 'bo_driven', 'config.yaml')
BO_BENCHMARK, BO_METHOD, BO_SPLIT = 'binomial_options', 'ensemble', 'tails'
BO_ROWS, BO_EPOCHS = 262_144, 2
BO_TRIALS, BO_RESTART_TRIALS = 2, 3
BO_FILES = ('ax_client.json', 'ax_client_optimization_step.json',
            'trial_results.csv', 'metrics.csv', 'model.pth')
BO_DIR = 'build'                     # its temporary directory lives here
# the user entry points around a trial: the HTTP server's requests, the
# workflow drivers' smaller data file and cells
HTTP_REQUESTS = (1, 100, 4096, 65_536)
HTTP_LATENCY_REQUESTS = 50
WORKFLOW_ROWS = 32_768
WORKFLOW_METHODS = ('ensemble', 'mc_dropout')


# the CNN phase: tests/test_cnn.py's CNN_DESCR (1 x 8 x 8 images, 4
# channels) and CNN-128, the flagship's hidden width on the same images;
# no kernel takes a Conv2d network (the folds and the training plan refuse
# it), so both train step by step and serve through their modules
CNN_IMAGE = (1, 8, 8)
CNN_DESCR = [{'Conv2d': {'args': [1, 4, 3], 'padding': 1}},
             {'BatchNorm2d': {'args': [4]}}, {'ReLU': {}},
             {'MaxPool2d': {'args': [2]}}, {'Flatten': {}},
             {'Linear': {'args': [4 * 4 * 4, 16]}}, {'ReLU': {}},
             {'Linear': {'args': [16, 1]}}]
CNN_128 = [{'Conv2d': {'args': [1, WIDTH, 3], 'padding': 1}},
           {'BatchNorm2d': {'args': [WIDTH]}}, {'ReLU': {}},
           {'Conv2d': {'args': [WIDTH, WIDTH, 3], 'padding': 1}},
           {'BatchNorm2d': {'args': [WIDTH]}}, {'ReLU': {}},
           {'MaxPool2d': {'args': [2]}}, {'Flatten': {}},
           {'Linear': {'args': [WIDTH * 4 * 4, WIDTH]}},
           {'BatchNorm1d': {'args': [WIDTH]}}, {'ReLU': {}},
           {'Linear': {'args': [WIDTH, 1]}}]
# name: (architecture, training steps of TRAIN_BATCH images, the
# ensemble's requests, the other classes' requests); CNN_DESCR at a
# smaller depth
CNN_CASES = {
    'cnn_128': (CNN_128, 250, (1, 300, 4096, 16_384), (1, 300, 4096)),
    'cnn_descr': (CNN_DESCR, 50, (1, 300, 4096), (1, 300)),
}
CNN_BUCKETS = (256, 1024, 4096, 16_384)
CNN_VAL_BATCHES = 8                       # validation: 1,024 images
CNN_CLASSES = ('ensemble', 'mc_dropout', 'delta_uq', 'pager')
# the whole-fit phase: the flagship trial (1,000 steps, 100 validation
# batches) on the bo_trial phase's ID rows, each case fitted with
# whole_fit true and false from the same seed; the early-stop and plateau
# cases on 50-step epochs (the plateau on one Linear layer, whose
# validation loss no BatchNorm statistic moves)
WHOLE_FIT_EPOCHS = 6
WHOLE_FIT_SHORT_STEPS = 50
WHOLE_FIT_STOP_EPOCHS = 12
WHOLE_FIT_PLATEAU_EPOCHS, WHOLE_FIT_PLATEAU_LR = 14, 1e-9
WHOLE_FIT_FAMILY_EPOCHS = 3
WHOLE_FIT_ANCHORED_STEPS = 100      # Δ-UQ's epoch 0 runs step by step
WHOLE_FIT_DIR = os.path.join('build', 'chip_smoke_whole_fit')
# the validation phase: the flagship trial's validation pass (TRAIN_CONFIG's
# 100 batches of 128 rows) through kernels 1, 1b, 2, 2b, 5 and 5b in one
# launch against one launch a batch, and kernels 2 and 2b again at 100 rows
# a batch (tiles that span two batches' seeds); batched and per-batch
# losses within TOL_VAL_LOSS_REL (a batched mean sums in another order)
VAL_RAGGED_BATCH = 100
TOL_VAL_LOSS_REL = 1e-6
VAL_SEED = 303                     # the phase's own generator

STARTED = time.perf_counter()      # the imports done


def emit(phase, **fields):
    """One JSON line; ``at_s`` is the seconds since the imports were done,
    so the gaps between lines split the run."""
    print(json.dumps({'phase': phase, **fields,
                      'at_s': time.perf_counter() - STARTED}), flush=True)


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
          judge=None, phase='serving', shape=(IN_DIM,),
          buckets=DEFAULT_BUCKETS):
    """Drive ``Predictor`` on ``model``: warm-up, then one request of each
    size, each request ``(n,) + shape`` (rows of features, or NCHW
    images), with ``buckets``. Launch counts are set to 0 just before and
    read just after;
    ``kernel`` must have launched once per bucket in the warm-up and once
    per chunk of each request, and no other kernel at all (with ``kernel``
    None, no kernel at all). ``reference(x, call_index)`` gives the unfused
    answer on the card for a request that was the model's
    ``call_index``-th call; ``judge(x, call_index, mean, ue)``, when given,
    checks an answer instead and returns its errors."""
    x_requests = [rng.normal(size=(n,) + tuple(shape)).astype(np.float32)
                  for n in requests]
    reset_launches()
    start = time.perf_counter()
    predictor = Predictor(model, buckets=buckets, device=DEVICE, warmup=False)
    predictor.warmup(shape)
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
        expected[kernel] = len(buckets) + sum(
            -(-n // buckets[-1]) for n in requests)
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
         request_s=latencies,
         request_rows_per_s=[n / t for n, t in zip(requests, latencies)],
         launches=launches, expected_launches=expected,
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


def bf16_curve_bars(kernel, plain, fp32, host):
    """Kernel 3b's loss curve over an epoch against the plain bf16 curve
    on the card: the largest distance between them must stay within
    BF16_WITNESS_SHARE of the largest distance between the plain bf16
    curve on the host (``host``) and on the card (``witness_bar``, the
    check). That holds the kernel's parting to that of two correct bf16
    versions, and still fails a member's learning rate doubled by 40x
    (``tools/bf16_curve_seeds.py``). ``gap_bar``, whether the distance
    stays within the plain bf16 curve's largest distance to the fp32 one,
    is reported only: it compares two maxima of one chaotic curve and
    failed a correct kernel (1 seed of 8, every step within its bars)."""
    apart = (kernel - plain).abs()
    out = {'curve': bf16_close('fused_train_bf16 loss curve', kernel, plain,
                               fp32, gate=False),
           'max_abs_diff': float(apart.max()),
           'gap_max': float((plain - fp32).abs().max()),
           'abs_diff_at_step': {k: float(apart[k - 1])
                                for k in (1, 16, 32, 64) if k <= len(apart)}}
    out['gap_bar'] = out['max_abs_diff'] <= out['gap_max']
    out['witness_max'] = float((host.to(plain.device) - plain).abs().max())
    out['witness_bar'] = (out['max_abs_diff']
                          <= BF16_WITNESS_SHARE * out['witness_max'])
    return out


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


def bf16_judge(name, reference16, reference32, pooled=None):
    """A ``serve`` judge for a model in bf16: each answer against
    ``reference16(x, call)`` (the plain bf16 function on the card), within
    the bf16 bars of its gap to ``reference32(x, call)`` (the same model's
    fp32 function); an output whose fp32 reference is None does not depend
    on the precision (KDE's and kNN-KDE's density scores) and is held to
    TOL_SCORE. Given a dict ``pooled``, each answer is held to the max bar
    alone and kept there per part, for ``bf16_pooled`` to hold the rms bar
    over every request of the run at once."""
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
            elif pooled is None:
                out[part] = bf16_close(label, got, want.cpu(), ref32.cpu())
            else:
                res = bf16_close(label, got, want.cpu(), ref32.cpu(),
                                 gate=False)
                check(res['max_abs_err'] <= res['bar_max'],
                      bf16_verdict(label, res))
                out[part] = res
                pooled.setdefault(part, []).append(
                    (got, want.cpu(), ref32.cpu()))
        return out
    return judge


def bf16_pooled(name, pooled):
    """The rms bar of ``bf16_close`` over every answer ``bf16_judge`` kept
    in ``pooled``, part by part."""
    return {part: bf16_close(f'{name} {part}, every request',
                             *(torch.cat(t) for t in zip(*kept)))
            for part, kept in pooled.items()}


def check_launches(name, launches, **expected):
    want = {k: expected.get(k, 0) for k in WRAPPERS}
    check(launches == want, f'{name}: launches {launches}, expected {want}')


def bo_config(data_path, trials, **uq):
    """``examples/bo_driven/config.yaml`` read by the port's YAML reader,
    its binomial_options tails split pointed at the tab-delimited
    ``data_path``, BO_EPOCHS epochs a trial and ``trials`` trials; ``uq``
    added to the ensemble's section (``eval_precision``). The rest of the
    trainer and training sections stay as committed: batch 128, lr 5e-5,
    clip 5, 1,000 steps an epoch, 100 validation batches, l1."""
    cfg = config_reader.load_path(BO_CONFIG)
    cfg['trainer']['max_epochs'] = BO_EPOCHS
    cfg['bo_config']['trials'] = trials
    datasets = cfg['benchmarks'][BO_BENCHMARK]['datasets']
    for split, percentiles in (('tails_id', '[0, 70]'),
                               ('tails_ood', '[70, 100]')):
        datasets[split] = {'format': 'character_delimited',
                           'path': data_path, 'delimiter': '\t',
                           'percentiles': percentiles, 'dtype': 'float32'}
    cfg['uq_methods'][BO_METHOD].update(uq)
    return cfg


def passes(n):
    """Kernel launches of one model call on ``n`` rows: one a chunk of up
    to 2^19 rows."""
    return -(-n // model_base._MAX_BUCKET)


def val_launches(n_val, batch, limit):
    """Kernel launches of one validation pass over the first ``limit``
    batches of ``batch`` rows of ``n_val`` rows: the full batches in one
    evaluation (one launch a chunk of up to 2^19 rows), a partial tail in
    one more."""
    nb = min(limit, -(-n_val // batch))
    full = min(nb, n_val // batch)
    return passes(full * batch) + (nb - full)


def bo_trial_launches(cfg, n_id, n_ood):
    """Kernel 1's launches in one trial of ``cfg`` on ``n_id`` ID and
    ``n_ood`` OOD rows: (the fit's validation passes, the evaluation's UE
    passes)."""
    batch = next(p['value'] for p in cfg['training']['parameter_space']
                 if p['name'] == 'batch_size')
    trainer = cfg['trainer']
    # a validation pass an epoch, the fit validating on the ID rows
    val = trainer['max_epochs'] * val_launches(
        n_id, batch, trainer['limit_val_batches'])
    n_all = n_id + n_ood
    # driver.evaluate: WARMUP passes on ID, one warm and TRIALS timed
    # passes each on combined, ID and OOD, then one on ID and one on OOD
    ue = (WARMUP * passes(n_id)
          + (1 + TRIALS) * (passes(n_all) + passes(n_id) + passes(n_ood))
          + passes(n_id) + passes(n_ood))
    return val, ue + metric_launches(get_uncertainty_evaluator(
        cfg['bo_config']['evaluation_metric']).metrics, n_id, n_ood)


def metric_launches(metrics, n_id, n_ood):
    """Kernel launches of the model calls that ``metrics`` make on ``n_id``
    ID and ``n_ood`` OOD rows: a timed metric's warm-up and timed passes
    over the combined rows, a score or classification metric one pass on
    each set, the memory metric one combined pass."""
    n_all = n_id + n_ood
    total = 0
    for metric in metrics:
        if isinstance(metric, RuntimeEvaluation):
            total += (metric.num_warmup + metric.num_trials) * passes(n_all)
        elif isinstance(metric, (UncertaintyEvaluationMetric,
                                 ClassificationMetric)):
            total += passes(n_id) + passes(n_ood)
        elif isinstance(metric, MaxMemoryUsageEvaluation):
            total += passes(n_all)
        else:
            raise ValueError(f'no launch count for {metric}')
    return total


def bo_run(label, cfg, out, restart, new_trials, n_id, n_ood, bf16=False):
    """One ``run_bo_experiment`` call of the BO trial phase, with every
    launch count and the native parser's read count set to 0 just before
    and read just after. Checks that the trials ``new_trials`` (and no
    other) ran: their files, the parser's three reads a trial (training,
    ID and OOD sets), kernel 3 once an epoch, kernel 1 once a validation
    pass (``val_launches``) and as often as the evaluation protocol implies (its bf16 form
    for the UE passes with ``bf16``, the fp32 form then only for
    validation), no other kernel, no failed row; emits each trial's times.
    Returns the rows of ``trial_results.csv`` by trial and the run's
    seconds."""
    reset_launches()
    load_delimited.native_reads = 0
    start = time.time()
    results = run_bo_experiment(BO_BENCHMARK, BO_METHOD, cfg, BO_SPLIT, out,
                                restart=restart)
    torch.cuda.synchronize()
    seconds = time.time() - start
    launches = read_launches()
    reads = load_delimited.native_reads
    trials = len(new_trials)
    check(reads == 3 * trials, f'bo_trial {label}: the native parser read '
                               f'{reads} files, expected {3 * trials}')
    val, ue = bo_trial_launches(cfg, n_id, n_ood)
    expected = {'fused_train': BO_EPOCHS * trials}
    if bf16:
        expected.update(fused_ensemble=val * trials,
                        fused_ensemble_bf16=ue * trials)
    else:
        expected['fused_ensemble'] = (val + ue) * trials
    check_launches(f'bo_trial {label}', launches, **expected)
    method_dir = os.path.join(out, BO_BENCHMARK, BO_SPLIT, BO_METHOD)
    check(sorted(os.listdir(method_dir)) == sorted(
        f'bo_trial_{k}' for k in range(new_trials[-1] + 1)),
        f'bo_trial {label}: trial directories {os.listdir(method_dir)}')
    last = os.path.join(method_dir, f'bo_trial_{new_trials[-1]}')
    check(os.path.isfile(os.path.join(last, 'pareto_parameters.json')),
          f'bo_trial {label}: no pareto_parameters.json in {last}')
    rows = {r['trial']: r for r in ResultsTable(
        os.path.join(last, 'trial_results.csv')).records()}
    check(sorted(rows) == sorted(results) == list(range(new_trials[-1] + 1)),
          f'bo_trial {label}: trials {sorted(rows)} recorded, '
          f'{sorted(results)} returned')
    done = start
    for k in new_trials:
        trial_dir = os.path.join(method_dir, f'bo_trial_{k}')
        missing = [f for f in BO_FILES
                   if not os.path.isfile(os.path.join(trial_dir, f))]
        check(not missing, f'bo_trial {label}: {trial_dir} lacks {missing}')
        row = rows[k]
        check(row['failed'] is False and row['platform'] == 'gpu',
              f'bo_trial {label}: trial {k} failed or ran off the card: '
              f'{row}')
        finished = os.stat(os.path.join(
            trial_dir, 'ax_client_optimization_step.json')).st_mtime
        emit('bo_trial', run=label, trial=k, num_models=row['num_models'],
             train_time_s=row['train_time'], ue_time_s=row['ue_time'],
             ue_throughput=row['ue_throughput'], wall_s=finished - done,
             id_time_s=row['id_time'], ood_time_s=row['ood_time'],
             percentile_score=row['percentile_score'],
             uncertainty_estimating_throughput=row[
                 'uncertainty_estimating_throughput'],
             max_memory_usage_mb=row.get('max_memory_usage'),
             id_loss=row['id_loss'], ood_loss=row['ood_loss'])
        done = finished
    emit('bo_trial_run', run=label, trials=list(new_trials), seconds=seconds,
         launches=launches, expected_launches={k: v for k, v in
                                               expected.items()},
         native_reads=reads, id_rows=n_id, ood_rows=n_ood)
    return rows, seconds


def bo_data(cfg):
    """The ID and OOD sets of ``cfg``'s tails split, scaled as the driver
    scales them (OOD by the ID statistics)."""
    datasets = cfg['benchmarks'][BO_BENCHMARK]['datasets']
    dset_id = get_dataset(datasets, BO_SPLIT)
    dset_ood = prepare_dataset_for_use(
        get_dataset(datasets, BO_SPLIT, is_ood=True), cfg['training'],
        scaling_dset=dset_id)
    return prepare_dataset_for_use(dset_id, cfg['training']), dset_ood


def bo_trial_phase(seed):
    """The system's main path on the card: ``run_bo_experiment`` of the
    flagship ensemble on binomial_options (``datagen`` at BO_ROWS rows
    from ``seed``, written tab-delimited), BO_TRIALS trials, then a
    restart to BO_RESTART_TRIALS that must run the last trial only, then
    one trial with ``eval_precision: 'bf16-mixed'``. The first trial's
    recorded ``percentile_score`` must match the one recomputed from its
    reloaded bundle's UEs through kernel 1's plain version on the card,
    within TOL_STD; the bf16 trial's bundle is measured by the config's
    post-hoc ``max_memory_usage`` metric (the BO metrics do not take
    it); then one trial with ``whole_fit: true``. Returns the ID set's
    scaled rows ``(x, y)``."""
    os.makedirs(BO_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BO_DIR,
                                     prefix='chip_smoke_bo-') as tmp:
        start = time.time()
        ipt, opt = datagen.generate_binomial_options(BO_ROWS, seed=seed)
        data_path = os.path.join(tmp, 'binomial_options.tsv')
        datagen.write_delimited(data_path, ipt, opt, '\t')
        data_s = time.time() - start
        cfg = bo_config(data_path, BO_TRIALS)
        dset_id, dset_ood = bo_data(cfg)
        n_id, n_ood = len(dset_id), len(dset_ood)
        out = os.path.join(tmp, 'results')
        rows, fresh_s = bo_run('fresh', cfg, out, False,
                               list(range(BO_TRIALS)), n_id, n_ood)
        method_dir = os.path.join(out, BO_BENCHMARK, BO_SPLIT, BO_METHOD)

        def stamps():
            return {k: os.stat(os.path.join(method_dir, f'bo_trial_{k}', f))
                    .st_mtime_ns for k in range(BO_TRIALS) for f in BO_FILES}
        before = stamps()
        rows3, restart_s = bo_run(
            'restart', bo_config(data_path, BO_RESTART_TRIALS), out, True,
            list(range(BO_TRIALS, BO_RESTART_TRIALS)), n_id, n_ood)
        check(stamps() == before, 'bo_trial restart: an earlier trial\'s '
                                  'files were written again')
        check(all(json.dumps(rows3[k], sort_keys=True)
                  == json.dumps(rows[k], sort_keys=True) for k in rows),
              'bo_trial restart: the earlier trials\' rows changed')

        # the recorded percentile_score against the reloaded bundle's UEs
        # through kernel 1's plain version on the card
        bundle = load_model(os.path.join(method_dir, 'bo_trial_0',
                                         'model.pth'), device=DEVICE)
        x_id = torch.as_tensor(np.asarray(dset_id.input), device=DEVICE)
        with torch.no_grad():
            _, std = fused_forward_plain(prepare_fused_weights(bundle.net),
                                         x_id)
        percentile = next(m['percentile'] for m in
                          cfg['bo_config']['evaluation_metric']
                          if m['name'] == 'percentile_score')
        want = float(np.percentile(std.cpu().numpy(), percentile))
        got = rows[0]['percentile_score']
        score_err = abs(got - want)
        check(score_err <= TOL_STD['atol'] + TOL_STD['rtol'] * abs(want),
              f'bo_trial: trial 0 recorded percentile_score {got}, the '
              f'plain version gives {want} (tolerance {TOL_STD})')
        del bundle, x_id, std

        # one trial's UE passes in bf16-mixed (training stays fp32)
        out16 = os.path.join(tmp, 'results_bf16')
        _, bf16_s = bo_run('bf16_eval', bo_config(
            data_path, 1, eval_precision='bf16-mixed'), out16, False, [0],
            n_id, n_ood, bf16=True)
        # the config's post-hoc memory metric on that trial's bundle, in
        # bf16-mixed: one pass over the combined rows
        bundle = load_model(os.path.join(out16, BO_BENCHMARK, BO_SPLIT,
                                         BO_METHOD, 'bo_trial_0',
                                         'model.pth'), device=DEVICE)
        bundle.set_precision('bf16-mixed')
        memory = get_evaluator([m for m in cfg['evaluation']['metrics']
                                if m['name'] == 'max_memory_usage'])
        check(len(memory.metrics) == 1,
              f'{BO_CONFIG} configures no max_memory_usage metric')
        reset_launches()
        memory_mb = memory.evaluate(
            bundle, (dset_id.input, dset_id.output),
            (dset_ood.input, dset_ood.output))['max_memory_usage']
        check_launches('bo_trial max_memory_usage', read_launches(),
                       fused_ensemble_bf16=passes(n_id + n_ood))
        card_mb = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
        check(0 < memory_mb < card_mb,
              f'bo_trial bf16_eval: max_memory_usage {memory_mb} MB, the '
              f'card holds {card_mb} MB')
        # one trial with whole_fit true through the driver: every epoch of
        # the fit in one dispatch
        cfg_whole = bo_config(data_path, 1)
        cfg_whole['trainer']['whole_fit'] = True
        _, whole_s = bo_run('whole_fit', cfg_whole,
                            os.path.join(tmp, 'results_whole_fit'), False,
                            [0], n_id, n_ood)
        # the post-hoc tools on the fp32 tree, before it is deleted
        posthoc_phase(tmp, bo_config(data_path, BO_RESTART_TRIALS), out,
                      dset_id, dset_ood)
    emit('bo_trial_summary', rows=BO_ROWS, epochs=BO_EPOCHS,
         data_s=data_s, fresh_s=fresh_s, restart_s=restart_s, bf16_s=bf16_s,
         whole_fit_s=whole_s,
         percentile_score=got, percentile_score_plain=want,
         percentile_score_abs_err=score_err, tol=TOL_STD,
         max_memory_usage_mb=memory_mb, card_mb=card_mb,
         seconds=time.time() - start)
    return (np.asarray(dset_id.input, dtype=np.float32),
            np.asarray(dset_id.output, dtype=np.float32))


class SyncCheckedTrainer(Trainer):
    """The port's ``Trainer`` with its whole-fit dispatch's epochs enqueued
    under ``torch.cuda.set_sync_debug_mode('error')``: any operation there
    that waits for the card raises. The dispatch's stated check point, its
    one wait after the last epoch is enqueued, lies outside."""

    def _enqueue_whole_fit(self, enqueue, poll, e0):
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        try:
            return super()._enqueue_whole_fit(enqueue, poll, e0)
        finally:
            torch.cuda.set_sync_debug_mode(previous)


def whole_fit_run(name, model, x, y, epochs, seed, whole, callbacks=None,
                  **config):
    """``Trainer.fit`` (:class:`SyncCheckedTrainer`) of ``model`` on the
    first TRAIN_SPLIT rows of ``x``, validated on the next ones, with
    ``whole_fit: whole`` and every step's loss logged; launch counts set to
    0 just before and read just after. Returns (trainer, checkpoint
    callback, launches, seconds, metrics rows)."""
    train_dl = DataLoader(ArrayDataset(x[:TRAIN_SPLIT], y[:TRAIN_SPLIT]),
                          TRAIN_BATCH, shuffle=True, drop_last=True)
    val_dl = DataLoader(ArrayDataset(x[TRAIN_SPLIT:], y[TRAIN_SPLIT:]),
                        TRAIN_BATCH)
    saver = ModelSavingCallback(defer_serialization=True)
    trainer = SyncCheckedTrainer(
        name, {**TRAIN_CONFIG, 'max_epochs': epochs, 'seed': seed,
               'whole_fit': whole, 'log_every_n_steps': 1, **config},
        callbacks=(callbacks or [EarlyStopping()]) + [saver]
        + model.get_callbacks(),
        log_dir=WHOLE_FIT_DIR,
        version=f'{name}_' + ('whole' if whole else 'per_epoch'),
        device=DEVICE)
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.fit(model, train_dl, val_dl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    with open(os.path.join(trainer.logger.log_dir, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    return trainer, saver, read_launches(), seconds, rows


def whole_fit_case(name, make, x, y, epochs, seed, kernel, val_kernel,
                   callbacks=None, **config):
    """One case of the whole-fit phase: the fit with ``whole_fit`` true
    (one dispatch, its epochs enqueued with sync debugging on) and false
    (an epoch at a time) from the same seeded model. The two must leave
    theta, m, v and sigma, every step's loss, the stop epoch, the pinned
    best bundle and the validation losses (the best one too) bit for bit
    equal: both paths take the mean through one reduction
    (``weighted_mean``).
    The whole fit launches ``kernel`` once for each epoch that
    trained and ``val_kernel`` once a validation pass (its 100 full
    batches in one launch) of each epoch it enqueued. Returns both fits'
    readings."""
    fits = {}
    for whole in (False, True):
        fits[whole] = whole_fit_run(name, make(), x, y, epochs, seed, whole,
                                    callbacks=callbacks() if callbacks
                                    else None, **config)
    (tw, sw, lw, secw, rw), (te, se, le, sece, re_) = fits[True], fits[False]
    check(tw.whole_fit_dispatches == 1 and te.whole_fit_dispatches == 0,
          f'{name}: whole_fit_dispatches {tw.whole_fit_dispatches}, '
          f'{te.whole_fit_dispatches}')
    check(tw.fused_epochs_used == te.fused_epochs_used,
          f'{name}: {tw.fused_epochs_used} kernel epochs whole, '
          f'{te.fused_epochs_used} per epoch')
    for part, a, b in zip(('theta', 'm', 'v', 'sigma'), tw.fused_buffers,
                          te.fused_buffers):
        check(torch.equal(a, b), f'{name}: {part} differs between the '
                                 'whole fit and the per-epoch fit')
    check([(r['epoch'], r['step'], r['train_loss']) for r in rw]
          == [(r['epoch'], r['step'], r['train_loss']) for r in re_],
          f'{name}: the logged step losses differ')
    vw, ve = ([float(r['val_loss']) for r in rows if r['val_loss']]
              for rows in (rw, re_))
    check(vw == ve, f'{name}: validation losses {vw} against {ve}')
    check(tw.current_epoch == te.current_epoch
          and tw.should_stop == te.should_stop,
          f'{name}: stopped after epoch {tw.current_epoch} whole, '
          f'{te.current_epoch} per epoch')
    check(sw.best == se.best and all(
        torch.equal(a, b) for a, b in zip(sw._pinned.values(),
                                          se._pinned.values())),
          f'{name}: the pinned best differs')
    trained = tw.fused_epochs_used
    lost = tw.whole_fit_epochs_lost
    # one launch a validation pass (TRAIN_CONFIG's 100 full batches)
    val_pass = val_launches(len(x) - TRAIN_SPLIT, TRAIN_BATCH,
                            TRAIN_CONFIG['limit_val_batches'])
    check(lw[kernel] == le[kernel] == trained,
          f'{name}: {kernel} launched {lw[kernel]} times whole, '
          f'{le[kernel]} per epoch, {trained} epochs trained')
    check(lw[val_kernel] == (trained + lost) * val_pass
          + (le[val_kernel] - trained * val_pass),
          f'{name}: {val_kernel} launched {lw[val_kernel]} times whole, '
          f'{le[val_kernel]} per epoch ({lost} epochs enqueued past the '
          'stop)')
    first = epochs - trained
    emit('whole_fit', case=name, epochs=epochs, epochs_trained=trained,
         per_step_epochs=first, stopped_after=tw.current_epoch,
         epochs_lost=lost, launches_whole=lw, launches_per_epoch=le,
         val_losses=vw, best_val_loss=sw.best,
         seconds_whole=secw, seconds_per_epoch_path=sece,
         whole_fit_seconds=tw.whole_fit_seconds)
    return fits


def validation_ms(model, x, y):
    """CUDA-event and host times of one validation pass of ``model`` as the
    trainer runs it (TRAIN_CONFIG's 100 batches of 128 rows after
    TRAIN_SPLIT, the float64 mean on the card): every batch in one
    evaluation (``Trainer._val_losses``, one kernel launch), and one
    ``validation_loss`` call a batch as the trainer ran them before, whose
    mean it must match within TOL_VAL_LOSS_REL."""
    nb = TRAIN_CONFIG['limit_val_batches']
    rows = nb * TRAIN_BATCH
    x_val = torch.as_tensor(x[TRAIN_SPLIT:TRAIN_SPLIT + rows], device=DEVICE)
    y_val = torch.as_tensor(y[TRAIN_SPLIT:TRAIN_SPLIT + rows], device=DEVICE)
    probe = Trainer('probe', {}, log_dir=WHOLE_FIT_DIR, device=DEVICE)
    weights = probe._val_weights(x_val, TRAIN_BATCH, nb)

    def batched():
        return weighted_mean(probe._val_losses(
            model, x_val, y_val, TRAIN_BATCH, nb, 0), weights)

    def per_batch():
        return weighted_mean(torch.stack([
            model.validation_loss((x_val[lo:hi], y_val[lo:hi]),
                                  seed=probe._val_seed(0, b))
            for b, (lo, hi) in enumerate(probe._val_bounds(
                rows, TRAIN_BATCH, nb))]), weights)
    got, want = float(batched()), float(per_batch())
    check(abs(got - want) <= TOL_VAL_LOSS_REL * abs(want),
          f'validation: the batched pass gave {got}, the per-batch one '
          f'{want}')
    return {name: dict(event_ms(fn, warmup=2, trials=5),
                       host_ms=host_ms(fn))
            for name, fn in (('batched', batched), ('per_batch', per_batch))}


def host_ms(fn, trials=5):
    """Median host milliseconds to enqueue ``fn`` from an idle card."""
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def validation_kernel(model):
    """``(kernel name, call)``: the kernel a model's validation runs and
    its wrapper's call ``call(x, seed=0, seeds=None, batch=1)`` on rows
    ``x``, drawn with ``seed`` or the seed table ``seeds`` (one seed a
    ``batch`` rows; the MC kernels' only)."""
    bf16 = model.net.compute_dtype == torch.bfloat16
    if model.uq_method == 'mc_dropout':
        mw = model.mc_weights()
        return BF16_OF['fused_mc_dropout'] if bf16 else 'fused_mc_dropout', \
            lambda x, seed=0, seeds=None, batch=1: fused_mc_forward(
                mw, x, model.num_samples, seed, 0, seeds, batch)
    if model.uq_method == 'delta_uq':
        aw = model.anchored_weights()
        return BF16_OF['fused_anchored'] if bf16 else 'fused_anchored', \
            lambda x, seed=0, seeds=None, batch=1: fused_anchored_stats(
                aw, x, model.anchors, model._val_anchors())
    fw = model.fused_weights()
    return BF16_OF['fused_ensemble'] if bf16 else 'fused_ensemble', \
        lambda x, seed=0, seeds=None, batch=1: fused_forward_prefolded(fw, x)


def validation_work(model, rows, card):
    """``bound(...)``'s arguments for one call of a model's validation
    kernel on ``rows`` rows, counted by pipe: the products over their peak
    (bf16; the fp32 kernels 1, 2 and 5 three TF32 products for each, at
    the TF32 peak, half the bf16 one), the MC kernels' mask hashes on the
    integer pipes, each input read and each output written once."""
    bf16 = model.net.compute_dtype == torch.bfloat16
    tf32 = not bf16
    peak = card['peak_bf16'] / 2 if tf32 else \
        card['peak_bf16'] if bf16 else card['peak_flops']
    if model.uq_method == 'mc_dropout':
        w = model.mc_weights()
        # the bf16 form runs a dropout-free shift pass, the fp32 one none
        passes = model.num_samples + (1 if bf16 else 0)
        flops = 2.0 * rows * passes * w.macs_per_row
        extra = 0
    elif model.uq_method == 'delta_uq':
        w = model.anchored_weights()
        anchors = model._val_anchors()
        flops = 2.0 * rows * (w.macs_once + anchors * w.macs_per_anchor)
        extra = anchors * WIDTH
    else:
        w = model.fused_weights()
        flops = 2.0 * rows * w.num_members * w.macs_per_row
        extra = 0
    if tf32:
        flops *= 3
    moved = 4.0 * (rows * IN_DIM + w.b_all.numel() + 2 * rows * w.out_dim
                   + extra) + w.w_all.element_size() * w.w_all.numel()
    exps, rate = 0, 1.0
    if model.uq_method == 'mc_dropout':
        masked = sum(IN_DIM if layer == 0 else WIDTH
                     for layer, t in enumerate(w.thresholds) if t >= 0)
        exps, rate = rows * model.num_samples * masked, card['hash_rate']
    return flops, moved, peak, card['peak_bytes'], exps, rate


def validation_library(model, x):
    """The one PyTorch call chain that computes a validation kernel's
    function on ``x`` (yardstick only): kernel 1's ``baddbmm`` chain,
    kernel 5's ``addmm`` chain over the anchored rows; None for kernel 2
    (no PyTorch call draws the hash masks)."""
    if model.uq_method == 'mc_dropout':
        return None
    if model.uq_method == 'delta_uq':
        aw = model.anchored_weights()
        anchors = model.anchors[:model._val_anchors()]
        return lambda: anchored_library(aw, x, anchors)
    fw = model.fused_weights()
    return lambda: library_chain(fw, x)


def validation_case(case, model, xs, ys, seeds):
    """One validation pass of ``model`` over the batches ``xs`` (``(nb, bs,
    in)``, targets ``ys``): its outputs from one launch of the model's
    kernel (``validation_output`` over every row, the seed table for MC
    dropout) must equal, bit for bit, the outputs of one launch a batch as
    the trainer ran them before (``mc_stats`` with the batch's seed, row 0
    on; the evaluation path); the batched losses must match the per-batch
    ``validation_loss`` within TOL_VAL_LOSS_REL. Launch counts are set to 0
    before each side and read after: one launch against ``nb``."""
    nb, bs = xs.shape[:2]
    x = xs.reshape(nb * bs, -1)
    kernel, _ = validation_kernel(model)
    mc = model.uq_method == 'mc_dropout'
    with torch.no_grad():
        reset_launches()
        batched = model.validation_output(x, 0, seeds, bs)
        torch.cuda.synchronize()
        one = read_launches()
        reset_launches()
        per = torch.cat([model.mc_stats(xs[b], seeds[b])[0] if mc
                         else model.validation_output(xs[b])
                         for b in range(nb)])
        torch.cuda.synchronize()
        many = read_launches()
    check_launches(f'validation {case} batched', one, **{kernel: 1})
    check_launches(f'validation {case} per batch', many, **{kernel: nb})
    check(torch.equal(batched, per),
          f'validation {case}: the batched launch differs from the per-batch '
          f'launches by up to {float((batched - per).abs().max())}')
    losses = model.validation_losses(xs, ys, seeds)
    want = torch.stack([model.validation_loss((xs[b], ys[b]), seed=seeds[b])
                        for b in range(nb)])
    rel = float(((losses - want).abs() / want.abs()).max())
    check(rel <= TOL_VAL_LOSS_REL,
          f'validation {case}: batched losses {rel} relative from the '
          'per-batch losses')
    return {'batches': nb, 'batch_rows': bs, 'kernel': kernel,
            'launches_batched': one[kernel], 'launches_per_batch': many[kernel],
            'outputs_bit_for_bit': True, 'loss_max_rel_err': rel}


def validation_phase(seed, card):
    """The trainer's validation pass at the flagship trial's shape through
    each of kernels 1, 1b, 2, 2b, 5 and 5b: the batched pass against the
    per-batch launches (:func:`validation_case`), kernels 2 and 2b also at
    VAL_RAGGED_BATCH rows a batch and held to their plain versions with
    the seed table; then, at the validation shape, each kernel's time on
    one 128-row batch, on the batched pass and on the pass one batch after
    another, its bound on a batch and on the pass, and the PyTorch
    yardstick at both. Returns the readings by kernel name."""
    phase_start = time.perf_counter()
    gen = np.random.default_rng(seed + VAL_SEED)
    nb = TRAIN_CONFIG['limit_val_batches']
    probe = Trainer('probe', {}, log_dir=WHOLE_FIT_DIR, device=DEVICE)
    seeds = [probe._val_seed(0, b) for b in range(nb)]

    def batches(bs):
        x = gen.normal(size=(nb * bs, IN_DIM)).astype(np.float32)
        xs = torch.as_tensor(x, device=DEVICE).reshape(nb, bs, IN_DIM)
        return xs, torch.as_tensor(smooth_target(x),
                                   device=DEVICE).reshape(nb, bs, 1)

    def models(precision):
        out = [build_model(seed), build_mc(seed),
               build_anchored(DeltaUQMLPModelBuilder, seed)]
        for m in out:
            m.set_precision(precision)
        return out

    xs, ys = batches(TRAIN_BATCH)
    xr, yr = batches(VAL_RAGGED_BATCH)
    x_pass = xs.reshape(-1, IN_DIM)
    x_batch = x_pass[:TRAIN_BATCH].contiguous()
    out = {}
    for precision in ('32-true', 'bf16-mixed'):
        fp32 = models('32-true') if precision != '32-true' else None
        for i, model in enumerate(models(precision)):
            kernel, call = validation_kernel(model)
            reading = validation_case(kernel, model, xs, ys, seeds)
            if model.uq_method == 'mc_dropout':
                reading['ragged'] = validation_case(
                    f'{kernel} batch {VAL_RAGGED_BATCH}', model, xr, yr,
                    seeds)
                # the seed table against the plain version with it
                mw = model.mc_weights()
                for x_t, bs in ((x_pass, TRAIN_BATCH),
                                (xr.reshape(-1, IN_DIM), VAL_RAGGED_BATCH)):
                    got = call(x_t, 0, seeds, bs)
                    want = fused_mc_forward_plain(mw, x_t, model.num_samples,
                                                  0, 0, seeds, bs)
                    name = f'{kernel} seed table batch {bs}'
                    if fp32 is None:
                        errs = {part: compare(f'{name} {part}', g, w, tol)
                                for part, g, w, tol in zip(
                                    ('mean', 'std'), got, want,
                                    (TOL_MEAN, TOL_STD))}
                    else:
                        ref = fused_mc_forward_plain(
                            fp32[i].mc_weights(), x_t, model.num_samples, 0,
                            0, seeds, bs)
                        errs = {part: bf16_close(f'{name} {part}', g, w, r)
                                for part, g, w, r in zip(('mean', 'std'),
                                                         got, want, ref)}
                    emit('kernel_vs_plain', kernel=kernel,
                         case=f'seed_table_batch_{bs}', rows=x_t.shape[0],
                         max_abs_err=errs)
            pass_t = event_ms(lambda: call(x_pass, 0, seeds, TRAIN_BATCH))
            batch_t = event_ms(lambda: call(x_batch, seeds[0]))
            serial_t = event_ms(lambda: [call(xs[b], seeds[b])
                                         for b in range(nb)],
                                warmup=1, trials=3)
            reading.update(
                batch_ms=batch_t, pass_ms=pass_t, per_batch_pass_ms=serial_t,
                launches_per_epoch_before=reading['launches_per_batch'],
                launches_per_epoch_after=reading['launches_batched'])
            for shape, rows, x_t in (('batch', TRAIN_BATCH, x_batch),
                                     ('pass', nb * TRAIN_BATCH, x_pass)):
                bound_ms, bound_by = bound(*validation_work(model, rows, card))
                lib = validation_library(model, x_t)
                reading[f'bound_ms_{shape}'] = bound_ms
                reading[f'bound_by_{shape}'] = bound_by
                reading[f'library_ms_{shape}'] = None if lib is None \
                    else event_ms(lib)['median_ms']
            reading['pass_share_of_bound'] = (reading['bound_ms_pass']
                                              / pass_t['median_ms'])
            emit('validation', precision=precision, rows=nb * TRAIN_BATCH,
                 **reading)
            out[kernel] = reading
    emit('validation_summary', kernels=sorted(out),
         nvidia_smi=nvidia_smi('name,power.limit'),
         seconds=time.perf_counter() - phase_start)
    return out


def whole_fit_phase(seed, x, y, kernel_ms):
    """Whole-fit dispatch on the card (``Trainer`` ``whole_fit``): every
    case against the same fit an epoch at a time, bit for bit, with no
    sync inside the dispatch. ``x``, ``y``: the bo_trial phase's ID rows;
    ``kernel_ms``: kernels 3 and 3b's epoch times of the timing phase.
    Prints seconds an epoch both ways beside the kernel's, the time a stop
    loses and the dispatch's fixed host cost."""
    phase_start = time.perf_counter()
    shutil.rmtree(WHOLE_FIT_DIR, ignore_errors=True)
    check(len(x) >= TRAIN_SPLIT + TRAIN_CONFIG['limit_val_batches']
          * TRAIN_BATCH, f'whole_fit: {len(x)} rows are too few')

    def flagship(builder=EnsembleModelBuilder, descr=FLAGSHIP, uq=None,
                 **train):
        return lambda: builder(descr, uq or {'num_models': MEMBERS},
                               train_config=dict(TRAIN_MODEL_CONFIG, **train),
                               seed=seed, device=DEVICE).build()

    timing = {}
    for precision, kernel, val_kernel in (
            ('32-true', 'fused_train', 'fused_ensemble'),
            ('bf16-mixed', 'fused_train_bf16', 'fused_ensemble_bf16')):
        fits = whole_fit_case(f'flagship_{precision}', flagship(), x, y,
                              WHOLE_FIT_EPOCHS, seed, kernel, val_kernel,
                              precision=precision)
        # seconds an epoch as a fit of 6 epochs less one of 2 (a fit's
        # fixed costs cancel), after the case's fits warmed both paths
        seconds = {}
        for epochs in (2, WHOLE_FIT_EPOCHS):
            for whole in (False, True):
                seconds[epochs, whole] = whole_fit_run(
                    f'time_{precision}', flagship()(), x, y, epochs, seed,
                    whole, precision=precision)[3]
        marginal = {whole: (seconds[WHOLE_FIT_EPOCHS, whole]
                            - seconds[2, whole]) / (WHOLE_FIT_EPOCHS - 2)
                    for whole in (False, True)}
        model = flagship()()
        model.set_precision(precision)
        timing[precision] = {
            'seconds_per_epoch_whole': marginal[True],
            'seconds_per_epoch_per_epoch_path': marginal[False],
            'saving_per_epoch_s': marginal[False] - marginal[True],
            'fit_seconds': {f'{e}_{"whole" if w else "per_epoch"}': t
                            for (e, w), t in seconds.items()},
            'kernel_epoch_ms': kernel_ms[kernel],
            'validation_pass_ms': validation_ms(model, x, y),
            'dispatch_setup_s': fits[True][0].whole_fit_seconds['setup'],
            'whole_fit_seconds': fits[True][0].whole_fit_seconds}

    # early stop: no epoch beats a min_delta of 1e6, patience 1 stops the
    # fit after epoch 1; the epochs enqueued past it change nothing
    stop_fits = whole_fit_case(
        'early_stop', flagship(), x, y, WHOLE_FIT_STOP_EPOCHS, seed,
        'fused_train', 'fused_ensemble',
        callbacks=lambda: [EarlyStopping(min_delta=1e6, patience=1)],
        limit_train_batches=WHOLE_FIT_SHORT_STEPS)
    check(stop_fits[True][0].current_epoch == 1,
          f'early_stop: stopped after epoch '
          f'{stop_fits[True][0].current_epoch}, expected 1')

    # plateau: at lr 1e-9 no epoch improves on epoch 0 by the scheduler's
    # threshold, so the scale drops after epoch 11 and epochs 12 and 13
    # train at 0.1x (the whole fit reads its learning rate on the card)
    one_linear = [{'Linear': {'args': [IN_DIM, 1]}}]
    plateau = whole_fit_case(
        'plateau', flagship(descr=one_linear,
                            learning_rate=WHOLE_FIT_PLATEAU_LR),
        x, y, WHOLE_FIT_PLATEAU_EPOCHS, seed, 'fused_train',
        'fused_ensemble', callbacks=lambda: [EarlyStopping(patience=100)],
        limit_train_batches=WHOLE_FIT_SHORT_STEPS)
    scales = [1.0] * 12 + [0.1] * (WHOLE_FIT_PLATEAU_EPOCHS - 12)
    check(plateau[True][0].lr_scales == plateau[False][0].lr_scales
          == scales, f'plateau: scales {plateau[True][0].lr_scales} whole, '
                     f'{plateau[False][0].lr_scales} per epoch, expected '
                     f'{scales}')

    # Δ-UQ (epoch 0 step by step while the hook captures 229 anchors) and
    # MC dropout
    whole_fit_case('delta_uq', flagship(
        DeltaUQMLPModelBuilder, uq={'num_anchors': ANCHORS,
                                    'anchored_batch_size': ANCHORS}),
        x, y, WHOLE_FIT_FAMILY_EPOCHS, seed, 'fused_train',
        'fused_anchored', limit_train_batches=WHOLE_FIT_ANCHORED_STEPS)
    whole_fit_case('mc_dropout', flagship(
        MCDropoutModelBuilder, uq={'num_samples': MC_SAMPLES,
                                   'dropout_percent': MC_P}),
        x, y, WHOLE_FIT_FAMILY_EPOCHS, seed, 'fused_train',
        'fused_mc_dropout')

    # what a stop costs: the epochs enqueued past it, each a stopped
    # kernel epoch (its launches return at once) and a validation pass
    model = flagship()()
    plan = train_plan(model)
    bufs, xs, ys = train_inputs(model, plan, np.random.default_rng(seed),
                                EPOCH_STEPS)
    lr_dev = torch.full((1,), TRAIN_MODEL_CONFIG['learning_rate'],
                        dtype=torch.float32, device=DEVICE)
    stopped = torch.ones(1, dtype=torch.int32, device=DEVICE)
    before = [b.clone() for b in bufs]
    stopped_t = event_ms(lambda: ft.fused_epoch(plan, *bufs, xs, ys, lr_dev,
                                                0, stop=stopped))
    check(all(torch.equal(a, b) for a, b in zip(bufs, before)),
          'a stopped kernel epoch changed its buffers')
    val_t = timing['32-true']['validation_pass_ms']['batched']
    lost = stop_fits[True][0].whole_fit_epochs_lost
    stop_ms = lost * (stopped_t['median_ms'] + val_t['median_ms'])
    # 'auto' engages whenever a fit is eligible: a dispatch's host set-up
    # must stay under an fp32 epoch's saving
    setup_ms = timing['32-true']['dispatch_setup_s'] * 1e3
    saving_ms = timing['32-true']['saving_per_epoch_s'] * 1e3
    emit('whole_fit_summary', timing=timing,
         epochs_lost_after_stop=lost,
         stopped_kernel_epoch_ms=stopped_t,
         validation_pass_ms=val_t,
         auto_setup_ms=setup_ms, auto_saving_ms_per_epoch=saving_ms,
         auto_setup_under_one_epochs_saving=setup_ms < saving_ms,
         stop_loses_ms=stop_ms,
         stop_loses_note='epochs enqueued past the stop x (a stopped '
                         f'{EPOCH_STEPS}-step kernel epoch + a validation '
                         'pass); the early_stop case ran '
                         f'{WHOLE_FIT_SHORT_STEPS}-step epochs',
         nvidia_smi=nvidia_smi('name,power.limit'),
         seconds=time.perf_counter() - phase_start)


def plain_stds(bundle_path, xs):
    """The UE (std) of the bundle at ``bundle_path`` on each of ``xs``
    through kernel 1's plain version on the card, as numpy arrays."""
    fw = prepare_fused_weights(load_model(bundle_path, device=DEVICE).net)
    with torch.no_grad():
        return [fused_forward_plain(fw, torch.as_tensor(
            np.asarray(x), device=DEVICE))[1].cpu().numpy() for x in xs]


def close_to(name, got, want, tol=TOL_STD):
    err = abs(got - want)
    check(err <= tol['atol'] + tol['rtol'] * abs(want),
          f'{name}: {got} against {want} from the plain version '
          f'(tolerance {tol})')
    return err


def posthoc_phase(tmp, cfg, out, dset_id, dset_ood):
    """The port's post-hoc tools on the BO trial phase's results tree
    ``out`` (trained under ``cfg``, written to ``tmp/config.yaml`` by the
    port's config writer): ``evaluate_metrics`` with the config's
    ``evaluation.metrics`` on the Pareto trials, kernel 1 launched exactly
    as the metrics imply, every classification metric recomputed from the
    trial bundle's UEs through kernel 1's plain version on the card within
    TOL_STD; ``classify_posthoc`` (no plots) on every trial, held the same
    way, with its ``ue_dist`` the recorded ``percentile_score``;
    ``collate``'s ``summary.csv`` against the tree's ``trial_results.csv``;
    and ``metric_eval_driver`` with one task, whose combined rows must
    equal the direct run's but for the timed and memory metrics."""
    start = time.time()
    cfg_path = os.path.join(tmp, 'config.yaml')
    with open(cfg_path, 'w') as f:
        config_reader.dump(cfg, f)
    check(config_reader.load_path(cfg_path) == cfg,
          'posthoc: the written config does not read back as written')
    evaluator = get_evaluator(cfg['evaluation']['metrics'])
    n_id, n_ood = len(dset_id), len(dset_ood)
    x_id, x_ood = np.asarray(dset_id.input), np.asarray(dset_ood.input)
    method_dir = os.path.join(out, BO_BENCHMARK, BO_SPLIT, BO_METHOD)
    times = {}

    direct = os.path.join(tmp, 'evaluated_metrics.csv')
    reset_launches()
    t0 = time.time()
    evaluate_metrics.evaluate_metrics(out, cfg_path, output=direct,
                                      device=DEVICE)
    torch.cuda.synchronize()
    times['evaluate_metrics_s'] = time.time() - t0
    rows = ResultsTable(direct).records()
    check(all(r['metric'] != 'FAILED' for r in rows),
          f'posthoc evaluate_metrics: FAILED rows {rows}')
    trials = sorted({r['trial'] for r in rows})
    check(trials, 'posthoc evaluate_metrics: no trial evaluated')
    launches = {'evaluate_metrics': len(trials) * metric_launches(
        evaluator.metrics, n_id, n_ood)}
    check_launches('posthoc evaluate_metrics', read_launches(),
                   fused_ensemble=launches['evaluate_metrics'])
    value = {(r['trial'], r['metric'], r['objective']): r['value']
             for r in rows}
    errs = {}
    stds = {}
    for trial in os.listdir(method_dir):
        stds[trial] = plain_stds(os.path.join(method_dir, trial,
                                              'model.pth'), (x_id, x_ood))
    for trial in trials:
        for metric in evaluator.metrics:
            if not isinstance(metric, ClassificationMetric):
                continue
            for objective, want in metric._evaluate_scores(
                    *stds[trial]).items():
                key = (trial, metric.get_name(), objective)
                errs[' '.join(key)] = close_to(f'posthoc {key}', value[key],
                                               want)

    classified = os.path.join(tmp, 'classified')
    reset_launches()
    t0 = time.time()
    cls_rows = classify_posthoc.classify(out, cfg, classified, device=DEVICE,
                                         plots=False)
    torch.cuda.synchronize()
    times['classify_posthoc_s'] = time.time() - t0
    check(len(cls_rows) == len(stds),
          f'posthoc classify: {len(cls_rows)} rows for {len(stds)} trials')
    launches['classify_posthoc'] = len(cls_rows) * (passes(n_id)
                                                    + passes(n_ood))
    check_launches('posthoc classify', read_launches(),
                   fused_ensemble=launches['classify_posthoc'])
    recorded = {r['trial']: r for r in ResultsTable(os.path.join(
        method_dir, f'bo_trial_{BO_RESTART_TRIALS - 1}',
        'trial_results.csv')).records()}
    classifier = PercentileBasedIdOodClassifier(0.8)
    for row in ResultsTable(os.path.join(classified,
                                         'classification.csv')).records():
        want = classifier._evaluate_scores(*stds[f'bo_trial_{row["trial"]}'])
        for k in ('sensitivity', 'specificity'):
            errs[f'classify bo_trial_{row["trial"]} {k}'] = close_to(
                f'posthoc classify trial {row["trial"]} {k}', row[k], want[k])
        check(row['ue_dist'] == recorded[row['trial']]['percentile_score'],
              f'posthoc classify: trial {row["trial"]} ue_dist '
              f'{row["ue_dist"]} is not its recorded percentile_score')

    collated = os.path.join(tmp, 'collated')
    t0 = time.time()
    check(collate.main(['--input', out, '--output', collated,
                        '--no_plots']) == 0, 'posthoc collate failed')
    times['collate_s'] = time.time() - t0
    summary = ResultsTable(os.path.join(collated, 'summary.csv')).records()
    scores = [recorded[k]['percentile_score'] for k in sorted(recorded)]
    best = int(np.argmax(scores))
    want = {'benchmark': BO_BENCHMARK, 'dataset': BO_SPLIT,
            'method': BO_METHOD, 'source': os.path.basename(out),
            'trials': len(scores), 'metric': 'percentile_score',
            'best_trial': sorted(recorded)[best],
            'best_value': round(scores[best], 2),
            'median_value': round(float(np.median(scores)), 2)}
    check(summary == [want], f'posthoc collate: summary {summary}, '
                             f'expected [{want}]')

    rundir = os.path.join(tmp, 'metric_eval_rundir')
    combined = os.path.join(tmp, 'combined.csv')
    t0 = time.time()
    check(metric_eval_driver.main([
        '--results_dir', out, '--config_file', cfg_path, '--output',
        combined, '--rundir', rundir, '--max_tasks', '1',
        '--device', DEVICE]) == 0,
        'posthoc metric_eval_driver failed')
    times['metric_eval_driver_s'] = time.time() - t0
    timed = {m.get_name() for m in evaluator.metrics
             if isinstance(m, (RuntimeEvaluation, MaxMemoryUsageEvaluation))}

    def untimed(table):
        return [r for r in table if r['metric'] not in timed]
    fanned = ResultsTable(combined).records()
    check(len(fanned) == len(rows) and untimed(fanned) == untimed(rows),
          f'posthoc metric_eval_driver: its combined rows differ from the '
          f'direct run\'s (see {rundir})')
    emit('posthoc', trials_evaluated=trials, rows=len(rows),
         classified_trials=len(cls_rows), summary=summary,
         fanned_rows=len(fanned), compared_rows=len(untimed(rows)),
         max_abs_err_vs_plain=max(errs.values()), checked_values=len(errs),
         tol=TOL_STD, fused_ensemble_launches=launches,
         seconds=time.time() - start, **times)


def http_request(url, payload=None):
    """``(status, body)`` of one GET (``payload`` None) or JSON POST."""
    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(
        url, data=data, headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(request, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_phase(bundles, rng):
    """The port's HTTP server (``examples/serving/serve.py``'s
    ``make_handler``) on 127.0.0.1 on a free port, in a thread, serving
    each bundle of ``bundles`` (name -> path) through a ``Predictor`` on
    the card: /healthz, requests of HTTP_REQUESTS rows whose answers must
    equal ``Predictor.predict``'s bit for bit (an MC model's call counter
    set back, so that the same masks are drawn) and the kernel's plain
    version within TOL_MEAN/TOL_STD, a wrong-shape request answered 400, a
    profiled request whose trace names the annotated span and the kernel,
    the allocator's live bytes as its statistics count them, and p50/p99
    latency over HTTP_LATENCY_REQUESTS requests of 1 and 4,096
    rows. Launch counts are set to 0 once the server is up and read after
    its last request: one launch a request and a direct call."""
    for name, path in bundles.items():
        start = time.time()
        predictor = Predictor(path, device=DEVICE)
        model = predictor.model
        kernel = {'ensemble': 'fused_ensemble',
                  'mc_dropout': 'fused_mc_dropout'}[model.uq_method]
        server = ThreadingHTTPServer(('127.0.0.1', 0),
                                     make_handler(predictor))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f'http://127.0.0.1:{server.server_address[1]}'
        try:
            reset_launches()
            status, health = http_request(url + '/healthz')
            check(status == 200 and health['uq_method'] == model.uq_method
                  and health['num_features'] == IN_DIM,
                  f'http {name} /healthz: {status} {health}')
            calls, errs, request_ms = 0, [], {}
            for rows in HTTP_REQUESTS:
                x = rng.normal(size=(rows, IN_DIM)).astype(np.float32)
                call = getattr(model, '_eval_calls', None)
                t0 = time.perf_counter()
                status, body = http_request(url + '/predict',
                                            {'inputs': x.tolist()})
                # the round trip, and the server's predict alone
                request_ms[rows] = (1e3 * (time.perf_counter() - t0),
                                    body.get('latency_ms'))
                check(status == 200, f'http {name} {rows} rows: {status}')
                got = [np.asarray(body[k], np.float32)
                       for k in ('predictions', 'uncertainty')]
                if call is not None:
                    model._eval_calls = call      # the same masks again
                mean, ue = predictor.predict(x)
                calls += 2
                check(all(np.array_equal(g, w.ravel()) for g, w in
                          zip(got, (mean, ue))),
                      f'http {name} {rows} rows: the answer is not '
                      'Predictor.predict\'s bit for bit')
                xd = torch.from_numpy(x).to(DEVICE)
                with torch.no_grad():
                    if kernel == 'fused_ensemble':
                        want = reference_ue(model, xd)
                    else:
                        want = fused_mc_forward_plain(
                            model.mc_weights(), xd, model.num_samples,
                            model.call_seed(call))
                errs.append({'rows': rows, 'mean': compare(
                    f'http {name} {rows}-row mean',
                    torch.from_numpy(got[0]), want[0].cpu().ravel(),
                    TOL_MEAN), 'ue': compare(
                    f'http {name} {rows}-row ue', torch.from_numpy(got[1]),
                    want[1].cpu().ravel(), TOL_STD)})
            status, body = http_request(
                url + '/predict', {'inputs': [[0.0] * (IN_DIM + 1)]})
            check(status == 400 and 'error' in body,
                  f'http {name} wrong shape: {status} {body}')
            x = rng.normal(size=(4096, IN_DIM)).astype(np.float32).tolist()
            trace_dir = os.path.join(BO_DIR, f'chip_smoke_trace_{name}')
            shutil.rmtree(trace_dir, ignore_errors=True)
            with profile_trace(trace_dir, device=DEVICE):
                with annotate(f'http_{name}', device=DEVICE):
                    status, _ = http_request(url + '/predict', {'inputs': x})
                torch.cuda.synchronize()
            calls += 1
            with open(os.path.join(trace_dir, TRACE_FILE)) as f:
                trace = f.read()
            symbol = f'{kernel}_kernel'
            check(status == 200 and f'http_{name}' in trace
                  and symbol in trace,
                  f'http {name}: the trace in {trace_dir} does not name the '
                  f'span http_{name} and the kernel {symbol}')
            live = live_array_bytes(DEVICE)
            stats = device_memory_stats(DEVICE)
            check(live > 0 and stats['allocated_bytes.all.current'] == live,
                  f'http {name}: allocator statistics {live} live bytes, '
                  f'{stats.get("allocated_bytes.all.current")} allocated')
            latency = {}
            for rows in (1, 4096):
                payload = {'inputs': rng.normal(size=(rows, IN_DIM))
                           .astype(np.float32).tolist()}
                seconds = []
                for _ in range(HTTP_LATENCY_REQUESTS):
                    t0 = time.perf_counter()
                    status, _ = http_request(url + '/predict', payload)
                    seconds.append(time.perf_counter() - t0)
                    check(status == 200, f'http {name}: {status}')
                calls += HTTP_LATENCY_REQUESTS
                latency[rows] = {'p50_ms': 1e3 * float(np.percentile(
                    seconds, 50)), 'p99_ms': 1e3 * float(np.percentile(
                        seconds, 99))}
            check_launches(f'http {name}', read_launches(), **{kernel: calls})
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        emit('http', model=name, members_or_samples=getattr(
            model, 'num_models', getattr(model, 'num_samples', None)),
            request_rows=list(HTTP_REQUESTS), max_abs_err_vs_plain=errs,
            round_trip_and_predict_ms=request_ms, launches=calls,
            latency_ms=latency, seconds=time.time() - start,
            requests_per_latency=HTTP_LATENCY_REQUESTS, trace_span=True,
            trace_kernel=symbol, live_bytes=live)


def workflow_phase(seed):
    """The workflow drivers at the flagship width on WORKFLOW_ROWS rows of
    binomial options from ``seed``: ``workflow_driver`` runs the ensemble
    and MC-dropout cells of the tails split (one trial of one epoch each)
    as two concurrent subprocesses on the card, then
    ``mesh_workflow_driver`` runs the MC-dropout cell in this process on
    the slice ``cuda:0``, with every launch count set to 0 just before and
    read just after: kernel 3 once, kernel 2 as often as the fit's
    validation and the evaluation imply, no other kernel. Each tree must
    hold its trial's files and a row that ran on the card."""
    os.makedirs(BO_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BO_DIR,
                                     prefix='chip_smoke_workflow-') as tmp:
        start = time.time()
        ipt, opt = datagen.generate_binomial_options(WORKFLOW_ROWS,
                                                     seed=seed + 1)
        data_path = os.path.join(tmp, 'binomial_options.tsv')
        datagen.write_delimited(data_path, ipt, opt, '\t')
        cfg = bo_config(data_path, 1)
        cfg['trainer']['max_epochs'] = 1
        cfg['workflow_config']['retries'] = 0     # a failed cell fails
        cfg_path = os.path.join(tmp, 'config.yaml')
        with open(cfg_path, 'w') as f:
            config_reader.dump(cfg, f)
        cells = [(BO_BENCHMARK, m, BO_SPLIT) for m in WORKFLOW_METHODS]
        out = os.path.join(tmp, 'results')
        t0 = time.time()
        rc = workflow_driver.main([
            '--config', cfg_path, '--output', out,
            '--rundir', os.path.join(tmp, 'rundir'), '--max_tasks', '2',
            '--cells', ','.join(':'.join(c) for c in cells),
            '--device', DEVICE])
        workflow_s = time.time() - t0
        check(rc == 0, f'workflow_driver failed (logs in {tmp}/rundir)')

        def trial_row(tree, method):
            trial_dir = os.path.join(tree, BO_BENCHMARK, BO_SPLIT, method,
                                     'bo_trial_0')
            missing = [f for f in BO_FILES
                       if not os.path.isfile(os.path.join(trial_dir, f))]
            check(not missing, f'workflow: {trial_dir} lacks {missing}')
            row = ResultsTable(os.path.join(
                trial_dir, 'trial_results.csv')).records()[0]
            check(row['failed'] is False and row['platform'] == 'gpu',
                  f'workflow: {method} failed or ran off the card: {row}')
            return row
        rows = {m: trial_row(out, m) for m in WORKFLOW_METHODS}

        mesh_out = os.path.join(tmp, 'mesh_results')
        method = 'mc_dropout'
        dset_id, dset_ood = bo_data(cfg)
        reset_launches()
        t0 = time.time()
        rc = mesh_workflow_driver.main([
            '--config', cfg_path, '--output', mesh_out, '--slices', '1',
            '--retries', '0', '--cells', f'{BO_BENCHMARK}:{method}:{BO_SPLIT}',
            '--device', DEVICE])
        torch.cuda.synchronize()
        mesh_s = time.time() - t0
        check(rc == 0, 'mesh_workflow_driver failed')
        val, ue = bo_trial_launches(cfg, len(dset_id), len(dset_ood))
        launches = read_launches()
        check_launches('workflow mesh mc_dropout', launches, fused_train=1,
                       fused_mc_dropout=val + ue)
        mesh_row = trial_row(mesh_out, method)
    emit('workflow', rows=WORKFLOW_ROWS, cells=[':'.join(c) for c in cells],
         workflow_s=workflow_s, mesh_s=mesh_s, mesh_launches=launches,
         num_models=rows['ensemble']['num_models'],
         num_samples=rows['mc_dropout']['num_samples'],
         mesh_num_samples=mesh_row['num_samples'],
         seconds=time.time() - start)


def image_target(x):
    """The CNN phase's target: a smooth function of a 1 x 8 x 8 image."""
    return (x.mean(axis=(1, 2, 3))
            + 0.5 * np.sin(x[:, 0, :4, :4].mean(axis=(1, 2)))
            - 0.3 * x[:, 0, 4:, 4:].mean(axis=(1, 2)))[:, None].astype(
                np.float32)


def cnn_model(kind, arch, seed):
    """A CNN of UQ class ``kind`` as the port's builders make it, on the
    card: 8 members, MC dropout at p = 0.1 with 128 samples, Δ-UQ and PAGER
    with 229 anchors."""
    descr = {
        'ensemble': (EnsembleModelBuilder, {'num_models': MEMBERS}),
        'mc_dropout': (MCDropoutModelBuilder, {'num_samples': MC_SAMPLES,
                                               'dropout_percent': MC_P}),
        'delta_uq': (DeltaUQMLPModelBuilder, {
            'num_anchors': ANCHORS, 'anchored_batch_size': ANCHORS}),
        'pager': (PAGERModelBuilder, {'num_anchors': ANCHORS,
                                      'anchored_batch_size': ANCHORS}),
    }
    builder, uq = descr[kind]
    return builder(arch, uq, train_config=TRAIN_MODEL_CONFIG, seed=seed,
                   device=DEVICE).build()


def member_nets(model):
    """The ensemble's members as single networks (each member's slice of
    the stacked parameters), for the member-by-member reference."""
    params, state = tensor_trees(model.net)
    nets = []
    for i in range(model.num_models):
        net = build_network(model.net.architecture).to(DEVICE)
        load_pytrees(net, [{k: t[i] for k, t in p.items()} for p in params],
                     [{k: t[i] for k, t in s.items()} for s in state])
        nets.append(net)
    return nets


def mc_reference(net, x, samples, seed):
    """MC dropout's answer through ``net``'s layers sample by sample,
    written apart from the served path (``mc_forward_modules``): sample s
    keeps element (b, c, i, j) of the activation entering Dropout module k
    (or (b, f) of a row) where lowbias32 of the mask stream of (``seed``,
    s, k) plus the hashed row b plus the hashed column, the element's
    place ((c H) + i) W + j in its row, has its top 24 bits under the keep
    threshold; the mean and the unbiased std over the samples in float64.
    In the network's compute dtype the activations are in it, as the
    served path runs them."""
    def hashed(index, multiplier):          # index * multiplier mod 2^32
        lo, hi = index & 0xFFFF, index >> 16
        return (lo * multiplier + (((hi * multiplier) & 0xFFFF) << 16)) \
            & 0xFFFFFFFF

    cd = net.compute_dtype
    outs = []
    for s in range(samples):
        h = x if cd is None else x.to(cd)
        for k, layer in enumerate(net.layers):
            if not isinstance(layer, Dropout):
                h = layer(h)
                continue
            threshold, scale = keep_threshold(layer.p)
            if threshold < 0:
                continue
            dims = h.shape[1:]
            column = torch.zeros(dims, dtype=torch.int64, device=h.device)
            for d, size in enumerate(dims):
                place = torch.arange(size, device=h.device).reshape(
                    (size,) + (1,) * (len(dims) - d - 1))
                column = column * size + place
            row = torch.arange(h.shape[0], device=h.device).reshape(
                (-1,) + (1,) * len(dims))
            bits = lowbias32((mask_stream(seed, s, k) + hashed(row, 0xC2B2AE35)
                              + hashed(column, 0x27D4EB2F)) & 0xFFFFFFFF)
            keep = (bits >> 8) < threshold
            h = (h * torch.where(keep, scale, 0.0)).to(h.dtype)
        outs.append(h.double())
    p = torch.stack(outs)
    return p.mean(0).float(), p.std(0, correction=1).float()


def cnn_reference(model, nets, x, call, dtype):
    """The plain computation of a CNN model's answer on the card, in
    compute dtype ``dtype`` (None: fp32): the ensemble member by member
    (``nets``), Δ-UQ and PAGER anchor by anchor (PAGER's prediction matrix
    one anchor's column at a time), the statistics over members or
    anchors in float64; MC dropout sample by sample through a second copy
    of the network with the call's mask seed (``nets``,
    ``mc_reference``). Returns (mean, ue)."""
    def stats(preds):
        p = preds.double()
        return p.mean(0).float(), p.std(0, correction=1).float()
    with torch.no_grad():
        if model.uq_method == 'ensemble':
            for net in nets:
                net.compute_dtype = dtype
            return stats(torch.stack([net(x) for net in nets]))
        if model.uq_method == 'mc_dropout':
            nets[0].compute_dtype = dtype
            return mc_reference(nets[0], x, model.num_samples,
                                model.call_seed(call))
        net, before = model.net, model.net.compute_dtype
        net.compute_dtype = dtype
        try:
            anchors = model.anchors[:model.num_anchors]
            mean, spread = stats(torch.stack([
                net(anchored_input(x, a.expand_as(x))) for a in anchors]))
            if model.uq_method == 'pager':
                cols = torch.stack([
                    net(anchored_input(a.expand_as(x), x))[:, 0]
                    for a in anchors], dim=1)
                y = model.anchors_Y[:model.num_anchors].reshape(1, -1)
                score = (cols - y).abs().amax(dim=1, keepdim=True)
                spread = torch.maximum(spread, score)
            return mean, spread
        finally:
            net.compute_dtype = before


def cnn_phase(seed):
    """The CNN layers through the four UQ classes on the card: for each
    architecture of CNN_CASES, ``Trainer.fit`` of the ensemble, MC
    dropout, Δ-UQ and PAGER for one epoch (batch 128, lr 5e-5, clip 5,
    fp32) on images drawn from ``seed``, every launch count 0 and the
    bundle reloading to its logged validation loss; then ``Predictor`` on
    the reloaded model, in fp32 against the plain computation
    (``cnn_reference``: mean 1e-5; UE 1e-3 relative + 1e-5) and after
    ``set_precision('bf16-mixed')`` against its bf16-vs-fp32 gap
    (``attrib.bf16_close``), every launch count 0. Reports images/s and
    the allocator's peak, which must stay under the card's memory."""
    phase_start = time.perf_counter()
    rng = np.random.default_rng(seed + 61)
    total = torch.cuda.get_device_properties(0).total_memory
    for case, (arch, steps, ens_requests, requests) in CNN_CASES.items():
        n_train = steps * TRAIN_BATCH
        n_val = CNN_VAL_BATCHES * TRAIN_BATCH
        x = rng.normal(size=(n_train + n_val,) + CNN_IMAGE).astype(np.float32)
        y = image_target(x)
        train_dl = DataLoader(ArrayDataset(x[:n_train], y[:n_train]),
                              TRAIN_BATCH, shuffle=True, drop_last=True)
        val_dl = DataLoader(ArrayDataset(x[n_train:], y[n_train:]),
                            TRAIN_BATCH)
        for kind in CNN_CLASSES:
            name = f'{case}_{kind}'
            model = cnn_model(kind, arch, seed)
            check(prepare_fused_weights(model.net) is None
                  and prepare_mc_weights(model.net) is None
                  and prepare_fused_anchored(model.net) is None
                  and ft.plan_fused_train(model.net, 1, TRAIN_BATCH) is None,
                  f'{name}: a kernel took the Conv2d network')
            saver = ModelSavingCallback(defer_serialization=True)
            trainer = Trainer(name, dict(
                TRAIN_CONFIG, max_epochs=1, limit_train_batches=steps,
                limit_val_batches=CNN_VAL_BATCHES, seed=seed),
                callbacks=[EarlyStopping(), saver] + model.get_callbacks(),
                log_dir=TRAIN_DIR, version=f'seed_{seed}', device=DEVICE)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = time.perf_counter()
            trainer.fit(model, train_dl, val_dl)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - start
            check_launches(f'{name} fit', read_launches())
            check(trainer.fused_epochs_used == 0,
                  f'{name}: {trainer.fused_epochs_used} kernel epochs')
            fit_peak = torch.cuda.max_memory_allocated()
            log = os.path.join(trainer.logger.log_dir, 'metrics.csv')
            with open(log) as f:
                losses = [float(r['train_loss']) for r in csv.DictReader(f)
                          if r.get('train_loss')]
            check(losses and np.isfinite(losses).all(),
                  f'{name}: non-finite training losses')
            best = load_model(os.path.join(trainer.logger.log_dir,
                                           'model.pth'), device=DEVICE)
            reset_launches()
            val_again = trainer.validate(best, val_dl)
            check_launches(f'{name} revalidation', read_launches())
            check(abs(val_again - saver.best) <= 1e-5,
                  f'{name}: reloaded val_loss {val_again} != logged '
                  f'{saver.best}')
            if kind in ('delta_uq', 'pager'):
                check(tuple(best.anchors.shape) == (ANCHORS,) + CNN_IMAGE,
                      f'{name}: anchors {tuple(best.anchors.shape)}')
            nets = member_nets(best) if kind == 'ensemble' else \
                [copy.deepcopy(best.net)] if kind == 'mc_dropout' else None
            served = {}
            for precision in ('32-true', 'bf16-mixed'):
                best.set_precision(precision)
                if kind == 'mc_dropout':
                    best.reseed(seed)
                bf16 = precision == 'bf16-mixed'
                # the served and the plain convolutions sum in orders cuDNN
                # picks per shape, so a bf16 rounding may go the other way:
                # a 1-image request's one value a part read 0.209 of its
                # gap once on an H100, so the rms bar holds the run's
                # requests at once
                pooled = {}
                judge = bf16_judge(
                    f'{name} bf16',
                    lambda xd, call: cnn_reference(best, nets, xd, call,
                                                   torch.bfloat16),
                    lambda xd, call: cnn_reference(best, nets, xd, call,
                                                   None),
                    pooled) if bf16 else None
                sizes = ens_requests if kind == 'ensemble' else requests
                # the buckets up to the first that holds the largest request
                top = next(b for b in CNN_BUCKETS if b >= max(sizes))
                torch.cuda.reset_peak_memory_stats()
                start = time.perf_counter()
                serve(f'{name} {precision}', best, sizes, rng,
                      lambda xd, call: cnn_reference(best, nets, xd, call,
                                                     None),
                      None, judge=judge, phase='cnn_serving',
                      shape=CNN_IMAGE,
                      buckets=tuple(b for b in CNN_BUCKETS if b <= top))
                served[precision] = {
                    'seconds': time.perf_counter() - start,
                    'peak_bytes': torch.cuda.max_memory_allocated()}
                if bf16:
                    served[precision]['bf16_every_request'] = bf16_pooled(
                        f'{name} bf16', pooled)
                check(served[precision]['peak_bytes'] < total,
                      f'{name}: peak {served[precision]["peak_bytes"]} B')
            if case == 'cnn_128' and kind == 'ensemble':
                # the Predictor's own buckets, to 65,536 images: the model
                # chunks them by their activations (models/base.py)
                best.set_precision('32-true')
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                warm_s = Predictor(best, device=DEVICE,
                                   warmup=False).warmup(CNN_IMAGE)
                check_launches(f'{name} default buckets', read_launches())
                served['default_buckets'] = {
                    'largest': DEFAULT_BUCKETS[-1], 'seconds': warm_s,
                    'images_per_forward': best.max_rows(
                        torch.zeros((1,) + CNN_IMAGE, device=DEVICE)),
                    'peak_bytes': torch.cuda.max_memory_allocated()}
                check(served['default_buckets']['peak_bytes'] < total,
                      f'{name}: default buckets peak '
                      f'{served["default_buckets"]["peak_bytes"]} B')
            emit('cnn', case=case, model=kind, steps=steps,
                 batch=TRAIN_BATCH, fit_s=fit_s,
                 train_images_per_s=n_train / fit_s,
                 fit_peak_bytes=fit_peak, fit_peak_share=fit_peak / total,
                 first_losses=losses[:3], last_losses=losses[-3:],
                 val_loss=saver.best, reloaded_val_loss=val_again,
                 serving=served)
    emit('cnn', seconds=time.perf_counter() - phase_start,
         nvidia_smi=nvidia_smi('name,power.limit'))


# the parallel phase: meshes over torch.distributed ranks. A gloo world of
# two ranks both on cuda:0 (the script needs only one card, and NCCL
# refuses two ranks on one card) runs every sharded path; an NCCL
# world of one rank a visible card runs its collectives and a dp-sharded
# ensemble request. Sharded fits: the flagship trial's ensemble
# (TRAIN_MODEL_CONFIG) for 5 epochs of 20 steps of batch 128, each epoch
# validated, on dp = 2 and on {'member': 2}, against the same fit unsharded
# on the per-step path (fused_epochs off). A split batch sums in another
# order, and two float32 trajectories part exponentially from their first
# rounding difference (Adam's first steps move a weight whose gradient is
# rounding noise by a whole learning rate), so the bars read the first
# epoch: its CROSS_CHECKED losses within TOL_CROSS, as the kernel fit is
# held to the per-step fit, and its validation loss within PARALLEL_VAL_REL
# relative. On the card over seeds 0-4 the dp fit read at most 1.87e-5 and
# 3.24e-6 (the member fit 6e-8 and 9e-9); the planted faults that a bar
# sees read at least 7.6e-4 on the losses (BatchNorm gradients left
# unsummed) and 2.3e-4 and 8.1e-4 on the validation (those, and the
# running variance unbiased with a rank's rows). The later epochs are
# printed, not held: by step 100 the clean parting (2.2e-3 on a loss, 7.3e-3
# relative on the validation) is as large as the faults'
# (tools/parallel_fit_bars.py; PERF.md section 6).
PARALLEL_GLOO_DEVICES = ('cuda:0', 'cuda:0')
PARALLEL_FIT_EPOCHS, PARALLEL_EPOCH_STEPS = 5, CROSS_CHECKED
PARALLEL_FIT_VAL_BATCHES = 10
PARALLEL_VAL_REL = 3e-5
PARALLEL_TIMEOUT = 600                   # a world's limit, seconds
# the kernels whose dp ranks each launch on their rows of a bucket (the
# KDE kernel splits the corpus instead; MC dropout is checked bit for bit)
ROW_SHARDED = ('fused_ensemble', 'fused_ensemble_bf16', 'fused_anchored')
GLOO_CUDA_PROBES = ('all_reduce', 'broadcast', 'all_gather',
                    'all_gather_into_tensor', 'reduce_scatter_tensor',
                    'barrier')


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _digest(out):
    """A hash of an answer's bytes: two ranks' answers are equal iff their
    digests are."""
    import hashlib
    h = hashlib.sha256()
    for o in (out if isinstance(out, tuple) else (out,)):
        h.update(np.ascontiguousarray(o).tobytes())
    return h.hexdigest()


def _rank_trace(rank, start, *what):
    """A rank's progress on stderr: a world that stalls shows where."""
    print(f'parallel rank {rank} {time.perf_counter() - start:.2f} s:',
          *what, file=sys.stderr, flush=True)


def _shown(record):
    """A record as the phase prints it: no digest, launches that ran."""
    out = {k: v for k, v in record.items() if k != 'digest'}
    out['launches'] = {k: v for k, v in record['launches'].items() if v}
    return out


def gloo_cuda_probe(device):
    """Which collectives gloo takes on tensors on ``device``: each one
    tried on the default group, 'ok' or the error."""
    import torch.distributed as dist
    world = dist.get_world_size()
    ops = {
        'all_reduce': lambda: dist.all_reduce(torch.ones(4, device=device)),
        'broadcast': lambda: dist.broadcast(torch.ones(4, device=device), 0),
        'all_gather': lambda: dist.all_gather(
            [torch.empty(4, device=device) for _ in range(world)],
            torch.ones(4, device=device)),
        'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=device),
            torch.ones(4, device=device)),
        'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=device),
            torch.ones(4 * world, device=device)),
        'barrier': dist.barrier,
    }
    out = {}
    for name in GLOO_CUDA_PROBES:
        try:
            ops[name]()
            _sync(device)
            out[name] = 'ok'
        except RuntimeError as e:
            out[name] = f'{type(e).__name__}: {str(e)[:120]}'
    return out


def parallel_models(seed, corpus):
    """(name, make, kernel launched a bucket, rows, MC) of the dp-sharded
    requests: every class with a kernel on its path, fp32 and bf16-mixed
    for the ensemble and MC dropout, and kNN-KDE (no kernel)."""
    def bf16(model):
        return model.set_precision('bf16-mixed')
    return [
        ('ensemble', lambda: build_model(seed), 'fused_ensemble', ROWS,
         False),
        ('ensemble_bf16', lambda: bf16(build_model(seed)),
         'fused_ensemble_bf16', ROWS, False),
        ('mc_dropout', lambda: build_mc(seed), 'fused_mc_dropout', ROWS,
         True),
        ('mc_dropout_bf16', lambda: bf16(build_mc(seed)),
         'fused_mc_dropout_bf16', ROWS, True),
        ('delta_uq', lambda: build_anchored(DeltaUQMLPModelBuilder, seed),
         'fused_anchored', ANCHORED_ROWS, False),
        ('kde', lambda: build_density(KDEModelBuilder, {'rtol': KDE_RTOL},
                                      seed, corpus), 'kde', ROWS, False),
        ('knn_kde', lambda: build_density(KNNKDEModelBuilder, {'k': KNN_K},
                                          seed, corpus), None, ROWS, False),
    ]


def share_witness(make, x, dp, got, ref):
    """Each dp rank's share of a row-sharded answer ``got`` against the
    same model unsharded, run in this process on exactly that rank's rows
    of each bucket (``bucket[lo:hi]``, the rows its kernel launch took).
    Returns (every share equal to that bit for bit, the number of the
    shares' values that differ from the same rows of the whole-bucket
    call ``ref``)."""
    from nnueehcs_tpu_torch.parallel import Mesh, local_rows
    bucket = DEFAULT_BUCKETS[-1]
    check(x.shape[0] % bucket == 0,
          f'the share witness takes whole buckets, not {x.shape[0]} rows')
    model = make()
    same, moved = True, 0
    with torch.no_grad():
        for c0 in range(0, x.shape[0], bucket):
            chunk = torch.from_numpy(x[c0:c0 + bucket]).to(DEVICE)
            for r in range(dp):
                lo, hi = local_rows(bucket, Mesh({'dp': dp}, r, None, {},
                                                 None))
                share = model.eval_rows(chunk, lo, hi, return_ue=True)
                for part, t in enumerate(share):
                    mine = t.float().cpu().numpy()
                    same &= np.array_equal(mine, got[part][c0 + lo:c0 + hi])
                    moved += int(np.sum(mine != ref[part][c0 + lo:c0 + hi]))
    return same, moved


def parallel_fit_data(seed):
    """The sharded fits' rows, PARALLEL_FIT_EPOCHS x PARALLEL_EPOCH_STEPS
    training batches then PARALLEL_FIT_VAL_BATCHES validation batches, and
    their targets."""
    rng = np.random.default_rng(seed + 79)
    n = (PARALLEL_FIT_EPOCHS * PARALLEL_EPOCH_STEPS
         + PARALLEL_FIT_VAL_BATCHES) * TRAIN_BATCH
    x = rng.normal(size=(n, IN_DIM)).astype(np.float32)
    return x, smooth_target(x)


def parallel_fit(model, x, y, seed, log_dir, mesh=None, devices=None):
    """PARALLEL_FIT_EPOCHS epochs of PARALLEL_EPOCH_STEPS per-step training
    steps of batch TRAIN_BATCH (drawn from the training rows of
    :func:`parallel_fit_data`), each followed by PARALLEL_FIT_VAL_BATCHES
    validation batches, on the mesh of axes ``mesh`` over ``devices``
    (rank r on ``devices[r]``) or unsharded; returns (trainer, per-step
    losses, per-epoch validation losses, launches, seconds). The losses are
    rank 0's logs (None on the other ranks)."""
    n = PARALLEL_FIT_EPOCHS * PARALLEL_EPOCH_STEPS * TRAIN_BATCH
    n_val = PARALLEL_FIT_VAL_BATCHES * TRAIN_BATCH
    cfg = dict(TRAIN_CONFIG, max_epochs=PARALLEL_FIT_EPOCHS,
               limit_train_batches=PARALLEL_EPOCH_STEPS,
               limit_val_batches=PARALLEL_FIT_VAL_BATCHES,
               log_every_n_steps=1, seed=seed, fused_epochs=False)
    if mesh is not None:
        cfg.update(mesh=mesh, devices=list(devices))
    model.train_config.update(TRAIN_MODEL_CONFIG)
    trainer = Trainer('parallel', cfg,
                      callbacks=[EarlyStopping(patience=PARALLEL_FIT_EPOCHS)],
                      log_dir=log_dir, version=f'seed_{seed}_{mesh}',
                      device=DEVICE)
    reset_launches()
    start = time.perf_counter()
    trainer.fit(model, DataLoader(ArrayDataset(x[:n], y[:n]), TRAIN_BATCH,
                                  shuffle=True, drop_last=True),
                DataLoader(ArrayDataset(x[n:n + n_val], y[n:n + n_val]),
                           TRAIN_BATCH))
    _sync(DEVICE)
    seconds = time.perf_counter() - start
    launches = read_launches()
    losses = vals = None
    if trainer.mesh is None or trainer.mesh.rank == 0:
        with open(os.path.join(trainer.logger.log_dir, 'metrics.csv')) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r['train_loss']) for r in rows if r.get('train_loss')]
        vals = [float(r['val_loss']) for r in rows if r.get('val_loss')]
    return trainer, losses, vals, launches, seconds


def fit_readings(losses, vals, ref_losses, ref_vals):
    """A sharded fit's distances from the unsharded fit: the first
    CROSS_CHECKED losses' largest (``first``), every step's (``all``), the
    first validation loss's relative distance (``val_first_rel``) and the
    last's (``val_last_rel``)."""
    diff = np.abs(np.array(losses) - np.array(ref_losses))
    rel = np.abs(np.array(vals) - np.array(ref_vals)) / np.abs(ref_vals)
    return {'first': float(diff[:CROSS_CHECKED].max()),
            'all': float(diff.max()), 'val_first_rel': float(rel[0]),
            'val_last_rel': float(rel[-1])}


def parallel_gloo_rank(rank, mesh, devices, seed, log_dir):
    """One rank of the gloo world: the collectives probe, every dp-sharded
    request against the unsharded call (rank 0 runs the references), the
    member-sharded ensemble, and the sharded fits against the unsharded
    fit (rank 0). Returns what rank 0 compared and what every rank
    launched and hashed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from nnueehcs_tpu_torch.parallel import make_mesh
    lead = rank == 0
    start = time.perf_counter()
    out = {'probe': gloo_cuda_probe(DEVICE), 'requests': {}, 'fits': {}}
    _rank_trace(rank, start, 'probed', out['probe'])
    rng = np.random.default_rng(seed + 71)
    corpus = rng.normal(size=(KDE_FIT_ROWS, IN_DIM)).astype(np.float32)
    dp = make_mesh({'dp': mesh.size}, devices)
    member = make_mesh({'member': mesh.size}, devices)
    cases = parallel_models(seed, corpus)
    cases.append(('ensemble_member_sharded', lambda: build_model(seed),
                  'fused_ensemble', ROWS, False))
    for name, make, kernel, n, mc in cases:
        _rank_trace(rank, start, name)
        x = rng.normal(size=(n, IN_DIM)).astype(np.float32)
        ref, ref_s = None, None
        if lead:
            predictor = Predictor(make(), device=DEVICE)
            t0 = time.perf_counter()
            ref = predictor.predict(x)
            ref_s = time.perf_counter() - t0
            _rank_trace(rank, start, name, 'unsharded answered')
        on = member if name == 'ensemble_member_sharded' else dp
        # built, warmed and called as the reference was: MC dropout's call
        # counter stands where the reference's stood
        predictor = Predictor(make(), mesh=on)
        _rank_trace(rank, start, name, 'sharded warm')
        reset_launches()
        t0 = time.perf_counter()
        got = predictor.predict(x)
        _sync(DEVICE)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        record = {'rows': n, 'seconds': seconds, 'launches': launches,
                  'kernel': kernel, 'digest': _digest(got),
                  'buckets': -(-n // DEFAULT_BUCKETS[-1])}
        if lead:
            tol = TOL_SCORE if name in ('kde', 'knn_kde') else TOL_STD
            if mc:
                equal = all(np.array_equal(a, b) for a, b in zip(got, ref))
                check(equal, f'parallel {name}: the dp-sharded answer is not '
                             'the unsharded one bit for bit')
                err = {'mean': 0.0, 'ue': 0.0}
            else:
                err = {'mean': compare(f'parallel {name} mean',
                                       torch.from_numpy(got[0]),
                                       torch.from_numpy(ref[0]), TOL_MEAN),
                       'ue': compare(f'parallel {name} ue',
                                     torch.from_numpy(got[1]),
                                     torch.from_numpy(ref[1]), tol)}
            if on is dp and not mc and kernel in ROW_SHARDED:
                # the cause of any difference from the whole-bucket call:
                # each rank's share is its rows launched alone
                same, moved = share_witness(make, x, mesh.size, got, ref)
                check(same, f'parallel {name}: a rank\'s share is not the '
                            'unsharded call on its rows bit for bit')
                record.update(shares_bit_equal=same,
                              share_values_off_whole_bucket=moved)
            record.update(max_abs_err=err, unsharded_seconds=ref_s,
                          bit_equal=all(np.array_equal(a, b)
                                        for a, b in zip(got, ref)))
        out['requests'][name] = record
    # sharded fits against the unsharded per-step fit
    x, y = parallel_fit_data(seed)
    if lead:
        _, ref_losses, ref_vals, _, ref_s = parallel_fit(
            build_model(seed), x, y, seed, log_dir)
    for axes in ({'dp': mesh.size}, {'member': mesh.size}):
        _rank_trace(rank, start, 'fit', axes)
        trainer, losses, vals, launches, seconds = parallel_fit(
            build_model(seed), x, y, seed, log_dir, mesh=axes,
            devices=devices)
        record = {'seconds': seconds, 'launches': launches,
                  'val_loss': trainer.callback_metrics['val_loss'],
                  'fused_epochs_used': trainer.fused_epochs_used}
        if lead:
            steps = PARALLEL_FIT_EPOCHS * PARALLEL_EPOCH_STEPS
            check(len(losses) == len(ref_losses) == steps
                  and len(vals) == len(ref_vals) == PARALLEL_FIT_EPOCHS,
                  f'parallel fit {axes}: {len(losses)} steps, {len(vals)} '
                  'validations')
            got = fit_readings(losses, vals, ref_losses, ref_vals)
            record.update(steps=steps, unsharded_seconds=ref_s,
                          unsharded_val_loss=ref_vals[-1], **got)
            check(got['first'] <= TOL_CROSS['atol'],
                  f'parallel fit {axes}: the first {CROSS_CHECKED} losses '
                  f'part by {got["first"]} from the unsharded fit')
            check(got['val_first_rel'] <= PARALLEL_VAL_REL,
                  f'parallel fit {axes}: the validation loss after '
                  f'{PARALLEL_EPOCH_STEPS} steps is {vals[0]} against '
                  f'{ref_vals[0]} unsharded')
        out['fits'][str(axes)] = record
    return out


def parallel_nccl_rank(rank, mesh, seed):
    """One rank of the NCCL world (one a card): a sum over the default
    group, then a dp-sharded 8-member ensemble request through kernel 1
    against the unsharded call on the same card."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    total = torch.tensor([float(rank + 1)], device=mesh.device)
    dist.all_reduce(total)
    x = np.random.default_rng(seed + 73).normal(
        size=(ROWS, IN_DIM)).astype(np.float32)
    ref = Predictor(build_model(seed), device=mesh.device).predict(x)
    predictor = Predictor(build_model(seed), mesh=mesh)
    reset_launches()
    got = predictor.predict(x)
    torch.cuda.synchronize(mesh.device)
    return {'sum': float(total.item()), 'launches': read_launches(),
            'max_abs_err': [float(np.abs(a - b).max())
                            for a, b in zip(got, ref)],
            'digest': _digest(got), 'device': str(mesh.device)}


def parallel_phase(seed):
    """``parallel/`` on the card: the gloo world of PARALLEL_GLOO_DEVICES
    (two ranks on cuda:0), then the NCCL world of one rank a visible
    card. Every sharded answer is held to the unsharded call (MC dropout
    bit for bit), every rank must hold the same answer, and each rank's
    launches are exact: kernel 1, 2 and 5 (or their bf16 forms) once a
    bucket, kernel 4 once a bucket on the rank's shard, none for kNN-KDE,
    and kernel 3 never in a sharded fit (validation launches kernel 1
    once a batch)."""
    from nnueehcs_tpu_torch.parallel import launch
    phase_start = time.perf_counter()
    devices = PARALLEL_GLOO_DEVICES
    log_dir = tempfile.mkdtemp(dir=BO_DIR, prefix='parallel_')
    try:
        answers = launch(parallel_gloo_rank, len(devices), backend='gloo',
                         devices=devices, timeout=PARALLEL_TIMEOUT,
                         all_ranks=True,
                         args=(list(devices), seed, log_dir))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    lead = answers[0]
    for name, record in lead['requests'].items():
        for other in answers[1:]:
            check(other['requests'][name]['digest'] == record['digest'],
                  f'parallel {name}: the ranks hold different answers')
        for ans in answers:
            want = {record['kernel']: record['buckets']} \
                if record['kernel'] else {}
            check_launches(f'parallel {name}', ans['requests'][name][
                'launches'], **want)
        emit('parallel', world='gloo, 2 ranks on cuda:0', request=name,
             **_shown(record))
    for axes, record in lead['fits'].items():
        for ans in answers:
            check_launches(f'parallel fit {axes}', ans['fits'][axes][
                'launches'], fused_ensemble=PARALLEL_FIT_EPOCHS
                * val_launches(PARALLEL_FIT_VAL_BATCHES * TRAIN_BATCH,
                               TRAIN_BATCH, PARALLEL_FIT_VAL_BATCHES))
            check(ans['fits'][axes]['fused_epochs_used'] == 0,
                  f'parallel fit {axes}: kernel epochs in a sharded fit')
            check(ans['fits'][axes]['val_loss'] == record['val_loss'],
                  f'parallel fit {axes}: the ranks stopped apart')
        emit('parallel', world='gloo, 2 ranks on cuda:0', fit=axes,
             batch=TRAIN_BATCH, **_shown(record))
    probe = lead['probe']
    emit('parallel', world='gloo, 2 ranks on cuda:0',
         gloo_cuda_collectives=probe)
    gloo_seconds = time.perf_counter() - phase_start
    count = torch.cuda.device_count()
    nccl_answers = launch(parallel_nccl_rank, count, backend='nccl',
                          timeout=PARALLEL_TIMEOUT, all_ranks=True,
                          args=(seed,))
    for ans in nccl_answers:
        check(ans['sum'] == count * (count + 1) / 2,
              f'NCCL all-reduce gave {ans["sum"]}')
        check_launches('parallel nccl ensemble', ans['launches'],
                       fused_ensemble=-(-ROWS // DEFAULT_BUCKETS[-1]))
        check(ans['digest'] == nccl_answers[0]['digest'],
              'NCCL ranks hold different answers')
        check(max(ans['max_abs_err']) <= TOL_MEAN['atol'],
              f'NCCL dp-sharded ensemble: {ans["max_abs_err"]}')
        ans['launches'] = {k: v for k, v in ans['launches'].items() if v}
    emit('parallel', world=f'nccl, {count} rank(s), one a card',
         ranks=[{k: v for k, v in ans.items() if k != 'digest'}
                for ans in nccl_answers])
    emit('parallel', seconds=time.perf_counter() - phase_start,
         gloo_seconds=gloo_seconds)


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
    eval_chain = eval_chain_sass(info.path, ptxas, info.log)
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

    def kernel_vs_plain(kernel, case, rows, in_dim, run, plain, square=False,
                        source=None):
        """Hold one kernel call against its plain version on the same x
        (drawn from ``source``, else the script's generator); ``square``
        compares std^2 (the 'var' estimator)."""
        x = torch.as_tensor((source or rng).normal(size=(rows, in_dim)),
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
    # kernel 1 (3xTF32, a cluster of min(M, 8) member blocks) at a request's
    # and a validation pass's rows, and at the BO trials' member counts, on
    # a generator of their own so that the other cases keep their inputs
    ens_rng = np.random.default_rng(args.seed + 21)
    fw_members = [prepare_fused_weights(build_model(args.seed, members=m).net)
                  for m in ENSEMBLE_MEMBERS]
    ens_cases = [(f'rows_{r}', fw, r) for r in ENSEMBLE_ROWS] + [
        (f'members_{w.num_members}', w, ROWS) for w in fw_members]
    for case, weights, rows in ens_cases:
        kernel_vs_plain('fused_ensemble', case, rows, weights.in_dim,
                        lambda x, w=weights: fused_forward_prefolded(w, x),
                        lambda x, w=weights: fused_forward_plain(w, x),
                        source=ens_rng)

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
    # a rank's share of a dp-sharded request: its rows hash from row0
    kernel_vs_plain(
        'fused_mc_dropout', 'row0', 4096, IN_DIM,
        lambda x: fused_mc_forward(mw, x, MC_SAMPLES, 1999, row0=MC_ROW0),
        lambda x: fused_mc_forward_plain(mw, x, MC_SAMPLES, 1999,
                                         row0=MC_ROW0))

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
    bf16_vs_plain(
        'fused_mc_dropout_bf16', 'row0', 4096, IN_DIM,
        lambda x: fused_mc_forward(mw16, x, MC_SAMPLES, 2999, row0=MC_ROW0),
        lambda x: fused_mc_forward_plain(mw16, x, MC_SAMPLES, 2999,
                                         row0=MC_ROW0),
        lambda x: fused_mc_forward_plain(mw, x, MC_SAMPLES, 2999,
                                         row0=MC_ROW0))
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
    def train_case_bf16(case, model, loss, per_member=False, wd=0.0,
                        steps=STEPWISE_BF16_STEPS, gen=rng, witnessed=False):
        plan = train_plan(model, loss, per_member, wd, bf16=True)
        bufs, xs, ys = train_inputs(model, plan, gen, steps)
        out = stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, TRAIN_STEP0,
                                     int(gen.integers(1 << 31)),
                                     ft.drop_rates(model.net).to(DEVICE),
                                     witnessed=witnessed)
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
    # MC dropout with every pre-ReLU value away from 0, where two correct
    # bf16 versions part by up to the gap on single steps: held over
    # BF16_SEPARATE_STEPS steps, with witnessed bars (inputs from a
    # generator of its own, so every later phase keeps its inputs)
    train_case_bf16(f'mc_dropout_p{MC_P}_separate_relu', separate_relu(
        build_mc(args.seed), torch.Generator().manual_seed(args.seed + 7)),
        'l1_loss', steps=BF16_SEPARATE_STEPS,
        gen=np.random.default_rng(args.seed + 71), witnessed=True)
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
    # the witness: the plain bf16 epoch on the host, a second correct bf16
    # version (the curve is chaotic: two correct versions part by whole
    # bf16 roundings that compound over the epoch)
    host_start = time.perf_counter()
    host = ft.fused_epoch_reference(
        plan16, *[b.to('cpu', copy=True) for b in bufs], xs.cpu(), ys.cpu(),
        lr, TRAIN_STEP0, seed)[4]
    host_s = time.perf_counter() - host_start
    curve = bf16_curve_bars(*curves, host)
    check(curve['witness_bar'],
          f'fused_train_bf16 loss curve: {curve["max_abs_diff"]:.3e} from '
          f'the plain bf16 curve, past {BF16_WITNESS_SHARE} x the host\'s '
          f'plain bf16 curve\'s distance to it ({curve["witness_max"]:.3e})')
    emit('kernel_vs_plain', kernel='fused_train_bf16',
         case='joint_l1_clip5_as_built_loss_curve', steps=BF16_CURVE_STEPS,
         host_witness_s=host_s, **curve)

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
    val_pass = val_launches(TRAIN_ROWS - TRAIN_SPLIT, TRAIN_BATCH,
                            TRAIN_CONFIG['limit_val_batches'])
    check_launches('flagship fit', train_launches, fused_train=epochs,
                   fused_ensemble=epochs * val_pass)
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
    served_bundles = {'ensemble': os.path.join(trainer.logger.log_dir,
                                               'model.pth')}
    best = load_model(served_bundles['ensemble'], device='cuda')
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
                       fused_ensemble=val_pass)
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
            {kernel: val_pass} if kernel else {}))
        losses = [float(r['train_loss']) for r in csv.DictReader(open(
            os.path.join(tr.logger.log_dir, 'metrics.csv'))) if r['train_loss']]
        check(np.isfinite(losses).all(), f'{name}: non-finite training losses')
        if name == 'mc_dropout':
            served_bundles[name] = os.path.join(tr.logger.log_dir,
                                                'model.pth')
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
                   * val_pass)
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
                'fused_anchored' + suffix: ANCHORED_FIT_EPOCHS * val_pass})
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

    # the MC kernels' mask hash: one for every masked element (the inputs
    # of the Linears a Dropout precedes, over every row and sample), each
    # the function's operations (MASK_HASH_OPS) on the integer pipes
    masked = sum(IN_DIM if layer == 0 else WIDTH
                 for layer, t in enumerate(mw.thresholds) if t >= 0)
    hashes = ROWS * MC_SAMPLES * masked
    clocks = hash_clocks(MASK_HASH_OPS)
    hash_rate = sms * int(clock_mhz.group(1)) * 1e6 / clocks
    peak_tf32 = peak_bf16 / 2

    def tf32_terms(flops, hashes=0):
        """The fp32 kernels 1, 2 and 5 counted by pipe: 3 TF32 products
        for each fp32 one at the TF32 peak, the mask hash on the integer
        pipes; beside them, the fp32 FFMA floor they left."""
        return {'tf32_products': 1e3 * 3 * flops / peak_tf32,
                'mask_hash_int_ops': 1e3 * hashes / hash_rate,
                'ffma_floor': 1e3 * flops / peak_flops}

    def ensemble_work(w, rows):
        """Kernel 1's operations (fp32, before the 3xTF32 split) and
        bytes on ``rows`` rows."""
        return (2.0 * rows * w.num_members * w.macs_per_row,
                4.0 * (rows * w.in_dim + w.w_all.numel() + w.b_all.numel()
                       + 2 * rows * w.out_dim))

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
    flops, moved = ensemble_work(fw, ROWS)
    # kernel 1 at a request's rows and at the BO trials' member counts,
    # each beside its bound and its baddbmm chain
    shapes = []
    for w, rows in [(fw, r) for r in ENSEMBLE_ROWS] + [
            (w, ROWS) for w in fw_members]:
        xs = x[:rows].contiguous()
        f, b = ensemble_work(w, rows)
        shape_t = event_ms(lambda: fused_forward_prefolded(w, xs))
        shapes.append(dict(
            rows=rows, members=w.num_members, ms=shape_t['median_ms'],
            bound_ms=bound(3 * f, b, peak_tf32, peak_bytes)[0],
            library_ms=event_ms(lambda: library_chain(w, xs))['median_ms']))
    record(0, ens_launches, kernel_t, plain_t, 3 * flops, moved,
           library_t['median_ms'], peak=peak_tf32, rows=ROWS,
           kernel_again=kernel_t2, library_baddbmm=library_t,
           bound_terms_ms=tf32_terms(flops), shapes=shapes,
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels[-1].update(
        bound_terms_ms=tf32_terms(flops),
        share_of_bound=kernels[-1]['bound_ms'] / kernels[-1]['ms'],
        shapes=shapes, ptxas=eval_chain['fused_ensemble_kernel'])

    x_plain = x[:MC_PLAIN_TIMING_ROWS].contiguous()
    kernel_t = event_ms(lambda: fused_mc_forward(mw, x, MC_SAMPLES, 7))
    plain_t = event_ms(lambda: fused_mc_forward_plain(mw, x_plain, MC_SAMPLES, 7))
    gemm_t = event_ms(lambda: mc_gemm_only(mw, x, MC_SAMPLES))
    e2e_s = e2e_median_s(mc_predictor, ROWS)
    flops = 2.0 * ROWS * MC_SAMPLES * mw.macs_per_row
    record(1, mc_launches, kernel_t, plain_t, 3 * flops,
           4.0 * (x.numel() + mw.w_all.numel() + mw.b_all.numel()
                  + 2 * ROWS * mw.out_dim),
           None, peak=peak_tf32, exps=hashes, exp_rate=hash_rate,
           rows=ROWS, samples=MC_SAMPLES, p=MC_P,
           plain_rows=MC_PLAIN_TIMING_ROWS, gemm_only_reference=gemm_t,
           bound_terms_ms=tf32_terms(flops, hashes),
           mask_loop=eval_chain['mask_loop_tf32'],
           predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ROWS / e2e_s)
    kernels[-1].update(
        plain_rows=MC_PLAIN_TIMING_ROWS,
        gemm_only_reference_ms=gemm_t['median_ms'],
        bound_terms_ms=tf32_terms(flops, hashes),
        share_of_bound=kernels[-1]['bound_ms'] / kernels[-1]['ms'],
        ptxas=eval_chain['fused_mc_dropout_kernel'])

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
    flops = 2.0 * ANCHORED_ROWS * (aw.macs_once
                                   + ANCHORS * aw.macs_per_anchor)
    record(2, dq_launches + pager_launches, kernel_t, plain_t, 3 * flops,
           4.0 * (xa.numel() + aw.w_all.numel() + aw.b_all.numel()
                  + ANCHORS * WIDTH + 2 * ANCHORED_ROWS * aw.out_dim),
           library_t['median_ms'], peak=peak_tf32, rows=ANCHORED_ROWS,
           anchors=ANCHORS, bound_terms_ms=tf32_terms(flops),
           library_gemm_chain=library_t, predictor_e2e_median_s=e2e_s,
           predictor_e2e_samples_per_s=ANCHORED_ROWS / e2e_s)
    kernels[-1].update(
        bound_terms_ms=tf32_terms(flops),
        share_of_bound=kernels[-1]['bound_ms'] / kernels[-1]['ms'],
        ptxas=eval_chain['fused_anchored_kernel'])

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
    # beside the bf16 products, the mask hash (as kernel 2's); the mask
    # loop's SASS instructions a hash beside it
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

    # 6b. the trainer's validation pass in one launch of each eval kernel,
    # against one launch a batch, and timed at the validation shape
    validation = validation_phase(args.seed, {
        'peak_flops': peak_flops, 'peak_bytes': peak_bytes,
        'peak_bf16': peak_bf16, 'hash_rate': hash_rate})

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
    for k in kernels:
        if k['name'] in validation:
            v = validation[k['name']]
            k['validation'] = {
                'rows': TRAIN_CONFIG['limit_val_batches'] * TRAIN_BATCH,
                'batch_ms': v['batch_ms']['median_ms'],
                'pass_ms': v['pass_ms']['median_ms'],
                'per_batch_pass_ms': v['per_batch_pass_ms']['median_ms'],
                'launches_per_epoch_before': v['launches_per_epoch_before'],
                'launches_per_epoch_after': v['launches_per_epoch_after'],
                **{key: v[key] for key in (
                    'bound_ms_batch', 'bound_ms_pass', 'library_ms_batch',
                    'library_ms_pass')}}

    # 8. the BO trial: data -> train -> evaluate -> metrics -> BO ->
    # results tree, through the port's driver
    x_id, y_id = bo_trial_phase(args.seed)
    # 8b. whole-fit dispatch on the trial's rows, against the per-epoch fit
    whole_fit_phase(args.seed, x_id, y_id,
                    {k['name']: k['ms'] for k in kernels})
    # 9. the user entry points around a trial: the HTTP server on the
    # trained bundles, then the workflow drivers
    http_phase(served_bundles, rng)
    workflow_phase(args.seed)
    # 10. the CNN layers through every UQ class (no kernel on their path)
    cnn_phase(args.seed)
    # 11. meshes over torch.distributed ranks: every sharded path against
    # its unsharded call, launches exact on each rank
    parallel_phase(args.seed)

    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)
    print(f'chip_smoke: {time.perf_counter() - wall:.1f} s', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
