#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nnueehcs_tpu_torch``) on one card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version, serves requests through the
port's ``Predictor`` on the flagship ensemble (8 members, 5 inputs, 7
Linear layers 128 wide, weights drawn from ``--seed``), checks every answer
against the unfused network on the card, and times the kernel beside its
plain version, a batched-GEMM PyTorch yardstick and its roofline bound.
It prints one JSON line per phase, then the card's ``nvidia-smi`` name and
power limit, then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a card it exits non-zero before doing anything.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.ops import _build
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   fused_forward_prefolded,
                                                   prepare_fused_weights)
from nnueehcs_tpu_torch.serving import DEFAULT_BUCKETS, Predictor
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

DEVICE = 'cuda'
ROWS = 262_144                       # the bench's evaluation batch
REQUESTS = (1, 300, 4096, 65_536, 262_144)
WARMUP, TRIALS = 5, 10               # the bench's timing protocol
# kernel vs plain: the tolerances of tests/test_fused_ensemble.py
TOL_MEAN = {'rtol': 1e-5, 'atol': 1e-5}
TOL_STD = {'rtol': 1e-3, 'atol': 1e-5}
KERNELS = [{
    'name': 'fused_ensemble',
    'route': 'cuda',
    'source': 'nnueehcs_tpu_torch/ops/csrc/fused_ensemble.cu',
    'replaces': 'nnueehcs_tpu/ops/fused_ensemble.py:195',
}]
WRAPPERS = {'fused_ensemble': fused_forward_prefolded}
# (name substring, fp32 non-tensor FLOP/s, memory bytes/s), NVIDIA data
# sheets at full power; the first match wins
PEAKS = [('H100 PCIe', 51.2e12, 2.0e12), ('H100 NVL', 60e12, 3.9e12),
         ('H200', 67e12, 4.8e12), ('H100', 67e12, 3.35e12)]


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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


def nvidia_smi(query):
    try:
        out = subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return 'not available'
    return out.stdout.strip() if out.returncode == 0 else 'not available'


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


def build_model(seed, layers=FLAGSHIP):
    model = EnsembleModelBuilder(layers, {'num_models': MEMBERS}, seed=seed,
                                 device=DEVICE).build()
    randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    return model


def reference_ue(model, x):
    """The unfused network, member by member through the modules."""
    with torch.no_grad():
        out = model.net(x)
    return out.mean(0), out.std(0, correction=1)


def library_chain(fw, x):
    """Yardstick only: the same function as one batched GEMM per layer."""
    last = fw.num_layers - 1
    h = x.expand(fw.num_members, *x.shape)
    for l, relu in enumerate(fw.relus):
        w, b = fw.ws[l], fw.b_all[l]
        if l == last:
            w, b = w[:, :, :fw.out_dim], b[:, :fw.out_dim]
        h = torch.baddbmm(b.unsqueeze(1), h, w)
        if relu:
            h = torch.relu(h)
    std, mean = torch.std_mean(h, dim=0, correction=1)
    return mean, std


def event_ms(fn):
    """Median and spread of ``TRIALS`` passes after ``WARMUP``, each pass
    bracketed by CUDA events."""
    for _ in range(WARMUP):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(TRIALS)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    return {'median_ms': ms[len(ms) // 2], 'min_ms': ms[0], 'max_ms': ms[-1]}


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
    rng = np.random.default_rng(args.seed)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi('name,power.limit')
    peak_flops, peak_bytes = next(((f, b) for key, f, b in PEAKS if key in kind),
                                  (67e12, 3.35e12))
    emit('device', kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         fp32_peak_flops=peak_flops, peak_bytes_per_s=peak_bytes,
         peak_source=next((key for key, _, _ in PEAKS if key in kind),
                          'not in table: H100 SXM assumed'))

    # 2. build
    info = _build.build_info()
    emit('build', seconds=info.seconds, library=str(info.path.name),
         ptxas=ptxas_report(info.log))

    # 3. kernel vs plain on the card
    model = build_model(args.seed)
    fw = prepare_fused_weights(model.net)
    check(fw is not None, 'flagship ensemble did not fold')
    shifted = build_model(args.seed)
    with torch.no_grad():
        shifted.net.layers[-1].bias += 1e3          # |mean| >> std
    fw_shifted = prepare_fused_weights(shifted.net)
    fw_wide = prepare_fused_weights(build_model(args.seed, WIDE_INPUT).net)
    check(fw_wide is not None, f'{WIDE_IN}-input ensemble did not fold')
    flagship_err = None
    for case, weights, rows in (('flagship', fw, ROWS), ('ragged', fw, 1000),
                                ('mean_1e3', fw_shifted, 4096),
                                (f'input_{WIDE_IN}', fw_wide, 1000)):
        x = torch.as_tensor(rng.normal(size=(rows, weights.in_dim)),
                            dtype=torch.float32, device=DEVICE)
        mean, std = fused_forward_prefolded(weights, x)
        ref_mean, ref_std = fused_forward_plain(weights, x)
        torch.cuda.synchronize()
        errs = {'mean': compare(f'{case} mean', mean, ref_mean, TOL_MEAN),
                'std': compare(f'{case} std', std, ref_std, TOL_STD)}
        if case == 'flagship':
            flagship_err = max(errs.values())
        emit('kernel_vs_plain', case=case, rows=rows,
             max_abs_err=errs, tol_mean=TOL_MEAN, tol_std=TOL_STD)

    # 4. the serving path: builder -> Predictor -> EnsembleModel -> kernel
    x_requests = [rng.normal(size=(n, IN_DIM)).astype(np.float32)
                  for n in REQUESTS]
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    start = time.perf_counter()
    predictor = Predictor(model, buckets=DEFAULT_BUCKETS, device=DEVICE)
    warmup_s = time.perf_counter() - start
    answers, latencies = [], []
    for x in x_requests:
        start = time.perf_counter()
        answers.append(predictor.predict(x))
        latencies.append(time.perf_counter() - start)
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    # warm-up drives each bucket once; a request runs once per chunk of up
    # to the largest bucket
    expected = len(DEFAULT_BUCKETS) + sum(-(-n // DEFAULT_BUCKETS[-1])
                                          for n in REQUESTS)
    check(launches['fused_ensemble'] == expected,
          f'fused_ensemble launched {launches["fused_ensemble"]} times on the '
          f'serving path, expected {expected}')
    errs = []
    for x, (mean, std) in zip(x_requests, answers):
        ref_mean, ref_std = reference_ue(model, torch.from_numpy(x).to(DEVICE))
        errs.append({'rows': len(x),
                     'mean': compare(f'{len(x)}-row mean', torch.from_numpy(mean),
                                     ref_mean.cpu(), TOL_MEAN),
                     'std': compare(f'{len(x)}-row std', torch.from_numpy(std),
                                    ref_std.cpu(), TOL_STD)})
    torch.cuda.synchronize()
    emit('serving', warmup_s=warmup_s, request_rows=list(REQUESTS),
         request_s=latencies, launches=launches, expected_launches=expected,
         max_abs_err_vs_unfused=errs)

    # 5. timing at the bench's batch
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
    x_host = x.cpu().numpy()
    e2e_s = timed_passes(lambda: predictor.predict(x_host), WARMUP, TRIALS)
    flops = 2.0 * ROWS * fw.num_members * fw.macs_per_row
    moved = 4.0 * (x.numel() + fw.w_all.numel() + fw.b_all.numel()
                   + 2 * ROWS * fw.out_dim)
    bound_s = max(flops / peak_flops, moved / peak_bytes)
    bound_by = 'operations' if flops / peak_flops >= moved / peak_bytes \
        else 'bytes'
    kernel_ms = kernel_t['median_ms']
    emit('timing', rows=ROWS, kernel=kernel_t, kernel_again=kernel_t2,
         plain=plain_t, library_baddbmm=library_t, flops=flops, bytes=moved,
         bound_ms=1e3 * bound_s, bound_by=bound_by,
         kernel_samples_per_s=ROWS / (kernel_ms / 1e3),
         kernel_share_of_bound=1e3 * bound_s / kernel_ms,
         predictor_e2e_median_s=float(np.median(e2e_s)),
         predictor_e2e_samples_per_s=ROWS / float(np.median(e2e_s)),
         clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))

    print(smi, flush=True)
    print(json.dumps({'kernels': [dict(
        KERNELS[0], launches=launches['fused_ensemble'],
        max_abs_err=flagship_err, ms=kernel_ms, plain_ms=plain_t['median_ms'],
        bound_ms=1e3 * bound_s, bound_by=bound_by,
        library_ms=library_t['median_ms'])]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)
    print(f'chip_smoke: {time.perf_counter() - wall:.1f} s', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
