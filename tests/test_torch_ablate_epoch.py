"""The port's attribution probe of the fused training epoch
(``nnueehcs_tpu_torch/ops/ablate_epoch.py``, its plain version on the CPU)
against the TPU probe it replaces (``experiments/grid_r5/attrib_train.py``
``ablate_epoch``, run in Pallas interpret mode) on the same JAX-packed
buffers and batches: every mode, and the fix candidates (``unroll``,
``gn_fused``, ``opt_chunk``), which change how the kernel runs, not what it
computes.

Both sides start from non-zero Adam moments and non-trivial BatchNorm
state, as tests/test_torch_fused_train.py does, and share its tolerances:
per-step losses 5e-6 absolute; Adam moments 1e-6; parameters and BatchNorm
running statistics 1e-5. The kernel is held to this plain version on a
card by tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses
import os
import sys

import pytest
import torch

from nnueehcs_tpu.ops import fused_train as ft
from nnueehcs_tpu_torch.ops import ablate_epoch as ae
from nnueehcs_tpu_torch.ops import fused_train as pt

from test_torch_fused_train import (_assert_epochs_agree, _batches,
                                    _jax_model, _moments, _plans, _torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBES = os.path.join(REPO, 'experiments', 'grid_r5')
if _PROBES not in sys.path:
    sys.path.insert(0, _PROBES)
import attrib_train  # noqa: E402

STEPS = 4


def _problem(kind='ensemble', members=2, per_member=False, clip=5.0):
    m = _jax_model(kind, 'l1_loss', per_member, 0.2, members)
    plan, pplan = _plans(m, members, 'l1_loss', per_member, clip=clip)
    theta = ft.pack_tree(plan, m.params)
    sigma = ft.pack_state(plan, m.state)
    mu, nu = _moments(plan, m.params, 5)
    xs, ys = _batches(plan, steps=STEPS, seed=2)
    return plan, pplan, (theta, mu, nu, sigma, xs, ys)


CASES = {
    # name: (mode, unroll, gn_fused, opt_chunk); opt_chunk in rows of 128
    **{mode: (mode, 1, False, None) for mode in ae.MODES},
    'unroll2': ('prod', 2, False, None),
    'gn_fused': ('prod', 1, True, None),
    'opt_chunk8': ('prod', 1, False, 8),
    'no_opt_gn_fused_unroll4': ('no_opt', 4, True, None),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_ablate_epoch_matches_the_jax_probe(case):
    mode, unroll, gn_fused, opt_chunk = CASES[case]
    plan, pplan, bufs = _problem()
    theta, mu, nu, sigma, xs, ys = bufs
    want = attrib_train.ablate_epoch(
        plan, theta, mu, nu, sigma, xs, ys, 1e-3, 3, mode=mode,
        unroll=unroll, gn_fused=gn_fused, opt_chunk=opt_chunk or 1024,
        interpret=True)
    port = _torch(*bufs)
    got = ae.ablate_epoch(pplan, *port, 1e-3, 3, mode=mode, unroll=unroll,
                          gn_fused=gn_fused, opt_chunk=opt_chunk)
    _assert_epochs_agree(want, got)
    before = _torch(theta, mu, nu, sigma)
    for name, a, b in zip(('theta', 'm', 'v'), got[:3], before[:3]):
        assert torch.equal(a, b) == (mode != 'prod'), name
    assert torch.equal(got[3], before[3]) == (mode == 'empty')


def test_gn_fused_with_a_binding_clip_matches_the_jax_probe():
    """With a clip below every step's gradient norm, the clip scale
    carries gn_fused's sum of squares into every update."""
    plan, pplan, bufs = _problem(clip=1e-2)
    want = attrib_train.ablate_epoch(plan, *bufs, 1e-3, 3, gn_fused=True,
                                     interpret=True)
    norms = torch.empty(STEPS)
    got = ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3, gn_fused=True,
                          norms=norms)
    assert bool((norms >= 1e-2).all()), norms
    _assert_epochs_agree(want, got)
    # the clip moved the update: the same epoch unclipped is elsewhere
    free = ae.ablate_epoch(dataclasses.replace(pplan, clip=None),
                           *_torch(*bufs), 1e-3, 3)
    assert not torch.allclose(free[1], got[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ae.MODES)
def test_norms_are_the_clip_input(mode, monkeypatch):
    """``norms`` receives each step's global gradient norm in the modes
    with a gradient, and is refused in the others."""
    _, pplan, bufs = _problem()
    norms = torch.full((STEPS,), -1.0)
    if mode not in ('prod', 'no_opt'):
        with pytest.raises(ValueError, match='norms'):
            ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3, mode=mode,
                            norms=norms)
        return
    g_seen = []
    real_adam = pt._adam

    def spy(plan, k, theta, m, v, g, lr, t):
        g_seen.append(torch.sqrt((g * g).sum()))
        return real_adam(plan, k, theta, m, v, g, lr, t)
    monkeypatch.setattr(pt, '_adam', spy)
    ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3, mode=mode, norms=norms)
    assert bool((norms > 0).all())
    if mode == 'prod':
        assert torch.equal(norms, torch.stack(g_seen))
    with pytest.raises(ValueError, match='norms'):
        ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3, mode=mode,
                        norms=torch.empty(STEPS + 1))


@pytest.mark.parametrize('kind,members,per_member', [
    ('mc', 1, False),            # dropout ignored, joint sweep of one net
    ('ensemble', 3, True),       # per-member loss ignored: joint mean
])
def test_ablate_epoch_ignores_dropout_and_per_member_loss(kind, members,
                                                          per_member):
    plan, pplan, bufs = _problem(kind, members, per_member)
    assert plan.n_drop > 0 or plan.per_member
    want = attrib_train.ablate_epoch(plan, *bufs, 1e-3, 3, interpret=True)
    got = ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3)
    _assert_epochs_agree(want, got)


def test_prod_is_the_plain_epoch_bit_for_bit():
    """On a dropout-free joint-mean plan, the probe's prod control is
    kernel 3's plain epoch, value for value."""
    _, pplan, bufs = _problem(members=3)
    a = ae.ablate_epoch(pplan, *_torch(*bufs), 1e-3, 3)
    b = pt.fused_epoch(pplan, *_torch(*bufs), 1e-3, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_probe_plan_drops_masks_and_the_per_member_loss():
    _, pplan, _ = _problem('mc', 1)
    probe = ae.probe_plan(pplan)
    assert pplan.n_drop > 0 and probe.n_drop == 0
    assert all(L.mask_idx == -1 for L in probe.lins)
    assert [L.w_off for L in probe.lins] == [L.w_off for L in pplan.lins]
    assert not ae.probe_plan(_problem('ensemble', 2, True)[1]).per_member


def test_ablate_epoch_checks_its_inputs():
    _, pplan, bufs = _problem()
    port = _torch(*bufs)
    before = ae.ablate_epoch.launches
    with pytest.raises(ValueError, match='mode'):
        ae.ablate_epoch(pplan, *port, 1e-3, 0, mode='fast')
    with pytest.raises(ValueError, match='unroll'):
        ae.ablate_epoch(pplan, *port, 1e-3, 0, unroll=3)
    with pytest.raises(ValueError, match='opt_chunk'):
        ae.ablate_epoch(pplan, *port, 1e-3, 0, opt_chunk=0)
    with pytest.raises(ValueError, match='xs'):
        ae.ablate_epoch(pplan, *port[:4], port[4][:, :8], port[5], 1e-3, 0)
    with pytest.raises(TypeError, match='float32'):
        ae.ablate_epoch(pplan, port[0].double(), *port[1:], 1e-3, 0)
    assert ae.ablate_epoch.launches == before
