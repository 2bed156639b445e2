"""The training kernel's launch layout (``ops/fused_train.py``
``train_layout``), the one place that decides how a plan runs on the card:
one thread-block cluster per member, each block owning a slice of the 128
lanes, the exchanged activations resident in shared memory where they fit.
Checked over the plans the training tests build and over batches 8 to
1,024. The order in which the kernel adds its partial sums is the card's
to show: the determinism tests run it twice, bit for bit."""
import numpy as np
import pytest

from nnueehcs_tpu_torch.model_builder import (DeltaUQMLPModelBuilder,
                                              EnsembleModelBuilder,
                                              MCDropoutModelBuilder,
                                              MVEModelBuilder)
from nnueehcs_tpu_torch.ops import fused_train as ft

from torch_parity import descr

BATCHES = (8, 40, 128, 256, 512, 1024)


def _flagship(out_dim=1):
    return descr(in_dim=5, width=128, hidden=6, out_dim=out_dim)
# (MVEModelBuilder widens the last Linear to its two outputs itself)


# name: (builder, architecture, members, plan keywords); the plans of
# tests/test_torch_fused_train*.py, tests/test_torch_trainer*.py and the
# card tests (flagship, MVE, MC dropout, the Δ-UQ/PAGER anchored net)
PLANS = {
    'flagship_joint_l1': (EnsembleModelBuilder, _flagship(), 8, {}),
    'flagship_per_member_mse': (EnsembleModelBuilder, _flagship(), 8,
                                dict(loss='mse_loss', per_member=True,
                                     weight_decay=0.01)),
    'flagship_mve': (MVEModelBuilder, _flagship(), 1,
                     dict(loss='gaussian_nll')),
    'flagship_mc': (MCDropoutModelBuilder, _flagship(), 1, {}),
    'anchored': (DeltaUQMLPModelBuilder, _flagship(), 1, {}),
    'small_ensemble': (EnsembleModelBuilder, descr(in_dim=5, width=32,
                                                   hidden=2), 3, {}),
    'narrow_24': (EnsembleModelBuilder, descr(in_dim=5, width=24, hidden=3),
                  2, dict(loss='mse_loss')),
    'mve_head': (MVEModelBuilder, descr(in_dim=7, width=24, hidden=3), 1,
                 dict(loss='gaussian_nll')),
    'wide_out_128': (EnsembleModelBuilder, descr(in_dim=128, width=128,
                                                 hidden=1, out_dim=128),
                     2, {}),
    'wide_out_40': (EnsembleModelBuilder, descr(in_dim=9, width=64,
                                                hidden=2, out_dim=40),
                    2, dict(per_member=True)),
    'single_linear': (EnsembleModelBuilder, descr(in_dim=9, width=9,
                                                  hidden=0, out_dim=4), 2, {}),
    'deep': (EnsembleModelBuilder, descr(in_dim=5, width=16, hidden=20), 2,
             {}),
}


def _plan(name, batch, bf16=False):
    builder, arch, members, kw = PLANS[name]
    if builder is EnsembleModelBuilder:
        cfg = {'num_models': members}
    elif builder is MCDropoutModelBuilder:
        cfg = {'num_samples': 4, 'dropout_percent': 0.1}
    elif builder is DeltaUQMLPModelBuilder:
        cfg = {'num_anchors': 4}
    else:
        cfg = {}
    model = builder(arch, cfg, device='cpu').build()
    plan = ft.plan_fused_train(model.net, members, batch, clip=5.0, bf16=bf16,
                               member_stacked=builder is EnsembleModelBuilder,
                               **kw)
    assert plan is not None, name
    return plan


CASES = [(name, batch) for name in sorted(PLANS) for batch in BATCHES]


@pytest.mark.parametrize('name,batch', CASES)
def test_layout_invariants(name, batch):
    plan = _plan(name, batch)
    lay = ft.train_layout(plan)
    assert (lay.cluster, lay.threads) == (ft.CLUSTER, ft.THREADS)
    # the cluster's blocks split the 128 lanes into equal slices of whole
    # float4 groups, one owner a lane
    assert lay.cluster * lay.lanes == ft.LANES and lay.lanes % 4 == 0
    # out_blocks (the blocks that run the last layer and the loss) are
    # exactly the owners of the lanes below out_pad
    assert lay.out_blocks * lay.lanes >= plan.out_pad \
        > (lay.out_blocks - 1) * lay.lanes
    if plan.loss == 'gaussian_nll':
        assert lay.out_blocks == 1
    # shared memory within the card's limit
    assert 0 < lay.smem_bytes <= ft.SMEM_LIMIT


@pytest.mark.parametrize('name,batch', CASES)
def test_layout_regions_are_disjoint_and_aligned(name, batch):
    """Shared-memory regions and each member's scratch regions do not
    overlap, start on 16 bytes (cp.async and float4 access) and fit in the
    sizes the wrapper allocates."""
    plan = _plan(name, batch)
    lay = ft.train_layout(plan)
    B, L, X = plan.batch, lay.lanes, lay.x_stride
    smem = [(lay.smem_w, 2 * lay.w_slot),
            (lay.smem_red, ft.red_floats(L, lay.threads))]
    scratch = []
    if lay.resident:
        smem += [(lay.smem_x, 2 * B * X), (lay.smem_d, 4 * B * L)]
        assert lay.scratch_x == lay.scratch_d == -1
    else:
        assert lay.smem_x == lay.smem_d == -1
        scratch.append((lay.scratch_x, 2 * B * X))
    for r in range(lay.cluster):
        start = lay.scratch_blocks + r * lay.block_floats
        if not lay.resident:
            scratch.append((start + lay.scratch_d, 2 * B * L))
        scratch += [(start + lay.scratch_zh, plan.n_bn * B * L),
                    (start + lay.scratch_inv, plan.n_bn * L)]
    for regions, total in ((smem, lay.smem_bytes // 4),
                           (scratch, lay.member_floats)):
        regions = sorted(regions)
        for (a, n), (b, _) in zip(regions, regions[1:]):
            assert a + n <= b
        assert regions[-1][0] + regions[-1][1] <= total
        assert all(a % 4 == 0 and a >= 0 for a, _ in regions)
    assert lay.member_floats % 4 == 0 and lay.block_floats % 4 == 0
    assert lay.w_slot >= ft.LANES * L        # the forward slice, 128 x L


@pytest.mark.parametrize('name', sorted(PLANS))
def test_layout_is_the_same_for_both_forms(name):
    """The bf16 form runs the fp32 form's layout; the layout depends on the
    batch, widths and slots, not on the precision."""
    for batch in BATCHES:
        assert ft.train_layout(_plan(name, batch)) == \
            ft.train_layout(_plan(name, batch, bf16=True))


def test_flagship_is_resident_and_the_anchored_plan_is_not():
    """At the compiled cluster size the flagship (batch 128) keeps its
    activations in shared memory; the Δ-UQ/PAGER plan (batch 256) and the
    battery's larger batches exchange them through device memory."""
    assert ft.train_layout(_plan('flagship_joint_l1', 128)).resident
    for batch in (256, 512, 1024):
        assert not ft.train_layout(_plan('anchored', batch)).resident
    lay = ft.train_layout(_plan('flagship_joint_l1', 128))
    assert lay.out_blocks == 1 and lay.ints()[0] == ft.CLUSTER
    assert len(lay.ints()) == len(ft.LAYOUT_FIELDS)


@pytest.mark.parametrize('name', sorted(PLANS))
def test_residency_falls_with_the_batch(name):
    """A batch whose activations are resident in shared memory keeps them
    there at every smaller batch of the same plan."""
    resident = [ft.train_layout(_plan(name, b)).resident for b in BATCHES]
    assert resident == sorted(resident, reverse=True)
