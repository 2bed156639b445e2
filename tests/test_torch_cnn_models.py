"""The CNN through the port's UQ wrappers against the JAX package:
``CNN_DESCR`` (tests/test_cnn.py, 1 x 8 x 8 images) built by both
packages' builders, the JAX model's weights carried across by the bundle
format, then the plain model, the ensemble (3 members), Δ-UQ (anchored on
the channel axis, anchors ``(A, 1, 8, 8)``) and PAGER on the same numpy
images made from a seed: predictions within 1e-5, UE within 1e-3 relative
+ 1e-5 (tests/torch_parity.py). MC dropout is held statistically, as in
tests/test_torch_mc_dropout.py. Two per-step training epochs
(``shuffle=False``) give per-step losses within 1e-4 of the JAX trainer's;
``model.pth`` bundles load both ways; KDE, kNN-KDE and MVE answer where
JAX answers and raise where it raises. No kernel wrapper is called: the
fold, the MC fold, the anchored kernel's gate and the training plan all
refuse a Conv2d network."""
import copy
import csv
import os

import jax
import numpy as np
import pytest
import torch

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu import training as jtr
from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu_torch import model_builder as pmb
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.models import delta_uq, ensemble, mc_dropout
from nnueehcs_tpu_torch.nn.layers import Conv2d
from nnueehcs_tpu_torch.ops import fused_train as ft
from nnueehcs_tpu_torch.serving import Predictor

from test_torch_trainer_anchored import jax_trainer_permutations
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (TOL_MEAN, assert_ue_close, port_of,
                          randomize_params, randomize_state)
from torch_trainer_parity import LOOSE

# torch on one intra-op thread: the suite's xdist workers share the cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

CNN_DESCR = [
    {'Conv2d': {'args': [1, 4, 3], 'padding': 1}},
    {'BatchNorm2d': {'args': [4]}},
    {'ReLU': {}},
    {'MaxPool2d': {'args': [2]}},
    {'Flatten': {}},
    {'Linear': {'args': [4 * 4 * 4, 16]}},
    {'ReLU': {}},
    {'Linear': {'args': [16, 1]}},
]
IMAGE = (1, 8, 8)
ANCHORS = 7
TRAIN_LOSS_ATOL = 1e-4
STAT_FACTOR = 3.0            # as tests/test_torch_mc_dropout.py


@pytest.fixture(autouse=True)
def no_kernel_wrapper(monkeypatch):
    """Every kernel wrapper on a CNN model's path raises if called."""
    def refuse(*args, **kwargs):
        raise AssertionError('a kernel wrapper was called on a CNN path')
    monkeypatch.setattr(ensemble, 'fused_forward_prefolded', refuse)
    monkeypatch.setattr(mc_dropout, 'fused_mc_forward', refuse)
    monkeypatch.setattr(delta_uq, 'fused_anchored_stats', refuse)
    monkeypatch.setattr(ft, 'fused_epoch', refuse)


def images(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows,) + IMAGE).astype(np.float32)
    y = x.mean(axis=(1, 2, 3))[:, None].astype(np.float32)
    return x, y


def jax_cnn(kind, seed=0, **descr):
    """A JAX CNN model of ``kind``, initialised for 1 x 8 x 8 images (the
    JAX package defers a CNN's init to fit time) with BatchNorm state and
    affine parameters away from (0, 1)."""
    tc = {'loss': 'l1_loss'}
    arch = copy.deepcopy(CNN_DESCR)
    builders = {
        'mlp': lambda: jmb.MLPModelBuilder(arch, train_config=tc),
        'ensemble': lambda: jmb.EnsembleModelBuilder(
            arch, {'num_models': 3}, train_config=tc),
        'mc_dropout': lambda: jmb.MCDropoutModelBuilder(
            arch, {'num_samples': descr.get('num_samples', 8),
                   'dropout_percent': 0.2}, train_config=tc),
        'delta_uq': lambda: jmb.DeltaUQMLPModelBuilder(
            arch, {'estimator': descr.get('estimator', 'std'),
                   'num_anchors': ANCHORS}, train_config=tc),
        'pager': lambda: jmb.PAGERModelBuilder(
            arch, {'estimator': 'std', 'num_anchors': ANCHORS},
            train_config=tc),
        'mve': lambda: jmb.MVEModelBuilder(arch, {}, train_config=tc),
        'kde': lambda: jmb.KDEModelBuilder(arch, {'rtol': 1000},
                                           train_config=tc),
        'knn_kde': lambda: jmb.KNNKDEModelBuilder(arch, {'k': 5},
                                                  train_config=tc),
    }
    m = builders[kind]().build()
    assert not m.initialized
    m.init(jax.random.PRNGKey(seed), IMAGE)
    m.params = randomize_params(m.params, seed + 1)
    m.state = randomize_state(m.state, seed + 2)
    if kind in ('delta_uq', 'pager'):
        rng = np.random.default_rng(seed + 3)
        m.anchors = rng.normal(size=(ANCHORS,) + IMAGE).astype(np.float32)
        if kind == 'pager':
            m.anchors_Y = rng.normal(size=(ANCHORS, 1)).astype(np.float32)
    m.invalidate_cache()
    return m


@pytest.mark.parametrize('kind,estimator', [
    ('mlp', None), ('ensemble', None), ('delta_uq', 'std'),
    ('delta_uq', 'var'), ('pager', None), ('mve', None)])
def test_cnn_predictions_and_ue_match_jax(kind, estimator):
    jm = jax_cnn(kind, **({'estimator': estimator} if estimator else {}))
    pm = port_of(jm)
    first = pm.net.layers[0]
    assert isinstance(first, Conv2d)
    assert first.in_channels == (2 if kind in ('delta_uq', 'pager') else 1)
    x, _ = images(37, seed=5)
    if kind == 'mlp':
        np.testing.assert_allclose(pm(x).numpy(), np.asarray(jm(x)),
                                   **TOL_MEAN)
        return
    got = pm(x, return_ue=True)
    assert got[0].shape == (37, 1) and got[1].shape == (37, 1)
    assert_ue_close(got, jm(x, return_ue=True))


@pytest.mark.parametrize('kind', ['ensemble', 'mc_dropout', 'delta_uq',
                                  'pager'])
def test_no_kernel_takes_a_cnn(kind):
    """The folds of kernels 1, 2 and 5 and the training kernel's plan
    refuse a Conv2d network, as the JAX package's do."""
    from nnueehcs_tpu.ops.fused_ensemble import (
        fold_ensemble_params as jax_fold)
    from nnueehcs_tpu_torch.ops.fused_anchored import prepare_fused_anchored
    from nnueehcs_tpu_torch.ops.fused_ensemble import prepare_fused_weights
    from nnueehcs_tpu_torch.ops.fused_mc_dropout import prepare_mc_weights
    jm = jax_cnn(kind)
    pm = port_of(jm)
    for prepare in (prepare_fused_weights, prepare_mc_weights,
                    prepare_fused_anchored):
        assert prepare(pm.net) is None
    members = getattr(pm, 'num_models', 1)
    assert ft.plan_fused_train(pm.net, members, 32,
                               member_stacked=members > 1) is None
    if kind == 'ensemble':
        assert jax_fold(jm.net, jm.params, jm.state) is None


def test_anchored_budget_groups_image_rows(monkeypatch):
    """An NCHW request keeps its anchored rows in flight within the budget's
    activations (``ROW_ELEMENTS`` per budget row): small groups of anchors,
    the same answers as one group."""
    jm = jax_cnn('pager')
    pm = port_of(jm)
    x, _ = images(20, seed=6)
    want = [t.numpy() for t in pm(x, return_ue=True)]
    widest = pm.row_elements(torch.from_numpy(x))
    assert widest == 8 * 8 * 4          # the first Conv2d's output
    monkeypatch.setattr(pm, 'anchor_rows_budget', 64)
    # 64 rows of 128 activations hold 32 anchored image rows
    assert pm._rows_budget(torch.from_numpy(x)) == 64 * 128 // widest
    assert pm._rows_budget(torch.from_numpy(x[:, 0, 0])) == 64
    got = [t.numpy() for t in pm(x, return_ue=True)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert_ue_close(got, jm(x, return_ue=True))


@pytest.mark.parametrize('kind,widest', [
    ('ensemble', 3 * 4 * 64),       # three members' first Conv2d outputs
    ('mc_dropout', 4 * 64), ('delta_uq', 4 * 64), ('pager', 4 * 64)])
def test_image_requests_chunk_by_their_activations(monkeypatch, kind,
                                                   widest):
    """The largest bucket holds _MAX_BUCKET rows of ROW_ELEMENTS
    activations: an NCHW request is chunked, and its bucket capped, at the
    power of two of images that hold no more at the network's widest
    layer; the answers are those of one call, and JAX's."""
    from nnueehcs_tpu_torch.models import base
    jm = jax_cnn(kind)
    pm = port_of(jm)
    x, _ = images(70, seed=8)
    whole = [t.numpy() for t in pm(x, return_ue=True)]
    assert pm.row_elements(torch.from_numpy(x)) == widest
    for cap in (base._MAX_BUCKET, 128):
        monkeypatch.setattr(base, '_MAX_BUCKET', cap)
        limit = 1 << (cap * 128 // widest).bit_length() - 1
        assert pm.max_rows(torch.from_numpy(x)) == limit
        assert pm.max_rows(torch.from_numpy(x[:, 0, 0])) == cap
    assert limit < 70
    rows = []
    run = pm.eval_output
    monkeypatch.setattr(pm, 'eval_output',
                        lambda xb, **kw: rows.append(xb.shape[0]) or run(
                            xb, **kw))
    if kind == 'mc_dropout':
        pm.reseed(0)
    got = [t.numpy() for t in pm(x, return_ue=True)]
    assert rows == [limit] * -(-70 // limit)
    if kind != 'mc_dropout':        # a sample's masks follow its row
        for a, b in zip(got, whole):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert_ue_close(got, jm(x, return_ue=True))


def test_cnn_mc_dropout_matches_jax_within_sampling_noise():
    """The builder's Dropout before the hidden Linear (the first Conv2d is
    the first block and never gets one); at S = 1024 the port's mean
    and std within 3 x the JAX package's own deviation between two seeds
    at that S."""
    S = 1024
    jm = jax_cnn('mc_dropout', num_samples=S, seed=4)
    pm = port_of(jm)
    names = [type(l).__name__ for l in pm.net.layers]
    assert names == [type(l).__name__ for l in jm.net.layers]
    assert names.index('Dropout') == names.index('Linear') - 1
    x, _ = images(32, seed=11)
    jm.reseed(1)
    a = [np.asarray(t) for t in jm(x, return_ue=True)]
    jm.reseed(2)
    b = [np.asarray(t) for t in jm(x, return_ue=True)]
    got = [t.numpy() for t in pm(x, return_ue=True)]
    for i, name in enumerate(('mean', 'std')):
        noise = float(np.abs(a[i] - b[i]).max())
        dev = float(np.abs(got[i] - a[i]).max())
        assert noise > 0
        assert dev <= STAT_FACTOR * noise, (name, dev, noise)


def test_mc_masks_index_each_image_element():
    """On an NCHW activation a mask element is keyed by (row, flattened
    C x H x W column): the module walk equals a walk over the flattened
    activation."""
    from nnueehcs_tpu_torch.nn.network import build_network
    from nnueehcs_tpu_torch.ops.fused_mc_dropout import mc_forward_modules
    # the Dropout at the same module index (its hash key) in both
    conv = [{'Conv2d': {'args': [1, 3, 3], 'padding': 1}}, {'Identity': {}},
            {'Dropout': {'args': [0.5]}}, {'Flatten': {}},
            {'Linear': {'args': [3 * 64, 2]}}]
    flat = [conv[0], {'Flatten': {}}, conv[2], {'Identity': {}}, conv[4]]
    a, b = build_network(conv), build_network(flat)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(images(9, seed=2)[0])
    for got, want in zip(mc_forward_modules(a, x, 16, 7),
                         mc_forward_modules(b, x, 16, 7)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('layout', ['served', 'columns_reversed'])
def test_chip_smoke_mc_reference_is_the_served_answer(monkeypatch, layout):
    """``chip_smoke.py``'s MC-dropout reference (``mc_reference``, each
    mask element hashed from its (row, ((c H) + i) W + j) place, the
    statistics in float64) gives CNN-128's served answer, whose Dropouts
    take NCHW activations; a served mask with its columns in another order
    answers otherwise."""
    import chip_smoke
    from nnueehcs_tpu_torch.ops import fused_mc_dropout as fm
    monkeypatch.setattr(chip_smoke, 'DEVICE', 'cpu')
    model = chip_smoke.cnn_model('mc_dropout', chip_smoke.CNN_128, 0)
    model.num_samples = 16
    dims = [tuple(out.shape[1:]) for out in _layer_inputs(
        model.net, 'Dropout', torch.zeros((1,) + IMAGE))]
    assert (chip_smoke.WIDTH, 8, 8) in dims
    if layout == 'columns_reversed':
        scale = fm.dropout_scale
        monkeypatch.setattr(fm, 'dropout_scale',
                            lambda *a: scale(*a).flip(1))
    nets = [copy.deepcopy(model.net)]
    x = torch.from_numpy(images(6, seed=5)[0])
    call = model._eval_calls
    got = model(x, return_ue=True)
    want = chip_smoke.cnn_reference(model, nets, x, call, None)
    apart = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if layout == 'served':
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)
    else:
        assert apart > 1e-3


def _layer_inputs(net, name, x):
    """The inputs of ``net``'s layers of class ``name`` on ``x``."""
    seen = []
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
        for layer in net.layers if type(layer).__name__ == name]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for hook in hooks:
            hook.remove()
    return seen


def _losses(log_dir):
    with open(os.path.join(log_dir, 'metrics.csv')) as f:
        return np.array([float(r['train_loss']) for r in csv.DictReader(f)
                         if r.get('train_loss')])


@pytest.mark.parametrize('kind', ['mlp', 'ensemble', 'mc_dropout',
                                  'delta_uq', 'pager', 'mve'])
def test_cnn_training_losses_match_jax(tmp_path, kind, monkeypatch):
    """Two epochs of 4 per-step batches from the same weights, unshuffled:
    the per-step losses within 1e-4 of the JAX trainer's (MC dropout's
    masks come from each package's own stream, so its losses are held
    only to be finite). Δ-UQ and PAGER train on the anchored doubled
    batch, their permutations fed from JAX's draws."""
    jm = jax_cnn(kind)
    pm = port_of(jm)
    x, y = images(64, seed=3)
    cfg = {'accelerator': 'cpu', 'max_epochs': 2, 'gradient_clip_val': 5.0,
           'log_every_n_steps': 1}

    def loaders(pkg):
        return (pkg.DataLoader(pkg.ArrayDataset(x, y), 16, shuffle=False,
                               drop_last=True),
                pkg.DataLoader(pkg.ArrayDataset(x, y), 16))
    jt = jtr.Trainer('t', cfg, callbacks=jm.get_callbacks(),
                     log_dir=str(tmp_path), version='jax')
    jt.fit(jm, *loaders(jtr))
    pt = ptr.Trainer('t', cfg, callbacks=pm.get_callbacks(),
                     log_dir=str(tmp_path), version='port', device='cpu')
    if kind in ('delta_uq', 'pager'):
        monkeypatch.setattr(pt, 'anchor_permutations',
                            jax_trainer_permutations())
    pt.fit(pm, *loaders(ptr))
    assert pt.fused_epochs_used == 0
    got, want = _losses(pt.logger.log_dir), _losses(jt.logger.log_dir)
    assert got.shape == want.shape == (8,)
    assert np.all(np.isfinite(got))
    if kind == 'mc_dropout':
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_LOSS_ATOL)
    if kind in ('delta_uq', 'pager'):
        assert tuple(pm.anchors.shape) == (ANCHORS,) + IMAGE
        np.testing.assert_array_equal(pm.anchors.numpy(),
                                      np.asarray(jm.anchors))


def test_cnn_trains_in_bf16_mixed_where_jax_cannot(tmp_path):
    """Trainer precision 'bf16-mixed' on a network no kernel takes: by
    JAX's precision rules both packages train it step by step in bf16. The
    JAX trainer raises there (the gradient of its bf16 convolution, which
    sums into fp32, meets operands of two dtypes); the port trains, its
    first step's loss within twice the bf16-vs-fp32 gap of the JAX
    network's own bf16 training-mode loss on that batch."""
    x, y = images(64, seed=3)
    cfg = {'accelerator': 'cpu', 'max_epochs': 2, 'gradient_clip_val': 5.0,
           'log_every_n_steps': 1, 'precision': 'bf16-mixed'}

    def loader(pkg):
        return pkg.DataLoader(pkg.ArrayDataset(x, y), 16, shuffle=False,
                              drop_last=True)
    jm = jax_cnn('ensemble')
    with pytest.raises(TypeError, match='same dtypes'):
        jtr.Trainer('t', cfg, log_dir=str(tmp_path), version='jax').fit(
            jm, loader(jtr))
    jm = jax_cnn('ensemble')
    pm = port_of(jm)
    first = []
    for precision in ('bf16-mixed', None):
        jm.set_precision(precision)
        first.append(float(jm.training_loss(
            jm.params, jm.state, (x[:16], y[:16]),
            jax.random.PRNGKey(0))[0]))
    t = ptr.Trainer('t', cfg, log_dir=str(tmp_path), version='port',
                    device='cpu')
    t.fit(pm, loader(ptr), loader(ptr))
    assert t.fused_epochs_used == 0 and pm.precision == 'bf16-mixed'
    losses = _losses(t.logger.log_dir)
    assert losses.shape == (8,) and np.all(np.isfinite(losses))
    gap = abs(first[0] - first[1])
    assert gap > 0
    assert abs(losses[0] - first[0]) <= 2 * gap


@pytest.mark.parametrize('kind', ['ensemble', 'delta_uq', 'pager',
                                  'mc_dropout'])
def test_cnn_bundles_load_both_ways(tmp_path, kind):
    jm = jax_cnn(kind)
    x, _ = images(21, seed=9)
    jtr.save_model(jm, str(tmp_path / 'jax.pth'))
    pm = ptr.load_model(str(tmp_path / 'jax.pth'), device='cpu')
    ptr.save_model(pm, str(tmp_path / 'port.pth'))
    back = jtr.load_model(str(tmp_path / 'port.pth'))
    if kind == 'mc_dropout':
        np.testing.assert_allclose(
            pm.net(torch.from_numpy(x)).detach().numpy(),
            np.asarray(back.net.apply(back.params, back.state, x,
                                      EVAL_MODE)[0]), **TOL_MEAN)
        return
    assert_ue_close(pm(x, return_ue=True), back(x, return_ue=True))
    assert_ue_close(pm(x, return_ue=True), jm(x, return_ue=True))


@pytest.mark.parametrize('kind', ['kde', 'knn_kde', 'mve'])
def test_density_and_mve_on_a_cnn_answer_or_raise_as_jax(tmp_path, kind):
    """One fit of each through both trainers: MVE answers in both (the
    same answers), KDE and kNN-KDE raise in both: their corpora are
    tables (N, d), and a batch of images is not."""
    x, y = images(32, seed=12)
    outcome = {}
    for pkg, name in ((jtr, 'jax'), (ptr, 'port')):
        m = jax_cnn(kind) if pkg is jtr else port_of(jax_cnn(kind))
        kw = {} if pkg is jtr else {'device': 'cpu'}
        trainer = pkg.Trainer('t', {'accelerator': 'cpu', 'max_epochs': 1},
                              callbacks=m.get_callbacks(),
                              log_dir=str(tmp_path), version=name, **kw)
        dl = pkg.DataLoader(pkg.ArrayDataset(x, y), 16, drop_last=True)
        try:
            trainer.fit(m, dl, dl)
            outcome[name] = [np.asarray(t) for t in m(x, return_ue=True)]
        except ValueError as err:
            outcome[name] = type(err)
    if kind == 'mve':
        # after a fit, as tests/torch_trainer_parity.py holds fitted
        # answers: the Conv2d bias that BatchNorm cancels walks on rounding
        # noise from zero Adam moments, and the running mean with it
        for got, want in zip(outcome['port'], outcome['jax']):
            np.testing.assert_allclose(got, want, **LOOSE)
    else:
        assert outcome['port'] is ValueError and outcome['jax'] is ValueError


def test_port_builders_draw_cnn_weights_at_build():
    """A deliberate difference: the JAX package defers a CNN's init to fit
    time (the image's height and width are not in the architecture); the
    port's builders draw every parameter at build from the seed, as for an
    MLP, since no shape in a CNN depends on the image size but the first
    Linear's, which the architecture states."""
    for builder in (pmb.MLPModelBuilder(CNN_DESCR, device='cpu'),
                    pmb.EnsembleModelBuilder(CNN_DESCR, {'num_models': 2},
                                             device='cpu')):
        a, b = builder.build(), builder.build()
        conv = a.net.layers[0]
        assert float(conv.weight.abs().max()) > 0
        for p, q in zip(a.net.parameters(), b.net.parameters()):
            assert torch.equal(p, q)
    j = jmb.MLPModelBuilder(CNN_DESCR).build()
    assert not j.initialized


def test_cnn_serves_nchw_requests_in_both_precisions():
    """``Predictor`` pads and trims NCHW requests (warmed with the image's
    shape; without it the warm-up raises, naming ``warmup(sample_shape)``),
    answers as the model does, and in bf16-mixed the model answers in fp32
    within the bf16-vs-fp32 gap of JAX's own."""
    jm = jax_cnn('ensemble')
    pm = port_of(jm)
    with pytest.raises(ValueError, match=r'warmup\(sample_shape\)'):
        Predictor(pm, buckets=(16, 64), device='cpu')
    pred = Predictor(pm, buckets=(16, 64), device='cpu', warmup=False)
    assert pred.num_features is None
    with pytest.raises(ValueError, match=r'warmup\(sample_shape\)'):
        pred.warmup()
    assert pred.warmup(IMAGE) > 0
    x, _ = images(70, seed=13)
    assert_ue_close(pred.predict(x), jm(x, return_ue=True))
    assert_ue_close(pred.predict(x[0:1]), jm(x[0:1], return_ue=True))
    x64 = x.astype(np.float64)
    assert_ue_close(pm(x64, return_ue=True), jm(x, return_ue=True))
    ref32 = [np.asarray(t) for t in jm(x, return_ue=True)]
    jm.set_precision('bf16-mixed')
    pm.set_precision('bf16-mixed')
    want = [np.asarray(t, np.float32) for t in jm(x, return_ue=True)]
    got = [t.numpy() for t in pm(x, return_ue=True)]
    for g, w, r in zip(got, want, ref32):
        assert g.dtype == np.float32
        assert np.abs(g - w).max() <= np.abs(w - r).max()
