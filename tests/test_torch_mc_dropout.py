"""The port's MC-dropout serving path on the CPU against the JAX package:
the fold and its dropout positions, the builder's architecture, the
dropout-free outputs, the hash masks, the per-call stream, bundles both
ways and ``Predictor``.

The two packages draw their masks from different generators (the port's
counter hash, JAX's ``jax.random``), so the sampled statistics are held
statistically: at S = 4096 the port's mean and std may differ from the JAX
vmap path's by at most 3 x the JAX package's own deviation between two
seeds. Everything without dropout is held exactly, with mean 1e-5 absolute
and relative; std 1e-3 relative, 1e-5 absolute (as tests/torch_parity.py).
The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import \
    MCDropoutModelBuilder as JaxMCDropoutModelBuilder
from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu.ops.fused_ensemble import \
    fold_mc_dropout_params as jax_fold_mc_dropout_params
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu.training import save_model as jax_save_model
from nnueehcs_tpu_torch.model_builder import MCDropoutModelBuilder
from nnueehcs_tpu_torch.models import base
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc
from nnueehcs_tpu_torch.ops.fused_ensemble import prepare_fused_weights
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_parity import (TOL_MEAN, assert_ue_close, descr, jax_mc_dropout,
                          port_of)

# at S = 4096: the port against JAX within 3 x JAX's own seed-to-seed spread
STAT_FACTOR = 3.0


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _uint32_lowbias32(x):
    x = np.asarray(x, np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_hash_is_uint32_arithmetic():
    """The int64 emulation in the plain version is the kernel's uint32
    arithmetic: lowbias32 and the mask bits against numpy's uint32."""
    vals = np.random.default_rng(0).integers(0, 2**32, size=4096,
                                             dtype=np.uint64)
    vals[:4] = [0, 1, 2**32 - 1, 2**31]
    got = mc.lowbias32(torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  _uint32_lowbias32(vals).astype(np.uint64))
    assert all(mc.lowbias32(int(v)) == int(_uint32_lowbias32(v))
               for v in vals[:64])
    seed, sample, key = 0xDEADBEEF, 77, 5
    with np.errstate(over='ignore'):
        stream = _uint32_lowbias32(
            _uint32_lowbias32(np.uint32(seed) + np.uint32(sample)
                              * np.uint32(0x9E3779B9))
            + np.uint32(key) * np.uint32(0x85EBCA6B))
        assert mc.mask_stream(seed, sample, key) == int(stream)
        rows = np.arange(300, dtype=np.uint32)[:, None]
        cols = np.arange(40, dtype=np.uint32)[None, :]
        bits = _uint32_lowbias32(stream + rows * np.uint32(0xC2B2AE35)
                                 + cols * np.uint32(0x27D4EB2F))
    threshold, scale = mc.keep_threshold(0.3)
    want = np.where((bits >> np.uint32(8)) < threshold, scale, 0.0)
    got = mc.dropout_scale(seed, sample, key, threshold, scale, 300, 40, 'cpu')
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the keep rate is 1 - p
    assert abs(float((got > 0).float().mean()) - 0.7) < 0.02


def test_keep_thresholds():
    assert mc.keep_threshold(0.0) == (-1, 1.0)
    assert mc.keep_threshold(1.0) == (0, 0.0)
    t, s = mc.keep_threshold(0.5)
    assert t == 1 << 23 and s == 2.0
    t, s = mc.keep_threshold(0.1)
    assert t == int(np.ceil(float(np.float32(0.9)) * 2**24))
    assert s == float(np.float32(1 / np.float32(0.9)))


@pytest.mark.parametrize('hidden,p', [(2, 0.2), (3, 0.5)])
def test_fold_and_drop_positions_match_jax(hidden, p):
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=hidden), p=p)
    pm = port_of(jm)
    folded, drops = mc.fold_mc_dropout_params(pm.net)
    ref_folded, ref_drops = jax_fold_mc_dropout_params(jm.net, jm.params,
                                                       jm.state)
    assert drops == list(ref_drops)
    assert len(folded) == len(ref_folded)
    for (w, b, relu), (rw, rb, rrelu) in zip(folded, ref_folded):
        assert relu == rrelu
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-6,
                                   atol=1e-7)
    mw = mc.prepare_mc_weights(pm.net)
    linear_at = [i for i, layer in enumerate(pm.net.layers)
                 if type(layer).__name__ == 'Linear']
    assert mw.keys == tuple(i - 1 if d > 0 else -1
                            for i, d in zip(linear_at, drops))
    # the ensemble path still refuses a Dropout
    assert prepare_fused_weights(pm.net) is None


@pytest.mark.parametrize('hidden', [1, 2, 3])
def test_builder_architecture_matches_jax(hidden):
    layers = descr(in_dim=4, width=16, hidden=hidden)
    cfg = {'num_samples': 3, 'dropout_percent': 0.25}
    jm = JaxMCDropoutModelBuilder(layers, cfg,
                                  train_config={'loss': 'l1_loss'}).build()
    pm = MCDropoutModelBuilder(layers, cfg, device='cpu').build()
    assert pm.net.architecture == jm.net.architecture
    assert sum(type(l).__name__ == 'Dropout' for l in pm.net.layers) == \
        max(hidden - 1, 0)


@pytest.mark.parametrize('p', [0.0, 0.3])
def test_dropout_free_outputs_match_jax_eval_mode(p):
    """The shift pass (no dropout) of any rate is the JAX ``EVAL_MODE``
    network; at p = 0 every sample is that network, so std is 0."""
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), p=p)
    pm = port_of(jm)
    x = _x(300)
    ref, _ = jm.net.apply(jm.params, jm.state, jnp.asarray(x), EVAL_MODE)
    with torch.no_grad():
        modules = pm.net(torch.from_numpy(x))       # Dropout is the identity
    np.testing.assert_allclose(modules.numpy(), np.asarray(ref), **TOL_MEAN)
    folded, drops = mc.fold_mc_dropout_params(pm.net)
    no_dropout = mc.McWeights(folded, [0.0] * len(drops), [-1] * len(drops))
    shift, _ = mc.fused_mc_forward_plain(no_dropout, torch.from_numpy(x), 1, 0)
    np.testing.assert_allclose(shift.numpy(), np.asarray(ref), **TOL_MEAN)
    if p == 0.0:
        mean, std = pm(x, return_ue=True)
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref), **TOL_MEAN)
        assert float(std.abs().max()) == 0.0
        assert_ue_close((mean, std), jm(x, return_ue=True))


def test_p_one_drops_everything():
    """Rate 1 zeroes every kept value (zeros, not NaN), as the JAX vmap
    path's where() does."""
    pm = MCDropoutModelBuilder(descr(in_dim=5, width=16, hidden=2),
                               {'num_samples': 4, 'dropout_percent': 1.0},
                               device='cpu').build()
    mean, std = pm(_x(20), return_ue=True)
    assert bool(torch.isfinite(mean).all() and torch.isfinite(std).all())


def test_reseed_repeats_the_stream_and_calls_differ():
    pm = port_of(jax_mc_dropout(descr(in_dim=5, width=32, hidden=3)))
    x = _x(100)
    first = pm(x, return_ue=True)
    second = pm(x, return_ue=True)
    assert not torch.equal(first[1], second[1])
    pm.reseed(0)
    again = pm(x, return_ue=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    pm.reseed(5)
    other = pm(x, return_ue=True)
    assert not torch.equal(first[1], other[1])
    assert pm._eval_calls == 1
    # return_ue=False consumes a call too, as in the JAX package
    pm(x)
    assert pm._eval_calls == 2


def test_row_answer_does_not_depend_on_its_bucket():
    """The masks are keyed by the row's position, not by the padded batch:
    the same rows give the same answers in a 256-row and a 1024-row
    bucket, and alone."""
    pm = port_of(jax_mc_dropout(descr(in_dim=5, width=32, hidden=3)))
    x = _x(700)
    pm.reseed(3)
    big = pm(x, return_ue=True)                     # 1024-row bucket
    pm.reseed(3)
    small = pm(x[:200], return_ue=True)             # 256-row bucket
    assert_ue_close(tuple(a[:200] for a in big), small)


def test_plain_version_matches_the_module_walk():
    """The folded plain version and the unfused module walk draw the same
    masks (keys are Dropout module indices) and agree to round-off."""
    pm = port_of(jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), p=0.3))
    x = torch.from_numpy(_x(150))
    mw = mc.prepare_mc_weights(pm.net)
    with torch.no_grad():
        got = mc.fused_mc_forward_plain(mw, x, 16, 99)
        want = mc.mc_forward_modules(pm.net, x, 16, 99)
    assert_ue_close(got, want)
    assert float(got[1].min()) > 0


def test_unfoldable_network_runs_through_the_modules():
    """A network the fold does not take (BatchNorm after the ReLU) runs the
    module walk, with the same masks."""
    layers = [{'Linear': {'args': [5, 16]}}, {'ReLU': {}},
              {'BatchNorm1d': {'args': [16]}}, {'Linear': {'args': [16, 16]}},
              {'ReLU': {}}, {'Linear': {'args': [16, 1]}}]
    pm = MCDropoutModelBuilder(layers, {'num_samples': 6,
                                        'dropout_percent': 0.2},
                               device='cpu').build()
    assert mc.prepare_mc_weights(pm.net) is None
    x = _x(40)
    got = pm(x, return_ue=True)
    with torch.no_grad():
        want = mc.mc_forward_modules(pm.net, torch.from_numpy(x), 6,
                                     pm.call_seed(0))
    assert_ue_close(got, want)


def test_wide_network_runs_the_plain_version_off_the_kernel():
    """Widths over 128 fail the kernel's rule, as on the TPU: no weights
    are packed, and the module walk answers."""
    jm = jax_mc_dropout(descr(in_dim=5, width=160, hidden=2))
    pm = port_of(jm)
    assert mc.prepare_mc_weights(pm.net) is None
    mean, std = pm(_x(30), return_ue=True)
    assert mean.shape == std.shape == (30, 1)


def test_statistics_match_jax_within_sampling_noise():
    """S = 4096 on 64 rows: the port's mean and std against the JAX vmap
    path's, within 3 x the JAX path's deviation between two of its own
    seeds at the same S."""
    S = 4096
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3),
                        num_samples=S, p=0.2, seed=4)
    pm = port_of(jm)
    assert pm.num_samples == S
    x = _x(64, seed=11)
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


def test_model_call_chunks_are_calls_of_their_own(monkeypatch):
    """Above the largest bucket each chunk is its own call, with its own
    seed, as in the JAX base ``__call__``."""
    pm = port_of(jax_mc_dropout(descr(in_dim=5, width=16, hidden=2)))
    monkeypatch.setattr(base, '_MAX_BUCKET', 256)
    x = _x(600)
    pm.reseed(0)
    mean, std = pm(x, return_ue=True)
    assert pm._eval_calls == 3
    mw = mc.prepare_mc_weights(pm.net)
    xt = torch.from_numpy(x)
    for i, start in enumerate(range(0, 600, 256)):
        want = mc.fused_mc_forward_plain(mw, xt[start:start + 256].contiguous(),
                                         pm.num_samples, pm.call_seed(i))
        assert_ue_close((mean[start:start + 256], std[start:start + 256]),
                        want)


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    pm = port_of(jax_mc_dropout(descr(in_dim=5, width=16, hidden=2)))
    mw = mc.prepare_mc_weights(pm.net)
    x = torch.from_numpy(_x(50))
    before = mc.fused_mc_forward.launches
    got = mc.fused_mc_forward(mw, x, 5, 17)
    assert mc.fused_mc_forward.launches == before
    want = mc.fused_mc_forward_plain(mw, x, 5, 17)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError, match='float32'):
        mc.fused_mc_forward(mw, x.bfloat16(), 5, 17)
    with pytest.raises(ValueError, match='shape'):
        mc.fused_mc_forward(mw, torch.zeros(4, 6), 5, 17)
    with pytest.raises(ValueError, match='num_samples'):
        mc.fused_mc_forward(mw, x, 0, 17)


def test_jax_bundle_loads_and_port_bundle_loads_in_jax(tmp_path):
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), num_samples=6,
                        p=0.3)
    path = str(tmp_path / 'jax.pth')
    jax_save_model(jm, path)
    pm = load_model(path, device='cpu')
    assert type(pm).__name__ == 'MCDropoutModel'
    assert (pm.num_samples, pm.dropout_percent, pm.prng_impl) == \
        (6, 0.3, jm.prng_impl)
    assert [l.p for l in pm.net.layers if type(l).__name__ == 'Dropout'] == \
        [0.3, 0.3]
    out = str(tmp_path / 'port.pth')
    save_model(pm, out)
    back = jax_load_model(out)
    assert type(back).__name__ == 'MCDropoutModel'
    assert (back.num_samples, back.dropout_percent) == (6, 0.3)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the dropout-free network agrees across the round trip
    x = _x(40)
    ref, _ = jm.net.apply(jm.params, jm.state, jnp.asarray(x), EVAL_MODE)
    with torch.no_grad():
        np.testing.assert_allclose(pm.net(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref), **TOL_MEAN)


def test_predictor_serves_mc_dropout_and_warmup_advances_the_stream():
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), num_samples=8)
    pm = port_of(jm)
    pred = Predictor(pm, buckets=(256, 1024), device='cpu')
    assert pm._eval_calls == 2                      # one call per bucket
    x = _x(300)
    mean, std = pred.predict(x)
    assert mean.shape == std.shape == (300, 1)
    want = mc.fused_mc_forward_plain(mc.prepare_mc_weights(pm.net),
                                     torch.from_numpy(x), 8, pm.call_seed(2))
    assert_ue_close((mean, std), want)
    assert float(std.min()) > 0
