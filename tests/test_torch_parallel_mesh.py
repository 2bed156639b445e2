"""The port's mesh rules (``nnueehcs_tpu_torch.parallel.mesh``) against the
JAX package's on tests/conftest.py's 8 virtual CPU devices, in one process:
``param_spec`` on the leaves of tests/test_sharding.py:152-168, each
rank's ``shard_params`` slice against the shard JAX places on the device
at the same mesh coordinate, ``batch_spec``, ``pad_to_multiple``, and
``make_mesh``'s refusals. A process that never initialised
``torch.distributed`` is a world of one rank."""
import numpy as np
import pytest
import torch

from nnueehcs_tpu import parallel as jpar
from nnueehcs_tpu_torch.parallel import mesh as pmesh

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MEMBER_TP = {'member': 2, 'tp': 2}
DP_TP = {'dp': 4, 'tp': 2}

# (mesh axes, leaf shape, member_stacked), tests/test_sharding.py:152-168
SPEC_CASES = [
    (MEMBER_TP, (2, 8, 8), True),     # stacked weight
    (MEMBER_TP, (2, 8), True),        # stacked bias / BatchNorm vector
    (MEMBER_TP, (2,), True),          # stacked scalar-ish leaf
    (MEMBER_TP, (2, 8, 7), True),     # tp does not divide
    (DP_TP, (8, 8), False),           # non-stacked weight
    (DP_TP, (8,), False),             # non-stacked bias: replicated
    (DP_TP, (), False),
    ({'dp': 8}, (4, 16, 16), True),   # no member or tp axis
]


def _rank_mesh(axes, rank):
    """This rank's view of a mesh of ``axes`` (no process group: only
    the layout is read)."""
    return pmesh.Mesh(axes, rank, 'cpu', {}, 'gloo')


@pytest.mark.parametrize('axes,shape,stacked', SPEC_CASES)
def test_param_spec_follows_jax(axes, shape, stacked):
    leaf = np.zeros(shape, np.float32)
    want = tuple(jpar.param_spec(leaf, jpar.make_mesh(axes), stacked))
    want += (None,) * (len(shape) - len(want))
    assert pmesh.param_spec(leaf, axes, stacked) == want
    assert pmesh.param_spec(leaf, _rank_mesh(axes, 0), stacked) == want


@pytest.mark.parametrize('shape,stacked', [((2, 8, 8), True), ((2, 8), True),
                                           ((2, 8, 7), True),
                                           ((8, 8), False)])
def test_each_rank_holds_the_shard_jax_puts_on_its_device(shape, stacked):
    """Ranks lie row-major over the axes, as JAX reshapes its devices:
    rank r's slice is the shard on mesh device r."""
    axes = MEMBER_TP
    leaf = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jmesh = jpar.make_mesh(axes)
    sharded = jpar.shard_params({'w': leaf}, jmesh, stacked)['w']
    by_device = {s.device: np.asarray(s.data)
                 for s in sharded.addressable_shards}
    for rank, device in enumerate(jmesh.devices.reshape(-1)):
        got = pmesh.shard_params({'w': leaf}, _rank_mesh(axes, rank),
                                 stacked)['w']
        np.testing.assert_array_equal(got, by_device[device])


def test_batch_spec_follows_jax():
    for axes in ({'dp': 8}, MEMBER_TP, DP_TP):
        assert pmesh.batch_spec(axes) == tuple(
            jpar.batch_spec(jpar.make_mesh(axes)))


@pytest.mark.parametrize('n,multiple', [(10, 4), (12, 4), (1, 8), (7, 1)])
def test_pad_to_multiple_follows_jax(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want, want_n = jpar.pad_to_multiple(x, multiple)
    got, got_n = pmesh.pad_to_multiple(x, multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, np.asarray(want))
    got_t, _ = pmesh.pad_to_multiple(torch.from_numpy(x), multiple)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


@pytest.mark.parametrize('n', [0, 1, 3, 997, 1024])
@pytest.mark.parametrize('dp', [1, 3, 4])
def test_local_rows_cover_the_batch_once(n, dp):
    spans = [pmesh.local_rows(n, _rank_mesh({'dp': dp}, r))
             for r in range(dp)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1
    assert pmesh.local_rows(n, None) == (0, n)


def test_make_mesh_in_one_process():
    """'auto' (and None) puts every rank, here the one, on dp; a mesh
    needing more ranks than the world raises ValueError, as JAX's needing
    more devices does; so do unknown axes and too short a device list."""
    for axes in ('auto', None, {'dp': 1}):
        mesh = pmesh.make_mesh(axes)
        assert mesh.shape == {'dp': 1} and mesh.is_trivial
        assert mesh.rank == 0 and mesh.axis_index('dp') == 0
        t = torch.arange(3.0)
        assert torch.equal(mesh.all_reduce(t, 'dp'), t)
        assert torch.equal(mesh.all_gather(t, 'dp'), t)
        assert mesh.broadcast_object({'a': 1}) == {'a': 1}
    with pytest.raises(ValueError):
        jpar.make_mesh({'dp': 16})
    with pytest.raises(ValueError, match='needs 2 ranks, have 1'):
        pmesh.make_mesh({'dp': 2})
    with pytest.raises(ValueError, match='unknown mesh axis'):
        pmesh.make_mesh({'pp': 1})
    with pytest.raises(ValueError, match='needs 1 devices, have 0'):
        pmesh.make_mesh({'dp': 1}, devices=[])
    assert pmesh.make_mesh({'member': 1}, devices=['cpu']).device == \
        torch.device('cpu')


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match='duplicate GPU'):
        pmesh.check_nccl_devices(['cuda:0', 'cuda:0'])
    with pytest.raises(ValueError, match='duplicate GPU'):
        pmesh.check_nccl_devices([0, 'cuda:0'])
    pmesh.check_nccl_devices(['cuda:0', 'cuda:1'])


def test_shard_leaf_refuses_a_split_that_does_not_divide():
    with pytest.raises(ValueError, match='does not divide'):
        pmesh.shard_leaf(np.zeros((3, 4)), ('member', None),
                         _rank_mesh({'member': 2}, 0))


# (the mesh's device, the device asked for, the device placed; None: refused)
PLACED_CASES = [
    (None, 'cuda', 'cuda'),
    (None, None, None),
    ('cpu', None, 'cpu'),
    ('cpu', 'cpu', 'cpu'),
    ('cuda:1', 'cuda', 'cuda:1'),
    ('cuda:1', 1, 'cuda:1'),
    ('cpu', 'cuda', 'refused'),
    ('cpu', 'cuda:0', 'refused'),
    ('cuda:0', 'cpu', 'refused'),
    ('cuda:0', 'cuda:1', 'refused'),
]


@pytest.mark.parametrize('mesh_device, asked, want', PLACED_CASES)
def test_placed_keeps_the_device_asked_for_or_raises(mesh_device, asked,
                                                     want):
    """A rank's work goes to its mesh's device; a device asked for that is
    another one raises instead of moving the work there."""
    mesh = pmesh.Mesh({'dp': 1}, 0, mesh_device, {}, 'gloo')
    if want == 'refused':
        with pytest.raises(ValueError, match='the mesh puts rank 0 on'):
            pmesh.placed(mesh, asked)
    else:
        got = pmesh.placed(mesh, asked)
        assert got == (None if want is None else torch.device(want))
    assert pmesh.placed(None, 'cpu') == torch.device('cpu')


@pytest.fixture
def card_visible(monkeypatch):
    """torch as on a machine with a card: the refusals below are the
    mesh's, not the missing card's."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)


def _cpu_model():
    from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
    arch = [{'Linear': {'args': [3, 8]}}, {'ReLU': {}},
            {'Linear': {'args': [8, 1]}}]
    return EnsembleModelBuilder(arch, {'num_models': 2}, seed=0,
                                device='cpu').build()


def test_predictor_refuses_a_mesh_on_another_device(card_visible):
    """A predictor asked for the card (its default, or by name) under a
    mesh whose rank sits on the CPU raises, and the model stays where it
    was; asked for the mesh's device, it serves there."""
    from nnueehcs_tpu_torch.serving import Predictor
    mesh = _rank_mesh({'dp': 1}, 0)
    model = _cpu_model()
    for device in ('cuda', 'cuda:0'):
        with pytest.raises(ValueError, match='puts rank 0 on cpu'):
            Predictor(model, mesh=mesh, device=device, warmup=False)
        assert model.device == torch.device('cpu') and model.mesh is None
    predictor = Predictor(model, mesh=mesh, device='cpu', warmup=False)
    assert predictor.model.mesh is mesh
    mean, ue = predictor.predict(np.zeros((5, 3), np.float32))
    assert mean.shape == ue.shape == (5, 1)


@pytest.mark.parametrize('asked', [
    {}, {'device': 'cuda:0'}, {'accelerator': 'gpu'}])
def test_trainer_refuses_a_mesh_on_another_device(card_visible, tmp_path,
                                                   asked):
    """The trainer's device (``device``, else the accelerator's: the card
    unless it says 'cpu') must be the mesh's."""
    from nnueehcs_tpu_torch.training import Trainer
    cfg = {'mesh': {'dp': 1}, 'devices': ['cpu']}
    device = asked.get('device')
    cfg.update({k: v for k, v in asked.items() if k != 'device'})
    with pytest.raises(ValueError, match='puts rank 0 on cpu'):
        Trainer('t', cfg, log_dir=str(tmp_path), device=device)
    cfg['accelerator'] = 'cpu'
    assert Trainer('t', cfg, log_dir=str(tmp_path)).device == \
        torch.device('cpu')


def test_attach_mesh_never_moves_a_model_off_its_card(card_visible,
                                                      monkeypatch):
    """A model on a card attached to a mesh whose rank sits on the CPU
    raises and stays unattached (it used to be moved to the CPU)."""
    model = _cpu_model()
    monkeypatch.setattr(type(model), 'device',
                        property(lambda self: torch.device('cuda', 0)))
    with pytest.raises(ValueError, match='puts rank 0 on cpu'):
        model.attach_mesh(_rank_mesh({'dp': 1}, 0))
    assert model.mesh is None
    with pytest.raises(ValueError, match='puts rank 0 on cuda:1'):
        model.attach_mesh(pmesh.Mesh({'dp': 1}, 0, 'cuda:1', {}, None))
