"""How the attribution probes of kernels 1 and 3 lay themselves out on the
card, on the CPU: ``ablate_forward`` takes kernel 1's launch layout
(``eval_layout('ensemble', ..., fp32=True)``) for each member and layer
cut, with a cut chain's image packed with every layer as a hidden one;
``ablate_epoch`` takes kernel 3's launch layout (``train_layout``) and
its buffers; both refuse what their kernels do not take. The kernels
themselves run only on a card (``tests/test_torch_cuda.py -m cuda``)."""
import pytest
import torch

from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.ops import ablate_epoch as ae
from nnueehcs_tpu_torch.ops import ablate_forward as af
from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
from nnueehcs_tpu_torch.ops import fused_train as ft
from nnueehcs_tpu_torch.ops.fused_ensemble import prepare_fused_weights

SMS = 132                 # an H100's SMs
ROWS = 262_144            # the attribution battery's rows


@pytest.fixture(scope='module')
def fw():
    torch.manual_seed(0)
    return prepare_fused_weights(attrib.flagship(0, 'cpu').net)


@pytest.mark.parametrize('members', [1, 2, 4, 8])
@pytest.mark.parametrize('layers', [1, 3, 5, 7])
def test_probe_layout_of_each_cut(fw, members, layers):
    """Each cut's layout: a cluster of min(M, 8) blocks holding
    ceil(M / c) members each, one or two warpgroups, the statistics of 16
    column groups for a chain cut short (its last layer 128 wide) and of
    the real columns for the whole chain, and shared memory within the
    card's 227 KB; the image the kernel streams is the layout's size a
    member."""
    layout = af.probe_layout(fw, ROWS, members, layers, SMS)
    cut = layers < fw.num_layers
    assert layout.cluster == min(members, 8)
    assert layout.members == -(-members // layout.cluster)
    assert layout.warpgroups in (1, 2)
    assert layout.threads == 128 * layout.warpgroups
    assert layout.out_groups == (16 if cut else -(-fw.out_dim // 8))
    assert layout.ring >= ec.TF32_MIN_RING_2 or layout.warpgroups == 1
    assert layout.smem_bytes <= ec.SMEM_LIMIT == 232_448
    assert layout.grid % layout.cluster == 0
    assert layout.grid <= SMS
    image = af.probe_image(fw, layers)
    assert image.dtype == torch.float32
    assert 4 * image.numel() == fw.num_members * layout.image_bytes
    assert layout == ec.eval_layout('ensemble', fw.in_dim, layers,
                                    128 if cut else fw.out_dim, ROWS, SMS,
                                    members, fp32=True)


def test_probe_layout_small_request_takes_one_warpgroup(fw):
    """As kernel 1: while the tiles are no more than the clusters, one
    warpgroup a block, one cluster a tile."""
    layout = af.probe_layout(fw, 128, 8, fw.num_layers, SMS)
    assert layout.warpgroups == 1 and layout.grid == 2 * layout.cluster


@pytest.mark.parametrize('layers', [1, 3, 6])
def test_cut_image_is_a_deeper_chains_hidden_layers(fw, layers):
    """A chain cut to ``layers`` layers streams every layer as a hidden
    one: its image is the start of the image of the chain one layer
    deeper, and its blocks are those of tf32_blocks' open end."""
    blocks = ec.tf32_blocks(fw.in_dim, layers, 128, open_end=True)
    deeper = ec.tf32_blocks(fw.in_dim, layers + 1, fw.out_dim)
    assert blocks == deeper[:len(blocks)]
    assert all(cols == 128 for *_, cols in blocks)
    image = af.probe_image(fw, layers).view(fw.num_members, -1)
    full = ec.member_images(fw.ws[:layers + 1], 128)
    assert torch.equal(image, full[:, :image.shape[1]])
    assert af.probe_image(fw, layers) is af.probe_image(fw, layers)
    assert af.probe_image(fw, fw.num_layers) is ec.cached_image(fw)


@pytest.mark.parametrize('batch', [128, 256, 1024])
def test_ablate_epoch_takes_kernel_3s_layout_and_scratch(batch):
    """The training probe launches with kernel 3's layout of its plan
    (resident in shared memory at 128 rows, through device memory past
    160) and kernel 3's buffers: the members' scratch, the zeroed
    gradient, the sweep's predictions and the two sums a member."""
    _, plan, bufs, _, _ = attrib.train_problem(0, 'cpu', batch=batch,
                                               steps=1)
    layout, got = ae.launch_buffers(plan, bufs[0])
    assert layout == ft.train_layout(plan) == ft.train_layout(
        ae.probe_plan(plan))
    assert layout.resident == (batch == 128)
    M = plan.num_members
    assert got['scratch'].numel() == M * layout.member_floats
    assert got['g'].shape == bufs[0].shape and not bool(got['g'].any())
    assert got['preds'].shape == (M, batch, ft.LANES)
    assert got['small'].shape == (2 * M,)
    assert torch.equal(got['lins'], ft.lin_table(plan, 'cpu'))


def _epoch_args(bf16=False):
    _, plan, bufs, xs, ys = attrib.train_problem(0, 'cpu', batch=16, steps=4,
                                                 bf16=bf16)
    return plan, bufs, xs, ys


@pytest.mark.parametrize('kw,match', [
    (dict(mode='sweep'), 'mode'),
    (dict(unroll=3), 'unroll 3 must divide'),
    (dict(unroll=0), 'unroll 0'),
    (dict(opt_chunk=0), 'opt_chunk'),
    (dict(mode='no_bwd', norms=torch.empty(4)), 'norms'),
    (dict(norms=torch.empty(3)), 'norms')])
def test_ablate_epoch_refuses(kw, match):
    plan, bufs, xs, ys = _epoch_args()
    with pytest.raises(ValueError, match=match):
        ae.ablate_epoch(plan, *bufs, xs, ys, attrib.LR, 0, **kw)


def test_ablate_epoch_refuses_a_bf16_plan():
    plan, bufs, xs, ys = _epoch_args(bf16=True)
    assert plan.bf16
    with pytest.raises(ValueError, match='fp32 only'):
        ae.ablate_epoch(plan, *bufs, xs, ys, attrib.LR, 0)
    with pytest.raises(ValueError, match='fp32 only'):
        ae.ablate_epoch_reference(plan, *bufs, xs, ys, attrib.LR, 0)


@pytest.mark.parametrize('kw', [dict(mode='fast'), dict(n_out=3),
                                dict(tile=0), dict(num_members=0),
                                dict(num_members=9), dict(num_layers=8)])
def test_ablate_forward_refuses(fw, kw):
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        af.ablate_forward(fw, x, **kw)


def test_ablate_forward_refuses_bf16_weights():
    model = attrib.flagship(0, 'cpu')
    model.set_precision('bf16-mixed')
    with pytest.raises(ValueError, match='float32'):
        af.ablate_forward(prepare_fused_weights(model.net),
                          torch.zeros((4, 128)))
