"""The launch layout and weight image of the bf16 eval kernels 1b, 2b and 5b
and of the fp32 kernels 1, 2 and 5 (their 3xTF32 image: hi and lo parts, the
K permutation, the blocks' offsets, kernel 1's members one after another;
their cluster layouts for every d and out_dim up to 128 and 2 to 8
Linears, kernel 1's for 1 to 32 members and its grid, which spreads a
small request over as many clusters as it has tiles)
(``ops/fused_eval_chain.py``), the one place that decides how a chain runs
on the card: resident in shared memory or streamed through a ring, how many
consumer warpgroups a block runs, where each weight block lies, and for the
ensemble (1b) the thread-block cluster, its exchange rings and its grid.
Checked over the shapes the kernels' gate accepts (any input width, any
depth, hidden widths and outputs up to 128, 1 to 32 members). The kernels
themselves run only on a card (tests/test_torch_cuda.py)."""
import itertools

import pytest
import torch

from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
from torch_tf32 import (TF32_RECONSTRUCTION, image_layers, read_tf32_block,
                        rel_err, tf32_exact)

SMS = 132
IN_DIMS = (1, 5, 16, 17, 37, 128, 129, 200, 1000, 5000)
DEPTHS = (1, 2, 3, 7, 8, 12, 71)
OUT_DIMS = (1, 3, 8, 9, 64, 127, 128)
ROWS = (1, 63, 64, 65, 262_143)


def _gate_shapes():
    for kernel, d, L, out in itertools.product(('mc', 'anchored'), IN_DIMS,
                                               DEPTHS, OUT_DIMS):
        if kernel == 'anchored' and L < 2:
            continue   # the anchored gate takes two Linears or more
        yield kernel, d, L, out


def _kernel_offset(b, d, L, out_dim):
    """Chain::offset of csrc/fused_chain_wgmma.cuh, transcribed."""
    d16 = -(-d // 16) * 16
    nb0 = -(-d16 // ec.K_BLOCK)
    cols0 = -(-out_dim // 8) * 8 if L == 1 else ec.WIDTH
    if b < nb0:
        return 2 * b * ec.K_BLOCK * cols0
    return 2 * d16 * ec.WIDTH + (b - nb0) * ec.SLOT_BYTES


def _read_block(image: torch.Tensor, offset: int, rows: int, cols: int):
    """A block of the image back as its ``(rows, cols)`` matrix, read the
    way the kernel's descriptors address it: k-step ``kk`` starts at
    ``offset + 256 kk`` bytes, its second 8 rows one leading byte offset
    (128) further, each group of 8 columns one stride byte offset (``16
    rows``) further; within a core matrix column n's 8 k values are 16
    contiguous bytes."""
    flat = image.view(-1)
    out = image.new_zeros((rows, cols))
    lbo, sbo = 128, 16 * rows
    for kk in range(rows // 16):
        for half in range(2):
            for ng in range(cols // 8):
                base = (offset + 256 * kk + lbo * half + sbo * ng) // 2
                core = flat[base:base + 64].reshape(8, 8)   # [n % 8][k % 8]
                out[16 * kk + 8 * half:16 * kk + 8 * half + 8,
                    8 * ng:8 * ng + 8] = core.t()
    return out


def test_every_gate_shape_has_a_layout_that_fits():
    for kernel, d, L, out in _gate_shapes():
        for rows in ROWS:
            lay = ec.eval_layout(kernel, d, L, out, rows, SMS)
            assert lay.smem_bytes <= ec.SMEM_LIMIT == 232_448
            assert 1 <= lay.warpgroups <= ec.MAX_WARPGROUPS[kernel]
            assert lay.threads == 128 * lay.warpgroups + (32 if lay.ring
                                                          else 0)
            assert lay.out_groups == -(-out // 8)
            assert lay.image_bytes == ec.image_bytes(d, L, out)
            if lay.resident:
                assert lay.smem_stats == lay.image_bytes
            else:
                assert lay.ring == ec.RING_SLOTS == 3
                assert lay.warpgroups == 1
                assert lay.smem_stats == lay.ring * ec.SLOT_BYTES
            # statistics after the weights, barriers after the statistics
            assert lay.smem_bars >= lay.smem_stats + \
                lay.warpgroups * lay.out_groups * ec.STAT_BYTES
            assert lay.smem_bars % 8 == 0
            assert lay.smem_bytes == lay.smem_bars + 8 * (
                2 * lay.ring if lay.ring else 1)
            tiles = -(-rows // 64)
            assert 1 <= lay.grid <= min(SMS, -(-tiles // lay.warpgroups))


@pytest.mark.parametrize('kernel,warpgroups', [('mc', 3), ('anchored', 2)])
def test_flagship_is_resident_with_the_most_warpgroups(kernel, warpgroups):
    lay = ec.eval_layout(kernel, 5, 7, 1, 262_144, SMS)
    assert lay.resident and lay.warpgroups == warpgroups
    assert lay.image_bytes == 16 * 128 * 2 + 5 * 128 * 128 * 2 + 128 * 8 * 2
    assert lay.grid == SMS and lay.threads == 128 * warpgroups


@pytest.mark.parametrize('kernel', ['mc', 'anchored'])
@pytest.mark.parametrize('depth,resident', [(2, True), (7, True),
                                            (8, True), (9, False),
                                            (12, False), (71, False)])
def test_resident_or_ring_by_depth(kernel, depth, resident):
    lay = ec.eval_layout(kernel, 5, depth, 1, 4096, SMS)
    assert lay.resident == resident
    if not resident:
        assert lay.ring == 3 and lay.warpgroups == 1 and lay.threads == 160


@pytest.mark.parametrize('d,L,out,resident,warpgroups', [
    (5, 7, 128, False, 1),      # 96 KB of statistics per warpgroup
    (1000, 2, 1, False, 1),     # layer 0 alone is 256 KB
    (37, 3, 3, True, 3),
    (128, 1, 128, True, 2),     # a 32 KB image beside 192 KB of sums
    (300, 3, 128, False, 1),
])
def test_resident_or_ring_by_widths(d, L, out, resident, warpgroups):
    lay = ec.eval_layout('mc', d, L, out, 10_000, SMS)
    assert (lay.resident, lay.warpgroups) == (resident, warpgroups)


def test_small_batches_take_few_blocks():
    assert ec.eval_layout('mc', 5, 7, 1, 1, SMS).grid == 1
    assert ec.eval_layout('mc', 5, 7, 1, 193, SMS).grid == 2
    assert ec.eval_layout('anchored', 5, 7, 1, 129, SMS).grid == 2
    assert ec.eval_layout('anchored', 5, 7, 1, 65_536, SMS).grid == SMS


@pytest.mark.parametrize('out_dim,L', [(0, 3), (129, 3), (1, 0)])
def test_shapes_past_the_gate_are_refused(out_dim, L):
    with pytest.raises(ValueError):
        ec.eval_layout('mc', 5, L, out_dim, 100, SMS)


@pytest.mark.parametrize('d,L,out', [(5, 7, 1), (37, 3, 3), (1, 1, 128),
                                     (200, 2, 9), (300, 1, 5), (16, 12, 64)])
def test_image_blocks_read_back_through_the_descriptor_layout(d, L, out):
    gen = torch.Generator().manual_seed(d * 100 + L)
    ws = [torch.randn((1, d, 128), generator=gen).bfloat16()] + \
        [torch.randn((1, 128, 128), generator=gen).bfloat16()
         for _ in range(L - 1)]
    image = ec.chain_image(ws, out)
    assert image.dtype == torch.bfloat16
    assert 2 * image.numel() == ec.image_bytes(d, L, out)
    offset = 0
    for b, (layer, k0, rows, cols) in enumerate(ec.chain_blocks(d, L, out)):
        assert offset == _kernel_offset(b, d, L, out)
        assert rows % 16 == 0 and cols % 8 == 0 and rows <= ec.K_BLOCK
        want = torch.zeros((rows, cols), dtype=torch.bfloat16)
        src = ws[layer][0, k0:k0 + rows, :cols]
        want[:src.shape[0]] = src
        assert torch.equal(_read_block(image, offset, rows, cols), want)
        assert 2 * rows * cols <= ec.SLOT_BYTES
        offset += 2 * rows * cols
    assert offset == ec.image_bytes(d, L, out)


def test_image_is_cached_on_the_weights():
    class Folded:
        ws = [torch.ones((1, 5, 128)).bfloat16(),
              torch.ones((1, 128, 128)).bfloat16()]
        out_dim = 1
    fw = Folded()
    first = ec.cached_image(fw)
    assert ec.cached_image(fw) is first


# kernel 1b, the ensemble: clusters of c = min(M, 8) member blocks
ENSEMBLE_WIDTHS = ((1, 1), (5, 1), (37, 3), (200, 9), (1000, 64), (5, 128))
ENSEMBLE_DEPTHS = (1, 2, 7, 12)


def _ensemble_layouts(members):
    for (d, out), L, rows in itertools.product(ENSEMBLE_WIDTHS,
                                               ENSEMBLE_DEPTHS, ROWS):
        yield (d, L, out, rows), ec.eval_layout('ensemble', d, L, out, rows,
                                                SMS, members=members)


@pytest.mark.parametrize('members', range(1, 33))
def test_every_member_count_has_an_ensemble_layout_that_fits(members):
    c = min(members, 8)
    for (d, L, out, rows), lay in _ensemble_layouts(members):
        assert lay.smem_bytes <= ec.SMEM_LIMIT == 232_448
        assert lay.cluster == c and lay.members == -(-members // c)
        assert 1 <= lay.warpgroups <= ec.MAX_WARPGROUPS['ensemble'] == 3
        assert lay.threads == 128 * lay.warpgroups + (32 if lay.ring else 0)
        weights = (lay.members * lay.image_bytes if lay.resident
                   else ec.RING_SLOTS * ec.SLOT_BYTES)
        assert lay.smem_stats == weights
        assert lay.smem_exchange == lay.smem_stats + \
            lay.warpgroups * lay.out_groups * ec.STAT_BYTES
        # one exchange ring per peer, each up to two members' outputs
        assert (lay.slots == 0) == (c == 1)
        assert lay.slots <= ec.EXCHANGE_MEMBERS * lay.out_groups
        assert lay.smem_bars >= lay.smem_exchange + lay.warpgroups * (
            c - 1) * lay.slots * ec.exchange_slot_bytes(out)
        assert lay.smem_bars % 8 == 0
        weight_bars = 2 * lay.ring if lay.ring else 1
        exchange_bars = lay.warpgroups * c * lay.slots if c > 1 else 0
        assert lay.smem_bytes == lay.smem_bars + 8 * (weight_bars
                                                      + exchange_bars)
        if not lay.resident:
            assert lay.warpgroups == 1 and lay.ring == ec.RING_SLOTS


def test_flagship_ensemble_is_one_resident_cluster_of_8_with_the_most_warpgroups():
    lay = ec.eval_layout('ensemble', 5, 7, 1, 262_144, SMS, members=8)
    assert lay.resident and lay.cluster == 8 and lay.members == 1
    assert lay.warpgroups == ec.MAX_WARPGROUPS['ensemble'] == 3
    assert lay.image_bytes == 169_984
    assert lay.slots >= 1 and lay.smem_bytes <= ec.SMEM_LIMIT
    assert lay.grid == 8 * (SMS // 8)


@pytest.mark.parametrize('members,L,resident', [
    (8, 7, True), (2, 7, True), (1, 7, True), (12, 7, False),
    (32, 7, False), (8, 12, False), (12, 2, True)])
def test_ensemble_resident_or_ring(members, L, resident):
    lay = ec.eval_layout('ensemble', 5, L, 1, 4096, SMS, members=members)
    assert lay.resident == resident
    if not resident:
        assert lay.ring == 3 and lay.warpgroups == 1 and lay.threads == 160


@pytest.mark.parametrize('members', [1, 2, 3, 7, 8, 9, 12, 32])
@pytest.mark.parametrize('rows', [1, 64, 300, 4096, 262_144, 262_145])
@pytest.mark.parametrize('clusters', [None, 1, 7, 16])
def test_ensemble_grid_is_a_whole_number_of_clusters(members, rows,
                                                     clusters):
    lay = ec.eval_layout('ensemble', 5, 7, 1, rows, SMS, members=members,
                         clusters=clusters)
    c = min(members, 8)
    assert lay.grid % lay.cluster == 0 and lay.cluster == c
    units = lay.grid // c
    tiles = -(-rows // 64)
    assert 1 <= units <= (SMS // c if clusters is None else clusters)
    assert units <= max(1, -(-tiles // lay.warpgroups))


@pytest.mark.parametrize('members,d,L,out', [(8, 5, 7, 1), (3, 37, 3, 3),
                                             (2, 1, 1, 128), (12, 200, 2, 9),
                                             (4, 16, 12, 64)])
def test_each_member_image_reads_back_to_its_weights(members, d, L, out):
    gen = torch.Generator().manual_seed(members * 1000 + d * 10 + L)
    ws = [torch.randn((members, d, 128), generator=gen).bfloat16()] + \
        [torch.randn((members, 128, 128), generator=gen).bfloat16()
         for _ in range(L - 1)]

    class Folded:
        pass
    fw = Folded()
    fw.ws, fw.out_dim = ws, out
    images = ec.cached_image(fw)
    size = ec.image_bytes(d, L, out)
    assert 2 * images.numel() == members * size
    for m in range(members):
        image = images[m * size // 2:(m + 1) * size // 2]
        assert torch.equal(image, ec.chain_image(ws, out, m))
        offset = 0
        for b, (layer, k0, rows, cols) in enumerate(
                ec.chain_blocks(d, L, out)):
            assert offset == _kernel_offset(b, d, L, out)
            want = torch.zeros((rows, cols), dtype=torch.bfloat16)
            src = ws[layer][m, k0:k0 + rows, :cols]
            want[:src.shape[0]] = src
            assert torch.equal(_read_block(image, offset, rows, cols), want)
            offset += 2 * rows * cols


@pytest.mark.parametrize('out_dim,lanes', [(1, 1), (2, 1), (3, 2), (4, 2),
                                           (5, 3), (7, 4), (8, 4), (9, 4),
                                           (128, 4)])
def test_exchange_slots_carry_the_lanes_of_real_columns(out_dim, lanes):
    """A lane q of a quad holds columns 2 q, 2 q + 1 of each group of 8: a
    slot carries 16 bytes from each of the 32 quads' first ``lanes``."""
    assert lanes == min(4, -(-min(out_dim, 8) // 2))
    assert ec.exchange_slot_bytes(out_dim) == 32 * lanes * 16


def test_flagship_ensemble_exchange_is_double_buffered():
    lay = ec.eval_layout('ensemble', 5, 7, 1, 262_144, SMS, members=8)
    assert lay.slots == ec.EXCHANGE_MEMBERS == 2
    assert ec.exchange_slot_bytes(1) == 512


def test_ensemble_layout_ints_follow_the_kernel_struct():
    lay = ec.eval_layout('ensemble', 5, 7, 1, 4096, SMS, members=8)
    assert ec.ENSEMBLE_FIELDS[:len(ec.LAYOUT_FIELDS)] == ec.LAYOUT_FIELDS
    assert ec.ENSEMBLE_FIELDS[len(ec.LAYOUT_FIELDS):] == (
        'cluster', 'members', 'slots', 'smem_exchange')
    assert lay.ints() == [getattr(lay, f) for f in ec.ENSEMBLE_FIELDS]
    # the MC-dropout and anchored kernels read the Layout struct, its start
    mc = ec.eval_layout('mc', 5, 7, 1, 4096, SMS)
    assert (mc.cluster, mc.members, mc.slots) == (1, 1, 0)


# the fp32 kernels 2 and 5 (3xTF32): the image holds W_hi = tf32(W) and
# W_lo = tf32(W - W_hi) of every block; a tile's passes run over a cluster
# of GROUPS blocks
TF32_SHAPES = [(5, 7, 1), (37, 3, 3), (1, 1, 128), (200, 2, 9),
               (300, 1, 5), (16, 12, 64), (128, 8, 128), (8, 2, 8)]


def _fp32_ws(d, L, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((1, d, 128), generator=gen)] + \
        [torch.randn((1, 128, 128), generator=gen) for _ in range(L - 1)]


def _padded(ws, layer, d, L, out):
    """Layer ``layer`` of ``ws`` as the image's blocks hold it (K rounded
    up to 8, the last layer's columns to a multiple of 8)."""
    k = -(-d // 8) * 8 if layer == 0 else 128
    n = -(-out // 8) * 8 if layer == L - 1 else 128
    w = ws[layer][0]
    full = w.new_zeros((k, n))
    full[:w.shape[0], :min(n, w.shape[1])] = w[:, :n]
    return full


def _chain32_block(b, d, L, out):
    """Chain32's rows, cols and offset of block b (csrc/fused_chain_wgmma.cuh),
    transcribed."""
    d8 = -(-d // 8) * 8
    nb0 = -(-d8 // ec.TF32_ROWS)
    k = b % nb0 if L == 1 else b
    rows = min(32, d8 - 32 * k) if k < nb0 else 32
    cols = 8 if L == 1 or b >= nb0 + 4 * (L - 2) else 128
    if L == 1:
        offset = (b // nb0) * d8 * 64 + (b % nb0) * 2048
    elif b < nb0:
        offset = b * 32768
    elif b - nb0 < 4 * (L - 2):
        offset = d8 * 1024 + (b - nb0) * 32768
    else:
        offset = d8 * 1024 + (L - 2) * 131072 + (b - nb0 - 4 * (L - 2)) * 2048
    return rows, cols, offset


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11       # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp * 0.99, one + 3 * half_ulp, 0.0, -0.0,
                      1e-30, 3.0e38])
    got = ec.tf32_round(x)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 0.0, -0.0,
                         float(ec.tf32_round(torch.tensor([1e-30]))[0]),
                         float(ec.tf32_round(torch.tensor([3.0e38]))[0])])
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()
    assert tf32_exact(got)


@pytest.mark.parametrize('d,L,out', TF32_SHAPES)
def test_tf32_image_parts_have_their_low_13_mantissa_bits_zero(d, L, out):
    ws = _fp32_ws(d, L, d * 10 + L)
    image = ec.chain_image(ws, out)
    assert image.dtype == torch.float32
    assert 4 * image.numel() == ec.tf32_image_bytes(d, L, out)
    assert tf32_exact(image)
    for layer, (hi, lo) in enumerate(image_layers(image, d, L, out)):
        assert tf32_exact(hi) and tf32_exact(lo)
        assert torch.equal(hi, ec.tf32_round(_padded(ws, layer, d, L, out)))


@pytest.mark.parametrize('d,L,out', TF32_SHAPES)
def test_tf32_hi_plus_lo_gives_the_weights_back(d, L, out):
    ws = _fp32_ws(d, L, d * 10 + L + 1)
    image = ec.chain_image(ws, out)
    for layer, (hi, lo) in enumerate(image_layers(image, d, L, out)):
        w = _padded(ws, layer, d, L, out)
        assert rel_err(hi + lo, w) <= TF32_RECONSTRUCTION
        assert torch.equal((w == 0), (hi + lo == 0))
        # the split is exactly the host's: lo = tf32(w - hi)
        assert torch.equal(lo, ec.tf32_round(w - hi))


@pytest.mark.parametrize('d,L,out', TF32_SHAPES)
def test_tf32_k_permutation_round_trips(d, L, out):
    """Each block read back the way the descriptors address it, its
    logical rows put back through TF32_PERM, is the block of the weights;
    and TF32_PERM puts the A fragment's inputs q, q + 4 of each 8 on the
    accumulator's columns 2 q, 2 q + 1."""
    assert sorted(ec.TF32_PERM) == list(range(8))
    for q in range(4):
        assert ec.TF32_PERM[q] == 2 * q and ec.TF32_PERM[q + 4] == 2 * q + 1
    ws = _fp32_ws(d, L, d * 10 + L + 2)
    image = ec.chain_image(ws, out)
    offset = 0
    for b, (layer, k0, rows, c0, cols) in enumerate(ec.tf32_blocks(d, L,
                                                                   out)):
        assert (rows, cols, 4 * offset) == _chain32_block(b, d, L, out)
        assert rows % 8 == 0 and rows <= ec.TF32_ROWS and cols in (8, 128)
        assert 8 * rows * cols <= ec.SLOT_BYTES
        w = _padded(ws, layer, d, L, out)[k0:k0 + rows, c0:c0 + cols]
        hi = read_tf32_block(image, offset, rows, cols)
        lo = read_tf32_block(image, offset + rows * cols, rows, cols)
        assert torch.equal(hi, ec.tf32_round(w))
        assert torch.equal(lo, ec.tf32_round(w - hi))
        offset += 2 * rows * cols
    assert 4 * offset == ec.tf32_image_bytes(d, L, out)


@pytest.mark.parametrize('kernel', ['mc', 'anchored'])
@pytest.mark.parametrize('L', range(2, 9))
def test_every_tf32_layout_fits(kernel, L):
    """d from 1 to 128, out_dim from 1 to 128: the fp32 form's layout fits
    a block's shared memory and the portable cluster."""
    for d in range(1, 129):
        for out in range(1, 129):
            lay = ec.eval_layout(kernel, d, L, out, 12_800, SMS, fp32=True)
            wgs = lay.warpgroups
            assert lay.smem_bytes <= ec.SMEM_LIMIT == 232_448
            assert lay.cluster == ec.GROUPS <= ec.MAX_CLUSTER
            assert wgs in (1, 2) and lay.members == 1
            assert lay.threads == 128 * wgs and lay.slots >= 1
            assert lay.ring >= (ec.TF32_MIN_RING_2 if wgs == 2 else 2)
            assert lay.out_groups == -(-out // 8)
            assert lay.smem_stats == lay.ring * ec.SLOT_BYTES
            assert lay.smem_exchange == lay.smem_stats + \
                wgs * lay.out_groups * ec.STAT_BYTES
            assert lay.smem_bars >= lay.smem_exchange + wgs * (
                ec.GROUPS - 1) * lay.slots * ec.exchange_slot_bytes(out)
            assert lay.smem_bars % 8 == 0
            assert lay.smem_bytes == lay.smem_bars + 8 * (
                2 * lay.ring + wgs * ec.GROUPS * lay.slots) + \
                ec.TF32_STREAM_BYTES
            assert lay.image_bytes == ec.tf32_image_bytes(d, L, out)


def test_one_linear_mc_has_a_tf32_layout():
    for d in (1, 37, 128, 300):
        for out in (1, 9, 128):
            lay = ec.eval_layout('mc', d, 1, out, 64, SMS, fp32=True)
            assert lay.smem_bytes <= ec.SMEM_LIMIT
            assert lay.image_bytes == 8 * (-(-d // 8) * 8) * 8 * lay.out_groups


@pytest.mark.parametrize('kernel', ['mc', 'anchored'])
@pytest.mark.parametrize('rows', [1, 64, 65, 128, 4096, 12_800, 262_144])
@pytest.mark.parametrize('clusters', [None, 1, 15])
def test_tf32_grid_is_whole_clusters_no_more_than_the_tiles(kernel, rows,
                                                            clusters):
    lay = ec.eval_layout(kernel, 5, 7, 1, rows, SMS, clusters=clusters,
                         fp32=True)
    units = lay.grid // ec.GROUPS
    assert lay.grid % ec.GROUPS == 0
    assert 1 <= units <= min(-(-rows // (64 * lay.warpgroups)),
                             SMS // ec.GROUPS if clusters is None
                             else clusters)


def test_flagship_tf32_layouts():
    mc = ec.eval_layout('mc', 5, 7, 1, 262_144, SMS, fp32=True)
    anchored = ec.eval_layout('anchored', 5, 7, 1, 65_536, SMS, fp32=True)
    # layer 0 (8 rows), 5 hidden layers, the last layer's column group,
    # each in hi and lo
    assert mc.image_bytes == 8 * (8 * 128 + 5 * 128 * 128 + 128 * 8) \
        == 671_744
    # two warpgroups a block, each on its own tile, through one ring
    assert (mc.warpgroups, mc.ring, mc.slots) == (2, 6, 2)
    assert anchored == ec.eval_layout('mc', 5, 7, 1, 65_536, SMS, fp32=True)
    assert mc.threads == anchored.threads == 256
    assert mc.grid == anchored.grid == ec.GROUPS * (SMS // ec.GROUPS)
    # 128 outputs' statistics leave room for one
    wide = ec.eval_layout('mc', 5, 7, 128, 262_144, SMS, fp32=True)
    assert (wide.warpgroups, wide.threads) == (1, 128)


def test_bf16_layouts_are_unchanged_by_the_fp32_form():
    for kernel in ('mc', 'anchored', 'ensemble'):
        assert ec.eval_layout(kernel, 5, 7, 1, 4096, SMS, members=8) == \
            ec.eval_layout(kernel, 5, 7, 1, 4096, SMS, members=8,
                           fp32=False)
    # the fp32 ensemble has a layout of its own; no kernel but the three
    # has one
    assert ec.eval_layout('ensemble', 5, 7, 1, 4096, SMS, members=8,
                          fp32=True).ring > 0
    with pytest.raises(ValueError):
        ec.eval_layout('kde', 5, 7, 1, 4096, SMS, fp32=True)


ENSEMBLE_MEMBERS = (1, 2, 3, 7, 8, 9, 15, 16, 28, 32)


@pytest.mark.parametrize('members', ENSEMBLE_MEMBERS)
@pytest.mark.parametrize('L', (1, 2, 7, 12))
def test_every_tf32_ensemble_layout_fits(members, L):
    """Kernel 1's fp32 layout, d from 1 to 200 and out_dim from 1 to 128:
    the carve fits a block's shared memory, a cluster of c = min(M, 8)
    blocks each holding ceil(M / c) members' images in turn, an exchange
    ring for each of the c - 1 peers of each warpgroup (none for one
    member) holding up to two members' outputs."""
    c = min(members, ec.MAX_CLUSTER)
    for d in (1, 5, 13, 37, 128, 200):
        for out in (1, 8, 9, 64, 127, 128):
            for rows in (1, 12_800):
                lay = ec.eval_layout('ensemble', d, L, out, rows, SMS,
                                     members, fp32=True)
                wgs = lay.warpgroups
                assert lay.smem_bytes <= ec.SMEM_LIMIT == 232_448
                assert lay.cluster == c and lay.members == -(-members // c)
                assert lay.grid % c == 0
                assert wgs in (1, 2) and lay.threads == 128 * wgs
                assert lay.ring >= (ec.TF32_MIN_RING_2 if wgs == 2 else 2)
                assert lay.smem_stats == lay.ring * ec.SLOT_BYTES
                assert lay.smem_exchange == lay.smem_stats + \
                    wgs * lay.out_groups * ec.STAT_BYTES
                if c == 1:
                    assert lay.slots == 0
                    assert lay.smem_bytes == lay.smem_bars + \
                        8 * 2 * lay.ring + ec.TF32_STREAM_BYTES
                else:
                    assert 1 <= lay.slots <= \
                        ec.EXCHANGE_MEMBERS * lay.out_groups
                    assert lay.smem_bars >= lay.smem_exchange + wgs * (
                        c - 1) * lay.slots * ec.exchange_slot_bytes(out)
                    assert lay.smem_bytes == lay.smem_bars + 8 * (
                        2 * lay.ring + wgs * c * lay.slots) + \
                        ec.TF32_STREAM_BYTES
                assert lay.image_bytes == ec.tf32_image_bytes(d, L, out)


@pytest.mark.parametrize('members', ENSEMBLE_MEMBERS)
@pytest.mark.parametrize('rows,clusters,units,warpgroups', [
    (1, None, 1, 1), (128, None, 2, 1), (128, 15, 2, 1), (960, 15, 15, 1),
    (961, 15, 8, 2), (12_800, 15, 15, 2), (12_800, None, None, 2),
    (262_144, 15, 15, 2), (262_144, None, None, 2), (262_144, 1, 1, 2)])
def test_tf32_ensemble_grid_spreads_small_requests(members, rows, clusters,
                                                   units, warpgroups):
    """One warpgroup a block while the tiles are no more than the clusters
    (each tile a cluster of its own: a 128-row request on two clusters),
    else two; the grid the clusters the tiles fill, at most ``clusters``
    (``SMS // c`` when not given) and no more than the tiles fill."""
    c = min(members, ec.MAX_CLUSTER)
    lay = ec.eval_layout('ensemble', 5, 7, 1, rows, SMS, members,
                         clusters=clusters, fp32=True)
    if units is None:
        units = min(SMS // c, -(-rows // (64 * warpgroups)))
    assert lay.warpgroups == warpgroups
    assert lay.grid == c * units


def test_flagship_tf32_ensemble_layout():
    """8 members, 7 Linears, one output: a cluster of 8 blocks of one
    member each, two warpgroups on a ring of 6 slots at the flagship's
    rows, the same carve as kernels 2 and 5 but for the exchange's slots."""
    lay = ec.eval_layout('ensemble', 5, 7, 1, 262_144, SMS, 8, 15, True)
    mc = ec.eval_layout('mc', 5, 7, 1, 262_144, SMS, clusters=15, fp32=True)
    assert (lay.cluster, lay.members, lay.warpgroups, lay.ring) == \
        (8, 1, 2, 6)
    assert lay.image_bytes == mc.image_bytes == 671_744
    assert lay.slots == ec.EXCHANGE_MEMBERS * lay.out_groups == 2
    assert (lay.smem_stats, lay.smem_exchange) == (mc.smem_stats,
                                                  mc.smem_exchange)
    assert lay.grid == mc.grid == 8 * 15
    small = ec.eval_layout('ensemble', 5, 7, 1, 128, SMS, 8, 15, True)
    assert (small.warpgroups, small.grid, small.threads) == (1, 16, 128)


@pytest.mark.parametrize('members,d,L,out', [(1, 5, 7, 1), (3, 13, 2, 9),
                                             (9, 5, 1, 9), (2, 13, 7, 1)])
def test_cached_tf32_image_is_every_member_in_turn(members, d, L, out):
    """The fp32 ensemble's image (cached_image of fp32 FusedWeights):
    member m's 3xTF32 chain image at m * image_bytes, read back to its
    weights through the descriptor layout."""
    from nnueehcs_tpu_torch.ops.fused_ensemble import FusedWeights
    gen = torch.Generator().manual_seed(members * 100 + L)
    dims = [d] + [128] * (L - 1) + [out]
    folded = [(torch.randn((members, k, n), generator=gen),
               torch.randn((members, n), generator=gen), l < L - 1)
              for l, (k, n) in enumerate(zip(dims[:-1], dims[1:]))]
    fw = FusedWeights(folded)
    image = ec.cached_image(fw)
    n = ec.tf32_image_bytes(d, L, out) // 4
    assert image.dtype == torch.float32 and image.numel() == members * n
    for m in range(members):
        layers = image_layers(image[m * n:(m + 1) * n], d, L, out)
        for l, (hi, lo) in enumerate(layers):
            w = fw.ws[l][m]
            k, cols = hi.shape
            want = torch.zeros((k, cols))
            want[:w.shape[0], :min(cols, w.shape[1])] = \
                w[:, :min(cols, w.shape[1])]
            assert torch.equal(hi, ec.tf32_round(want))
            assert torch.equal(lo, ec.tf32_round(want - hi))
