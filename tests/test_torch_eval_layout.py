"""The launch layout and weight image of the bf16 eval kernels 2b and 5b
(``ops/fused_eval_chain.py``), the one place that decides how a chain runs
on the card: resident in shared memory or streamed through a ring, how many
consumer warpgroups a block runs, and where each weight block lies. Checked
over the shapes the kernels' gate accepts (any input width, any depth,
hidden widths and outputs up to 128). The kernels themselves run only on a
card (tests/test_torch_cuda.py)."""
import itertools

import pytest
import torch

from nnueehcs_tpu_torch.ops import fused_eval_chain as ec

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
