"""The launch layout and the weight image of the bf16 eval kernels 2b and 5b
(``csrc/fused_chain_wgmma.cuh``): the one place that decides, from the
weights' shapes, how a chain runs on the card.

The kernels keep one network's bf16 chain in shared memory as an *image*:
layer 0's ``d`` input rows rounded up to a multiple of 16 and cut into
blocks of at most 128 rows, then one 128-row block per later layer; every
block 128 columns wide but the last layer's, which is ``out_dim`` rounded up
to 8. A block of ``R`` rows and ``N`` columns stores element ``(k, n)`` at
byte ``((n // 8) * (R // 8) + k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2``:
8 x 8 core matrices with ``k`` contiguous, the layout a ``wgmma``
shared-memory descriptor reads without swizzle (leading byte offset 128,
stride byte offset ``16 R``). :func:`chain_image` packs it once per folded
weights; the kernel copies it into shared memory as it is.

:func:`eval_layout` chooses the form: *resident* when the image, the
statistics of every consumer warpgroup and the barriers fit in a block's
shared memory (``SMEM_LIMIT``), with as many consumer warpgroups as fit up
to the kernel's limit (``MAX_WARPGROUPS``: three for the MC-dropout kernel,
two for the anchored one, whose threads also hold ``u`` in registers);
else a *ring* of three slots of one block each (32 KB), filled by a
producer warp, for one consumer warpgroup. Every shape the kernels' gate
takes (any ``d``, any depth, hidden widths and ``out_dim`` up to 128) has a
layout: the ring with ``out_dim`` 128 needs 192 KB.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

WIDTH = 128               # padded layer width
K_BLOCK = 128             # input rows of an image block
SLOT_BYTES = K_BLOCK * WIDTH * 2
WG_THREADS = 128
STAT_BYTES = 3 * WG_THREADS * 16   # sc, s1, s2 of a group of 8 columns
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use (227 KB)
# consumer warpgroups of a block at most in the resident form: ptxas caps a
# thread's registers at 65,536 over the threads rounded up to whole
# warpgroups, 168 for three warpgroups and 255 for two; the MC kernel fits
# 168, the anchored one, whose threads also hold u, needs more. The ring
# form runs one warpgroup beside its producer warp (which the cap counts as
# a second warpgroup), with RING_SLOTS slots: 96 KB, which fits beside the
# largest statistics, 96 KB for 128 outputs.
MAX_WARPGROUPS = {'mc': 3, 'anchored': 2}
RING_SLOTS = 3
# the Layout struct of csrc/fused_chain_wgmma.cuh, in its order
LAYOUT_FIELDS = ('warpgroups', 'ring', 'out_groups', 'image_bytes',
                 'smem_stats', 'smem_bars', 'smem_bytes', 'grid', 'threads')


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def chain_blocks(in_dim: int, num_layers: int, out_dim: int):
    """``(layer, first input row, rows, columns)`` of each image block, in
    image order."""
    d16 = _up(in_dim, 16)
    out_n = _up(out_dim, 8)
    blocks = []
    for k0 in range(0, d16, K_BLOCK):
        blocks.append((0, k0, min(K_BLOCK, d16 - k0),
                       out_n if num_layers == 1 else WIDTH))
    for layer in range(1, num_layers):
        blocks.append((layer, 0, K_BLOCK,
                       out_n if layer == num_layers - 1 else WIDTH))
    return blocks


def image_bytes(in_dim: int, num_layers: int, out_dim: int) -> int:
    return sum(2 * rows * cols
               for _, _, rows, cols in chain_blocks(in_dim, num_layers,
                                                    out_dim))


@dataclasses.dataclass(frozen=True)
class EvalLayout:
    """How one launch runs: ``warpgroups`` consumer warpgroups a block,
    the image resident (``ring`` 0) or streamed through ``ring`` slots,
    the shared-memory carve-up (weights at 0, then the statistics at
    ``smem_stats``, then the mbarriers at ``smem_bars``), ``grid`` blocks
    of ``threads`` threads."""
    warpgroups: int
    ring: int
    out_groups: int
    image_bytes: int
    smem_stats: int
    smem_bars: int
    smem_bytes: int
    grid: int
    threads: int

    @property
    def resident(self) -> bool:
        return self.ring == 0

    def ints(self):
        """The layout as the kernels' C entries take it (LAYOUT_FIELDS)."""
        return [int(getattr(self, f)) for f in LAYOUT_FIELDS]


def _carve(weights: int, warpgroups: int, out_groups: int, ring: int):
    stats = weights
    bars = _up(stats + warpgroups * out_groups * STAT_BYTES, 8)
    return stats, bars, bars + 8 * (2 * ring if ring else 1)


def eval_layout(kernel: str, in_dim: int, num_layers: int, out_dim: int,
                rows: int, sms: int) -> EvalLayout:
    """The layout of ``kernel`` ('mc' or 'anchored') for a chain of
    ``num_layers`` Linears from ``in_dim`` features to ``out_dim`` outputs
    (hidden widths padded to 128) over ``rows`` rows on a card of ``sms``
    SMs: resident with the most warpgroups that fit, else the ring; at most
    one block per SM and no more blocks than the tiles fill."""
    if not (1 <= out_dim <= WIDTH and in_dim >= 1 and num_layers >= 1):
        raise ValueError(f'no eval layout for in_dim {in_dim}, '
                         f'{num_layers} layers, out_dim {out_dim}')
    out_groups = -(-out_dim // 8)
    image = image_bytes(in_dim, num_layers, out_dim)
    for wgs in range(MAX_WARPGROUPS[kernel], 0, -1):
        stats, bars, total = _carve(image, wgs, out_groups, 0)
        if total <= SMEM_LIMIT:
            ring = 0
            break
    else:
        wgs, ring = 1, RING_SLOTS
        stats, bars, total = _carve(ring * SLOT_BYTES, wgs, out_groups, ring)
    tiles = -(-max(rows, 1) // 64)
    grid = max(1, min(sms, -(-tiles // wgs)))
    return EvalLayout(
        warpgroups=wgs, ring=ring, out_groups=out_groups, image_bytes=image,
        smem_stats=stats, smem_bars=bars, smem_bytes=total, grid=grid,
        threads=WG_THREADS * wgs + (32 if ring else 0))


def chain_image(ws, out_dim: int) -> torch.Tensor:
    """The image of a one-member folded chain: ``ws[l]`` is layer l's bf16
    weight, ``(1, K, 128)`` (``FusedWeights.ws``); returns the packed bf16
    bytes as a flat tensor on the weights' device."""
    num_layers = len(ws)
    in_dim = ws[0].shape[-2]
    parts = []
    for layer, k0, rows, cols in chain_blocks(in_dim, num_layers, out_dim):
        w = ws[layer][0]
        blk = w.new_zeros((rows, cols))
        src = w[k0:k0 + rows, :cols]
        blk[:src.shape[0]] = src
        # (rows, cols) -> [n // 8][k // 8][n % 8][k % 8]
        parts.append(blk.reshape(rows // 8, 8, cols // 8, 8)
                     .permute(2, 0, 3, 1).reshape(-1))
    return torch.cat(parts).contiguous()


def cached_image(fw) -> torch.Tensor:
    """:func:`chain_image` of folded weights ``fw`` (one member, bf16),
    computed once and kept on the weights object."""
    image = getattr(fw, '_wgmma_image', None)
    if image is None:
        image = chain_image(fw.ws, fw.out_dim)
        fw._wgmma_image = image
    return image


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_args(kernel: str, fw, rows: int, device):
    """``(image, layout ints)`` for launching ``kernel`` ('mc' or
    'anchored') on bf16 folded weights ``fw`` over ``rows`` rows on a
    CUDA ``device``: the cached image and the :func:`eval_layout` of this
    call as a ctypes int array."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    layout = eval_layout(kernel, fw.in_dim, fw.num_layers, fw.out_dim, rows,
                         _sms(index))
    return cached_image(fw), (ctypes.c_int * len(LAYOUT_FIELDS))(
        *layout.ints())
