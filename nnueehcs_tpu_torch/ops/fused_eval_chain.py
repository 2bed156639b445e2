"""The launch layout and the weight image of the bf16 eval kernels 1b, 2b
and 5b (``csrc/fused_chain_wgmma.cuh``): the one place that decides, from
the weights' shapes, how a chain runs on the card.

The kernels keep a network's bf16 chain in shared memory as an *image*:
layer 0's ``d`` input rows rounded up to a multiple of 16 and cut into
blocks of at most 128 rows, then one 128-row block per later layer; every
block 128 columns wide but the last layer's, which is ``out_dim`` rounded up
to 8. A block of ``R`` rows and ``N`` columns stores element ``(k, n)`` at
byte ``((n // 8) * (R // 8) + k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2``:
8 x 8 core matrices with ``k`` contiguous, the layout a ``wgmma``
shared-memory descriptor reads without swizzle (leading byte offset 128,
stride byte offset ``16 R``). :func:`chain_image` packs one member's image,
:func:`cached_image` every member's, one after another, once per folded
weights; the kernel copies them into shared memory as they are.

:func:`eval_layout` chooses the form: *resident* when the images, the
statistics of every consumer warpgroup (and, for the ensemble, its
exchange rings) and the barriers fit in a block's shared memory
(``SMEM_LIMIT``), with as many consumer warpgroups as fit up to the
kernel's limit (``MAX_WARPGROUPS``: three for the MC-dropout and ensemble
kernels, two for the anchored one, whose threads also hold ``u`` in
registers); else a *ring* of three slots of one block each (32 KB), filled
by a producer warp, for one consumer warpgroup. Every shape the kernels'
gate takes (any ``d``, any depth, hidden widths and ``out_dim`` up to 128,
any number of members) has a layout: the ring with ``out_dim`` 128 needs
192 KB, 206 KB with the ensemble's exchange.

The ensemble kernel (1b) runs one thread-block cluster of ``c = min(M, 8)``
blocks per unit of tiles: block ``r`` holds members ``r, r + c, ...``
(``ceil(M / c)`` images at most) and sends each member's last-layer output
of a tile, one group of 8 columns (2 KB) at a time, into its ring of
``slots`` slots in the leader block (rank 0), which sums the members in
order. The grid is as many clusters as the card runs at once
(``cudaOccupancyMaxActiveClusters``, asked through the library at launch),
no more than the tiles fill.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

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
MAX_WARPGROUPS = {'mc': 3, 'anchored': 2, 'ensemble': 3}
RING_SLOTS = 3
# the ensemble's cluster: at most the portable 8 blocks; each exchange slot
# is one column group of a tile, 16 bytes from each thread whose lane holds
# real columns (exchange_slot_bytes); a ring holds at most the outputs of
# EXCHANGE_MEMBERS members
MAX_CLUSTER = 8
EXCHANGE_MEMBERS = 2


def exchange_slot_bytes(out_dim: int) -> int:
    """Bytes of an exchange slot (csrc/fused_chain_wgmma.cuh
    exchange_slot_bytes): 16 from each of the 32 quads' lanes q that hold
    real columns 2 q, 2 q + 1 of a group of 8."""
    lanes = 4 if out_dim >= 8 else (out_dim + 1) // 2
    return 32 * lanes * 16
# the Layout struct of csrc/fused_chain_wgmma.cuh, in its order, then the
# ensemble's (EnsembleLayout)
LAYOUT_FIELDS = ('warpgroups', 'ring', 'out_groups', 'image_bytes',
                 'smem_stats', 'smem_bars', 'smem_bytes', 'grid', 'threads')
ENSEMBLE_FIELDS = LAYOUT_FIELDS + ('cluster', 'members', 'slots',
                                   'smem_exchange')


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
    the images resident (``ring`` 0) or streamed through ``ring`` slots,
    the shared-memory carve-up (weights at 0, then the statistics at
    ``smem_stats``, the ensemble's exchange rings at ``smem_exchange``,
    then the mbarriers at ``smem_bars``), ``grid`` blocks of ``threads``
    threads; for the ensemble, clusters of ``cluster`` blocks, each holding
    at most ``members`` members, with ``slots`` slots in each exchange
    ring (1, 0 and 0 for the other kernels)."""
    warpgroups: int
    ring: int
    out_groups: int
    image_bytes: int
    smem_stats: int
    smem_bars: int
    smem_bytes: int
    grid: int
    threads: int
    cluster: int = 1
    members: int = 1
    slots: int = 0
    smem_exchange: int = 0

    @property
    def resident(self) -> bool:
        return self.ring == 0

    def ints(self):
        """The layout as the kernels' C entries take it (ENSEMBLE_FIELDS;
        the MC-dropout and anchored kernels read LAYOUT_FIELDS, its
        start)."""
        return [int(getattr(self, f)) for f in ENSEMBLE_FIELDS]


def _carve(weights: int, warpgroups: int, out_groups: int, ring: int,
           peers: int = 0, slots: int = 0, slot_bytes: int = 0):
    """``(stats, exchange, bars, total)`` byte offsets: the statistics
    after the weights, the exchange rings (``peers`` rings of ``slots``
    slots a warpgroup) after them, then the mbarriers: the weights' (a
    full and an empty one per ring slot, else one), a full one per exchange
    slot and an empty one per slot of a warpgroup's own ring."""
    stats = weights
    exchange = stats + warpgroups * out_groups * STAT_BYTES
    bars = _up(exchange + warpgroups * peers * slots * slot_bytes, 8)
    count = (2 * ring if ring else 1) + warpgroups * (peers + 1) * slots \
        if peers else (2 * ring if ring else 1)
    return stats, exchange, bars, bars + 8 * count


def eval_layout(kernel: str, in_dim: int, num_layers: int, out_dim: int,
                rows: int, sms: int, members: int = 1,
                clusters: Optional[int] = None) -> EvalLayout:
    """The layout of ``kernel`` ('mc', 'anchored' or 'ensemble') for a
    chain of ``num_layers`` Linears from ``in_dim`` features to ``out_dim``
    outputs (hidden widths padded to 128) over ``rows`` rows on a card of
    ``sms`` SMs: resident with the most warpgroups that fit, else the ring.
    'mc' and 'anchored': at most one block per SM and no more blocks than
    the tiles fill. 'ensemble' (``members`` members): clusters of ``c =
    min(members, 8)`` blocks, each ring of the exchange with the most slots
    that fit up to two members' outputs (after the most warpgroups), and a
    grid of at most ``clusters`` clusters (the card's count at this layout;
    ``sms // c`` when not given) and no more than the tiles fill."""
    if not (1 <= out_dim <= WIDTH and in_dim >= 1 and num_layers >= 1
            and members >= 1):
        raise ValueError(f'no eval layout for in_dim {in_dim}, '
                         f'{num_layers} layers, out_dim {out_dim}, '
                         f'{members} members')
    out_groups = -(-out_dim // 8)
    image = image_bytes(in_dim, num_layers, out_dim)
    cluster = min(members, MAX_CLUSTER) if kernel == 'ensemble' else 1
    held = -(-members // cluster) if kernel == 'ensemble' else 1
    peers = cluster - 1
    # exchange slots a ring may take, most first (0: no exchange)
    slot_choices = range(EXCHANGE_MEMBERS * out_groups, 0, -1) if peers \
        else (0,)
    slot_bytes = exchange_slot_bytes(out_dim)
    form = None
    for wgs in range(MAX_WARPGROUPS[kernel], 0, -1):
        for slots in slot_choices:
            carve = _carve(held * image, wgs, out_groups, 0, peers, slots,
                           slot_bytes)
            if carve[-1] <= SMEM_LIMIT:
                form = (wgs, 0, slots, carve)
                break
        if form:
            break
    else:
        for slots in slot_choices:
            carve = _carve(RING_SLOTS * SLOT_BYTES, 1, out_groups,
                           RING_SLOTS, peers, slots, slot_bytes)
            if carve[-1] <= SMEM_LIMIT:
                form = (1, RING_SLOTS, slots, carve)
                break
    wgs, ring, slots, (stats, exchange, bars, total) = form
    tiles = -(-max(rows, 1) // 64)
    units = sms // cluster if clusters is None else clusters
    grid = cluster * max(1, min(units, -(-tiles // wgs)))
    return EvalLayout(
        warpgroups=wgs, ring=ring, out_groups=out_groups, image_bytes=image,
        smem_stats=stats, smem_bars=bars, smem_bytes=total, grid=grid,
        threads=WG_THREADS * wgs + (32 if ring else 0), cluster=cluster,
        members=held, slots=slots, smem_exchange=exchange)


def chain_image(ws, out_dim: int, member: int = 0) -> torch.Tensor:
    """The image of member ``member`` of a folded chain: ``ws[l]`` is layer
    l's bf16 weight, ``(M, K, 128)`` (``FusedWeights.ws``); returns the
    packed bf16 bytes as a flat tensor on the weights' device."""
    num_layers = len(ws)
    in_dim = ws[0].shape[-2]
    parts = []
    for layer, k0, rows, cols in chain_blocks(in_dim, num_layers, out_dim):
        w = ws[layer][member]
        blk = w.new_zeros((rows, cols))
        src = w[k0:k0 + rows, :cols]
        blk[:src.shape[0]] = src
        # (rows, cols) -> [n // 8][k // 8][n % 8][k % 8]
        parts.append(blk.reshape(rows // 8, 8, cols // 8, 8)
                     .permute(2, 0, 3, 1).reshape(-1))
    return torch.cat(parts).contiguous()


def cached_image(fw) -> torch.Tensor:
    """Every member's :func:`chain_image` of folded weights ``fw`` (bf16),
    member after member, computed once and kept on the weights object."""
    image = getattr(fw, '_wgmma_image', None)
    if image is None:
        image = torch.cat([chain_image(fw.ws, fw.out_dim, m)
                           for m in range(fw.ws[0].shape[0])])
        fw._wgmma_image = image
    return image


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ints(layout: EvalLayout):
    return (ctypes.c_int * len(ENSEMBLE_FIELDS))(*layout.ints())


@functools.lru_cache(maxsize=None)
def _clusters(entry: str, form: tuple, index: int) -> int:
    """The clusters of the library's kernel behind ``entry`` at the layout
    ``form`` (its ints) that card ``index`` runs at once."""
    from ._build import library
    with torch.cuda.device(index):
        n = getattr(library(), entry)((ctypes.c_int * len(form))(*form))
    if n <= 0:
        raise RuntimeError(f'{entry}: no cluster of {form} fits the card '
                           f'(CUDA error {-n})' if n < 0 else
                           f'{entry}: no cluster of {form} fits the card')
    return n


def launch_args(kernel: str, fw, rows: int, device, probe: bool = False):
    """``(image, layout ints)`` for launching ``kernel`` ('mc',
    'anchored' or 'ensemble'; ``probe``: the ensemble's packed probe) on
    bf16 folded weights ``fw`` over ``rows`` rows on a CUDA ``device``: the
    cached image and the :func:`eval_layout` of this call as a ctypes int
    array, the ensemble's grid from the clusters its kernel fits."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    members = fw.num_members if kernel == 'ensemble' else 1
    layout = eval_layout(kernel, fw.in_dim, fw.num_layers, fw.out_dim, rows,
                         _sms(index), members)
    if kernel == 'ensemble':
        entry = 'nnueehcs_packed_forward_bf16_clusters' if probe else \
            'nnueehcs_fused_ensemble_bf16_clusters'
        clusters = _clusters(entry, tuple(layout.ints()), index)
        layout = eval_layout(kernel, fw.in_dim, fw.num_layers, fw.out_dim,
                             rows, _sms(index), members, clusters)
    return cached_image(fw), _ints(layout)
