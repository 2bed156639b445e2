"""The launch layout and the weight image of the eval kernels on Hopper's
warpgroup products (``csrc/fused_chain_wgmma.cuh``): the bf16 kernels 1b,
2b and 5b and the fp32 kernels 1, 2 and 5 (3xTF32). The one place that
decides, from the weights' shapes, how a chain runs on the card.

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

The fp32 kernels 1, 2 and 5 run their products as 3xTF32 (``a_hi b_hi +
a_hi b_lo + a_lo b_hi``, each term a TF32 ``wgmma``, summed in fp32). Their
image (:func:`chain_image` of fp32 weights) holds each weight twice, ``W_hi
= tf32(W)`` and ``W_lo = tf32(W - W_hi)`` (round to nearest, ties away, as
``cvt.rna.tf32.f32``), cut into blocks of at most ``TF32_ROWS`` input rows
(:func:`tf32_blocks`): layer 0's ``d`` rows rounded up to 8, 4 blocks of
each hidden layer, and the last layer per group of 8 output columns (a
one-Linear chain: layer 0 per column group). A block of ``R`` rows and ``N``
columns is its hi image then its lo image, each storing logical row ``k``,
column ``n`` at float ``((n // 8) * (R // 4) + k // 4) * 32 + (n % 8) * 4 + k
% 4`` (8 x 4 core matrices, leading byte offset 128, stride byte offset
``32 R``). Logical row ``k`` of each 8 is weight row ``TF32_PERM[k % 8]``:
the TF32 A fragment holds inputs ``q`` and ``q + 4`` of each 8 where the
fp32 accumulator of the layer before holds columns ``2 q`` and ``2 q + 1``,
so permuting the weight rows lets a pass keep its activations in registers.
Every image streams through a ring of ``ring`` 32 KB slots (the flagship's
hi and lo images are 656 KB) into a block's one or two consumer
warpgroups, each on its own tile, all through the same blocks; the first
thread of each warpgroup is also a producer. A tile's passes (samples,
anchors) are split into ``GROUPS`` groups, one for each block of a
thread-block cluster of ``GROUPS`` blocks;
each group's shifted sums reach the leader block through its exchange
rings, which merges them in group order by Chan's formula. The fp32
ensemble (kernel 1) keeps 1b's cluster of ``min(M, 8)`` member blocks, each
streaming its own members' images (:func:`cached_image`) through its ring,
and the leader folds the members' outputs in member order as 1b does; it
runs one warpgroup a block while the tiles do not fill the card's
clusters, so a small request spreads over as many clusters as it has
tiles.
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
# the fp32 kernels (3xTF32): input rows of an image block; groups of a
# tile's passes, one a block of a cluster (a constant of the kernels,
# kGroups); ring slots tried, most first; the weight row at each logical
# row of 8 (the TF32 A fragment's inputs q, q + 4 are columns 2 q, 2 q + 1
# of the accumulator before)
TF32_ROWS = 32
GROUPS = 8
TF32_RING = (6, 5, 4, 3, 2)
TF32_MIN_RING_2 = 3          # the fewest slots two warpgroups share
TF32_STREAM_BYTES = 64       # the producers' state (Stream), at the end
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
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


def tf32_blocks(in_dim: int, num_layers: int, out_dim: int):
    """``(layer, first input row, rows, first column, columns)`` of each
    block of an fp32 image, in image order (``Chain32`` of
    csrc/fused_chain_wgmma.cuh)."""
    d8 = _up(in_dim, 8)
    groups = -(-out_dim // 8)
    blocks = []

    def rows_of(layer, k, c0, cols):
        for k0 in range(0, k, TF32_ROWS):
            blocks.append((layer, k0, min(TF32_ROWS, k - k0), c0, cols))
    if num_layers == 1:
        for g in range(groups):
            rows_of(0, d8, 8 * g, 8)
        return blocks
    rows_of(0, d8, 0, WIDTH)
    for layer in range(1, num_layers - 1):
        rows_of(layer, WIDTH, 0, WIDTH)
    for g in range(groups):
        rows_of(num_layers - 1, WIDTH, 8 * g, 8)
    return blocks


def tf32_image_bytes(in_dim: int, num_layers: int, out_dim: int) -> int:
    return sum(8 * rows * cols for _, _, rows, _, cols in
               tf32_blocks(in_dim, num_layers, out_dim))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: the low 13 bits zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)


def tf32_split(w: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(w)``, ``lo = tf32(w - hi)``."""
    hi = tf32_round(w)
    return hi, tf32_round(w - hi)


def _tf32_part(blk: torch.Tensor) -> torch.Tensor:
    """Each member's ``(rows, cols)`` block of ``blk`` ``(M, rows, cols)``
    (rows a multiple of 8) in descriptor order, ``(M, rows * cols)``, its
    rows permuted by TF32_PERM in each 8: logical row ``8 a + 4 c + b`` is
    weight row ``8 a + 2 b + c``. Views only (no index tensor to copy to
    the card, which would synchronise a fit that enqueues ahead of it)."""
    members, rows, cols = blk.shape
    logical = blk.reshape(members, rows // 8, 4, 2, cols).transpose(2, 3)
    # (rows, cols) -> [n // 8][k // 4][n % 8][k % 4]
    return logical.reshape(members, rows // 4, 4, cols // 8, 8).permute(
        0, 3, 1, 4, 2).reshape(members, -1)


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


def _tf32_layout(kernel: str, in_dim: int, num_layers: int, out_dim: int,
                 rows: int, sms: int, clusters: Optional[int],
                 members: int = 1) -> EvalLayout:
    """The fp32 kernels' layout: two consumer warpgroups a block with a
    ring of at least TF32_MIN_RING_2 slots where that fits, else one; the
    ring with the most slots that fit (TF32_RING), then the statistics, the
    exchange rings of the cluster's peers with the most slots that fit up
    to one tile's sums (two members' outputs for the ensemble), the
    barriers and the producer's state (TF32_STREAM_BYTES); clusters of
    GROUPS blocks ('mc', 'anchored') or of ``c = min(members, 8)``
    ('ensemble'), at most ``clusters`` (``sms // c`` when not given) and no
    more than the tiles' warpgroups fill. The ensemble runs one warpgroup a
    block while its tiles are no more than the clusters, so that each tile
    has a cluster of its own."""
    out_groups = -(-out_dim // 8)
    slot_bytes = exchange_slot_bytes(out_dim)
    ensemble = kernel == 'ensemble'
    cluster = min(members, MAX_CLUSTER) if ensemble else GROUPS
    tiles = -(-max(rows, 1) // 64)
    units = sms // cluster if clusters is None else clusters
    most = 2 * out_groups if not ensemble else EXCHANGE_MEMBERS * out_groups
    slot_choices = range(most, 0, -1) if cluster > 1 else (0,)
    form = None
    for wgs in ((1,) if ensemble and tiles <= units else (2, 1)):
        for ring in TF32_RING:
            if wgs == 2 and ring < TF32_MIN_RING_2:
                break
            for slots in slot_choices:
                carve = _carve(ring * SLOT_BYTES, wgs, out_groups, ring,
                               cluster - 1, slots, slot_bytes)
                if carve[-1] + TF32_STREAM_BYTES <= SMEM_LIMIT:
                    form = (wgs, ring, slots, carve)
                    break
            if form:
                break
        if form:
            break
    wgs, ring, slots, (stats, exchange, bars, total) = form
    return EvalLayout(
        warpgroups=wgs, ring=ring, out_groups=out_groups,
        image_bytes=tf32_image_bytes(in_dim, num_layers, out_dim),
        smem_stats=stats, smem_bars=bars,
        smem_bytes=total + TF32_STREAM_BYTES,
        grid=cluster * max(1, min(units, -(-tiles // wgs))),
        threads=WG_THREADS * wgs, cluster=cluster,
        members=-(-members // cluster), slots=slots, smem_exchange=exchange)


def eval_layout(kernel: str, in_dim: int, num_layers: int, out_dim: int,
                rows: int, sms: int, members: int = 1,
                clusters: Optional[int] = None,
                fp32: bool = False) -> EvalLayout:
    """The layout of ``kernel`` ('mc', 'anchored' or 'ensemble') for a
    chain of ``num_layers`` Linears from ``in_dim`` features to ``out_dim``
    outputs (hidden widths padded to 128) over ``rows`` rows on a card of
    ``sms`` SMs: resident with the most warpgroups that fit, else the ring.
    'mc' and 'anchored': at most one block per SM and no more blocks than
    the tiles fill. 'ensemble' (``members`` members): clusters of ``c =
    min(members, 8)`` blocks, each ring of the exchange with the most slots
    that fit up to two members' outputs (after the most warpgroups), and a
    grid of at most ``clusters`` clusters (the card's count at this layout;
    ``sms // c`` when not given) and no more than the tiles fill.
    ``fp32``: the fp32 (3xTF32) form of any of them (:func:`_tf32_layout`,
    ``clusters`` as for the ensemble)."""
    if not (1 <= out_dim <= WIDTH and in_dim >= 1 and num_layers >= 1
            and members >= 1) or kernel not in MAX_WARPGROUPS:
        raise ValueError(f'no eval layout for in_dim {in_dim}, '
                         f'{num_layers} layers, out_dim {out_dim}, '
                         f'{members} members, fp32 {fp32} {kernel}')
    if fp32:
        return _tf32_layout(kernel, in_dim, num_layers, out_dim, rows, sms,
                            clusters, members if kernel == 'ensemble' else 1)
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


def member_images(ws, out_dim: int, members=slice(None)) -> torch.Tensor:
    """The images of members ``members`` (a slice) of a folded chain,
    ``(M', image floats)`` (or bf16 values): ``ws[l]`` is layer l's weight,
    ``(M, K, 128)`` (``FusedWeights.ws``), bf16 or fp32; the packed bf16
    values, or for fp32 weights the TF32 hi and lo images of every block
    (:func:`tf32_blocks`), on the weights' device. Every member's block in
    one tensor operation, so the ops a fold costs do not grow with M."""
    num_layers = len(ws)
    in_dim = ws[0].shape[-2]
    parts = []
    if ws[0].dtype == torch.float32:
        for layer, k0, rows, c0, cols in tf32_blocks(in_dim, num_layers,
                                                     out_dim):
            w = ws[layer][members]
            blk = w.new_zeros((w.shape[0], rows, cols))
            src = w[:, k0:k0 + rows, c0:c0 + cols]
            blk[:, :src.shape[1], :src.shape[2]] = src
            parts += [_tf32_part(half) for half in tf32_split(blk)]
        return torch.cat(parts, dim=1)
    for layer, k0, rows, cols in chain_blocks(in_dim, num_layers, out_dim):
        w = ws[layer][members]
        blk = w.new_zeros((w.shape[0], rows, cols))
        src = w[:, k0:k0 + rows, :cols]
        blk[:, :src.shape[1]] = src
        # (rows, cols) -> [n // 8][k // 8][n % 8][k % 8]
        parts.append(blk.reshape(-1, rows // 8, 8, cols // 8, 8)
                     .permute(0, 3, 1, 4, 2).reshape(w.shape[0], -1))
    return torch.cat(parts, dim=1)


def chain_image(ws, out_dim: int, member: int = 0) -> torch.Tensor:
    """The image of member ``member`` of a folded chain
    (:func:`member_images`) as a flat tensor."""
    return member_images(ws, out_dim, slice(member, member + 1))[0] \
        .contiguous()


def cached_image(fw) -> torch.Tensor:
    """Every member's image of folded weights ``fw``, member after member
    (:func:`member_images`), computed once and kept on the weights
    object."""
    image = getattr(fw, '_wgmma_image', None)
    if image is None:
        image = member_images(fw.ws, fw.out_dim).reshape(-1).contiguous()
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


# the library entries that count the clusters a kernel fits at a layout
CLUSTER_ENTRIES = {
    ('ensemble', False): 'nnueehcs_fused_ensemble_bf16_clusters',
    ('probe', False): 'nnueehcs_packed_forward_bf16_clusters',
    ('ensemble', True): 'nnueehcs_fused_ensemble_f32_clusters',
    ('mc', True): 'nnueehcs_fused_mc_dropout_f32_clusters',
    ('anchored', True): 'nnueehcs_fused_anchored_f32_clusters'}


def launch_args(kernel: str, fw, rows: int, device, probe: bool = False):
    """``(image, layout ints)`` for launching ``kernel`` ('mc',
    'anchored' or 'ensemble'; ``probe``: the ensemble's packed probe, bf16
    only) on folded weights ``fw`` (bf16, or fp32 for the kernels' 3xTF32
    form) over ``rows`` rows on a CUDA ``device``: the cached image and the
    :func:`eval_layout` of this call as a ctypes int array, a cluster
    kernel's grid from the clusters it fits."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    members = fw.num_members if kernel == 'ensemble' else 1
    fp32 = not probe and fw.compute_dtype == torch.float32
    return cached_image(fw), _launch_layout(
        kernel, fw.in_dim, fw.num_layers, fw.out_dim, rows, index, members,
        fp32, probe)


@functools.lru_cache(maxsize=4096)
def _launch_layout(kernel, in_dim, num_layers, out_dim, rows, index,
                   members, fp32, probe):
    """The layout ints of one launch shape on card ``index``, computed
    once: two :func:`eval_layout` calls cost a small request more host
    time than its kernel takes on the card."""
    layout = eval_layout(kernel, in_dim, num_layers, out_dim, rows,
                         _sms(index), members, fp32=fp32)
    entry = CLUSTER_ENTRIES.get(('probe' if probe else kernel, fp32))
    if entry is not None:
        clusters = _clusters(entry, tuple(layout.ints()), index)
        layout = eval_layout(kernel, in_dim, num_layers, out_dim, rows,
                             _sms(index), members, clusters, fp32)
    return _ints(layout)
