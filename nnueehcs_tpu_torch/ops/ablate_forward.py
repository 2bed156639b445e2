"""Attribution probes of the fused ensemble pass (kernel 1): the CUDA
kernel's wrappers and their plain PyTorch versions.

Counterparts of four TPU probes, each a variant of the JAX package's
``_fused_kernel`` written to split its time: ``ablate_forward`` and
``xt_forward`` (``experiments/grid_r5/attrib_eval.py``), ``narrow_forward``
(``experiments/grid_r5/attrib_eval2.py``) and ``packed_forward``
(``experiments/grid_r4/kernel_variants.py``, fp32 and bf16). Each takes
the port's :class:`~.fused_ensemble.FusedWeights` in place of the JAX
probes' padded ``ws``/``bs``/``relus``, and returns what the JAX probe
returns: outputs padded to the probe's widths (128, or 8 for the narrow
ones), zeros past the chain's real width.

On a CUDA tensor each launches its kernel (``csrc/ablate_chain.cu``), on a
CPU tensor it runs its plain version (``*_plain``). It never falls back from
one to the other. ``<function>.launches`` counts kernel launches.
``ablate_forward`` runs kernel 1's own body (``fused_chain_wgmma.cuh``'s
``ensemble_tf32_as``: 3xTF32 ``wgmma`` products, the members over a cluster
of ``min(M, 8)`` blocks), one instance for each mode and for a chain cut
short, with kernel 1's launch layout (:func:`probe_layout`) and images: its
``'prod'`` is kernel 1's math, padded to 128 columns. ``xt_forward``,
``narrow_forward`` and the fp32 ``packed_forward`` run instances of kernel
1's former FFMA body (``fused_chain.cuh``'s ``ensemble_pass``), whose prod
instance (:func:`ffma_prod`) is the control they are held to bit for bit.

``packed_forward`` also takes bf16 folded weights (``compute_dtype``, the
JAX probe's ``compute_dtype='bfloat16'``): it then launches an instance of
kernel 1b's body (``fused_chain_wgmma.cuh``'s cluster ``ensemble_pass``,
with kernel 1b's images and layout) and counts it in
``packed_forward.launches_bf16``. The
other probes have no bf16 form and refuse such weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import collections
import ctypes
import functools

from .fused_eval_chain import (ENSEMBLE_FIELDS, _sms, cached_image,
                               eval_layout, launch_args, member_images)
from .fused_ensemble import (WIDTH, FusedWeights, check_weights_dtype,
                             shifted_stats)

# rows of a tile: a warpgroup's in ablate_forward, a block's in the FFMA
# probes; the probes' `tile` only sets which row io_floor reads
TILE_ROWS = 64
MODES = ('prod', 'io_floor', 'gemm_only', 'no_epi')
NARROW = 8         # the narrow probes' width
# output layouts of csrc/ablate_chain.cu
_OUT_ROWS, _OUT_COLS, _OUT_PACKED = 1, 2, 3


def _out_dim(fw: FusedWeights, layers: int) -> int:
    """The real width of layer ``layers - 1``: a chain cut short ends on a
    hidden layer, which the kernel computes 128 wide."""
    return fw.out_dim if layers == fw.num_layers else WIDTH


def _members_out(fw: FusedWeights, x, members: int, layers: int,
                 affine: bool = True):
    """Each member's output of the chain's first ``layers`` layers on ``x``
    (``(B, d)``): a list of ``(B, out_dim)`` tensors, the ops of
    ``fused_forward_plain`` (without bias and ReLU unless ``affine``)."""
    out_dim = _out_dim(fw, layers)
    outs = []
    for m in range(members):
        h = fw.round(x)
        for l in range(layers):
            w, b = fw.ws[l][m].float(), fw.b_all[l, m]
            if l == layers - 1:
                w, b = w[:, :out_dim], b[:out_dim]
            if affine:
                h = torch.addmm(b, h, w)
                if fw.relus[l]:
                    h = torch.relu(h)
            else:
                h = h @ w
            if l != layers - 1:
                h = fw.round(h)
        outs.append(h)
    return outs


def _stats(outs):
    """Shifted mean and std over the members' outputs, as
    ``fused_forward_plain`` sums them."""
    c = outs[0]
    s1, s2 = torch.zeros_like(c), torch.zeros_like(c)
    for h in outs[1:]:
        d = h - c
        s1 = s1 + d
        s2 = s2 + d * d
    return shifted_stats(s1, s2, c, len(outs))


def _fit(t, width):
    """``t`` (B, n) cut or zero-padded to ``width`` columns."""
    return t[:, :width] if t.shape[1] >= width else \
        F.pad(t, (0, width - t.shape[1]))


def _pass_plain(fw, x, members, layers, mode, tile):
    """The two (B, 128) outputs of one carved pass on ``x`` (``(B, d)``
    real features, contiguous)."""
    if mode == 'io_floor':
        first = torch.arange(x.shape[0], device=x.device) // tile * tile
        v = (1.0 + x[first, 0])[:, None].expand(-1, WIDTH).contiguous()
        return v, v.clone()
    outs = _members_out(fw, x, members, layers, affine=mode != 'gemm_only')
    pair = (outs[-1], outs[0]) if mode == 'no_epi' else _stats(outs)
    return tuple(_fit(t, WIDTH) for t in pair)


def _check(fw: FusedWeights, x, rows_first: bool, name: str):
    if x.dtype != torch.float32:
        raise TypeError(f'{name}: expected float32 input, got {x.dtype}')
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f'{name}: x must be a contiguous 2-d tensor')
    width = x.shape[1] if rows_first else x.shape[0]
    if width < fw.in_dim:
        raise ValueError(f'{name}: x holds {width} features, the network '
                         f'takes {fw.in_dim}')
    check_weights_dtype(fw)
    if fw.compute_dtype != torch.float32 and name != 'packed_forward':
        raise ValueError(f'{name}: no {fw.compute_dtype} form; the probe '
                         'takes float32 folded weights')
    for t in (fw.w_all, fw.b_all, fw.relu_flags):
        if t.device != x.device:
            raise ValueError(f'{name}: folded weights must be on {x.device}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: no kernel for device {x.device}')


def _launch(fw, x, *, n_out, x_cols, layout, out_dim, ow, outs):
    """Launch an FFMA probe instance (every member and layer)."""
    from ._build import library
    B = x.shape[1] if x_cols else x.shape[0]
    # the stride between rows of a (B, dx) x, or between features of a
    # feature-major (dx, B) one: its second dimension either way
    ldx = x.shape[1]
    with torch.cuda.device(x.device):
        err = library().nnueehcs_ablate_chain_f32(
            n_out, int(x_cols), layout, x.data_ptr(), B, fw.in_dim, ldx,
            fw.w_all.data_ptr(), fw.b_all.data_ptr(), fw.num_members,
            fw.num_members, fw.num_layers, fw.relu_flags.data_ptr(), out_dim,
            ow, outs[0].data_ptr(), outs[1].data_ptr() if n_out > 1 else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ablation kernel launch failed: CUDA error {err}')


def probe_layout(fw, rows: int, members: int, layers: int, sms: int = 132,
                 clusters=None):
    """The launch layout of :func:`ablate_forward` on the first ``members``
    members and ``layers`` layers of ``fw`` (folded weights, or their
    ``in_dim``, ``num_layers`` and ``out_dim``) over ``rows`` rows on a card of
    ``sms`` SMs: kernel 1's (``eval_layout('ensemble', ..., fp32=True)``)
    for that chain, whose last layer is 128 wide when it is cut short, with
    ``clusters`` clusters at most (the count the probe's instance fits)."""
    return eval_layout('ensemble', fw.in_dim, layers, _out_dim(fw, layers),
                       rows, sms, members, clusters, fp32=True)


def probe_image(fw: FusedWeights, layers: int) -> torch.Tensor:
    """Every member's fp32 image of the chain's first ``layers`` layers,
    member after member, as :func:`ablate_forward` streams it: kernel 1's
    (``cached_image``) for the whole chain; for a chain cut short, every
    layer packed as a hidden one (``member_images`` with ``open_end``),
    made once per folded weights and cut."""
    if layers == fw.num_layers:
        return cached_image(fw)
    images = fw.__dict__.setdefault('_probe_images', {})
    if layers not in images:
        images[layers] = member_images(fw.ws[:layers], WIDTH,
                                       open_end=True).reshape(-1).contiguous()
    return images[layers]


@functools.lru_cache(maxsize=1024)
def _probe_launch_layout(shape, rows, index, members, layers, mode, cut):
    """The layout ints of one probe launch on card ``index`` for a chain of
    ``shape`` (:class:`_Shape`), the grid from the clusters its instance
    fits (:func:`probe_layout`)."""
    from ._build import library
    layout = probe_layout(shape, rows, members, layers, _sms(index))
    form = (ctypes.c_int * len(ENSEMBLE_FIELDS))(*layout.ints())
    with torch.cuda.device(index):
        n = library().nnueehcs_ablate_forward_f32_clusters(mode, cut, form)
    if n <= 0:
        raise RuntimeError(f'ablate_forward: no cluster of {layout} fits the '
                           f'card (CUDA error {-n})')
    layout = probe_layout(shape, rows, members, layers, _sms(index), n)
    return (ctypes.c_int * len(ENSEMBLE_FIELDS))(*layout.ints())


# the shapes of folded weights that fix a probe's layout (a cache key)
_Shape = collections.namedtuple('_Shape', 'in_dim num_layers out_dim')


def _launch_tf32(fw, x, mode, members, layers, tile, outs):
    """Launch ablate_forward's instance of ``mode`` on kernel 1's body."""
    from ._build import library
    device = x.device
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out_dim = _out_dim(fw, layers)
    cut = int(layers < fw.num_layers and mode != 'io_floor')
    with torch.cuda.device(device):
        layout = _probe_launch_layout(
            _Shape(fw.in_dim, fw.num_layers, fw.out_dim), x.shape[0], index,
            members, layers, MODES.index(mode), cut)
        err = library().nnueehcs_ablate_forward_f32(
            MODES.index(mode), cut, x.data_ptr(), x.shape[0], fw.in_dim,
            x.shape[1], probe_image(fw, layers).data_ptr(),
            fw.b_all.data_ptr(), members, fw.num_members, layers,
            fw.relu_flags.data_ptr(), out_dim, tile,
            outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
            layout, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ablate_forward launch failed: CUDA error {err}')


def _real(x, d):
    return x[:, :d].contiguous()


def _cut(fw, num_members, num_layers):
    """The members and layers to run (None: all of them)."""
    members = fw.num_members if num_members is None else num_members
    layers = fw.num_layers if num_layers is None else num_layers
    if not (1 <= members <= fw.num_members and 1 <= layers <= fw.num_layers):
        raise ValueError(f'ablate_forward: {members} members, {layers} '
                         f'layers of {fw.num_members} and {fw.num_layers}')
    return members, layers


def ablate_forward_plain(fw: FusedWeights, x_pad, num_members=None,
                         num_layers=None, tile=TILE_ROWS, mode='prod',
                         n_out=2):
    """:func:`ablate_forward` in plain tensor ops."""
    members, layers = _cut(fw, num_members, num_layers)
    return _pass_plain(fw, _real(x_pad, fw.in_dim), members, layers, mode,
                       tile)[:n_out]


def ablate_forward(fw: FusedWeights, x_pad, num_members=None,
                   num_layers=None, tile=TILE_ROWS, mode='prod', n_out=2):
    """Kernel 1 with parts carved off (JAX ``ablate_forward``): the first
    ``num_members`` members (default all) of the chain cut to its first
    ``num_layers`` layers (default all) on ``x_pad`` (``(B, dx)``, the
    network's ``d`` features then zeros). ``mode``: ``'prod'`` (shifted mean
    and std), ``'io_floor'`` (no chain: every output is ``1 + x[first row
    of the tile, 0]`` for ``tile``-row tiles), ``'gemm_only'`` (no bias, no
    ReLU), ``'no_epi'`` (out0 = the last member's output, out1 = member
    0's). Returns ``n_out`` (1 or 2) ``(B, 128)`` tensors. On the card,
    ``'gemm_only'`` takes the whole chain only: its instance for a chain
    cut short spills at the register cap, so there is none, and the
    wrapper raises (the plain version computes it)."""
    _check(fw, x_pad, True, 'ablate_forward')
    members, layers = _cut(fw, num_members, num_layers)
    if mode not in MODES or n_out not in (1, 2) or tile < 1:
        raise ValueError(f'ablate_forward: mode {mode!r}, n_out {n_out}, '
                         f'tile {tile}')
    if x_pad.device.type == 'cpu':
        return ablate_forward_plain(fw, x_pad, members, layers, tile, mode,
                                    n_out)
    if mode == 'gemm_only' and layers < fw.num_layers:
        raise ValueError(f'ablate_forward: no gemm_only kernel for a chain '
                         f'cut to {layers} of {fw.num_layers} layers')
    outs = [torch.empty((x_pad.shape[0], WIDTH), dtype=torch.float32,
                        device=x_pad.device) for _ in range(n_out)]
    if x_pad.shape[0]:
        _launch_tf32(fw, x_pad, mode, members, layers, tile, outs)
        ablate_forward.launches += 1
    return tuple(outs)


def ffma_prod(fw: FusedWeights, x_pad):
    """The prod instance of kernel 1's former FFMA body (``(B, 128)`` mean
    and std of every member and layer, zeros past the real width) on a CUDA
    ``x_pad``: the control that the FFMA probes (``xt_forward``,
    ``narrow_forward``, the fp32 ``packed_forward``) are held to bit for
    bit. A gate's reference, not a probe: no launch count."""
    _check(fw, x_pad, True, 'ffma_prod')
    if x_pad.device.type != 'cuda':
        raise ValueError(f'ffma_prod: the FFMA body runs on a card, got '
                         f'{x_pad.device}')
    outs = [torch.empty((x_pad.shape[0], WIDTH), dtype=torch.float32,
                        device=x_pad.device) for _ in range(2)]
    if x_pad.shape[0]:
        _launch(fw, x_pad, n_out=2, x_cols=False, layout=_OUT_ROWS,
                out_dim=fw.out_dim, ow=WIDTH, outs=outs)
    return tuple(outs)


def xt_forward_plain(fw: FusedWeights, x_t, out_t=False, out_rows=NARROW):
    """:func:`xt_forward` in plain tensor ops."""
    mean, std = _pass_plain(fw, x_t[:fw.in_dim].T.contiguous(),
                            fw.num_members, fw.num_layers, 'prod', TILE_ROWS)
    if out_t:
        return tuple(t.T[:out_rows].contiguous() for t in (mean, std))
    return mean, std


def xt_forward(fw: FusedWeights, x_t, out_t=False, out_rows=NARROW):
    """Kernel 1 with x fed feature-major (JAX ``xt_forward``): ``x_t`` is
    ``(dx, B)``, the network's ``d`` features then zero rows. Returns mean
    and std as ``(B, 128)`` tensors, or with ``out_t`` feature-major as
    ``(out_rows, B)`` tensors (rows past the real width are zeros)."""
    _check(fw, x_t, False, 'xt_forward')
    if not 1 <= out_rows <= WIDTH:
        raise ValueError(f'xt_forward: out_rows {out_rows}')
    if x_t.device.type == 'cpu':
        return xt_forward_plain(fw, x_t, out_t, out_rows)
    B = x_t.shape[1]
    shape = (out_rows, B) if out_t else (B, WIDTH)
    outs = [torch.empty(shape, dtype=torch.float32, device=x_t.device)
            for _ in range(2)]
    if B:
        _launch(fw, x_t, n_out=2, x_cols=True,
                layout=_OUT_COLS if out_t else _OUT_ROWS, out_dim=fw.out_dim,
                ow=shape[0] if out_t else WIDTH, outs=outs)
        xt_forward.launches += 1
    return tuple(outs)


def _narrow_widths(fw, x_in, narrow_in, narrow_out):
    want = NARROW if narrow_in else WIDTH
    if x_in.dim() != 2 or x_in.shape[1] != want:
        raise ValueError(f'narrow_forward: narrow_in={narrow_in} takes x of '
                         f'shape (B, {want}), got {tuple(x_in.shape)}')
    return NARROW if narrow_out else WIDTH


def narrow_forward_plain(fw: FusedWeights, x_in, narrow_in=True,
                         narrow_out=True):
    """:func:`narrow_forward` in plain tensor ops."""
    ow = _narrow_widths(fw, x_in, narrow_in, narrow_out)
    mean, std = _pass_plain(fw, _real(x_in, fw.in_dim), fw.num_members,
                            fw.num_layers, 'prod', TILE_ROWS)
    return _fit(mean, ow).contiguous(), _fit(std, ow).contiguous()


def narrow_forward(fw: FusedWeights, x_in, narrow_in=True, narrow_out=True):
    """Kernel 1 with narrow arrays (JAX ``narrow_forward``): ``x_in`` is
    ``(B, 8)`` with ``narrow_in`` (else ``(B, 128)``), the network's ``d``
    features then zeros; mean and std are ``(B, 8)`` with ``narrow_out``
    (else ``(B, 128)``)."""
    _check(fw, x_in, True, 'narrow_forward')
    ow = _narrow_widths(fw, x_in, narrow_in, narrow_out)
    if x_in.device.type == 'cpu':
        return narrow_forward_plain(fw, x_in, narrow_in, narrow_out)
    outs = [torch.empty((x_in.shape[0], ow), dtype=torch.float32,
                        device=x_in.device) for _ in range(2)]
    if x_in.shape[0]:
        _launch(fw, x_in, n_out=2, x_cols=False, layout=_OUT_ROWS,
                out_dim=fw.out_dim, ow=ow, outs=outs)
        narrow_forward.launches += 1
    return tuple(outs)


def _check_packed(fw):
    if 2 * fw.out_dim > WIDTH:
        raise ValueError(f'packed_forward: mean and std of {fw.out_dim} '
                         f'columns do not fit one {WIDTH}-column buffer')


def packed_forward_plain(fw: FusedWeights, x_pad):
    """:func:`packed_forward` in plain tensor ops."""
    _check_packed(fw)
    mean, std = _pass_plain(fw, _real(x_pad, fw.in_dim), fw.num_members,
                            fw.num_layers, 'prod', TILE_ROWS)
    od = fw.out_dim
    out = torch.zeros_like(mean)
    out[:, :od] = mean[:, :od]
    out[:, od:2 * od] = std[:, :od]
    return out[:, :od], out[:, od:2 * od]


def packed_forward(fw: FusedWeights, x_pad):
    """Kernel 1 with mean and std packed into one ``(B, 128)`` buffer (JAX
    ``packed_forward``, in the weights' compute dtype, fp32 or bf16): mean
    in columns ``[0, out_dim)``, std in ``[out_dim, 2 out_dim)``, zeros past
    them. ``x_pad`` is ``(B, dx)``, the network's ``d`` features then zeros.
    Returns the two views ``(mean, std)`` of the buffer, as the JAX probe
    does."""
    _check(fw, x_pad, True, 'packed_forward')
    _check_packed(fw)
    if x_pad.device.type == 'cpu':
        return packed_forward_plain(fw, x_pad)
    out = torch.empty((x_pad.shape[0], WIDTH), dtype=torch.float32,
                      device=x_pad.device)
    if x_pad.shape[0] and fw.compute_dtype == torch.bfloat16:
        from ._build import library
        with torch.cuda.device(x_pad.device):
            image, layout = launch_args('ensemble', fw, x_pad.shape[0],
                                        x_pad.device, probe=True)
            err = library().nnueehcs_packed_forward_bf16(
                x_pad.data_ptr(), x_pad.shape[0], fw.in_dim, x_pad.shape[1],
                image.data_ptr(), fw.b_all.data_ptr(), fw.num_members,
                fw.num_layers, fw.relu_flags.data_ptr(), fw.out_dim,
                out.data_ptr(), layout,
                torch.cuda.current_stream(x_pad.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'packed bf16 kernel launch failed: CUDA '
                               f'error {err}')
        packed_forward.launches_bf16 += 1
    elif x_pad.shape[0]:
        _launch(fw, x_pad, n_out=1, x_cols=False, layout=_OUT_PACKED,
                out_dim=fw.out_dim, ow=WIDTH, outs=[out])
        packed_forward.launches += 1
    od = fw.out_dim
    return out[:, :od], out[:, od:2 * od]


for _fn in (ablate_forward, xt_forward, narrow_forward, packed_forward):
    _fn.launches = 0
packed_forward.launches_bf16 = 0
