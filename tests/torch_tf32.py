"""A plain-torch emulation of the fp32 kernels 1 (the ensemble), 2 (MC
dropout) and 5 (anchored) as they compute on the card
(``csrc/fused_chain_wgmma.cuh``, its 3xTF32 section): the weights read back
from the kernels' image (``ops/fused_eval_chain.py`` ``chain_image``; the
ensemble's members one after another, ``cached_image``) the way the
``wgmma`` descriptors address it, each activation split into TF32 hi and lo
parts (round to nearest, ties away, by bit mask:
``fused_eval_chain.tf32_round``), each product as ``a_lo w_hi + a_hi w_lo +
a_hi w_hi`` summed in fp32. Kernels 2 and 5: a tile's passes split into
``GROUPS`` groups (the first ``count % GROUPS`` one pass more), each
group's sums shifted by its own first pass, the groups' moments merged by
Chan's formula in group order. Kernel 1: the members' outputs folded in
member order into sums shifted by member 0's output, as the leader block
folds them. Used by tests/test_torch_tf32_chain.py and
tests/test_torch_eval_layout.py."""
import math

import torch

from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc


def read_tf32_block(image, offset, rows, cols):
    """One part (hi or lo) of an image block at float ``offset`` back as its
    ``(rows, cols)`` matrix in weight-row order, read the way the kernel's
    descriptors address it: k step ``s`` (8 inputs) starts at byte ``256
    s``, its second 4 inputs one leading byte offset (128) further, each
    group of 8 columns one stride byte offset (``32 rows``) further; within
    a core matrix column n's 4 inputs are 16 contiguous bytes; logical row
    ``k`` is weight row ``8 (k // 8) + TF32_PERM[k % 8]``."""
    flat = image.view(-1)
    logical = image.new_zeros((rows, cols))
    lbo, sbo = 128, 32 * rows
    for s in range(rows // 8):
        for half in range(2):
            for ng in range(cols // 8):
                base = offset + (256 * s + lbo * half + sbo * ng) // 4
                core = flat[base:base + 32].reshape(8, 4)   # [n % 8][k % 4]
                logical[8 * s + 4 * half:8 * s + 4 * half + 4,
                        8 * ng:8 * ng + 8] = core.t()
    out = torch.empty_like(logical)
    for k in range(rows):
        out[8 * (k // 8) + ec.TF32_PERM[k % 8]] = logical[k]
    return out


def image_layers(image, in_dim, num_layers, out_dim):
    """``[(hi, lo)]`` of each layer, ``(K, N)`` as the image's blocks hold
    them (K: ``in_dim`` rounded up to 8 for layer 0, else 128; N: 128, or
    ``out_dim`` rounded up to 8 for the last layer), read back block by
    block."""
    d8 = -(-in_dim // 8) * 8
    out_n = -(-out_dim // 8) * 8
    shapes = [(d8 if l == 0 else ec.WIDTH,
               out_n if l == num_layers - 1 else ec.WIDTH)
              for l in range(num_layers)]
    layers = [(image.new_zeros(shape), image.new_zeros(shape))
              for shape in shapes]
    offset = 0
    for layer, k0, rows, c0, cols in ec.tf32_blocks(in_dim, num_layers,
                                                    out_dim):
        for part in layers[layer]:
            part[k0:k0 + rows, c0:c0 + cols] = read_tf32_block(
                image, offset, rows, cols)
            offset += rows * cols
    assert 4 * offset == ec.tf32_image_bytes(in_dim, num_layers, out_dim)
    return layers


def mm3(a, hi, lo):
    """``a @ (hi + lo)`` in 3xTF32: ``a`` split into TF32 parts, the three
    products in fp32, the small ones first (``step_n128``'s order)."""
    k = hi.shape[0]
    if a.shape[1] < k:
        a = torch.nn.functional.pad(a, (0, k - a.shape[1]))
    a_hi = ec.tf32_round(a)
    a_lo = ec.tf32_round(a - a_hi)
    return (a_lo @ hi + a_hi @ lo) + a_hi @ hi


def groups(count):
    """``(first, size)`` of each of the GROUPS groups of ``count`` passes
    (``group_first``, ``group_size``)."""
    base, extra = divmod(count, ec.GROUPS)
    return [(g * base + min(g, extra), base + (g < extra))
            for g in range(ec.GROUPS)]


def merged_stats(outs, count):
    """Mean and unbiased std over ``count`` pass outputs ``outs`` (a list,
    pass order): each group's shifted sums (``stats_fold``), its moments
    (``group_moments``), Chan's merge in group order (``merge_groups``)."""
    moments = []
    for first, size in groups(count):
        if size == 0:
            break
        c = outs[first]
        s1 = torch.zeros_like(c)
        s2 = torch.zeros_like(c)
        for h in outs[first + 1:first + size]:
            d = h - c
            s1 = s1 + d
            s2 = s2 + d * d
        m1 = s1 / size
        moments.append((size, c + m1, s2 - (size * m1) * m1))
    n, mean, m2 = moments[0]
    for nb, mb, m2b in moments[1:]:
        total = n + nb
        delta = mb - mean
        mean = mean + delta * (nb / total)
        m2 = m2 + m2b + delta * delta * (n * nb / total)
        n = total
    return mean, torch.sqrt(torch.clamp(m2, min=0.0) / max(count - 1, 1))


def _layer(h, layers, fw, l):
    hi, lo = layers[l]
    h = mm3(h, hi, lo) + fw.b_all[l, 0, :hi.shape[1]]
    return torch.relu(h) if fw.relus[l] else h


def tf32_mc(mw, x, num_samples, seed, row0=0, seeds=None, rows_per_seed=1):
    """Kernel 2's arithmetic on ``x`` (fp32 ``McWeights``): every sample
    masked (no dropout-free pass), the samples' outputs merged by
    :func:`merged_stats`."""
    layers = image_layers(ec.chain_image(mw.ws, mw.out_dim), mw.in_dim,
                          mw.num_layers, mw.out_dim)
    rows = x.shape[0]
    table = None if seeds is None else torch.as_tensor(seeds,
                                                       dtype=torch.int64)

    def forward(sample):
        h = x
        for l in range(mw.num_layers):
            if mw.thresholds[l] >= 0:
                h = h * mc.dropout_scale(seed, sample, mw.keys[l],
                                         mw.thresholds[l], mw.scales[l],
                                         rows, h.shape[1], x.device, row0,
                                         table, rows_per_seed)
            h = _layer(h, layers, mw, l)
        return h[:, :mw.out_dim]

    return merged_stats([forward(s) for s in range(num_samples)],
                        num_samples)


def tf32_anchored(aw, x, v):
    """Kernel 5's arithmetic on ``x`` (fp32 ``AnchoredWeights``, ``v`` the
    ``(k, 128)`` anchor rows): ``u = x @ W_bot + b0`` once, each anchor's
    ``relu0(u + v_j)`` split into the chain, the anchors' outputs merged by
    :func:`merged_stats`."""
    layers = image_layers(ec.chain_image(aw.ws, aw.out_dim), aw.in_dim,
                          aw.num_layers, aw.out_dim)
    hi, lo = layers[0]
    u = mm3(x, hi, lo) + aw.b_all[0, 0]
    outs = []
    for j in range(v.shape[0]):
        h = u + v[j]
        if aw.relus[0]:
            h = torch.relu(h)
        for l in range(1, aw.num_layers):
            h = _layer(h, layers, aw, l)
        outs.append(h[:, :aw.out_dim])
    return merged_stats(outs, v.shape[0])


def tf32_ensemble(fw, x):
    """Kernel 1's arithmetic on ``x`` (fp32 ``FusedWeights``): member
    ``m``'s chain read back from its image at ``m`` images into
    :func:`~nnueehcs_tpu_torch.ops.fused_eval_chain.cached_image`, its
    products in 3xTF32, bias and ReLU in fp32; the members' outputs folded
    in member order into sums shifted by member 0's (``stats_fold``, the
    leader's ``fold_peers``), then ``stats_write``'s mean ``c + s1 / M``
    and std ``sqrt(max(s2 - (M m1) m1, 0) / max(M - 1, 1))``."""
    image = ec.cached_image(fw)
    size = ec.tf32_image_bytes(fw.in_dim, fw.num_layers, fw.out_dim) // 4
    c = s1 = s2 = None
    for m in range(fw.num_members):
        layers = image_layers(image[m * size:(m + 1) * size], fw.in_dim,
                              fw.num_layers, fw.out_dim)
        h = x
        for l, (hi, lo) in enumerate(layers):
            h = mm3(h, hi, lo) + fw.b_all[l, m, :hi.shape[1]]
            if fw.relus[l]:
                h = torch.relu(h)
        h = h[:, :fw.out_dim]
        if m == 0:
            c, s1, s2 = h, torch.zeros_like(h), torch.zeros_like(h)
        else:
            d = h - c
            s1 = s1 + d
            s2 = s2 + d * d
    n = fw.num_members
    m1 = s1 / n
    var = torch.clamp(s2 - (n * m1) * m1, min=0.0) / max(n - 1, 1)
    return c + m1, torch.sqrt(var)


def tf32_exact(x):
    """Whether every value of ``x`` has its low 13 mantissa bits zero."""
    return not bool((x.contiguous().view(torch.int32) & 0x1FFF).any())


def rel_err(a, b):
    """Largest ``|a - b| / |b|`` over nonzero ``b``."""
    nz = b != 0
    return float(((a - b).abs()[nz] / b.abs()[nz]).max()) if bool(
        nz.any()) else 0.0


TF32_RECONSTRUCTION = math.ldexp(1.0, -21)   # |hi + lo - w| / |w|
