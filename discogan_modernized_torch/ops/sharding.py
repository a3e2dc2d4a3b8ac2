"""The mesh's collectives inside the train forwards, and the layers that
run on a shard (the port of the JAX package's ``ops/sharding.py``; there
XLA's partitioner inserts the collectives, parallel/gspmd.py:1-15).

The kernels take local tensors, so every collective is explicit: each is
an ``autograd.Function`` whose backward is the collective of the
cotangents, and each issues its collectives through parallel/dp.py, which
counts them. A forward under a mesh carries the parallel.gspmd
``MeshParallel`` in its ops table (key ``"mesh"``; ops/autograd.py
``train_ops``), so a rematerialized region rebuilds with the same
collectives. Two modes, over the mesh's model axis of tp ranks:

- tensor parallelism ("gspmd"): a sharded layer's weight holds this rank's
  slice of its output channels (parallel/gspmd.py ``shard_spec``). Its
  input is whole on every model rank; ``_SumGrads`` passes it on and sums
  the model ranks' partial input gradients in the backward (Megatron's f).
  K3 (or the convT, or the dec0 product) gives the local channels and K3's
  or K1's statistics, taken over the data axis; K2 applies the BatchNorm
  with the local slice of the replicated gamma and beta; then the channels
  are gathered over the model axis for the next layer (``_Gather``, whose
  backward keeps this rank's channels of the cotangent: Megatron's g). The
  running statistics advance with the gathered statistics, so they stay
  whole and equal on every rank. K2 runs before the gather, on the local
  channels, so that only the layer's output is gathered.
- spatial ("spatial"): every rank holds the weights whole and a band of
  the rows of every map that splits. A k4/s2/p1 conv on a band of h rows
  (global rows a..a+h-1) gets two rows a side (``halo``): a zero row, then
  its neighbour's edge row (zeros at the image's edge), so the kernel sees
  h + 4 rows with its own one-row pad. Local output row o reads local input
  rows 2o-1..2o+2, global a+2o-3..a+2o; global output a/2+k needs global
  a+2k-1..a+2k+2, so o = k + 1: rows 1..h/2 are the band's output, and
  rows 0 and h/2+1 (which read the zero rows) are dropped, their
  cotangents zero for K4/K5b. The statistics are K1's over the kept rows,
  not K3's (which would count the dropped ones), over every rank of the
  mesh. A convT (the decoder's, and K6's head) of a band of h rows gets one
  neighbour row a side; its output rows 2..2h+1 are the band's. A map whose
  rows do not split (the 4x4 map into the latent, the discriminator's head,
  a band of odd height) is gathered and its layer runs whole on every rank;
  a whole map that splits again (dec0's 4x4) is cut back into bands
  (``_Slice``, whose backward gathers the bands' cotangents). The maps are
  square, so a band is a map shorter than it is wide.

Every tensor that is whole on the model axis holds equal values on every
model rank, and its cotangent is whole and equal on every model rank too:
the collectives above keep that, so a layer that runs whole needs nothing.
Over a model axis of one rank both modes are the plain layers with the
statistics over the data axis.
"""

from __future__ import annotations

import torch

from ..parallel.dp import all_gather, all_reduce_sum
from .autograd import (_rows, batch_stats_fn, bn_act_fn, conv, conv_batch_stats,
                       conv_transpose_fn, head_fn, mm_fn, train_bn_act)
from .batchnorm import advance_running_stats, fold_bn
from . import recompute


class _Gather(torch.autograd.Function):
    """The model ranks' pieces concatenated along ``dim``; the backward
    keeps this rank's piece of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, index, dim):
        dim %= x.dim()
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return torch.cat(all_gather(x, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None, None


class _Slice(torch.autograd.Function):
    """Piece ``index`` of ``parts`` along ``dim``; the backward gathers the
    pieces' cotangents."""

    @staticmethod
    def forward(ctx, x, group, index, parts, dim):
        dim %= x.dim()
        size = x.shape[dim] // parts
        ctx.group, ctx.dim = group, dim
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.group).unbind(0), ctx.dim), None, None, None, None


class _SumGrads(torch.autograd.Function):
    """x as it is; the backward sums the cotangents over ``group``, in f32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(g.to(torch.float32, copy=True).contiguous(), ctx.group)
        return total.to(g.dtype), None


class _Halo(torch.autograd.Function):
    """A band with its neighbours' edge rows: ``pad`` zero rows, the row
    above (the upper neighbour's last; zeros on the first band), the band,
    the row below (the lower neighbour's first; zeros on the last band),
    ``pad`` zero rows. One all-gather of every band's two edge rows over the
    model axis brings them; the backward gathers the halo rows' cotangents
    the same way and adds each to the row it came from, in f32."""

    @staticmethod
    def forward(ctx, x, mesh, pad):
        hd = x.dim() - 3
        m, tp = mesh.m, mesh.n_model
        ctx.mesh, ctx.pad, ctx.h = mesh, pad, x.shape[hd]
        edges = all_gather(torch.cat([x.narrow(hd, 0, 1), x.narrow(hd, ctx.h - 1, 1)], hd),
                           mesh.model_group)
        zero = torch.zeros_like(x.narrow(hd, 0, 1))
        above = edges[m - 1].narrow(hd, 1, 1) if m > 0 else zero
        below = edges[m + 1].narrow(hd, 0, 1) if m < tp - 1 else zero
        return torch.cat([zero] * pad + [above, x, below] + [zero] * pad, hd)

    @staticmethod
    def backward(ctx, g):
        hd = g.dim() - 3
        mesh, pad, h = ctx.mesh, ctx.pad, ctx.h
        m, tp = mesh.m, mesh.n_model
        band = g.narrow(hd, pad + 1, h).to(torch.float32, copy=True)
        sent = all_gather(torch.cat([g.narrow(hd, pad, 1), g.narrow(hd, pad + 1 + h, 1)], hd),
                          mesh.model_group)
        if m > 0:  # the upper neighbour's row below is this band's first
            band.narrow(hd, 0, 1).add_(sent[m - 1].narrow(hd, 1, 1).float())
        if m < tp - 1:  # the lower neighbour's row above is this band's last
            band.narrow(hd, h - 1, 1).add_(sent[m + 1].narrow(hd, 0, 1).float())
        return band.to(g.dtype), None, None


def mesh_of(ops):
    """The forward's parallel.gspmd.MeshParallel, or None."""
    return ops.get("mesh")


def mesh_from(stats_dp):
    """``stats_dp`` where it is a mesh's (parallel.gspmd.MeshParallel), else
    None (none, or a parallel.DataParallel)."""
    return stats_dp if getattr(stats_dp, "mesh", None) is not None else None


def _spatial(mp) -> bool:
    return mp is not None and mp.spatial and mp.tp > 1


def _tensor(mp) -> bool:
    return mp is not None and not mp.spatial and mp.tp > 1


def banded(x: torch.Tensor) -> bool:
    """Whether NHWC x is a band of rows of a square map."""
    return x.shape[-3] != x.shape[-2]


def splits(rows: int, tp: int) -> bool:
    """Spatial mode: whether a whole map of ``rows`` rows is cut into bands
    over ``tp`` model ranks. The one rule of which layers run on bands,
    which parallel/gspmd.py ``banded_layers`` reads too: a k4/s2/p1 conv
    runs on bands where its output map splits (its input's band then has
    an even count of rows), a convT where its input map does."""
    return tp > 1 and rows % tp == 0


def to_band(x: torch.Tensor, mp) -> torch.Tensor:
    """Spatial mode: this rank's band of a whole map whose rows split over
    the model axis; else x."""
    if not _spatial(mp) or banded(x) or not splits(x.shape[-3], mp.tp):
        return x
    return _Slice.apply(x, mp.mesh.model_group, mp.mesh.m, mp.tp, -3)


def whole(x: torch.Tensor, mp) -> torch.Tensor:
    """Spatial mode: the whole map of a band, its rows gathered; else x."""
    if not _spatial(mp) or not banded(x):
        return x
    return _Gather.apply(x, mp.mesh.model_group, mp.mesh.m, -3)


def halo(x: torch.Tensor, mp, pad: int) -> torch.Tensor:
    return _Halo.apply(x, mp.mesh, pad)


def _features(bn) -> int:
    return (bn[0] if isinstance(bn, (tuple, list)) else bn).num_features


def _tp_bn_act(bn, y, mean, var, act, ops, mp):
    """Tensor parallelism after a sharded layer: y holds this rank's
    channels, (mean, var) their statistics over the data axis. The running
    statistics advance with the model ranks' statistics gathered; K2
    normalizes with this rank's slice of gamma and beta; the channels are
    gathered for the next layer."""
    mesh = mp.mesh
    c = y.shape[-1]
    sl = slice(mesh.m * c, (mesh.m + 1) * c)
    count = _rows(y) * mp.world
    members = list(bn) if isinstance(bn, (tuple, list)) else [bn]
    paired = isinstance(bn, (tuple, list))
    if recompute.recomputing():
        stats = None
    else:
        stats = torch.cat(all_gather(torch.stack([mean, var]).detach(),
                                     mesh.model_group).unbind(0), -1)
    folded = []
    for p, module in enumerate(members):
        mp_, vp = (mean[p], var[p]) if paired else (mean, var)
        if stats is None:
            advance_running_stats(module, mp_, vp, count)  # checks the count only
        else:
            advance_running_stats(module, *(stats[:, p] if paired else stats), count)
        folded.append(fold_bn(module.weight[sl], module.bias[sl], mp_, vp, module.eps))
    if paired:
        scale, offset = (torch.stack([f[i] for f in folded]) for i in range(2))
    else:
        scale, offset = folded[0]
    y = bn_act_fn(y, scale, offset, act, ops)
    return _Gather.apply(y, mesh.model_group, mesh.m, -1)


def conv_layer(h, w, bn, act, ops):
    """A k4/s2/p1 conv of an encoder or discriminator trunk: with ``bn``, its
    BatchNorm on the batch statistics and ``act`` (K3 with its statistics,
    or K5f then K1; then K2); without, ``act`` in the conv's epilogue (the
    stem). Under a mesh: on this rank's channels (a sharded weight) or on
    its band, as the module docstring says."""
    mp = mesh_of(ops)
    if _spatial(mp) and banded(h):
        if splits(h.shape[-3] * mp.tp // 2, mp.tp):
            return _band_conv(h, w, bn, act, ops, mp)
        h = whole(h, mp)
    if bn is None:
        return conv(h, w, ops, act=act)
    if _tensor(mp) and w.shape[-1] < _features(bn):
        x = _SumGrads.apply(h, mp.mesh.model_group)
        return _tp_bn_act(bn, *conv_batch_stats(x, w, ops), act, ops, mp)
    return train_bn_act(bn, *conv_batch_stats(h, w, ops), act, ops)


def _band_conv(h, w, bn, act, ops, mp):
    """The conv of a band of h rows: the band with two rows a side, its
    output rows 1..h/2 kept; the statistics K1's over them and every rank."""
    y = conv(halo(h, mp, 1), w, ops, act=act if bn is None else None)
    y = y.narrow(-3, 1, h.shape[-3] // 2).contiguous()
    if bn is None:
        return y
    ops = dict(ops, stats_dp=mp.all)
    return train_bn_act(bn, y, *batch_stats_fn(y, ops), act, ops)


def convt_layer(h, w, bn, act, ops):
    """A k4/s2/p1 convT of the decoder (cuDNN), then K1 and K2. Under a
    mesh: on this rank's channels or band."""
    mp = mesh_of(ops)
    if _spatial(mp) and banded(h):
        y = conv_transpose_fn(halo(h, mp, 0), w).narrow(-3, 2, 2 * h.shape[-3]).contiguous()
        ops = dict(ops, stats_dp=mp.all)
        return train_bn_act(bn, y, *batch_stats_fn(y, ops), act, ops)
    if _tensor(mp) and w.shape[-3] < _features(bn):
        y = conv_transpose_fn(_SumGrads.apply(h, mp.mesh.model_group), w)
        return _tp_bn_act(bn, y, *batch_stats_fn(y, ops), act, ops, mp)
    y = conv_transpose_fn(h, w)
    return to_band(train_bn_act(bn, y, *batch_stats_fn(y, ops), act, ops), mp)


def dec0_layer(z, w, bn, ops):
    """The latent (…,1,1,100) to the 4x4 map: one product, K1, K2 (ReLU).
    Under tensor parallelism ``w`` holds this rank's channel columns (of
    each of the 16 positions); under spatial the map is cut into bands."""
    mp = mesh_of(ops)
    lead = z.shape[:-3]
    sharded = _tensor(mp) and w.shape[-1] < 16 * _features(bn)
    if sharded:
        z = _SumGrads.apply(z, mp.mesh.model_group)
    y = mm_fn(z.reshape(*lead, -1), w).reshape(*lead, 4, 4, -1)
    if sharded:
        return _tp_bn_act(bn, y, *batch_stats_fn(y, ops), "relu", ops, mp)
    return to_band(train_bn_act(bn, y, *batch_stats_fn(y, ops), "relu", ops), mp)


def head_layer(h, w, ops):
    """The generator's head convT to 3 channels through K6 (before the
    sigmoid); on a band: one row a side, output rows 2..2h+1 kept."""
    mp = mesh_of(ops)
    if _spatial(mp) and banded(h):
        return head_fn(halo(h, mp, 0), w, ops).narrow(-3, 2, 2 * h.shape[-3])
    return to_band(head_fn(h, w, ops), mp)
