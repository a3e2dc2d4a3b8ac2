"""Gradients around the kernels, as ``torch.autograd.Function``s: what the
JAX package leaves to ``jax.custom_vjp`` and XLA's autodiff.

Every function takes ``ops``, the table of kernel wrappers
(``KERNEL_OPS``) or of their plain PyTorch versions (``PLAIN_OPS``), so a
run on the card can hold the kernels' path against the plain one. Under
data parallelism with cross-rank BatchNorm the table also holds
``"stats_dp"``, the parallel.DataParallel whose ranks' global batch the
statistics are taken over (``train_ops``), and on a mesh ``"mesh"``
(ops/sharding.py's layers): a rematerialized region closes over the
table, so its rebuild in the backward takes the same statistics and the
same collectives as its first forward. Per function, forward and
backward:

- ``conv`` (k4/s2/p1): K3, or K5f on the ``takes_halo`` route, with an
  optional fused LeakyReLU (the stem) or the batch statistics: K3's
  (mean, mean_sq) from its accumulator, or on the halo route K1's
  (mean, var) of K5f's y. The backward folds the statistics' cotangents
  into dy in f32 (dy + g_mean/cnt + 2*y*g_meansq/cnt; on the halo route
  ``batch_stats``' gradient below) and casts the sum once, then dw
  through K4 (K5b on the halo route) and dx through cuDNN's
  conv2d_input. On the halo route K2's function hands its input gradient
  to the conv's backward in f32 (``_Link``), so the whole BatchNorm
  gradient of y is summed in f32 before that cast. A 3-channel input (the
  stem) takes its dx through K6 instead: dx of conv(x, w) is the k4/s2/p1
  convT of dy with w's I/O swapped, a convT to 3 channels (the JAX
  package's ``ops/conv.py:160-166`` routes it through its subpixel form for
  the same reason).
- ``batch_stats`` (K1): (mean, var) with var = max(E[x^2] - E[x]^2, 0). The
  backward is g_mean/cnt + g_var*2*(x - mean)/cnt where var > 0, and no var
  term where the clamp at 0 held.
- ``bn_act`` (K2): act(x*scale + offset); plain backward for x, scale and
  offset. scale/offset come from gamma, beta and the batch statistics in
  the graph, so gamma and beta get their gradients there.
- ``head`` (K6): the convT to <= 8 channels; backward through cuDNN
  (conv2d for dx, conv2d_weight with the roles of input and output
  swapped for dw).

- ``conv_transpose_fn`` and ``mm_fn``: the decoder's wide convTs through
  cuDNN and the latent products, with the backward autograd would record
  for them (``convolution_backward``; MmBackward's two products), written
  out so that a rematerialized region can hand back their outputs.

The backward passes compute in f32 and hand back each gradient in its
input's dtype. Activation masks are read off the saved outputs: LeakyReLU
and ReLU keep the sign of their input. The BatchNorm and activation terms
of the backward run in the span ``bn_backward`` (core/trace.py): ``conv``'s
up to its dy, without its dw and dx, and the whole of ``batch_stats``'
and ``bn_act``'s. The halo route's forward (K5f, K1) and backward (the
sum, K5b, dx) run in the span ``halo``.

Every function takes a leading pair axis (ops/pairs.py): activations
(P,N,H,W,C), weights per pair or shared, statistics, scale and offset
(P,C). The kernels take the pair whole, one launch for both; cuDNN's input
gradients and convTs and the latent products run one call a pair, and the
backward's per-channel sums run a pair at a time, so each pair's bits are
those of a single call. Under a rematerialized region's "conv" policy the
convolutions hand back the outputs their first forward recorded
(ops/recompute.py) instead of computing them again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from ..core import trace
from . import recompute
from .activations import NEGATIVE_SLOPE
from .pairs import member
from .batchnorm import batchnorm_train
from .conv_k4s2p1 import (conv2d_k4s2p1, conv2d_k4s2p1_dw,
                          conv2d_k4s2p1_dw_plain, conv2d_k4s2p1_plain)
from .fused import batch_stats, batch_stats_plain, bn_act, bn_act_plain
from .halo_conv import (halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_dw,
                        halo_conv2d_k4s2p1_dw_plain, halo_conv2d_k4s2p1_plain,
                        takes_halo)
from .head import MAX_CO, head_convt, head_convt_plain

# The kernels' wrappers, and their plain versions for comparison runs.
KERNEL_OPS = {"conv": conv2d_k4s2p1, "halo": halo_conv2d_k4s2p1,
              "bn_act": bn_act, "head": head_convt, "stats": batch_stats,
              "conv_dw": conv2d_k4s2p1_dw, "halo_dw": halo_conv2d_k4s2p1_dw}
PLAIN_OPS = {"conv": conv2d_k4s2p1_plain, "halo": halo_conv2d_k4s2p1_plain,
             "bn_act": bn_act_plain, "head": head_convt_plain,
             "stats": batch_stats_plain, "conv_dw": conv2d_k4s2p1_dw_plain,
             "halo_dw": halo_conv2d_k4s2p1_dw_plain}


def train_ops(plain: bool = False, stats_dp=None) -> dict:
    """The table a train forward takes: the kernels' wrappers (their plain
    versions with ``plain``), and with ``stats_dp`` (a
    parallel.DataParallel) the ranks whose global batch the BatchNorm
    statistics span; where that is a mesh's (parallel.gspmd.MeshParallel),
    under ``"mesh"`` too (ops/sharding.py)."""
    ops = PLAIN_OPS if plain else KERNEL_OPS
    if stats_dp is None:
        return ops
    ops = dict(ops, stats_dp=stats_dp)
    if getattr(stats_dp, "mesh", None) is not None:
        ops["mesh"] = stats_dp
    return ops


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _per_pair(fn, x, *operands):
    """fn on each pair's NHWC operands, stacked, where NHWC x has a pair
    axis (a 4-D weight is shared); else fn on the operands."""
    if x.dim() != 5:
        return fn(x, *operands)
    return torch.stack([fn(xp, *(member(t, p, 4) for t in operands))
                        for p, xp in enumerate(x)])


def _rows(t: torch.Tensor) -> int:
    """Values of a channel in one pair's NHWC t."""
    return t[0].numel() // t.shape[-1] if t.dim() == 5 else t.numel() // t.shape[-1]


def _per_channel(v, like):
    """(P,C) per-pair channel values laid over NHWC ``like`` (P,N,H,W,C);
    (C,) ones as they are."""
    return v.reshape(v.shape[0], 1, 1, 1, -1) if like.dim() == 5 and v.dim() == 2 else v


def _channel_sums(t, like):
    """Per-channel sums of t over its rows, a pair at a time where NHWC
    ``like`` has a pair axis."""
    c = t.shape[-1]
    if like.dim() != 5:
        return t.reshape(-1, c).sum(0)
    return torch.stack([tp.reshape(-1, c).sum(0) for tp in t])


def _conv_dx(x, w, dy):
    return _nhwc(nn_grad.conv2d_input(_nchw(x).shape, w.permute(3, 2, 0, 1), _nchw(dy),
                                      stride=2, padding=1))


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str | None) -> torch.Tensor:
    """g through the activation whose output is y (f32 g)."""
    if act in ("leaky", "leaky_relu"):
        return torch.where(y >= 0, g, g * NEGATIVE_SLOPE)
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    return g


def _stats_grad(x, mean, var, g_mean, g_var) -> torch.Tensor:
    """The f32 gradient of K1's (mean, var) of x: g_mean/cnt +
    g_var*2*(x - mean)/cnt, with no var term where the clamp at 0 held."""
    cnt = _rows(x)
    g_var = torch.where(var > 0, g_var, torch.zeros_like(g_var))
    return (_per_channel(g_mean, x) / cnt
            + (x.float() - _per_channel(mean, x)) * (2.0 * _per_channel(g_var, x) / cnt))


class _Link:
    """y's gradient through K2 in f32, handed from ``_BnAct``'s backward to
    that of the halo conv that made y (``conv_batch_stats``). y's two
    gradients, through K2 and through its statistics, nearly cancel (the
    BatchNorm gradient sums to 0 over a channel): a part rounded to the
    compute dtype before the sum leaves its rounding error in dy, with a
    per-channel sum that the weight gradient multiplies by the input's
    mean. Summed in f32, only the one cast of the sum rounds."""

    __slots__ = ("grad",)

    def __init__(self):
        self.grad = None


_LINK = "_discogan_bn_act_link"  # the attribute of a halo conv's y holding its _Link


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ops, halo, act, with_stats, link=None):
        """``link`` (a ``_Link``) with ``halo`` and ``with_stats``: y, then K1's
        (mean, var) of it."""
        ctx.ops, ctx.halo, ctx.act, ctx.with_stats = ops, halo, act, with_stats
        ctx.link = link
        if link is not None:  # K2's part of y's gradient comes through the link
            ctx.set_materialize_grads(False)
        with trace.span("halo") if halo else trace.NULL:
            out = recompute.replay()
            if out is None:
                if with_stats and not halo:
                    y, (mean, mean_sq) = ops["conv"](x, w, with_stats=True)
                    out = (y, mean, mean_sq)
                else:
                    out = ops["halo" if halo else "conv"](x, w, act=act)
                recompute.record(out)
            if with_stats and halo:  # K1 of K5f's y: rebuilt, as any statistics
                out = (out, *ops["stats"](out))
        y = out[0] if with_stats else out
        ctx.save_for_backward(x, w, y, *(out[1:] if with_stats and halo else ()))
        return out

    @staticmethod
    def backward(ctx, gy, g_mean=None, g_stat=None):
        with trace.span("halo") if ctx.halo else trace.NULL:
            return _Conv._backward(ctx, gy, g_mean, g_stat)

    @staticmethod
    def _backward(ctx, gy, g_mean, g_stat):
        x, w, y, *stats = ctx.saved_tensors
        with trace.span("bn_backward"):
            if ctx.link is not None:  # the halo route's statistics; g_stat: var's gradient
                g = _linked_grad(ctx.link, gy, y, stats, g_mean, g_stat)
            else:
                g = _act_grad(gy.float(), y, ctx.act)
                if ctx.with_stats:  # K3's; g_stat: mean_sq's gradient
                    cnt = _rows(y)
                    g = (g + _per_channel(g_mean, y) / cnt
                         + y.float() * (2.0 * _per_channel(g_stat, y) / cnt))
            dy = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = ctx.ops["halo_dw" if ctx.halo else "conv_dw"](x, dy)
        if ctx.needs_input_grad[0]:
            if x.shape[-1] <= MAX_CO:  # the stem: a convT to few channels
                dx = ctx.ops["head"](dy, w.transpose(-2, -1).contiguous())
            else:
                dx = _per_pair(lambda xp, wp, dp: _conv_dx(xp, wp, dp), x, w, dy)
        return dx, dw, None, None, None, None, None


def _linked_grad(link, gy, y, stats, g_mean, g_var) -> torch.Tensor:
    """The halo conv's y gradient in f32: K2's part (the link's), then its
    statistics' (K1's mean and var), then any other consumer's (gy)."""
    zeros = torch.zeros_like(stats[0])
    g = _stats_grad(y, *stats, zeros if g_mean is None else g_mean,
                    zeros if g_var is None else g_var)
    if link.grad is not None:
        g, link.grad = link.grad + g, None
    return g if gy is None else g + gy.float()


class _BatchStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ops):
        mean, var = ops["stats"](x)
        ctx.save_for_backward(x, mean, var)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, var = ctx.saved_tensors
        with trace.span("bn_backward"):
            return _stats_grad(x, mean, var, g_mean, g_var).to(x.dtype), None


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, offset, act, ops, link):
        y = ops["bn_act"](x, scale, offset, act)
        ctx.act, ctx.link = act, link
        ctx.save_for_backward(x, scale, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, y = ctx.saved_tensors
        with trace.span("bn_backward"):
            g = _act_grad(gy.float(), y, ctx.act)
            dx = None
            if ctx.needs_input_grad[0]:
                dx = g * _per_channel(scale, x)
                if ctx.link is not None:  # to the halo conv's backward, in f32
                    ctx.link.grad, dx = dx, None
                else:
                    dx = dx.to(x.dtype)
            dscale = _channel_sums(g * x.float(), x) if ctx.needs_input_grad[1] else None
            doffset = _channel_sums(g, x) if ctx.needs_input_grad[2] else None
            return dx, dscale, doffset, None, None, None


class _HeadConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ops):
        ctx.save_for_backward(x, w)
        out = recompute.replay()
        return recompute.record(ops["head"](x, w)) if out is None else out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _per_pair(lambda gp, wp: _nhwc(F.conv2d(_nchw(gp), wp.permute(2, 3, 0, 1),
                                                         stride=2, padding=1)), gy, w)
        if ctx.needs_input_grad[1]:
            dw = _per_pair(lambda gp, xp: nn_grad.conv2d_weight(
                _nchw(gp), tuple(w.shape[-4:][i] for i in (2, 3, 0, 1)), _nchw(xp),
                stride=2, padding=1).permute(2, 3, 0, 1), gy, x)
        return dx, dw, None


def _conv_transpose(x, w):
    """F.conv_transpose2d (k4, s2, p1) of NHWC x with a torch-layout
    (I,O,4,4) weight; NHWC out, as ops/conv.py's ``conv_transpose2d``."""
    return F.conv_transpose2d(_nchw(x), w, stride=2, padding=1).permute(0, 2, 3, 1).contiguous()


class _ConvT(torch.autograd.Function):
    """The decoder's k4/s2/p1 convT through cuDNN, with the backward
    autograd records for F.conv_transpose2d: ``convolution_backward`` of
    the transposed convolution, on the same views."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = recompute.replay()
        if out is None:
            out = recompute.record(_per_pair(_conv_transpose, x, w))
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]

        def grads(xp, wp, gp):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                _nchw(gp), _nchw(xp), wp, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
                mask)
            return gx.permute(0, 2, 3, 1) if mask[0] else None, gw

        if x.dim() != 5:
            return grads(x, w, gy)
        per = [grads(x[p], member(w, p, 4), gy[p]) for p in range(x.shape[0])]
        return tuple(None if per[0][i] is None else torch.stack([g[i] for g in per])
                     for i in range(2))


def _mm_grads(g, a, b, need_a: bool, need_b: bool):
    """MmBackward's products for a @ b: the branches autograd takes for
    a column-major operand, else g @ b.T and a.T @ g."""
    ga = gb = None
    if need_a:
        col = a.stride(0) == 1 and a.stride(1) == a.shape[0]
        ga = b.mm(g.t()).t() if col else g.mm(b.t())
    if need_b:
        col = b.stride(0) == 1 and b.stride(1) == b.shape[0]
        gb = g.t().mm(a).t() if col else a.t().mm(g)
    return ga, gb


class _Mm(torch.autograd.Function):
    """a @ b of the latent products (ops/conv.py), with MmBackward's
    backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = recompute.replay()
        if out is None:
            out = recompute.record(a.mm(b) if a.dim() == 2 else torch.stack(
                [ap.mm(member(b, p, 2)) for p, ap in enumerate(a)]))
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        if a.dim() == 2:
            return _mm_grads(g, a, b, *need)
        per = [_mm_grads(g[p], a[p], member(b, p, 2), *need) for p in range(a.shape[0])]
        return tuple(None if per[0][i] is None else torch.stack([q[i] for q in per])
                     for i in range(2))


def conv(x, w, ops, *, act=None, with_stats=False):
    """k4/s2/p1 conv of NHWC x with HWIO w: y through K5f where
    ``takes_halo`` and K3 elsewhere, or (y, mean, mean_sq) of the raw conv
    through K3 with ``with_stats``. The backward routes dw the same way."""
    halo = takes_halo(x, w) and not with_stats
    return _Conv.apply(x, w, ops, halo, act, with_stats)


def _global_stats(mean, var, ops):
    """One rank's K1 (mean, var), or with ``ops["stats_dp"]`` the global
    batch's: the ranks' mean of the means, and of each rank's variance
    plus its mean's squared distance from the global one (equal counts a
    rank). Over one rank the second term is exactly 0 and the statistics
    are K1's bits."""
    dp = ops.get("stats_dp")
    if dp is not None:
        mean_all = dp.rank_mean(mean)
        var = dp.rank_mean(var + (mean - mean_all).square())
        mean = mean_all
    return mean, var


def batch_stats_fn(x, ops):
    """Per-channel (mean, biased var) of NHWC x through K1; with
    ``ops["stats_dp"]``, the global batch's (``_global_stats``)."""
    return _global_stats(*_BatchStats.apply(x, ops), ops)


def conv_batch_stats(x, w, ops):
    """The conv of a BatchNorm'd layer and its batch statistics:
    (y, mean, var). K3 takes them from its f32 accumulator (mean and mean
    of squares; with ``ops["stats_dp"]``, the ranks' means of both);
    the halo route's K5f has none, so K1 reads them off y inside the
    conv's function, whose backward adds their gradient to y's in f32;
    y carries the ``_Link`` that K2's function (``bn_act_fn``) hands its
    own gradient of y through, in f32."""
    if takes_halo(x, w):
        link = _Link()
        y, mean, var = _Conv.apply(x, w, ops, True, None, True, link)
        setattr(y, _LINK, link)
        return (y, *_global_stats(mean, var, ops))
    y, mean, mean_sq = conv(x, w, ops, with_stats=True)
    dp = ops.get("stats_dp")
    if dp is not None:
        mean, mean_sq = dp.rank_mean(torch.stack([mean, mean_sq])).unbind(0)
    return y, mean, torch.clamp_min(mean_sq - mean.square(), 0.0)


def bn_act_fn(x, scale, offset, act, ops):
    """act(x * scale + offset) per channel through K2. Where x is a halo
    conv's y (``conv_batch_stats``), the backward hands x's gradient to
    that conv's in f32 (``_Link``) instead of to autograd."""
    return _BnAct.apply(x, scale, offset, act, ops, getattr(x, _LINK, None))


def head_fn(x, w, ops):
    """The head convT (k4/s2/p1, <= 8 output channels) through K6."""
    return _HeadConvT.apply(x, w, ops)


def conv_transpose_fn(x, w):
    """The decoder's k4/s2/p1 convT of NHWC x with a torch-layout weight."""
    return _ConvT.apply(x, w)


def mm_fn(a, b):
    """a @ b, (N,K) x (K,O), or per pair (P,N,K) x (P,K,O)."""
    return _Mm.apply(a, b)


def train_bn_act(bn, y, mean, var, act, ops):
    """A train-mode BatchNorm'd layer after its conv: advance ``bn``'s
    running statistics with the batch's (mean, var), then K2 applies
    act(normalize(y)) with gamma and beta in the graph. With a pair axis,
    ``bn`` holds one module a pair (the same one twice where both halves
    are one network's, which then takes the first half's update, then the
    second's). With ``ops["stats_dp"]`` the count is the global batch's."""
    dp = ops.get("stats_dp")
    count = _rows(y) * (dp.world if dp is not None else 1)
    if isinstance(bn, (tuple, list)):
        folded = [batchnorm_train(m, mean[p], var[p], count) for p, m in enumerate(bn)]
        scale, offset = (torch.stack([f[i] for f in folded]) for i in range(2))
    else:
        scale, offset = batchnorm_train(bn, mean, var, count)
    return bn_act_fn(y, scale, offset, act, ops)
