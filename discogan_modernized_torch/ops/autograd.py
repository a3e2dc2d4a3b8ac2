"""Gradients around the kernels, as ``torch.autograd.Function``s: what the
JAX package leaves to ``jax.custom_vjp`` and XLA's autodiff.

Every function takes ``ops``, the table of kernel wrappers
(``KERNEL_OPS``) or of their plain PyTorch versions (``PLAIN_OPS``), so a
run on the card can hold the kernels' path against the plain one. Per
function, forward and backward:

- ``conv`` (k4/s2/p1): K3, or K5f on the ``takes_halo`` route, with an
  optional fused LeakyReLU (the stem) or K3's batch statistics
  (mean, mean_sq). The backward folds the statistics' cotangents into dy
  (dy + g_mean/cnt + 2*y*g_meansq/cnt), then dw through K4 (K5b on the
  halo route) and dx through cuDNN's conv2d_input. A 3-channel input (the
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

The backward passes compute in f32 and hand back each gradient in its
input's dtype. Activation masks are read off the saved outputs: LeakyReLU
and ReLU keep the sign of their input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from .activations import NEGATIVE_SLOPE
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


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str | None) -> torch.Tensor:
    """g through the activation whose output is y (f32 g)."""
    if act in ("leaky", "leaky_relu"):
        return torch.where(y >= 0, g, g * NEGATIVE_SLOPE)
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    return g


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ops, halo, act, with_stats):
        ctx.ops, ctx.halo, ctx.act, ctx.with_stats = ops, halo, act, with_stats
        if with_stats:
            y, (mean, mean_sq) = ops["conv"](x, w, with_stats=True)
            ctx.save_for_backward(x, w, y)
            return y, mean, mean_sq
        y = ops["halo" if halo else "conv"](x, w, act=act)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, gy, g_mean=None, g_mean_sq=None):
        x, w, y = ctx.saved_tensors
        g = _act_grad(gy.float(), y, ctx.act)
        if ctx.with_stats:
            cnt = y.numel() // y.shape[-1]
            g = g + g_mean / cnt + y.float() * (2.0 * g_mean_sq / cnt)
        dy = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = ctx.ops["halo_dw" if ctx.halo else "conv_dw"](x, dy)
        if ctx.needs_input_grad[0]:
            if x.shape[3] <= MAX_CO:  # the stem: a convT to few channels
                dx = ctx.ops["head"](dy, w.transpose(2, 3).contiguous())
            else:
                dx = _nhwc(nn_grad.conv2d_input(
                    _nchw(x).shape, w.permute(3, 2, 0, 1), _nchw(dy),
                    stride=2, padding=1))
        return dx, dw, None, None, None, None


class _BatchStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ops):
        mean, var = ops["stats"](x)
        ctx.save_for_backward(x, mean, var)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, var = ctx.saved_tensors
        cnt = x.numel() // x.shape[-1]
        g_var = torch.where(var > 0, g_var, torch.zeros_like(g_var))
        dx = g_mean / cnt + (x.float() - mean) * (2.0 * g_var / cnt)
        return dx.to(x.dtype), None


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, offset, act, ops):
        y = ops["bn_act"](x, scale, offset, act)
        ctx.act = act
        ctx.save_for_backward(x, scale, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, y = ctx.saved_tensors
        g = _act_grad(gy.float(), y, ctx.act)
        c = x.shape[-1]
        dx = (g * scale).to(x.dtype) if ctx.needs_input_grad[0] else None
        dscale = ((g * x.float()).reshape(-1, c).sum(0)
                  if ctx.needs_input_grad[1] else None)
        doffset = g.reshape(-1, c).sum(0) if ctx.needs_input_grad[2] else None
        return dx, dscale, doffset, None, None


class _HeadConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ops):
        ctx.save_for_backward(x, w)
        return ops["head"](x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        w_t = w.permute(2, 3, 0, 1)  # HWIO -> torch's convT (I,O,kh,kw)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _nhwc(F.conv2d(_nchw(gy), w_t, stride=2, padding=1))
        if ctx.needs_input_grad[1]:
            dw = nn_grad.conv2d_weight(_nchw(gy), tuple(w_t.shape), _nchw(x),
                                       stride=2, padding=1).permute(2, 3, 0, 1)
        return dx, dw, None


def conv(x, w, ops, *, act=None, with_stats=False):
    """k4/s2/p1 conv of NHWC x with HWIO w: y through K5f where
    ``takes_halo`` and K3 elsewhere, or (y, mean, mean_sq) of the raw conv
    through K3 with ``with_stats``. The backward routes dw the same way."""
    halo = takes_halo(x, w) and not with_stats
    return _Conv.apply(x, w, ops, halo, act, with_stats)


def batch_stats_fn(x, ops):
    """Per-channel (mean, biased var) of NHWC x through K1."""
    return _BatchStats.apply(x, ops)


def conv_batch_stats(x, w, ops):
    """The conv of a BatchNorm'd layer and its batch statistics:
    (y, mean, var). K3 takes them from its f32 accumulator; the halo
    route's K5f has none, so K1 reads them off y."""
    if takes_halo(x, w):
        y = conv(x, w, ops)
        return (y, *batch_stats_fn(y, ops))
    y, mean, mean_sq = conv(x, w, ops, with_stats=True)
    return y, mean, torch.clamp_min(mean_sq - mean.square(), 0.0)


def bn_act_fn(x, scale, offset, act, ops):
    """act(x * scale + offset) per channel through K2."""
    return _BnAct.apply(x, scale, offset, act, ops)


def head_fn(x, w, ops):
    """The head convT (k4/s2/p1, <= 8 output channels) through K6."""
    return _HeadConvT.apply(x, w, ops)


def train_bn_act(bn, y, mean, var, act, ops):
    """A train-mode BatchNorm'd layer after its conv: advance ``bn``'s
    running statistics with the batch's (mean, var), then K2 applies
    act(normalize(y)) with gamma and beta in the graph."""
    scale, offset = batchnorm_train(bn, mean, var, y.numel() // y.shape[-1])
    return bn_act_fn(y, scale, offset, act, ops)
