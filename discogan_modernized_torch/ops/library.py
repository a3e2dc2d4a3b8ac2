"""The kernels of the eval forward as registered ops of the ``discogan``
namespace, so that ``torch.export`` records them as ``discogan::`` nodes
and an exported artifact runs the kernels (tools/export_model.py).

A ctypes call on a tensor's ``data_ptr()`` cannot be traced: under
``torch.export`` the wrappers would meet fake tensors, and on the CPU the
trace would take their plain versions and record those instead. Each op
here has three implementations:

- CUDA: the kernel's wrapper, which launches the kernel or raises;
- CPU: the kernel's plain PyTorch version;
- fake: the output's shape and dtype alone (no plan, no device query), so a
  symbolic batch never reaches a plan function: ``conv_plan(n, ...)`` and
  the others run inside the CUDA implementation, at run time.

    discogan::conv2d_k4s2p1        K3, with its scale, offset and act epilogue
    discogan::halo_conv2d_k4s2p1   K5f
    discogan::fused_batchnorm_act  K2: act(x * scale + offset), the BatchNorm
                                   folded into (scale, offset)
    discogan::head_convt_fwd       K6

``act`` is the activation's code (``activations.ACT_CODES``). The ops are
defined with ``torch.library.Library`` and Python implementations, which
the dispatcher calls with less work than ``torch.library.custom_op``'s
wrapper; they are the eval forward's only (no autograd formula is
registered: training keeps the ``autograd.Function``s of ops/autograd.py).
``SERVING_OPS`` is the eval forward's table of them, with the wrappers'
signatures (models/generator.py). Importing this module registers the ops.
"""

from __future__ import annotations

import torch

from .activations import ACT_CODES
from .conv_k4s2p1 import conv2d_k4s2p1, conv2d_k4s2p1_plain
from .fused import bn_act, bn_act_plain
from .halo_conv import halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain
from .head import head_convt, head_convt_plain

NAMESPACE = "discogan"
_ACT_NAMES = {0: None, 1: "relu", 2: "leaky"}

_lib = torch.library.Library(NAMESPACE, "DEF")
_lib.define("conv2d_k4s2p1(Tensor x, Tensor w, Tensor? scale, Tensor? offset, int act)"
            " -> Tensor")
_lib.define("halo_conv2d_k4s2p1(Tensor x, Tensor w, Tensor? scale, Tensor? offset, "
            "int act) -> Tensor")
_lib.define("fused_batchnorm_act(Tensor x, Tensor scale, Tensor offset, int act) -> Tensor")
_lib.define("head_convt_fwd(Tensor x, Tensor w) -> Tensor")


def _conv_impl(fn):
    def impl(x, w, scale, offset, act):
        return fn(x, w.to(x.dtype), scale=scale, offset=offset, act=_ACT_NAMES[act])
    return impl


def _conv_fake(x, w, scale, offset, act):
    return x.new_empty((*x.shape[:-3], x.shape[-3] // 2, x.shape[-2] // 2, w.shape[-1]))


def _bn_act_impl(fn):
    def impl(x, scale, offset, act):
        return fn(x, scale, offset, _ACT_NAMES[act])
    return impl


def _bn_act_fake(x, scale, offset, act):
    return torch.empty_like(x)


def _head_impl(fn):
    def impl(x, w):
        return fn(x, w.to(x.dtype))
    return impl


def _head_fake(x, w):
    return x.new_empty((*x.shape[:-3], 2 * x.shape[-3], 2 * x.shape[-2], w.shape[-1]))


# name -> (kernel wrapper, plain version, fake, how the two are called)
_OPS = {
    "conv2d_k4s2p1": (conv2d_k4s2p1, conv2d_k4s2p1_plain, _conv_fake, _conv_impl),
    "halo_conv2d_k4s2p1": (halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain, _conv_fake,
                           _conv_impl),
    "fused_batchnorm_act": (bn_act, bn_act_plain, _bn_act_fake, _bn_act_impl),
    "head_convt_fwd": (head_convt, head_convt_plain, _head_fake, _head_impl),
}
for _name, (_kernel, _plain, _fake, _impl) in _OPS.items():
    _lib.impl(_name, _impl(_kernel), "CUDA")
    _lib.impl(_name, _impl(_plain), "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_lib)

# The overloads themselves: a call skips the packet's overload resolution.
_conv = torch.ops.discogan.conv2d_k4s2p1.default
_halo = torch.ops.discogan.halo_conv2d_k4s2p1.default
_bn_act = torch.ops.discogan.fused_batchnorm_act.default
_head = torch.ops.discogan.head_convt_fwd.default


def conv_op(x, w, *, scale=None, offset=None, act=None):
    return _conv(x, w, scale, offset, ACT_CODES[act])


def halo_op(x, w, *, scale=None, offset=None, act=None):
    return _halo(x, w, scale, offset, ACT_CODES[act])


def bn_act_op(x, scale, offset, act=None):
    return _bn_act(x, scale, offset, ACT_CODES[act])


def head_op(x, w):
    return _head(x, w)


# The eval forward's table (the keys of ops/autograd.py's KERNEL_OPS).
SERVING_OPS = {"conv": conv_op, "halo": halo_op, "bn_act": bn_act_op, "head": head_op}
OP_NAMES = tuple(_OPS)
