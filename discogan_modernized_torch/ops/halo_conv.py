"""The k4/s2/p1 conv tiled over bands of output rows with 1-row halos
(kernel K5f, csrc/halo_conv_k4s2p1.cu) and its weight gradient (kernel
K5b, csrc/halo_conv_k4s2p1_dw.cu), the port of the JAX package's
``halo_conv2d_k4s2p1`` and ``halo_conv2d_k4s2p1_dw``: the same functions as
``conv2d_k4s2p1`` and ``conv2d_k4s2p1_dw``, for the wide-map, few-channel
layer. The backward routes by the same rule as the forward.

Preconditions (the JAX docstring's, asserted here): even H and W, CI and CO
multiples of 8, 2*CI <= 256; the kernel's band holds at most 256 output
pixels of a row, so W/2 <= 256. ``takes_halo`` is the shape rule that
sends a layer here instead of to K3: an input at least 128 pixels wide
with at most 64 channels (at 512px that is enc1 alone; enc2's 128px input
has 128 channels, where K3's contraction per tap is already deep).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import act_code
from .conv_k4s2p1 import (affine_pointers, check_conv_args, check_dw_args,
                          launch_dw)
from .conv_k4s2p1 import conv2d_k4s2p1_dw_plain as halo_conv2d_k4s2p1_dw_plain
from .conv_k4s2p1 import conv2d_k4s2p1_plain as halo_conv2d_k4s2p1_plain

MAX_BAND_WIDTH = 256  # output pixels per row a band can hold
MIN_WIDTH = 128       # input width from which the route takes this kernel
MAX_ROUTED_CI = 64

__all__ = ["halo_conv2d_k4s2p1", "halo_conv2d_k4s2p1_plain",
           "halo_conv2d_k4s2p1_dw", "halo_conv2d_k4s2p1_dw_plain", "takes_halo"]


def _check_preconditions(x, w):
    """w: the (4,4,CI,CO) weight, or dy (N,Ho,Wo,CO) of the backward."""
    ci, co = x.shape[3], w.shape[3]
    if ci % 8 or co % 8 or 2 * ci > 256:
        raise ValueError(f"halo_conv2d_k4s2p1: CI={ci}, CO={co} must be "
                         "multiples of 8 with 2*CI <= 256")
    if x.shape[2] // 2 > MAX_BAND_WIDTH:
        raise ValueError(f"halo_conv2d_k4s2p1: output width {x.shape[2] // 2} "
                         f"> {MAX_BAND_WIDTH}")


def takes_halo(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the generator routes this k4/s2/p1 conv to K5f."""
    h, wd, ci = x.shape[1:]
    co = w.shape[3]
    return (min(h, wd) >= MIN_WIDTH and wd // 2 <= MAX_BAND_WIDTH
            and ci <= MAX_ROUTED_CI and ci % 8 == 0 and co % 8 == 0)


def halo_conv2d_k4s2p1(x, w, *, scale=None, offset=None, act=None):
    """y = act(conv(x, w, k=4, s=2, p=1) * scale + offset), NHWC/HWIO."""
    check_conv_args("halo_conv2d_k4s2p1", x, w, scale, offset)
    _check_preconditions(x, w)
    code = act_code(act)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return halo_conv2d_k4s2p1_plain(x, w, scale=scale, offset=offset,
                                        act=act)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    _build.check_cuda_tensor("halo_conv2d_k4s2p1 x", x)
    _build.check_cuda_tensor("halo_conv2d_k4s2p1 w", w, dtype=x.dtype)
    sp, op = affine_pointers("halo_conv2d_k4s2p1", scale, offset, co)
    y = torch.empty(n, h // 2, wd // 2, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.launch("halo_conv_k4s2p1", lib.discogan_halo_conv_k4s2p1,
                  x.data_ptr(), w.data_ptr(), sp, op, y.data_ptr(), n, h, wd,
                  ci, co, code, _build.DTYPE_CODES[x.dtype],
                  _build.stream_of(x))
    return y


def halo_conv2d_k4s2p1_dw(x, dy):
    """Weight gradient of ``halo_conv2d_k4s2p1``: (4,4,CI,CO) in x's dtype."""
    check_dw_args("halo_conv2d_k4s2p1_dw", x, dy)
    _check_preconditions(x, dy)
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return halo_conv2d_k4s2p1_dw_plain(x, dy)
    return launch_dw("halo_conv_k4s2p1_dw", x, dy)
