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
On the card K5f has two paths, picked here by dtype and shape: bf16 with
CI % 16 == 0 and CI <= 64 (enc1) takes the tensor-core kernel with the tile
plan of ``tc_plan``; f32 and the other shapes take the f32-FMA kernel. K5b
computes K4's function: in bf16 it runs K4's wgmma design under its own
kernel name, with the plan of ``halo_dw_plan`` (K4's ``dw_plan``); in f32
its FMA kernel over runs of output rows.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .activations import act_code
from .conv_k4s2p1 import (DW_PATH_CODES, H100_SMS, DwPlan, _sm_count,
                          affine_pointers, check_conv_args, dw_operands,
                          dw_plan, pair_operands)
from .conv_k4s2p1 import MAX_SMEM_BYTES as SMEM_PER_BLOCK
from .conv_k4s2p1 import conv2d_k4s2p1_dw_plain as halo_conv2d_k4s2p1_dw_plain
from .conv_k4s2p1 import conv2d_k4s2p1_plain as halo_conv2d_k4s2p1_plain

MAX_BAND_WIDTH = 256  # output pixels per row a band can hold
MIN_WIDTH = 128       # input width from which the route takes this kernel
MAX_ROUTED_CI = 64

# The tensor-core path's tiling (csrc/halo_conv_k4s2p1.cu, namespace tc): a
# block owns a strip of TC_STRIP output columns of one image, a TC_CO_TILE
# channel tile and a run of output rows, with the tile's weights resident
# and a ring of TC_SLOTS input rows, each staged as two column-parity
# planes of TC_STRIP + 1 pixels, TC_PIXEL_BYTES a pixel.
TC_STRIP = 64
TC_CO_TILE = 64
TC_SLOTS = 6
TC_PIXEL_BYTES = 128
TC_MAX_CI = 64
# K5b's f32 FMA kernel (csrc/halo_conv_k4s2p1_dw.cu, halo_dw_kernel): a block
# owns one kernel row, a FMA_TILE tile of CI and of CO and a run of output
# rows; runs are halved while the blocks fill fewer than two waves and each
# keeps FMA_MIN_ROWS rows.
FMA_TILE = 64
FMA_MIN_ROWS = 4

__all__ = ["halo_conv2d_k4s2p1", "halo_conv2d_k4s2p1_plain",
           "halo_conv2d_k4s2p1_dw", "halo_conv2d_k4s2p1_dw_plain", "takes_halo",
           "tc_plan", "TilePlan", "halo_dw_plan"]


class TilePlan(NamedTuple):
    rows: int       # output rows per block
    bands: int      # blocks down the map
    strips: int     # blocks across the map
    co_tiles: int   # blocks across the output channels
    smem_bytes: int
    pairs: int = 1  # problems of the launch (folded into the grid's z)

    @property
    def blocks_per_image(self) -> int:
        return self.bands * self.strips * self.co_tiles


def tc_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
            sms: int = H100_SMS, pairs: int = 1) -> TilePlan | None:
    """The tensor-core path's tile plan for x (n,h,w,ci) and CO channels, or
    None where that path does not take the shape (f32, CI % 16 != 0,
    CI > 64, CO % 8 != 0). Rows per block are as few as keep the grid
    within one wave of ``sms`` blocks (one block fits an SM): each block
    pays its weights' copy and two halo rows once, so fewer, longer runs
    cost less, and one wave of equal blocks ends together. ``pairs``
    multiplies the grid alone: each pair runs the plan of a single call."""
    if dtype != torch.bfloat16 or ci % 16 or not 0 < ci <= TC_MAX_CI or co % 8:
        return None
    ho, wo = h // 2, w // 2
    strips = -(-wo // TC_STRIP)
    co_tiles = -(-co // TC_CO_TILE)
    bands_wanted = max(1, min(ho, sms // max(1, n * strips * co_tiles)))
    rows = max(1, -(-ho // bands_wanted))
    bands = -(-ho // rows)
    smem = (TC_SLOTS * 2 * (TC_STRIP + 1) * TC_PIXEL_BYTES
            + 16 * ci * TC_CO_TILE * 2)
    return TilePlan(rows, bands, strips, co_tiles, smem, pairs)


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
    """Whether the generator routes this k4/s2/p1 conv to K5f: by the shape
    of one problem, the same for each pair of a pair axis."""
    h, wd, ci = x.shape[-3:]
    co = w.shape[-1]
    return (min(h, wd) >= MIN_WIDTH and wd // 2 <= MAX_BAND_WIDTH
            and ci <= MAX_ROUTED_CI and ci % 8 == 0 and co % 8 == 0)


def halo_conv2d_k4s2p1(x, w, *, scale=None, offset=None, act=None):
    """y = act(conv(x, w, k=4, s=2, p=1) * scale + offset), NHWC/HWIO; per
    pair where x has a pair axis (w per pair or shared)."""
    pairs, x1, w1, w_ps = pair_operands("halo_conv2d_k4s2p1", x, w)
    check_conv_args("halo_conv2d_k4s2p1", x1, w1, scale, offset)
    _check_preconditions(x1, w1)
    code = act_code(act)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return halo_conv2d_k4s2p1_plain(x, w, scale=scale, offset=offset,
                                        act=act)
    n, h, wd, ci = x1.shape
    co = w1.shape[3]
    _build.check_cuda_tensor("halo_conv2d_k4s2p1 x", x)
    _build.check_cuda_tensor("halo_conv2d_k4s2p1 w", w, dtype=x.dtype)
    sp, op, aff_ps = affine_pointers("halo_conv2d_k4s2p1", scale, offset, co, pairs)
    plan = tc_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index), max(pairs, 1))
    y = torch.empty(*((pairs,) if pairs else ()), n, h // 2, wd // 2, co,
                    dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.launch("halo_conv_k4s2p1", lib.discogan_halo_conv_k4s2p1,
                  x.data_ptr(), w.data_ptr(), sp, op, y.data_ptr(), n, h, wd,
                  ci, co, code, _build.DTYPE_CODES[x.dtype],
                  plan.rows if plan else 0, max(pairs, 1), x1.numel(), w_ps, aff_ps,
                  _build.stream_of(x))
    return y


def halo_dw_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
                 sms: int = H100_SMS, pairs: int = 1) -> DwPlan:
    """K5b's plan for x (n,h,w,ci) and dy with CO channels (both multiples
    of 8). bf16: K4's ``dw_plan``, whose wgmma path takes every such shape
    (parity planes where W/2 % 8 == 0, else per-tap windows). f32: the FMA
    kernel's tiles of one kernel row x FMA_TILE channels of CI and CO, its
    steps whole output rows (``tile[2]`` = W/2 pixels), split while the
    blocks fill fewer than two waves of ``sms``. ``pairs`` sizes the grid
    and the workspace alone."""
    if dtype == torch.bfloat16:
        return dw_plan(n, h, w, ci, co, dtype, sms, pairs)
    rows = n * (h // 2)
    out_tiles = 4 * -(-ci // FMA_TILE) * -(-co // FMA_TILE)
    s = 1
    while out_tiles * s < 2 * sms and rows // (2 * s) >= FMA_MIN_ROWS:
        s *= 2
    rows_per_split = max(1, -(-rows // s))
    splits = max(1, -(-rows // rows_per_split))
    return DwPlan("fma", (4 * FMA_TILE, FMA_TILE, w // 2), 4, splits,
                  rows_per_split, out_tiles * splits, out_tiles * splits, 0, pairs)


def halo_conv2d_k4s2p1_dw(x, dy):
    """Weight gradient of ``halo_conv2d_k4s2p1``: (4,4,CI,CO) in x's dtype;
    (P,4,4,CI,CO) where x and dy have a pair axis."""
    pairs, x1, dy1 = dw_operands("halo_conv2d_k4s2p1_dw", x, dy)
    _check_preconditions(x1, dy1)
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return halo_conv2d_k4s2p1_dw_plain(x, dy)
    n, h, wd, ci = x1.shape
    co = dy1.shape[3]
    _build.check_cuda_tensor("halo_conv_k4s2p1_dw x", x)
    _build.check_cuda_tensor("halo_conv_k4s2p1_dw dy", dy, dtype=x.dtype)
    plan = halo_dw_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index),
                        max(pairs, 1))
    dw = torch.empty(*((pairs,) if pairs else ()), 4, 4, ci, co, dtype=x.dtype,
                     device=x.device)
    ws = _build.workspace(plan.workspace_floats(ci, co), x)
    lib = _build.library()
    _build.launch("halo_conv_k4s2p1_dw", lib.discogan_halo_conv_k4s2p1_dw,
                  x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _build.ptr(ws), n,
                  h, wd, ci, co, _build.DTYPE_CODES[x.dtype],
                  DW_PATH_CODES[plan.path], plan.splits, plan.steps_per_split,
                  plan.blocks, plan.smem_bytes, max(pairs, 1), x1.numel(), dy1.numel(),
                  _build.stream_of(x))
    return dw
