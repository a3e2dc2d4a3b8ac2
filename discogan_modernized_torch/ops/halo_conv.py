"""The k4/s2/p1 conv tiled over bands of output rows with 1-row halos
(kernel K5f, csrc/halo_conv_k4s2p1.cu) and its weight gradient (kernel
K5b, csrc/halo_conv_k4s2p1_dw.cu), the port of the JAX package's
``halo_conv2d_k4s2p1`` and ``halo_conv2d_k4s2p1_dw``: the same functions as
``conv2d_k4s2p1`` and ``conv2d_k4s2p1_dw``, for the wide-map, few-channel
layer. The backward routes by the same rule as the forward.

Preconditions (the JAX docstring's, asserted here): even H and W, CI and CO
multiples of 8, 2*CI <= 256; and the port's W/2 <= 256.
``takes_halo`` is the shape rule that sends a layer here instead of to K3:
an input at least 128 pixels wide with at most 64 channels (at 512px that
is enc1 alone; enc2's 128px input has 128 channels, where K3's contraction
per tap is already deep).
On the card K5f has two paths, each with a plan that the C entry checks:
bf16 with CI % 16 == 0 and CI <= 64 (enc1) takes the tensor-core kernel
with the tile plan of ``tc_plan``; f32 and the other shapes take the
CUDA-core kernel, ``halo_fma_kernel`` (exact f32 FMA, 8 x 8 register
micro-tiles, the band staged once per CI chunk through a cp.async ring),
with the plan of ``halo_fma_plan``. K5b computes K4's function: in bf16 it
runs K4's wgmma design under its own kernel name, with the plan of
``halo_dw_plan`` (K4's ``dw_plan``); in f32 its CUDA-core kernel,
``halo_dw_fma_kernel`` (exact f32 FMA on K4's 8 x 8 register micro-tiles,
each step's x one contiguous segment of an input row through a cp.async
ring), with the plan of ``halo_dw_fma_plan``. ``halo_dw_entry_args`` is the
C entry's argument list, for the wrapper and tools/dw_ab.py alike.
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

MAX_BAND_WIDTH = 256  # the widest output row K5f takes (its contract: W/2 <= 256)
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
# K5f's CUDA-core kernel (halo_fma_kernel, namespace fma): a block of
# HALO_FMA_THREADS threads owns HALO_FMA_PIXELS output pixels, rows x cols
# with cols one of HALO_FMA_COLS, by HALO_FMA_CO_TILE output channels, each
# lane an 8 x 8 micro-tile; CI goes by chunks of HALO_FMA_CK channels
# through a ring of HALO_FMA_STAGES stages, each the band's 2 rows + 2 input
# rows by 2 cols + 2 columns (HALO_FMA_CK f32 a column) and the chunk's 16 x
# HALO_FMA_CK x HALO_FMA_CO_TILE f32 weights.
HALO_FMA_THREADS = 256
HALO_FMA_PIXELS = 128
HALO_FMA_COLS = (32, 64, 128)
HALO_FMA_CO_TILE = 128
HALO_FMA_CK = 4
HALO_FMA_STAGES = 4
HALO_PATH_CODES = {"fma": 0, "wgmma": 1}
# K5b's f32 kernel (csrc/halo_conv_k4s2p1_dw.cu, halo_dw_fma_kernel): a
# block owns one kernel row, a window of HALO_DW_ROWS of that row's 4 CI dw
# rows (256: all of enc1's, in two halves of 256 threads), HALO_DW_COLS
# output channels and a run of output rows, each row in steps of
# HALO_DW_STEP pixels (HALO_DW_STEP_SHORT where that ring would not fit a
# block): one contiguous segment of the input row (2 CI (step - 1) +
# HALO_DW_ROWS floats) and dy's step x HALO_DW_COLS, f32, through a ring of
# HALO_DW_STAGES stages. HALO_DW_BLOCKS_PER_SM blocks share an SM; the rows
# are split while the tiles fill less than a wave of them, each part of at
# least HALO_DW_MIN_ROWS rows. tools/dw_ab.py's K5b variants time the
# alternatives.
HALO_DW_ROWS, HALO_DW_COLS, HALO_DW_STAGES = 256, 128, 3
HALO_DW_STEP, HALO_DW_STEP_SHORT = 64, 32
HALO_DW_BLOCKS_PER_SM, HALO_DW_MIN_ROWS = 1, 2

__all__ = ["halo_conv2d_k4s2p1", "halo_conv2d_k4s2p1_plain",
           "halo_conv2d_k4s2p1_dw", "halo_conv2d_k4s2p1_dw_plain", "takes_halo",
           "tc_plan", "TilePlan", "halo_fma_plan", "HaloFmaPlan", "halo_dw_plan",
           "halo_dw_fma_plan", "halo_dw_entry_args"]


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


class HaloFmaPlan(NamedTuple):
    rows: int        # output rows of a block
    cols: int        # output columns of a block (rows * cols = HALO_FMA_PIXELS)
    co_tile: int     # output channels of a block
    ci_chunk: int    # CI channels of a ring stage
    stages: int      # ring stages
    smem_bytes: int  # dynamic shared memory of a block
    grid: tuple      # (channel tiles, bands * strips, images * pairs)
    pairs: int = 1   # problems of the launch (folded into the grid's z)

    @property
    def x_units(self) -> int:
        """16-byte units of a stage's band: (2 rows + 2) x (2 cols + 2)."""
        return (2 * self.rows + 2) * (2 * self.cols + 2)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def halo_fma_plan(n: int, h: int, w: int, ci: int, co: int,
                  sms: int = H100_SMS, pairs: int = 1) -> HaloFmaPlan:
    """The CUDA-core kernel's plan for x (n,h,w,ci) and CO channels, in
    either dtype (f32, and bf16 off the tensor-core tiles: the dtype
    changes only how the stages are filled). Of the block shapes rows x cols (128 / cols rows of
    cols in HALO_FMA_COLS), the one whose grid takes the fewest waves of
    ``sms`` blocks (one fits an SM), then the one that stages the fewest
    input rows a pixel (the most rows: each band stages 2 rows + 2; enc1's
    128-wide map takes 4 x 32). Every block does a whole tile's FMAs, so
    below a wave more blocks would not finish sooner. ``pairs`` multiplies
    the grid's z alone: each pair runs the plan of a single call."""
    ho, wo = h // 2, w // 2
    co_tiles = -(-co // HALO_FMA_CO_TILE)

    def grid_of(cols):
        rows = HALO_FMA_PIXELS // cols
        return (co_tiles, -(-ho // rows) * -(-wo // cols), n * pairs)

    def cost(cols):
        gx, gy, _ = grid_of(cols)
        return (-(-(n * gx * gy) // sms), cols)

    cols = min(HALO_FMA_COLS, key=cost)
    rows = HALO_FMA_PIXELS // cols
    stage_floats = (4 * (2 * rows + 2) * (2 * cols + 2)
                    + 16 * HALO_FMA_CK * HALO_FMA_CO_TILE)
    return HaloFmaPlan(rows, cols, HALO_FMA_CO_TILE, HALO_FMA_CK, HALO_FMA_STAGES,
                       HALO_FMA_STAGES * stage_floats * 4, grid_of(cols), pairs)


def halo_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
              sms: int = H100_SMS, pairs: int = 1):
    """(path, rows, cols, stages, grid_x, grid_y, smem) of K5f's C entry:
    the tensor-core plan where ``tc_plan`` takes the shape, else the
    CUDA-core plan."""
    tc = tc_plan(n, h, w, ci, co, dtype, sms, pairs)
    if tc is not None:
        return ("wgmma", tc.rows, TC_STRIP, TC_SLOTS, tc.co_tiles, tc.strips * tc.bands,
                tc.smem_bytes)
    fp = halo_fma_plan(n, h, w, ci, co, sms, pairs)
    return ("fma", fp.rows, fp.cols, fp.stages, fp.grid[0], fp.grid[1], fp.smem_bytes)


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
    path, *plan = halo_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index),
                            max(pairs, 1))
    y = torch.empty(*((pairs,) if pairs else ()), n, h // 2, wd // 2, co,
                    dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.launch("halo_conv_k4s2p1", lib.discogan_halo_conv_k4s2p1,
                  x.data_ptr(), w.data_ptr(), sp, op, y.data_ptr(), n, h, wd,
                  ci, co, code, _build.DTYPE_CODES[x.dtype], HALO_PATH_CODES[path],
                  *plan, max(pairs, 1), x1.numel(), w_ps, aff_ps, _build.stream_of(x))
    return y


def halo_dw_fma_plan(n: int, h: int, w: int, ci: int, co: int,
                     sms: int = H100_SMS, pairs: int = 1) -> DwPlan:
    """The f32 kernel's plan for x (n,h,w,ci) and dy with CO channels: tiles
    of one kernel row x HALO_DW_ROWS of its 4 CI dw rows x HALO_DW_COLS
    columns (``tile`` = (rows, columns, pixels a step): HALO_DW_STEP pixels,
    HALO_DW_STEP_SHORT where that ring would not fit a block), its ring, and the
    N*H/2 output rows split while the tiles fill less than a wave of
    HALO_DW_BLOCKS_PER_SM blocks an SM of ``sms``, into as many parts as fit
    in it, each of at least HALO_DW_MIN_ROWS rows (``steps_per_split``
    counts rows). The shared memory is the ring of segments and dy runs.
    ``pairs`` sizes the grid and the workspace alone."""
    rows = n * (h // 2)
    out_tiles = 4 * -(-4 * ci // HALO_DW_ROWS) * -(-co // HALO_DW_COLS)
    splits = max(1, min(HALO_DW_BLOCKS_PER_SM * sms // out_tiles, rows // HALO_DW_MIN_ROWS))
    per = max(1, -(-rows // splits))
    splits = max(1, -(-rows // per))
    def ring(step):
        return HALO_DW_STAGES * (2 * ci * (step - 1) + HALO_DW_ROWS + step * HALO_DW_COLS) * 4

    step = HALO_DW_STEP if ring(HALO_DW_STEP) <= SMEM_PER_BLOCK else HALO_DW_STEP_SHORT
    return DwPlan("fma", (HALO_DW_ROWS, HALO_DW_COLS, step), 0, splits, per,
                  out_tiles * splits, out_tiles * splits, ring(step), pairs, HALO_DW_STAGES)


def halo_dw_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
                 sms: int = H100_SMS, pairs: int = 1) -> DwPlan:
    """K5b's plan for x (n,h,w,ci) and dy with CO channels (both multiples
    of 8). bf16: K4's ``dw_plan``, whose wgmma path takes every such shape
    (parity planes where W/2 % 8 == 0, else per-tap windows). f32:
    ``halo_dw_fma_plan``. ``pairs`` sizes the grid and the workspace
    alone."""
    if dtype == torch.bfloat16:
        return dw_plan(n, h, w, ci, co, dtype, sms, pairs)
    return halo_dw_fma_plan(n, h, w, ci, co, sms, pairs)


def halo_dw_entry_args(x, dy, dw, ws, plan: DwPlan, pairs: int = 0) -> tuple:
    """Every argument of the C entry ``discogan_halo_conv_k4s2p1_dw``, in
    order, for x (n,h,w,ci) and dy (with a leading pair axis of ``pairs``
    where it is not 0) into dw with the f32 workspace ``ws``, under
    ``plan``: the pointers, the shape, the plan's fields (the FMA kernel's
    window, step and ring; the split, the blocks and the shared memory),
    the pair axis and the stream."""
    x1, dy1 = (x[0], dy[0]) if pairs else (x, dy)
    n, h, wd, ci = x1.shape
    return (x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _build.ptr(ws), n, h, wd, ci,
            dy1.shape[3], _build.DTYPE_CODES[x.dtype], DW_PATH_CODES[plan.path],
            plan.tile[0], plan.tile[2], plan.stages, plan.splits, plan.steps_per_split,
            plan.blocks, plan.smem_bytes, max(pairs, 1), x1.numel(), dy1.numel(),
            _build.stream_of(x))


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
                  *halo_dw_entry_args(x, dy, dw, ws, plan, pairs))
    return dw
