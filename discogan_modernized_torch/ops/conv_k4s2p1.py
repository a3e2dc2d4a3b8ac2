"""The k4/s2/p1 halving conv (kernel K3, csrc/conv_k4s2p1.cu) and its
weight gradient (kernel K4, csrc/conv_k4s2p1_dw.cu), the port of the JAX
package's ``conv2d_k4s2p1`` and ``conv2d_k4s2p1_dw``.

x (N,H,W,I) NHWC, w (4,4,I,O) HWIO, even H and W. ``conv2d_k4s2p1``
returns act(conv(x, w) * scale + offset) of shape (N,H/2,W/2,O) in x's
dtype, with f32 accumulation and an f32 epilogue; scale/offset are
per-channel and optional (inference-form BN), act is None, "relu" or
"leaky" (0.2). With ``with_stats`` it returns (y, (mean, mean_sq)): the
per-channel means of the raw f32 accumulator and of its square over the
N*Ho*Wo rows, which train-mode BatchNorm reads instead of a second pass.
``conv_plan`` picks K3's path (wgmma kernels for bf16 with I a multiple of
64, or I at most 4 and O a multiple of 64 for the stem, else the f32 FMA
kernel), its tile, ring, split over K and grid.
``conv2d_k4s2p1_dw`` returns dw[kh,kw,i,o] = sum x_pad[b,2r+kh,2c+kw,i] *
dy[b,r,c,o], f32 accumulation, in x's dtype; ``dw_plan`` picks its path
(wgmma kernels for bf16 with O a multiple of 8 and I a multiple of 8 or at
most 4, else the f32 FMA kernel), its split over the M = N*Ho*Wo pixels
and its shared memory.
A CPU tensor takes the ``_plain`` version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .activations import act_code, apply_act


def check_conv_args(fn: str, x: torch.Tensor, w: torch.Tensor, scale, offset):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not NHWC and (4,4,I,O)")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{fn}: spatial dims must be even, got "
                         f"{x.shape[1]}x{x.shape[2]}")
    if (scale is None) != (offset is None):
        raise ValueError(f"{fn}: scale and offset go together")


def affine_pointers(fn: str, scale, offset, co: int):
    """Device pointers of the epilogue's f32 (CO,) scale and offset, or
    (None, None) without an affine; raises on anything else."""
    if scale is None:
        return None, None
    for name, t in (("scale", scale), ("offset", offset)):
        _build.check_cuda_tensor(f"{fn} {name}", t, dtype=torch.float32, ndim=1)
        if t.shape[0] != co:
            raise ValueError(f"{fn} {name}: {tuple(t.shape)} for {co} channels")
    return scale.data_ptr(), offset.data_ptr()


H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv2d_k4s2p1_plain(x, w, *, scale=None, offset=None, act=None,
                        with_stats: bool = False):
    """The 16 per-tap products sum_{kh,kw} x_pad[:, kh::2, kw::2, :] @ w[kh, kw]
    in f32, then the epilogue, cast to x's dtype."""
    check_conv_args("conv2d_k4s2p1_plain", x, w, scale, offset)
    n, h, wd, _ = x.shape
    ho, wo = h // 2, wd // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    w32 = w.float()
    acc = torch.zeros(n, ho, wo, w.shape[3], dtype=torch.float32,
                      device=x.device)
    for kh in range(4):
        for kw in range(4):
            acc += xp[:, kh:kh + 2 * ho:2, kw:kw + 2 * wo:2, :] @ w32[kh, kw]
    stats = None
    if with_stats:
        flat = acc.reshape(-1, acc.shape[-1])
        stats = (flat.mean(0), flat.square().mean(0))
    if scale is not None:
        acc = acc * scale.float() + offset.float()
    y = apply_act(acc, act).to(x.dtype)
    return (y, stats) if with_stats else y


# K3's three paths (csrc/conv_k4s2p1.cu). wgmma (bf16, I % 64 == 0, O % 8
# == 0): output tiles of CONV_BM rows (64 where M fits one) by CONV_BN_WIDE
# columns where O is a multiple of them and those tiles fill at least
# CONV_WIDE_FILL of a wave unsplit, else CONV_BN; K in steps of CONV_BK
# (one tap, 64 channels) through a ring of CONV_STAGES[(rows, columns)]
# stages of A (rows x 128 bytes) and B (CONV_BK x columns bf16); K is split
# while the tiles fill less than one wave of the card, each part of at
# least CONV_MIN_STEPS_PER_SPLIT steps, its f32 partials summed by a second
# pass whose statistics take one partial row per CONV_SPLIT_STAT_ROWS rows.
# The stem (bf16, I <= 4, O % 64 == 0): one warpgroup a block over
# CONV_STEM_BO channels and a run of CONV_STEM_CHUNK-pixel chunks,
# CONV_STEM_BLOCKS_PER_SM blocks an SM, each of at least
# CONV_STEM_MIN_CHUNKS chunks. FMA: CONV_FMA_TILE x CONV_FMA_TILE tiles, K
# in steps of 16.
CONV_BM, CONV_BN, CONV_BN_WIDE, CONV_BK = 128, 128, 256, 64
CONV_WIDE_FILL = 7 / 8
CONV_STAGES = {(128, 256): 4, (128, 128): 5, (64, 128): 6}
CONV_MIN_STEPS_PER_SPLIT = 4
CONV_SPLIT_STAT_ROWS = 64
CONV_STEM_CHUNK, CONV_STEM_BO = 64, 64
CONV_STEM_BLOCKS_PER_SM, CONV_STEM_MIN_CHUNKS = 4, 4
CONV_STEM_SMEM = (3 * CONV_STEM_CHUNK * 128 + CONV_STEM_CHUNK * (CONV_STEM_BO + 8) * 2
                  + 2 * 4 * CONV_STEM_BO * 4 + 2 * CONV_STEM_BO * 4)
CONV_FMA_TILE = 64
CONV_PATH_CODES = {"fma": 0, "wgmma": 1, "wgmma_stem": 2}
MAX_SMEM_BYTES = 232_448  # a block's shared memory on the H100


class ConvPlan(NamedTuple):
    path: str             # "wgmma", "wgmma_stem" or "fma"
    tile: tuple           # (rows, columns, K of a step) of an output tile
    stages: int           # ring stages (wgmma), A's double buffer (stem), 0 (FMA)
    splits: int           # parts of K (wgmma) or blocks along M (stem); 1 (FMA)
    steps_per_split: int  # K steps (wgmma) or 64-pixel chunks (stem) of a part
    grid: tuple           # (x, y, z)
    smem_bytes: int       # dynamic shared memory of a block
    partial_floats: int   # f32 split partials in the workspace
    stat_rows: int        # partial rows of the statistics (2 x O floats each)

    def workspace_floats(self, co: int, with_stats: bool) -> int:
        return self.partial_floats + (2 * self.stat_rows * co if with_stats else 0)


def conv_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
              sms: int = H100_SMS) -> ConvPlan:
    """K3's plan for x (n,h,w,ci) and CO output channels. The wgmma path
    takes 64-row tiles where M fits in one, 256 columns where CO is a
    multiple of them and those tiles fill most of a wave without a split
    (wide tiles read less from L2 per product, a split costs its
    partials), and splits K only while its tiles fill less than one wave
    of ``sms`` blocks (one fits an SM), into as many parts as fit in that
    wave; the grid walks M fastest. The stem spreads M over
    CONV_STEM_BLOCKS_PER_SM blocks an SM."""
    m = n * (h // 2) * (w // 2)
    if dtype == torch.bfloat16 and 1 <= ci <= 4 and co % CONV_STEM_BO == 0 and co > 0:
        chunks = -(-m // CONV_STEM_CHUNK)
        out_tiles = co // CONV_STEM_BO
        blocks = max(1, min(chunks // CONV_STEM_MIN_CHUNKS,
                            CONV_STEM_BLOCKS_PER_SM * sms // out_tiles))
        per_block = max(1, -(-chunks // blocks))
        blocks = max(1, -(-chunks // per_block))
        return ConvPlan("wgmma_stem", (CONV_STEM_CHUNK, CONV_STEM_BO, 16 * ci), 2,
                        blocks, per_block, (out_tiles, blocks, 1), CONV_STEM_SMEM, 0,
                        blocks)
    if dtype == torch.bfloat16 and ci % CONV_BK == 0 and ci > 0 and co % 8 == 0:
        bm = 64 if m <= 64 else CONV_BM
        wide = (bm == CONV_BM and co % CONV_BN_WIDE == 0
                and -(-m // bm) * (co // CONV_BN_WIDE) >= CONV_WIDE_FILL * sms)
        bn = CONV_BN_WIDE if wide else CONV_BN
        steps = 16 * ci // CONV_BK
        m_tiles, n_tiles = -(-m // bm), -(-co // bn)
        splits = max(1, min(sms // (m_tiles * n_tiles),
                            steps // CONV_MIN_STEPS_PER_SPLIT))
        sps = -(-steps // splits)
        splits = -(-steps // sps)
        stages = CONV_STAGES[(bm, bn)]
        return ConvPlan("wgmma", (bm, bn, CONV_BK), stages, splits, sps,
                        (m_tiles, n_tiles, splits),
                        stages * (bm * 128 + CONV_BK * bn * 2),
                        splits * m * co if splits > 1 else 0,
                        -(-m // CONV_SPLIT_STAT_ROWS) if splits > 1 else m_tiles)
    m_tiles = -(-m // CONV_FMA_TILE)
    return ConvPlan("fma", (CONV_FMA_TILE, CONV_FMA_TILE, 16), 0, 1, ci,
                    (m_tiles, -(-co // CONV_FMA_TILE), 1), 0, 0, m_tiles)


def conv2d_k4s2p1(x, w, *, scale=None, offset=None, act=None,
                  with_stats: bool = False):
    """y = act(conv(x, w, k=4, s=2, p=1) * scale + offset), NHWC/HWIO;
    (y, (mean, mean_sq)) of the raw conv with ``with_stats``."""
    check_conv_args("conv2d_k4s2p1", x, w, scale, offset)
    code = act_code(act)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return conv2d_k4s2p1_plain(x, w, scale=scale, offset=offset, act=act,
                                   with_stats=with_stats)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    _build.check_cuda_tensor("conv2d_k4s2p1 x", x)
    _build.check_cuda_tensor("conv2d_k4s2p1 w", w, dtype=x.dtype)
    sp, op = affine_pointers("conv2d_k4s2p1", scale, offset, co)
    plan = conv_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index))
    y = torch.empty(n, h // 2, wd // 2, co, dtype=x.dtype, device=x.device)
    stats = (torch.empty(2, co, dtype=torch.float32, device=x.device)
             if with_stats else None)
    ws = _build.workspace(plan.workspace_floats(co, with_stats), x)
    lib = _build.library()
    _build.launch("conv_k4s2p1", lib.discogan_conv_k4s2p1, x.data_ptr(),
                  w.data_ptr(), sp, op, y.data_ptr(), _build.ptr(ws),
                  _build.ptr(stats), n, h, wd, ci, co, code,
                  _build.DTYPE_CODES[x.dtype], CONV_PATH_CODES[plan.path],
                  plan.tile[0], plan.tile[1], plan.stages, plan.splits,
                  plan.steps_per_split, plan.grid[0], plan.grid[1],
                  plan.smem_bytes, plan.stat_rows,
                  _build.stream_of(x))
    return (y, (stats[0], stats[1])) if with_stats else y


def check_dw_args(fn: str, x: torch.Tensor, dy: torch.Tensor):
    n, h, wd, _ = x.shape
    if (x.dim() != 4 or dy.dim() != 4 or h % 2 or wd % 2
            or tuple(dy.shape[:3]) != (n, h // 2, wd // 2)):
        raise ValueError(f"{fn}: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         "are not NHWC with dy at half x's even size")


def conv2d_k4s2p1_dw_plain(x, dy):
    """Per tap, x_pad[:, kh::2, kw::2, :] flattened to (M, I), transposed,
    times dy flattened to (M, O), in f32; cast to x's dtype."""
    check_dw_args("conv2d_k4s2p1_dw_plain", x, dy)
    n, h, wd, ci = x.shape
    ho, wo, co = h // 2, wd // 2, dy.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d2 = dy.float().reshape(-1, co)
    dw = torch.empty(4, 4, ci, co, dtype=torch.float32, device=x.device)
    for kh in range(4):
        for kw in range(4):
            xt = xp[:, kh:kh + 2 * ho:2, kw:kw + 2 * wo:2, :].reshape(-1, ci)
            dw[kh, kw] = xt.t() @ d2
    return dw.to(x.dtype)


# K4's two paths (csrc/conv_k4s2p1_dw.cu). wgmma: a tile is the four taps of
# one kernel row, DW_CH input channels and DW_BN output channels; blocks
# walk the pixels in chunks of DW_CHUNK through a ring of stages, x staged
# as column-parity planes (DW_GROUP_PX pixels per 8-pixel group and parity;
# a ring of DW_STAGES["planes"]) where Wo % 8 == 0, else as the four taps'
# windows (DW_STAGES["windows"]), beside a bf16 epilogue buffer. The stem
# (I <= 4): one warpgroup a block over STEM_BO output channels and a part of
# the pixels, the 16*I dw rows as one im2col tile, f32 partials summed by a
# second pass; STEM_BLOCKS_PER_SM blocks share an SM. FMA: 64 x 64 tiles of
# the (16*I, O) matrix, FMA_STEP pixels a step.
DW_CH, DW_BN, DW_CHUNK, DW_GROUP_PX = 64, 128, 64, 9
DW_STAGES = {"planes": 4, "windows": 3}
DW_MIN_CHUNKS_PER_SPLIT = 4
DW_MAX_TILES_PER_BLOCK = 64
FMA_TILE, FMA_STEP, FMA_TARGET_BLOCKS, FMA_MIN_STEPS_PER_SPLIT = 64, 16, 2 * 132, 8
STEM_BO, STEM_BLOCKS_PER_SM, STEM_SMEM = 64, 4, 4 * DW_CHUNK * 128
DW_PATH_CODES = {"fma": 0, "wgmma_planes": 1, "wgmma_windows": 2,
                 "wgmma_stem": 3}


class DwPlan(NamedTuple):
    path: str             # "wgmma_planes", "wgmma_windows", "wgmma_stem" or "fma"
    tile: tuple           # (dw rows, o columns) of a tile, pixels per step
    taps: int             # taps of dw a tile owns (0: FMA tiles cut across taps)
    splits: int           # parts of the contraction over M
    steps_per_split: int  # steps (of tile[2] pixels) of each part
    tiles: int            # output tiles times splits
    blocks: int           # blocks launched (wgmma: each walks tiles b, b + blocks, ...)
    smem_bytes: int       # dynamic shared memory of a block


def dw_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
            sms: int = H100_SMS) -> DwPlan:
    """K4's plan for x (n,h,w,ci) and dy with CO channels. The wgmma path
    splits M only while its tiles fill less than one wave of ``sms`` blocks
    (one fits an SM), into as many parts as fit in that wave, each of at
    least DW_MIN_CHUNKS_PER_SPLIT chunks; unsplit, it launches one block per
    SM (more only where a block would walk over DW_MAX_TILES_PER_BLOCK
    tiles), each walking its share of the tiles. The FMA path doubles
    its split while its tiles fill fewer than two waves and each part keeps
    8 steps. The stem splits M over STEM_BLOCKS_PER_SM blocks an SM, each
    part of at least DW_MIN_CHUNKS_PER_SPLIT chunks, and always sums its
    parts in the second pass."""
    m = n * (h // 2) * (w // 2)
    chunks = -(-m // DW_CHUNK)
    if dtype == torch.bfloat16 and 1 <= ci <= 4 and co % 8 == 0:
        out_tiles = -(-co // STEM_BO)
        splits = max(1, min(chunks // DW_MIN_CHUNKS_PER_SPLIT,
                            STEM_BLOCKS_PER_SM * sms // out_tiles))
        sps = max(1, -(-chunks // splits))
        splits = max(1, -(-chunks // sps))
        return DwPlan("wgmma_stem", (16 * ci, STEM_BO, DW_CHUNK), 16, splits,
                      sps, out_tiles * splits, out_tiles * splits, STEM_SMEM)
    if dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0 and ci > 0:
        planes = (w // 2) % 8 == 0
        out_tiles = -(-co // DW_BN) * -(-ci // DW_CH) * 4
        splits = max(1, min(sms // out_tiles, chunks // DW_MIN_CHUNKS_PER_SPLIT))
        sps = max(1, -(-chunks // splits))
        splits = max(1, -(-chunks // sps))
        tiles = out_tiles * splits
        x_bytes = (2 * (DW_CHUNK // 8) * DW_GROUP_PX * 128 if planes
                   else 4 * DW_CHUNK * 128)
        ring = (DW_STAGES["planes" if planes else "windows"]
                * (x_bytes + DW_CHUNK * DW_BN * 2))
        epilogue = 4 * DW_CH * (DW_BN + 8) * 2
        blocks = (tiles if splits > 1 else
                  max(min(tiles, sms), -(-tiles // DW_MAX_TILES_PER_BLOCK)))
        return DwPlan("wgmma_planes" if planes else "wgmma_windows",
                      (4 * DW_CH, DW_BN, DW_CHUNK), 4, splits, sps, tiles,
                      blocks, ring + epilogue + 16 * DW_MAX_TILES_PER_BLOCK)
    out_tiles = -(-16 * ci // FMA_TILE) * -(-co // FMA_TILE)
    steps = -(-m // FMA_STEP)
    s = 1
    while (out_tiles * s < FMA_TARGET_BLOCKS
           and steps // (2 * s) >= FMA_MIN_STEPS_PER_SPLIT):
        s *= 2
    sps = max(1, -(-steps // s))
    splits = max(1, -(-steps // sps))
    return DwPlan("fma", (FMA_TILE, FMA_TILE, FMA_STEP), 0, splits, sps,
                  out_tiles * splits, out_tiles * splits, 0)


def conv2d_k4s2p1_dw(x, dy):
    """Weight gradient of ``conv2d_k4s2p1``: (4,4,I,O) in x's dtype."""
    check_dw_args("conv2d_k4s2p1_dw", x, dy)
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return conv2d_k4s2p1_dw_plain(x, dy)
    n, h, wd, ci = x.shape
    co = dy.shape[3]
    _build.check_cuda_tensor("conv_k4s2p1_dw x", x)
    _build.check_cuda_tensor("conv_k4s2p1_dw dy", dy, dtype=x.dtype)
    plan = dw_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index))
    dw = torch.empty(4, 4, ci, co, dtype=x.dtype, device=x.device)
    parts = plan.splits > 1 or plan.path == "wgmma_stem"
    ws = _build.workspace(plan.splits * 16 * ci * co if parts else 0, x)
    lib = _build.library()
    _build.launch("conv_k4s2p1_dw", lib.discogan_conv_k4s2p1_dw, x.data_ptr(),
                  dy.data_ptr(), dw.data_ptr(), _build.ptr(ws), n, h, wd, ci,
                  co, _build.DTYPE_CODES[x.dtype], DW_PATH_CODES[plan.path],
                  plan.splits, plan.steps_per_split, plan.blocks,
                  plan.smem_bytes, _build.stream_of(x))
    return dw
