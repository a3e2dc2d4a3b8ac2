"""The generator head: ConvTranspose2d(k=4, s=2, p=1) to a thin output
(kernel K6, csrc/head_convt.cu), the port of the JAX package's
``head_convt_fwd``.

x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO with I = the convT's input channels
(torch's (I,O,kh,kw) weight by transpose(2,3,0,1)); returns (N,2H,2W,CO)
in x's dtype, f32 accumulation. The kernel takes CO <= 8. On the card K6
has two paths, each with a plan that the C entry checks: bf16 with CI % 16
== 0, 16 <= CI <= 128 takes the tensor-core kernel with the tile plan of
``head_plan``; f32 and the other shapes take the CUDA-core kernel,
``head_fma_kernel`` (exact f32 FMA, the four phases' own taps, register
tiles of 2 x 4 input positions, a cp.async ring of halo tiles over CI),
with the plan of ``head_fma_plan``. A CPU tensor takes
``head_convt_plain``; a CUDA tensor launches a kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, pairs as pr
from .conv_k4s2p1 import H100_SMS, MAX_SMEM_BYTES, _sm_count, pair_operands

MAX_CO = 8
SMEM_PER_SM = 233_472         # an SM's shared memory, of which each block
SMEM_RESERVED = 1024          # takes this much beside its own
# The tensor-core path's tiling (csrc/head_convt.cu, namespace tc): a block
# owns a strip of TC_STRIP input columns of one image and a band of input
# rows; it holds B (9 windows x CI x TC_NP(co) columns), a ring of input
# rows in which each of its two warpgroups stages TC_WG_PIXELS pixels (its
# 64 columns and their padding), TC_PIXEL_BYTES a pixel for each 64
# channels, and the epilogue's lines; at most TC_BLOCKS_PER_SM blocks share
# an SM.
TC_STRIP = 128
TC_WG_PIXELS = 64 + 2
TC_PIXEL_BYTES = 128
TC_MAX_CI = 128
TC_SLOTS = (5, 4)             # ring rows, most first: copies run slots - 3 rows ahead
TC_BLOCKS_PER_SM = 2
# The CUDA-core path's tiling (csrc/head_convt.cu, namespace fma): a block
# owns one image, `rows` input rows (FMA_ROWS: 2 a warp) and 32 lanes x
# fma_thread_cols(co) input columns, each lane FMA_THREAD_ROWS x
# fma_thread_cols(co) positions; CI goes in chunks of FMA_KC channels
# through a ring of FMA_STAGES stages, each the halo tile (rows + 2 by cols
# + 2 pixels, a 16-byte unit a pixel a plane) and the chunk's 16 x FMA_KC x
# fma_co(co) f32 weights; afterwards each warp's 4 output lines pass
# through the drained ring. 8 warps an SM at most (255 registers a thread).
FMA_KC = 8
FMA_THREAD_ROWS = 2
FMA_ROWS = (8, 4)
FMA_STAGES = 2
FMA_WARPS_PER_SM = 8
HEAD_PATH_CODES = {"fma": 0, "wgmma": 1}

__all__ = ["head_convt", "head_convt_plain", "head_plan", "HeadPlan",
           "head_fma_plan", "HeadFmaPlan", "head_entry_plan"]


class HeadPlan(NamedTuple):
    rows: int        # input rows per block (the last band may hold fewer)
    bands: int       # blocks down the map
    strips: int      # blocks across the map
    slots: int       # input rows in the ring
    smem_bytes: int
    blocks: int      # the grid: pairs x images x bands x strips
    pairs: int = 1   # problems of the launch (the grid's z)


def tc_np(co: int) -> int:
    """B's columns: the 4 * CO phases and channels, padded to a wgmma width."""
    return 16 if co <= 4 else 32


def tc_smem_bytes(ci: int, co: int, slots: int) -> int:
    planes = -(-ci // 64)
    return (9 * planes * tc_np(co) * 128
            + slots * planes * 2 * TC_WG_PIXELS * TC_PIXEL_BYTES
            + 4 * (128 * co + 16) * 2)


def head_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
              sms: int = H100_SMS, pairs: int = 1) -> HeadPlan | None:
    """The tensor-core path's tile plan for x (n,h,w,ci) and CO output
    channels, or None where that path does not take the shape (f32,
    CI % 16 != 0, CI outside 16..128, CO outside 1..8). The ring holds 5
    rows where that fits a block's shared memory, else 4. Rows per band are
    as few as keep the grid within one wave of ``sms`` SMs holding as many
    blocks each as fit (two at most): each band pays B's build and two halo
    rows once, so fewer, longer bands cost less, and one wave of equal
    blocks ends together. ``pairs`` multiplies the grid alone: each pair
    runs the plan of a single call."""
    if (dtype != torch.bfloat16 or ci % 16 or not 0 < ci <= TC_MAX_CI
            or not 1 <= co <= MAX_CO):
        return None
    slots = next((s for s in TC_SLOTS if tc_smem_bytes(ci, co, s) <= MAX_SMEM_BYTES), None)
    if slots is None:
        return None
    smem = tc_smem_bytes(ci, co, slots)
    per_sm = min(TC_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    strips = -(-w // TC_STRIP)
    bands_wanted = max(1, min(h, per_sm * sms // max(1, n * strips)))
    rows = max(1, -(-h // bands_wanted))
    bands = -(-h // rows)
    return HeadPlan(rows, bands, strips, slots, smem, pairs * n * bands * strips, pairs)


def fma_co(co: int) -> int:
    """The kernel's CO for co output channels: 3 up to 3, else 8 (the
    weights past co are zeros)."""
    return 3 if co <= 3 else 8


def fma_thread_cols(co: int) -> int:
    """A lane's input columns: 4 at the kernel's CO 3 (96 accumulators), 2
    at CO 8 (128)."""
    return 4 if fma_co(co) == 3 else 2


def fma_smem_bytes(itemsize: int, co: int, rows: int, stages: int) -> int:
    """A block's shared memory: its ring of stages, each the halo tile's
    planes (rows + 2 staged rows of cols + 2 16-byte units) and the chunk's
    f32 weights; or the epilogue's lines where larger (4 a warp, 2 cols CO
    values of x's dtype and 16 bytes for y's phase)."""
    cot, cols = fma_co(co), 32 * fma_thread_cols(co)
    planes = -(-FMA_KC * itemsize // 16)
    stage = 16 * planes * (rows + 2) * (cols + 2) + 4 * 16 * FMA_KC * cot
    lines = rows // FMA_THREAD_ROWS * 4 * (2 * cols * cot + 16 // itemsize) * itemsize
    return max(stages * stage, lines)


class HeadFmaPlan(NamedTuple):
    rows: int          # input rows of a block (the last band may hold fewer)
    cols: int          # input columns of a block: 32 lanes x thread_cols
    thread_rows: int   # a lane's input rows
    thread_cols: int   # a lane's input columns
    ci_chunk: int      # CI channels of a ring stage
    stages: int        # ring stages
    vec: bool          # 16-byte copies (f32 CI % 4 == 0, bf16 CI % 8 == 0)
    smem_bytes: int    # dynamic shared memory of a block
    bands: int         # blocks down the map
    strips: int        # blocks across the map
    grid: tuple        # (bands * strips, images, pairs)
    pairs: int = 1     # problems of the launch (the grid's z)

    @property
    def threads(self) -> int:
        return 32 * self.rows // self.thread_rows

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def head_fma_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
                  sms: int = H100_SMS, pairs: int = 1) -> HeadFmaPlan | None:
    """The CUDA-core kernel's plan for x (n,h,w,ci) and CO output channels
    in either dtype (f32, and bf16 off the tensor-core path), or None where
    the kernel does not take the shape (CO outside 1..8, CI 0). Of the
    block heights FMA_ROWS, the one that leaves the busiest SM the fewest
    input rows when the grid's blocks go round the ``sms`` SMs, then the
    tallest (the fewest halo rows a row): 8 from batch 2 up (two blocks of
    4 warps an SM, 3.6-4.6% faster at batch 4 and 8 than one of 8 warps
    and 16 rows on the H100, tools/head_ab.py), 4 at batch 1; a ring of
    FMA_STAGES stages (a third was slower). ``pairs`` multiplies the grid
    alone: each pair runs the plan of a single call."""
    if not 1 <= co <= MAX_CO or ci < 1:
        return None
    itemsize = torch.finfo(dtype).bits // 8
    tcols = fma_thread_cols(co)
    cols = 32 * tcols
    strips = -(-w // cols)

    def cost(rows):
        blocks = n * -(-h // rows) * strips
        return (-(-blocks // sms) * rows, -rows)

    rows = min(FMA_ROWS, key=cost)
    bands = -(-h // rows)
    return HeadFmaPlan(rows, cols, FMA_THREAD_ROWS, tcols, FMA_KC, FMA_STAGES,
                       ci % (16 // itemsize) == 0,
                       fma_smem_bytes(itemsize, co, rows, FMA_STAGES), bands, strips,
                       (bands * strips, n, pairs), pairs)


def head_entry_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
                    sms: int = H100_SMS, pairs: int = 1):
    """(path, rows, cols, bands, strips, slots, kc, vec, smem) of K6's C
    entry: the tensor-core plan where ``head_plan`` takes the shape, else
    the CUDA-core plan; None where neither does."""
    tc = head_plan(n, h, w, ci, co, dtype, sms, pairs)
    if tc is not None:
        return ("wgmma", tc.rows, TC_STRIP, tc.bands, tc.strips, tc.slots, 0, 0,
                tc.smem_bytes)
    fp = head_fma_plan(n, h, w, ci, co, dtype, sms, pairs)
    if fp is None:
        return None
    return ("fma", fp.rows, fp.cols, fp.bands, fp.strips, fp.stages, fp.ci_chunk,
            int(fp.vec), fp.smem_bytes)


def _check_args(fn, x, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not NHWC and (4,4,I,O)")


def head_convt_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four-class subpixel form: with wf = w flipped spatially, output
    (2i+a, 2j+b) = sum_{u,v} x_pad[i+a+u, j+b+v] @ wf[a+2u, b+2v]; a loop
    over the pairs where x has a pair axis."""
    if pr.pairs_of(x, 4):
        return pr.stack([head_convt_plain(xp, pr.member(w, p, 4))
                         for p, xp in enumerate(x)])
    _check_args("head_convt_plain", x, w)
    n, h, wd, _ = x.shape
    co = w.shape[3]
    wf = w.float().flip(0, 1)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y = torch.empty(n, h, 2, wd, 2, co, dtype=torch.float32, device=x.device)
    for a in (0, 1):
        for b in (0, 1):
            acc = torch.zeros(n, h, wd, co, dtype=torch.float32,
                              device=x.device)
            for u in (0, 1):
                for v in (0, 1):
                    acc += (xp[:, a + u:a + u + h, b + v:b + v + wd, :]
                            @ wf[a + 2 * u, b + 2 * v])
            y[:, :, a, :, b, :] = acc
    return y.reshape(n, 2 * h, 2 * wd, co).to(x.dtype)


def head_convt(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv_transpose(x, w, k=4, s=2, p=1) for thin out_ch, NHWC/HWIO;
    per pair where x has a pair axis (w per pair or shared)."""
    pairs, x1, w1, w_ps = pair_operands("head_convt", x, w)
    _check_args("head_convt", x1, w1)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return head_convt_plain(x, w)
    n, h, wd, ci = x1.shape
    co = w1.shape[3]
    if not 1 <= co <= MAX_CO:
        raise ValueError(f"head_convt: out channels {co} not in 1..{MAX_CO}")
    plan = head_entry_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index),
                           max(pairs, 1))
    if plan is None:
        raise ValueError(f"head_convt: no plan for x {tuple(x1.shape)} and {co} "
                         "out channels")
    _build.check_cuda_tensor("head_convt x", x)
    _build.check_cuda_tensor("head_convt w", w, dtype=x.dtype)
    y = torch.empty(*((pairs,) if pairs else ()), n, 2 * h, 2 * wd, co, dtype=x.dtype,
                    device=x.device)
    path, *fields = plan
    lib = _build.library()
    _build.launch("head_convt", lib.discogan_head_convt, x.data_ptr(),
                  w.data_ptr(), y.data_ptr(), n, h, wd, ci, co,
                  _build.DTYPE_CODES[x.dtype], HEAD_PATH_CODES[path], *fields,
                  max(pairs, 1), x1.numel(), w_ps, _build.stream_of(x))
    return y
