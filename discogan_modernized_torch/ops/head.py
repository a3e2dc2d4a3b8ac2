"""The generator head: ConvTranspose2d(k=4, s=2, p=1) to a thin output
(kernel K6, csrc/head_convt.cu), the port of the JAX package's
``head_convt_fwd``.

x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO with I = the convT's input channels
(torch's (I,O,kh,kw) weight by transpose(2,3,0,1)); returns (N,2H,2W,CO)
in x's dtype, f32 accumulation. The kernel takes CO <= 8. On the card K6
has two paths, picked here by dtype and shape: bf16 with CI % 16 == 0,
16 <= CI <= 128 takes the tensor-core kernel with the tile plan of
``head_plan``; f32 and the other shapes take the f32-FMA kernel. A CPU
tensor takes ``head_convt_plain``; a CUDA tensor launches a kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_k4s2p1 import H100_SMS, MAX_SMEM_BYTES, _sm_count

MAX_CO = 8
STAGED_FLOATS = 3 * 258 * 17  # the FMA kernel's staged input rows
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

__all__ = ["head_convt", "head_convt_plain", "head_plan", "HeadPlan"]


class HeadPlan(NamedTuple):
    rows: int        # input rows per block (the last band may hold fewer)
    bands: int       # blocks down the map
    strips: int      # blocks across the map
    slots: int       # input rows in the ring
    smem_bytes: int
    blocks: int      # the grid: images x bands x strips


def tc_np(co: int) -> int:
    """B's columns: the 4 * CO phases and channels, padded to a wgmma width."""
    return 16 if co <= 4 else 32


def tc_smem_bytes(ci: int, co: int, slots: int) -> int:
    planes = -(-ci // 64)
    return (9 * planes * tc_np(co) * 128
            + slots * planes * 2 * TC_WG_PIXELS * TC_PIXEL_BYTES
            + 4 * (128 * co + 16) * 2)


def head_plan(n: int, h: int, w: int, ci: int, co: int, dtype,
              sms: int = H100_SMS) -> HeadPlan | None:
    """The tensor-core path's tile plan for x (n,h,w,ci) and CO output
    channels, or None where that path does not take the shape (f32,
    CI % 16 != 0, CI outside 16..128, CO outside 1..8). The ring holds 5
    rows where that fits a block's shared memory, else 4. Rows per band are
    as few as keep the grid within one wave of ``sms`` SMs holding as many
    blocks each as fit (two at most): each band pays B's build and two halo
    rows once, so fewer, longer bands cost less, and one wave of equal
    blocks ends together."""
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
    return HeadPlan(rows, bands, strips, slots, smem, n * bands * strips)


def _check_args(fn, x, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not NHWC and (4,4,I,O)")


def head_convt_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four-class subpixel form: with wf = w flipped spatially, output
    (2i+a, 2j+b) = sum_{u,v} x_pad[i+a+u, j+b+v] @ wf[a+2u, b+2v]."""
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
    """y = conv_transpose(x, w, k=4, s=2, p=1) for thin out_ch, NHWC/HWIO."""
    _check_args("head_convt", x, w)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return head_convt_plain(x, w)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    if not 1 <= co <= MAX_CO:
        raise ValueError(f"head_convt: out channels {co} not in 1..{MAX_CO}")
    plan = head_plan(n, h, wd, ci, co, x.dtype, _sm_count(x.device.index))
    if plan is None and (16 * ci * co + STAGED_FLOATS) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"head_convt: weight of {ci}x{co} does not fit in "
                         "shared memory")
    _build.check_cuda_tensor("head_convt x", x)
    _build.check_cuda_tensor("head_convt w", w, dtype=x.dtype)
    y = torch.empty(n, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    rows, bands, strips, slots, smem, _ = plan or (0, 0, 0, 0, 0, 0)
    lib = _build.library()
    _build.launch("head_convt", lib.discogan_head_convt, x.data_ptr(),
                  w.data_ptr(), y.data_ptr(), n, h, wd, ci, co,
                  _build.DTYPE_CODES[x.dtype], rows, bands, strips, slots,
                  smem, _build.stream_of(x))
    return y
