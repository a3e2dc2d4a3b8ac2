"""The generator head: ConvTranspose2d(k=4, s=2, p=1) to a thin output
(kernel K6, csrc/head_convt.cu), the port of the JAX package's
``head_convt_fwd``.

x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO with I = the convT's input channels
(torch's (I,O,kh,kw) weight by transpose(2,3,0,1)); returns (N,2H,2W,CO)
in x's dtype, f32 accumulation. The kernel takes CO <= 8. A CPU tensor
takes ``head_convt_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_CO = 8
STAGED_FLOATS = 3 * 258 * 17  # the kernel's staged input rows
MAX_SMEM_BYTES = 232448       # a block's shared memory on the H100


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
    if (16 * ci * co + STAGED_FLOATS) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"head_convt: weight of {ci}x{co} does not fit in "
                         "shared memory")
    _build.check_cuda_tensor("head_convt x", x)
    _build.check_cuda_tensor("head_convt w", w, dtype=x.dtype)
    y = torch.empty(n, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.launch("head_convt", lib.discogan_head_convt, x.data_ptr(),
                  w.data_ptr(), y.data_ptr(), n, h, wd, ci, co,
                  _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    return y
