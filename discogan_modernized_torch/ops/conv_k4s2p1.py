"""The k4/s2/p1 halving conv with its fused scale/offset/act epilogue
(kernel K3, csrc/conv_k4s2p1.cu), the port of the JAX package's
``conv2d_k4s2p1`` forward.

x (N,H,W,I) NHWC, w (4,4,I,O) HWIO, even H and W; returns
act(conv(x, w) * scale + offset) of shape (N,H/2,W/2,O) in x's dtype, with
f32 accumulation and an f32 epilogue. scale/offset are per-channel and
optional (inference-form BN); act is None, "relu" or "leaky" (0.2).
A CPU tensor takes ``conv2d_k4s2p1_plain``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

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


def conv2d_k4s2p1_plain(x, w, *, scale=None, offset=None, act=None):
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
    if scale is not None:
        acc = acc * scale.float() + offset.float()
    return apply_act(acc, act).to(x.dtype)


def conv2d_k4s2p1(x, w, *, scale=None, offset=None, act=None):
    """y = act(conv(x, w, k=4, s=2, p=1) * scale + offset), NHWC/HWIO."""
    check_conv_args("conv2d_k4s2p1", x, w, scale, offset)
    code = act_code(act)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return conv2d_k4s2p1_plain(x, w, scale=scale, offset=offset, act=act)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    _build.check_cuda_tensor("conv2d_k4s2p1 x", x)
    _build.check_cuda_tensor("conv2d_k4s2p1 w", w, dtype=x.dtype)
    sp, op = affine_pointers("conv2d_k4s2p1", scale, offset, co)
    y = torch.empty(n, h // 2, wd // 2, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    dt = _build.DTYPE_CODES[x.dtype]
    # f32 partial sums of the split-K tensor-core path (deep layers)
    ws_len = lib.discogan_conv_k4s2p1_workspace(n, h, wd, ci, co, dt)
    ws = (torch.empty(ws_len, dtype=torch.float32, device=x.device)
          if ws_len else None)
    _build.launch("conv_k4s2p1", lib.discogan_conv_k4s2p1, x.data_ptr(),
                  w.data_ptr(), sp, op, y.data_ptr(),
                  ws.data_ptr() if ws is not None else None, n, h, wd, ci, co,
                  code, dt, _build.stream_of(x))
    return y
