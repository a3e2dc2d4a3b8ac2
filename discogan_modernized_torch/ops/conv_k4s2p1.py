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
``conv2d_k4s2p1_dw`` returns dw[kh,kw,i,o] = sum x_pad[b,2r+kh,2c+kw,i] *
dy[b,r,c,o], f32 accumulation, in x's dtype.
A CPU tensor takes the ``_plain`` version; a CUDA tensor launches the
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
    y = torch.empty(n, h // 2, wd // 2, co, dtype=x.dtype, device=x.device)
    stats = (torch.empty(2, co, dtype=torch.float32, device=x.device)
             if with_stats else None)
    lib = _build.library()
    dt = _build.DTYPE_CODES[x.dtype]
    # f32 split-K partial sums (deep layers) and partial rows of the stats
    ws = _build.workspace(lib.discogan_conv_k4s2p1_workspace(
        n, h, wd, ci, co, dt, int(with_stats)), x)
    _build.launch("conv_k4s2p1", lib.discogan_conv_k4s2p1, x.data_ptr(),
                  w.data_ptr(), sp, op, y.data_ptr(), _build.ptr(ws),
                  _build.ptr(stats), n, h, wd, ci, co, code, dt,
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


def conv2d_k4s2p1_dw(x, dy):
    """Weight gradient of ``conv2d_k4s2p1``: (4,4,I,O) in x's dtype."""
    check_dw_args("conv2d_k4s2p1_dw", x, dy)
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return conv2d_k4s2p1_dw_plain(x, dy)
    return launch_dw("conv_k4s2p1_dw", x, dy)


def launch_dw(kernel: str, x, dy):
    """Launch K4 or K5b (the same C signature) into a new (4,4,I,O)."""
    n, h, wd, ci = x.shape
    co = dy.shape[3]
    _build.check_cuda_tensor(f"{kernel} x", x)
    _build.check_cuda_tensor(f"{kernel} dy", dy, dtype=x.dtype)
    dw = torch.empty(4, 4, ci, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    dt = _build.DTYPE_CODES[x.dtype]
    fn = getattr(lib, f"discogan_{kernel}")
    ws_args = (n, h, wd, ci, co) + ((dt,) if kernel == "conv_k4s2p1_dw" else ())
    ws = _build.workspace(getattr(lib, f"discogan_{kernel}_workspace")(*ws_args), x)
    _build.launch(kernel, fn, x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                  _build.ptr(ws), n, h, wd, ci, co, dt, _build.stream_of(x))
    return dw
