"""Eval-form BatchNorm + activation in one elementwise pass (kernel K2,
csrc/bn_act.cu), the port of the JAX package's ``fused_batchnorm_act``.

``bn_act`` applies y = act(x * scale + offset) per channel of NHWC x, in
f32, stored in x's dtype; ``fused_batchnorm_act`` folds running statistics
into (scale, offset) first. A CPU tensor takes ``bn_act_plain``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import act_code, apply_act
from .batchnorm import BN_EPS, fold_eval_bn


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 act: str | None = None) -> torch.Tensor:
    y = x.float() * scale.float() + offset.float()
    return apply_act(y, act).to(x.dtype)


def bn_act(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
           act: str | None = None) -> torch.Tensor:
    """y = act(x * scale + offset) over the last (channel) axis of x."""
    code = act_code(act)
    if x.device.type == "cpu":
        return bn_act_plain(x, scale, offset, act)
    c = x.shape[-1]
    _build.check_cuda_tensor("bn_act x", x)
    for name, t in (("scale", scale), ("offset", offset)):
        _build.check_cuda_tensor(f"bn_act {name}", t, dtype=torch.float32,
                                 ndim=1)
        if t.shape[0] != c:
            raise ValueError(f"bn_act {name}: {tuple(t.shape)} for {c} channels")
    y = torch.empty_like(x)
    lib = _build.library()
    _build.launch("bn_act", lib.discogan_bn_act, x.data_ptr(),
                  scale.data_ptr(), offset.data_ptr(), y.data_ptr(),
                  x.numel(), c, code, _build.DTYPE_CODES[x.dtype],
                  _build.stream_of(x))
    return y


def fused_batchnorm_act(x, mean, var, gamma, beta, *, eps: float = BN_EPS,
                        act: str | None = "leaky_relu"):
    """normalize + affine + activation with given statistics, one pass.

    x: (N,H,W,C); mean/var/gamma/beta: (C,). act: leaky_relu|relu|none."""
    scale, offset = fold_eval_bn(gamma, beta, mean, var, eps)
    return bn_act(x, scale, offset, act)
