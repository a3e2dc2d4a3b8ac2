"""BatchNorm's two elementwise/reduction passes, the port of the JAX
package's ``ops/pallas_fused.py``:

- ``batch_stats`` (kernel K1, csrc/batch_stats.cu): per-channel mean and
  biased variance of NHWC x in f32, one pass over E[x] and E[x^2] with
  var = max(E[x^2] - E[x]^2, 0), for train-mode BatchNorm;
- ``bn_act`` (kernel K2, csrc/bn_act.cu): y = act(x * scale + offset) per
  channel, in f32, stored in x's dtype; ``fused_batchnorm_act`` folds
  given statistics into (scale, offset) first.

A CPU tensor takes the plain version (``batch_stats_plain``,
``bn_act_plain``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .activations import act_code, apply_act
from .batchnorm import BN_EPS, fold_bn


def batch_stats_plain(x: torch.Tensor):
    """(mean, biased var) over all but the last axis, f32, one pass."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    mean = x2.mean(0)
    return mean, torch.clamp_min(x2.square().mean(0) - mean.square(), 0.0)


def batch_stats(x: torch.Tensor):
    """Per-channel (mean, biased var) of NHWC ``x`` as f32 (C,), (C,)."""
    if x.device.type == "cpu":
        return batch_stats_plain(x)
    c = x.shape[-1]
    rows = x.numel() // c
    _build.check_cuda_tensor("batch_stats x", x)
    stats = torch.empty(2, c, dtype=torch.float32, device=x.device)
    lib = _build.library()
    ws = _build.workspace(lib.discogan_batch_stats_workspace(rows, c), x)
    _build.launch("batch_stats", lib.discogan_batch_stats, x.data_ptr(),
                  _build.ptr(ws), stats[0].data_ptr(), stats[1].data_ptr(),
                  rows, c, _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    return stats[0], stats[1]


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
    scale, offset = fold_bn(gamma, beta, mean, var, eps)
    return bn_act(x, scale, offset, act)
