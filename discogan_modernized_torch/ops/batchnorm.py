"""BatchNorm with torch ``nn.BatchNorm2d`` eval semantics (ref
model.py:12-32, :84-176): eps 1e-5, scale 1, bias 0, running mean 0 and
running var 1 at init.

Eval mode normalizes with the running statistics, which is one per-channel
affine map: ``fold_eval_bn`` turns (gamma, beta, mean, var) into its
(scale, offset) in f32, and the kernels apply it inside a conv epilogue
(ops/conv_k4s2p1.py, ops/halo_conv.py) or as one elementwise pass
(ops/fused.py). The train form, with batch statistics and the running
update, is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batchnorm(ch: int) -> nn.BatchNorm2d:
    """A BatchNorm2d with the reference's settings (the torch defaults)."""
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def fold_eval_bn(gamma, beta, mean, var, eps: float = BN_EPS):
    """(scale, offset) = (gamma * rsqrt(var + eps), beta - mean * scale), f32."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    offset = beta.float() - mean.float() * scale
    return scale, offset
