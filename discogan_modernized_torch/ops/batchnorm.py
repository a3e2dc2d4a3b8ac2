"""BatchNorm with torch ``nn.BatchNorm2d`` semantics (ref model.py:12-32,
:84-176): eps 1e-5, momentum 0.1, scale 1, bias 0, running mean 0 and
running var 1 at init.

Either form is one per-channel affine map, (scale, offset) =
(gamma * rsqrt(var + eps), beta - mean * scale) in f32 (``fold_bn``),
which the kernels apply inside a conv epilogue (ops/conv_k4s2p1.py,
ops/halo_conv.py) or as one elementwise pass (ops/fused.py):

- eval mode folds the running statistics;
- train mode (``batchnorm_train``) folds the batch statistics, biased
  var = max(E[x^2] - E[x]^2, 0) from one pass (K3's fused output or K1),
  inside the autograd graph so gamma and beta get gradients, and advances
  the running statistics in place: running = (1 - m) * running + m * batch
  with the unbiased var * n / (n - 1), and num_batches_tracked += 1 (the
  JAX package's ``count``); not while a rematerialized region rebuilds its
  forward (ops/recompute.py), which would advance them twice.
"""

from __future__ import annotations

import torch
from torch import nn

from . import recompute

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batchnorm(ch: int) -> nn.BatchNorm2d:
    """A BatchNorm2d with the reference's settings (the torch defaults)."""
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def fold_bn(gamma, beta, mean, var, eps: float = BN_EPS):
    """(scale, offset) = (gamma * rsqrt(var + eps), beta - mean * scale), f32."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    offset = beta.float() - mean.float() * scale
    return scale, offset


def batchnorm_train(bn: nn.BatchNorm2d, mean, var, count: int):
    """Train form: advance ``bn``'s running statistics in place with the
    batch statistics (mean, biased var) of ``count`` values per channel,
    and return the (scale, offset) that normalizes with them. Like
    nn.BatchNorm2d, it refuses one value per channel. A region's
    rebuilt forward only returns the (scale, offset)."""
    advance_running_stats(bn, mean, var, count)
    return fold_bn(bn.weight, bn.bias, mean, var, bn.eps)


def advance_running_stats(bn: nn.BatchNorm2d, mean, var, count: int) -> None:
    """``batchnorm_train``'s update of the running statistics (none while a
    region rebuilds its forward); refuses one value per channel."""
    if count <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got {count}")
    if recompute.recomputing():
        return
    with torch.no_grad():
        m = bn.momentum
        unbiased = var * (count / max(count - 1, 1))
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var + m * unbiased)
        bn.num_batches_tracked.add_(1)
