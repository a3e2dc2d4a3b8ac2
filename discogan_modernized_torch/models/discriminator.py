"""PatchGAN-to-scalar Discriminator (ref model.py:5-69) as an ``nn.Module``.

Stride-2 k=4 convs, the generator encoder's trunk (BatchNorm + LeakyReLU
(0.2) on all but the first), then a 4x4 VALID conv to one channel and a
Sigmoid: a (N,1,1,1) probability. The forward returns (prob, features),
where the features are the LeakyReLU outputs of the BatchNorm'd convs, six
at 512px: the list model.py:69 feeds the feature-matching loss.

The module is in the reference layout (attributes conv1..conv{n+1},
bn2..bn{n}), so its ``state_dict`` is the reference's. Activations are
NHWC. Per layer, as in the generator's encoder (models/generator.py):

  conv1             K3, LeakyReLU epilogue
  conv2..           train: K3 with its fused statistics, or K5f then K1;
                    then K2 (BN + LeakyReLU). eval: K3 or K5f with the
                    folded running statistics in the epilogue
  conv{n+1}         one matrix product, then the sigmoid in f32
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import F32, Policy
from ..ops.activations import sigmoid
from ..ops.autograd import (KERNEL_OPS, PLAIN_OPS, conv, conv_batch_stats,
                            train_bn_act)
from ..ops.batchnorm import batchnorm, fold_bn
from ..ops.conv import init_conv_, latent_conv
from ..ops.halo_conv import takes_halo
from .geometry import KERNEL, encoder_channels


class Discriminator(nn.Module):
    def __init__(self, image_size: int = 512, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        chans = encoder_channels(image_size)
        self.n = len(chans)
        in_ch = 3
        for i, c in enumerate(chans):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(in_ch, c, KERNEL, 2, 1, bias=False))
            if i > 0:
                setattr(self, f"bn{i + 1}", batchnorm(c))
            in_ch = c
        setattr(self, f"conv{self.n + 1}",
                nn.Conv2d(chans[-1], 1, KERNEL, 1, 0, bias=False))
        for i in range(1, self.n + 2):
            init_conv_(getattr(self, f"conv{i}"), generator)
        self.eval()

    def _hwio(self, i: int, dtype: torch.dtype) -> torch.Tensor:
        """conv{i}'s (O,I,kh,kw) weight as (kh,kw,I,O) in ``dtype``."""
        w = getattr(self, f"conv{i}").weight
        return w.permute(2, 3, 1, 0).to(dtype).contiguous()

    def forward(self, x: torch.Tensor, *, policy: Policy = F32,
                plain: bool = False):
        """x: (N,H,W,3) -> (prob (N,1,1,1) float32, features).

        The train form normalizes with batch statistics, advances the
        running statistics and keeps the autograd graph; the eval form runs
        without a graph on the running statistics. plain=True runs the
        kernels' plain PyTorch versions instead."""
        ops = PLAIN_OPS if plain else KERNEL_OPS
        cd = policy.compute_dtype
        if not self.training:
            with torch.no_grad():
                return self._eval_forward(x, cd, ops)
        h = conv(x.to(cd).contiguous(), self._hwio(1, cd), ops, act="leaky")
        feats = []
        for i in range(2, self.n + 1):
            bn = getattr(self, f"bn{i}")
            h = train_bn_act(bn, *conv_batch_stats(h, self._hwio(i, cd), ops),
                             "leaky", ops)
            feats.append(h)
        return self._head(h, cd), feats

    def _eval_forward(self, x, cd, ops):
        h = ops["conv"](x.to(cd).contiguous(), self._hwio(1, cd), act="leaky")
        feats = []
        for i in range(2, self.n + 1):
            bn = getattr(self, f"bn{i}")
            w = self._hwio(i, cd)
            scale, offset = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps)
            conv_op = ops["halo"] if takes_halo(h, w) else ops["conv"]
            h = conv_op(h, w, scale=scale, offset=offset, act="leaky")
            feats.append(h)
        return self._head(h, cd), feats

    def _head(self, h, cd):
        w = self._hwio(self.n + 1, cd)
        logits = latent_conv(h, w.reshape(-1, 1))
        return sigmoid(logits.float())
