"""Convolution init and the plain conv layers that have no Pallas kernel.

Initialization reproduces the torch defaults the reference relies on (it
never sets a custom init): U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with
fan_in = in_ch*k*k for Conv2d and, the ConvTranspose2d quirk,
out_ch*k*k (weight.size(1) * receptive field), drawn from a
``torch.Generator`` by ``init_conv_``.

Activations are NHWC, as in the JAX package. The layers here are the ones
XLA carried there, and plain PyTorch carries here:
- the 4x4 VALID conv from the last encoder map to the 1x1 latent and the
  1 -> 4 VALID convT back, both a single matrix product;
- the wide k4/s2/p1 convTs of the decoder, through F.conv_transpose2d on a
  channels-last view.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def init_conv_(module: nn.Conv2d | nn.ConvTranspose2d,
               generator: torch.Generator | None = None) -> None:
    """Fill a module's weight with the torch-default uniform init.

    weight.size(1) * k * k is the fan_in torch uses for both module types,
    which is what gives ConvTranspose2d its out_ch quirk."""
    w = module.weight
    b = 1.0 / math.sqrt(w.size(1) * w.size(2) * w.size(3))
    w.uniform_(-b, b, generator=generator)


def latent_conv(x: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """4x4 VALID conv of NHWC (N,4,4,C) to (N,1,1,O) as one product with
    w_mat (16*C, O), the HWIO weight flattened."""
    n = x.shape[0]
    return torch.matmul(x.reshape(n, -1), w_mat).reshape(n, 1, 1, -1)


def latent_conv_transpose(x: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """1 -> 4 VALID convT of NHWC (N,1,1,I) to (N,4,4,O) as one product with
    w_mat (I, 16*O), the torch (I,O,4,4) weight permuted to (I,4,4,O)."""
    n = x.shape[0]
    return torch.matmul(x.reshape(n, -1), w_mat).reshape(n, 4, 4, -1)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """ConvTranspose2d(k, stride, padding, bias=False) of NHWC ``x`` with a
    torch-layout weight (I,O,k,k); NHWC out."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride,
                           padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()
