"""Encoder-decoder Generator (ref model.py:72-225) as an ``nn.Module``.

Encoder: stride-2 k=4 convs halving the map and doubling channels
(LeakyReLU(0.2) everywhere, BatchNorm on all but the first), then a 4x4
VALID conv to a 1x1 x 100 latent with BN + LeakyReLU. The decoder mirrors
it with transposed convs (BN + ReLU) and ends in a convT to 3 channels +
Sigmoid, output in [0,1]. At image_size=512 it is layer for layer the
reference model; depth otherwise follows image_size (models/geometry.py).

The module keeps the reference's ``encoder`` / ``decoder`` Sequentials,
so a reference-layout ``.pth`` loads with ``strict=True``. Activations are
NHWC, as in the JAX package. The forward is the eval form only (running
statistics; the train form comes with training), and it runs through the
kernels (ops/): per layer

  enc0              K3 conv, LeakyReLU epilogue
  enc1..            K5f (``takes_halo``: the wide, few-channel layer) or
                    K3, epilogue = folded eval BN + LeakyReLU
  latent conv       one matrix product, then K2 (BN + LeakyReLU)
  dec0 (1 -> 4)     one matrix product, then K2 (BN + ReLU)
  dec1..            F.conv_transpose2d, then K2 (BN + ReLU)
  head              K6 convT, then the sigmoid in f32

The kernels' operand copies (HWIO weights in the compute dtype, folded
BN scale/offset in f32) are derived once per dtype and device, at the
first forward after the weights were loaded or moved.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import F32, Policy
from ..ops.activations import sigmoid
from ..ops.batchnorm import batchnorm, fold_eval_bn
from ..ops.conv import (conv_transpose2d, init_conv_, latent_conv,
                        latent_conv_transpose)
from ..ops.conv_k4s2p1 import conv2d_k4s2p1, conv2d_k4s2p1_plain
from ..ops.fused import bn_act, bn_act_plain
from ..ops.halo_conv import (halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain,
                             takes_halo)
from ..ops.head import head_convt, head_convt_plain
from .geometry import KERNEL, LATENT_CH, encoder_channels

# The kernels' wrappers, and their plain versions for comparison runs.
KERNEL_OPS = {"conv": conv2d_k4s2p1, "halo": halo_conv2d_k4s2p1,
              "bn_act": bn_act, "head": head_convt}
PLAIN_OPS = {"conv": conv2d_k4s2p1_plain, "halo": halo_conv2d_k4s2p1_plain,
             "bn_act": bn_act_plain, "head": head_convt_plain}


def enc_conv_index(i: int) -> int:
    """encoder Sequential: [conv, lrelu], then (conv, bn, lrelu) groups."""
    return 0 if i == 0 else 2 + 3 * (i - 1)


def enc_bn_index(i: int) -> int:
    return 3 + 3 * (i - 1)


class Generator(nn.Module):
    def __init__(self, image_size: int = 512, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        chans = encoder_channels(image_size)
        enc: list[nn.Module] = [
            nn.Conv2d(3, chans[0], KERNEL, 2, 1, bias=False),
            nn.LeakyReLU(0.2, inplace=True),
        ]
        for prev, c in zip(chans[:-1], chans[1:]):
            enc += [nn.Conv2d(prev, c, KERNEL, 2, 1, bias=False), batchnorm(c),
                    nn.LeakyReLU(0.2, inplace=True)]
        enc += [nn.Conv2d(chans[-1], LATENT_CH, KERNEL, 1, 0, bias=False),
                batchnorm(LATENT_CH), nn.LeakyReLU(0.2, inplace=True)]
        self.encoder = nn.Sequential(*enc)

        dec: list[nn.Module] = [
            nn.ConvTranspose2d(LATENT_CH, chans[-1], KERNEL, 1, 0, bias=False),
            batchnorm(chans[-1]), nn.ReLU(True),
        ]
        rev = list(reversed(chans))
        for prev, c in zip(rev[:-1], rev[1:]):
            dec += [nn.ConvTranspose2d(prev, c, KERNEL, 2, 1, bias=False),
                    batchnorm(c), nn.ReLU(True)]
        dec += [nn.ConvTranspose2d(chans[0], 3, KERNEL, 2, 1, bias=False),
                nn.Sigmoid()]
        self.decoder = nn.Sequential(*dec)

        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                init_conv_(m, generator)
        self.n_halvings = len(chans)
        self._derived: dict = {}
        self.eval()

    # -- derived operand copies -------------------------------------------

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._derived.clear()
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def _apply(self, fn, *args, **kwargs):
        self._derived = {}
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def _operands(self, dtype: torch.dtype) -> dict:
        key = (dtype, self.encoder[0].weight.device)
        if key not in self._derived:
            self._derived[key] = self._derive(dtype)
        return self._derived[key]

    def _derive(self, dtype: torch.dtype) -> dict:
        def bn(m):
            return fold_eval_bn(m.weight, m.bias, m.running_mean,
                                m.running_var, m.eps)

        def hwio(conv):  # (O,I,kh,kw) -> (kh,kw,I,O)
            return conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()

        enc = []
        for i in range(self.n_halvings):
            conv = self.encoder[enc_conv_index(i)]
            affine = bn(self.encoder[enc_bn_index(i)]) if i > 0 else (None, None)
            enc.append((hwio(conv), *affine))
        li = self.n_halvings
        latent_w = hwio(self.encoder[enc_conv_index(li)])
        latent = (latent_w.reshape(-1, latent_w.shape[-1]),
                  *bn(self.encoder[enc_bn_index(li)]))
        dec0 = self.decoder[0].weight  # (I, O, 4, 4) -> (I, 4*4*O)
        dec = [(dec0.permute(0, 2, 3, 1).reshape(dec0.shape[0], -1)
                .to(dtype).contiguous(), *bn(self.decoder[1]))]
        n_dec = self.n_halvings + 1
        for j in range(1, n_dec - 1):  # channels-last, as cuDNN takes it
            w = self.decoder[3 * j].weight.to(dtype)
            dec.append((w.contiguous(memory_format=torch.channels_last),
                        *bn(self.decoder[3 * j + 1])))
        head = self.decoder[3 * (n_dec - 1)].weight  # (I,O,kh,kw) -> HWIO
        return {"enc": enc, "latent": latent, "dec": dec,
                "head": head.permute(2, 3, 0, 1).to(dtype).contiguous()}

    # -- forward ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, policy: Policy = F32,
                plain: bool = False) -> torch.Tensor:
        """x: (N,H,W,3) in [0,1] -> (N,H,W,3) float32 in [0,1].

        plain=True runs the kernels' plain PyTorch versions instead, for
        holding the kernels' path against them on the card."""
        if self.training:
            raise RuntimeError("Generator: the train-mode forward is not "
                               "ported yet; call .eval()")
        ops = PLAIN_OPS if plain else KERNEL_OPS
        p = self._operands(policy.compute_dtype)
        h = x.to(policy.compute_dtype).contiguous()
        for w, scale, offset in p["enc"]:
            conv = ops["halo"] if takes_halo(h, w) else ops["conv"]
            h = conv(h, w, scale=scale, offset=offset, act="leaky")
        w, scale, offset = p["latent"]
        h = ops["bn_act"](latent_conv(h, w), scale, offset, "leaky")
        for j, (w, scale, offset) in enumerate(p["dec"]):
            h = (latent_conv_transpose(h, w) if j == 0
                 else conv_transpose2d(h, w))
            h = ops["bn_act"](h, scale, offset, "relu")
        h = ops["head"](h, p["head"])
        return sigmoid(h.float())
