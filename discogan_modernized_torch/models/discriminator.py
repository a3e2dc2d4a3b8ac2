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

``discriminator_train`` runs the train form for one discriminator, or for
two at once on a pair axis (one kernel launch a layer for both, each
member with its own weights and BatchNorm), in the rematerialized regions
of ``remat`` (models/regions.py), on a mesh's shards where the ops table
holds one (ops/sharding.py; the features are whole maps). ``forward_pair`` is the JAX package's
``discriminator_apply_pair``: one discriminator's real and fake forwards
as one pass, the two halves on the pair axis, BatchNorm statistics per
half.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import F32, Policy
from ..ops.activations import sigmoid
from ..ops.autograd import mm_fn, train_ops
from ..ops.batchnorm import batchnorm, fold_bn
from ..ops.conv import init_conv_, latent_conv
from ..ops.halo_conv import takes_halo
from ..ops.sharding import conv_layer, mesh_of, to_band, whole
from .geometry import KERNEL, encoder_channels
from .regions import materialize, run_regions


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

    def _weight_views(self) -> list:
        """conv1..conv{n+1}'s (O,I,kh,kw) weights as (kh,kw,I,O) views."""
        return [getattr(self, f"conv{i}").weight.permute(2, 3, 1, 0)
                for i in range(1, self.n + 2)]

    def _hwio(self, i: int, dtype: torch.dtype) -> torch.Tensor:
        """conv{i}'s (O,I,kh,kw) weight as (kh,kw,I,O) in ``dtype``."""
        return materialize([self._weight_views()[i - 1]], dtype)

    def forward(self, x: torch.Tensor, *, policy: Policy = F32,
                plain: bool = False, remat: str | None = None, stats_dp=None):
        """x: (N,H,W,3) -> (prob (N,1,1,1) float32, features).

        The train form normalizes with batch statistics (over the ranks of
        ``stats_dp``, a parallel.DataParallel, where given), advances the
        running statistics and keeps the autograd graph, in the regions of
        ``remat``; the eval form runs without a graph on the running
        statistics. plain=True runs the kernels' plain PyTorch versions
        instead."""
        ops = train_ops(plain, stats_dp)
        if not self.training:
            with torch.no_grad():
                return self._eval_forward(x, policy.compute_dtype, ops)
        return discriminator_train((self,), x, policy, ops, remat)

    def forward_pair(self, x_real: torch.Tensor, x_fake: torch.Tensor, *,
                     policy: Policy = F32, plain: bool = False,
                     remat: str | None = None, stats_dp=None):
        """Both train forwards of this discriminator, real then fake, as
        one pass over the two halves on a pair axis, BatchNorm statistics
        per half: each layer's running statistics take the real update,
        then the fake one, as the two sequential forwards give them.
        Returns ((prob_real, feats_real), (prob_fake, feats_fake)).

        Where no parameter takes a gradient (a G step), both halves read
        one copy of the weights (pair stride 0); else each half has its
        own copy, so that each half's weight gradient reaches the f32
        parameter on its own and they add there, as the sequential
        forwards' do (summed before, in the compute dtype, they would
        round)."""
        ops = train_ops(plain, stats_dp)
        shared = not any(p.requires_grad for p in self.parameters())
        x_real, x_fake = (to_band(x, mesh_of(ops)) for x in (x_real, x_fake))
        prob, feats = discriminator_train((self, self), torch.stack([x_real, x_fake]),
                                          policy, ops, remat, shared=shared)
        return (prob[0], [f[0] for f in feats]), (prob[1], [f[1] for f in feats])

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


def discriminator_weights(dises, dtype: torch.dtype, shared: bool = False) -> list:
    """The layers' HWIO weights in ``dtype``: one discriminator's, or a
    pair's (each member's written into its slice), or, ``shared``, one copy
    of the first member's for every pair."""
    views = [d._weight_views() for d in (dises[:1] if shared else dises)]
    return materialize(views, dtype)


def discriminator_train(dises, x, policy: Policy, ops, remat: str | None = None,
                        shared: bool = False):
    """The train form of one discriminator (``dises`` = (d,), NHWC x), or
    of two on a pair axis (x (2,N,H,W,3), pair p through ``dises[p]``, with
    one copy of the weights where ``shared``), in the regions of
    ``remat``. Returns (prob, features), each with x's pair axis."""
    cd = policy.compute_dtype
    n = dises[0].n
    bns = [tuple(getattr(d, f"bn{i}") for d in dises) if len(dises) > 1
           else getattr(dises[0], f"bn{i}") for i in range(2, n + 1)]

    def weights():
        return discriminator_weights(dises, cd, shared)

    mp = mesh_of(ops)

    def whole_net(x, w=None):
        w = weights() if w is None else w
        h = conv_layer(x, w[0], None, "leaky", ops)
        feats = []
        for wi, bn in zip(w[1:-1], bns):
            h = conv_layer(h, wi, bn, "leaky", ops)
            feats.append(whole(h, mp))
        h = feats[-1] if feats else whole(h, mp)
        lead, head = h.shape[:-3], w[-1]
        logits = mm_fn(h.reshape(*lead, -1), head.reshape(*head.shape[:-4], -1, 1))
        return sigmoid(logits.reshape(*lead, 1, 1, 1).float()), feats

    return run_regions(remat, to_band(x, mp).to(cd).contiguous(), whole_net, weights)
