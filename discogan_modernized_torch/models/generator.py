"""Encoder-decoder Generator (ref model.py:72-225) as an ``nn.Module``.

Encoder: stride-2 k=4 convs halving the map and doubling channels
(LeakyReLU(0.2) everywhere, BatchNorm on all but the first), then a 4x4
VALID conv to a 1x1 x 100 latent with BN + LeakyReLU. The decoder mirrors
it with transposed convs (BN + ReLU) and ends in a convT to 3 channels +
Sigmoid, output in [0,1]. At image_size=512 it is layer for layer the
reference model; depth otherwise follows image_size (models/geometry.py).

The module keeps the reference's ``encoder`` / ``decoder`` Sequentials,
so a reference-layout ``.pth`` loads with ``strict=True``. Activations are
NHWC, as in the JAX package. Both forms run through the kernels (ops/):

  layer             eval form (running statistics)   train form (batch statistics)
  enc0              K3, LeakyReLU epilogue           the same
  enc1..            K5f (``takes_halo``: the wide,   K3 with its fused statistics,
                    few-channel layer) or K3,        or K5f then K1; then K2
                    epilogue = folded BN + LeakyReLU (BN + LeakyReLU)
  latent conv       one matrix product, then K2      the product, K1, K2
  dec0 (1 -> 4)     one matrix product, then K2      the product, K1, K2
  dec1..            F.conv_transpose2d, then K2      F.conv_transpose2d, K1, K2
  head              K6 convT, then the sigmoid in f32

The eval form reaches K2, K3, K5f and K6 through their registered
``discogan::`` ops (ops/library.py: the CUDA implementation launches the
kernel, the CPU one runs its plain version), so ``torch.export`` of it
records the kernels (tools/export_model.py); the train form calls the
wrappers from ops/autograd.py's functions.

The train form runs under autograd (ops/autograd.py: K4 / K5b weight
gradients, K6 for the stem's input gradient) and advances the BN running
statistics in place. ``generator_train`` runs it for one generator, or for
two at once on a pair axis ((2,N,H,W,3): one kernel launch a layer for
both, each member with its own weights and BatchNorm), on a mesh's shards
where the ops table holds one (ops/sharding.py: a whole x is cut into this
rank's band under spatial sharding, and the output is the band's); ``remat`` splits it
into rematerialized regions (train/graph.py's policies): "full" one region,
"latent" the encoder to the latent and the decoder, "conv" one region that
keeps every convolution's output and rebuilds only the BatchNorm and
activation chains (ops/recompute.py). The eval form runs without a graph, on operand
copies (HWIO weights in the compute dtype, folded BN scale/offset in f32)
derived once per dtype and device and re-derived whenever a parameter or
buffer has changed since (their ``_version`` counters, which every
in-place update raises: the optimizer step, ``load_state_dict``, a
train-mode forward).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import F32, Policy
from ..ops.activations import sigmoid
from ..ops.autograd import PLAIN_OPS, batch_stats_fn, mm_fn, train_bn_act, train_ops
from ..ops.batchnorm import batchnorm, fold_bn
from ..ops.conv import (conv_transpose2d, init_conv_, latent_conv,
                        latent_conv_transpose)
from ..ops.halo_conv import takes_halo
from ..ops.library import SERVING_OPS
from ..ops.sharding import (conv_layer, convt_layer, dec0_layer, head_layer, mesh_of,
                            to_band, whole)
from .geometry import KERNEL, LATENT_CH, encoder_channels
from .regions import materialize, run_regions


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

    # -- operands ----------------------------------------------------------

    def _apply(self, fn, *args, **kwargs):
        self._derived = {}
        return super()._apply(fn, *args, **kwargs)

    def _bn_layers(self) -> tuple[list, nn.Module, list]:
        """(encoder BNs of enc1.., the latent BN, decoder BNs of dec0..)."""
        n = self.n_halvings
        enc = [self.encoder[enc_bn_index(i)] for i in range(1, n)]
        dec = [self.decoder[3 * j + 1] for j in range(n)]
        return enc, self.encoder[enc_bn_index(n)], dec

    def _weight_views(self, part: str | None = None) -> dict:
        """The layers' weights as views of the parameters in the order the
        kernels and products store them: the encoder and the latent conv
        (O,I,kh,kw) -> HWIO, dec0 and the wide convTs (I,O,kh,kw) ->
        (I,kh,kw,O), the head -> HWIO. ``part``: "enc" (the encoder and the
        latent conv), "dec" (the rest) or None (all)."""
        n = self.n_halvings
        views = {}
        if part in (None, "enc"):
            views["enc"] = [self.encoder[enc_conv_index(i)].weight.permute(2, 3, 1, 0)
                            for i in range(n)]
            views["latent"] = self.encoder[enc_conv_index(n)].weight.permute(2, 3, 1, 0)
        if part in (None, "dec"):
            views["dec0"] = self.decoder[0].weight.permute(0, 2, 3, 1)
            views["dec"] = [self.decoder[3 * j].weight.permute(0, 2, 3, 1)
                            for j in range(1, n)]
            views["head"] = self.decoder[3 * n].weight.permute(2, 3, 0, 1)
        return views

    def _weights(self, dtype: torch.dtype, part: str | None = None) -> dict:
        """The layers' weights in the forms the kernels and products take,
        in ``dtype``: encoder HWIO, the latent conv as (16*C, 100), dec0 as
        (100, 16*C), the wide convTs channels-last (as cuDNN takes them),
        the head HWIO."""
        return generator_weights((self,), dtype, part)

    @torch.no_grad()
    def _operands(self, dtype: torch.dtype) -> dict:
        """Eval operands, re-derived when any parameter or buffer changed."""
        key = (dtype, self.encoder[0].weight.device)
        version = weights_version(self)
        if self._derived.get(key, (None,))[0] != version:
            self._derived[key] = (version, self._derive(dtype))
        return self._derived[key][1]

    def _derive(self, dtype: torch.dtype) -> dict:
        def bn(m):
            return fold_bn(m.weight, m.bias, m.running_mean, m.running_var,
                           m.eps)

        w = self._weights(dtype)
        enc_bn, latent_bn, dec_bn = self._bn_layers()
        enc = [(w["enc"][0], None, None)]
        enc += [(wi, *bn(m)) for wi, m in zip(w["enc"][1:], enc_bn)]
        dec = [(wj, *bn(m)) for wj, m in zip([w["dec0"], *w["dec"]], dec_bn)]
        return {"enc": enc, "latent": (w["latent"], *bn(latent_bn)),
                "dec": dec, "head": w["head"]}

    # -- forward ----------------------------------------------------------

    def forward(self, x: torch.Tensor, *, policy: Policy = F32,
                plain: bool = False, remat: str | None = None,
                stats_dp=None) -> torch.Tensor:
        """x: (N,H,W,3) in [0,1] -> (N,H,W,3) float32 in [0,1].

        The train form (``.train()``) normalizes with batch statistics
        (over the ranks of ``stats_dp``, a parallel.DataParallel, where
        given), advances the running statistics and keeps the autograd
        graph, in the regions of ``remat`` ("full", "latent", "conv"; None:
        none); the eval form runs without a graph. plain=True runs the
        kernels' plain PyTorch versions instead, for holding the kernels'
        path against them on the card."""
        if self.training:
            return generator_train((self,), x, policy, train_ops(plain, stats_dp), remat)
        with torch.no_grad():
            return self._eval_forward(x, policy, PLAIN_OPS if plain else SERVING_OPS)

    def _eval_forward(self, x, policy, ops):
        """The eval form through ``ops``: SERVING_OPS (the kernels as
        registered ``discogan::`` ops), KERNEL_OPS (their wrappers, called
        directly) or PLAIN_OPS."""
        return eval_forward(self._operands(policy.compute_dtype), x,
                            policy.compute_dtype, ops)


def eval_forward(p: dict, x: torch.Tensor, compute_dtype: torch.dtype, ops) -> torch.Tensor:
    """The eval form from ``Generator._operands``' dict ``p``: NHWC x in
    [0, 1] -> the image in [0, 1], f32. Routing between K3 and K5f is by
    shape (``takes_halo``)."""
    h = x.to(compute_dtype).contiguous()
    for w, scale, offset in p["enc"]:
        conv_op = ops["halo"] if takes_halo(h, w) else ops["conv"]
        h = conv_op(h, w, scale=scale, offset=offset, act="leaky")
    w, scale, offset = p["latent"]
    h = ops["bn_act"](latent_conv(h, w), scale, offset, "leaky")
    for j, (w, scale, offset) in enumerate(p["dec"]):
        h = (latent_conv_transpose(h, w) if j == 0
             else conv_transpose2d(h, w))
        h = ops["bn_act"](h, scale, offset, "relu")
    h = ops["head"](h, p["head"])
    return sigmoid(h.float())


def generator_weights(gens, dtype: torch.dtype, part: str | None = None) -> dict:
    """``Generator._weights`` of one generator, or of two on a pair axis,
    each member's permuted, cast weight written straight into its slice."""
    views = [g._weight_views(part) for g in gens]
    w = {k: materialize([v[k] for v in views], dtype) for k in views[0]}
    if "latent" in w:  # HWIO -> (16*C, O)
        w["latent"] = w["latent"].reshape(*w["latent"].shape[:-4], -1, LATENT_CH)
    if "dec0" in w:  # (I,4,4,O) -> (I, 16*O)
        w["dec0"] = w["dec0"].reshape(*w["dec0"].shape[:-3], -1)
    if "dec" in w:  # (I,4,4,O) -> (I,O,4,4), channels-last
        w["dec"] = [t.movedim(-1, -3) for t in w["dec"]]
    return w


def _encode(h, w, bns, ops):
    """The encoder and the latent conv: x in the compute dtype -> the
    latent after its BatchNorm and LeakyReLU. Under a mesh the layers run
    on shards (ops/sharding.py), and the latent's input is whole."""
    enc_bn, latent_bn, _ = bns
    h = conv_layer(h, w["enc"][0], None, "leaky", ops)
    for wi, bn in zip(w["enc"][1:], enc_bn):
        h = conv_layer(h, wi, bn, "leaky", ops)
    h = whole(h, mesh_of(ops))
    lead = h.shape[:-3]
    y = mm_fn(h.reshape(*lead, -1), w["latent"]).reshape(*lead, 1, 1, -1)
    return train_bn_act(latent_bn, y, *batch_stats_fn(y, ops), "leaky", ops)


def _decode(h, w, bns, ops):
    """The decoder and the head: the latent -> the image in [0, 1], f32
    (under spatial sharding this rank's band of it)."""
    for j, bn in enumerate(bns[2]):
        if j == 0:  # 1 -> 4: one product
            h = dec0_layer(h, w["dec0"], bn, ops)
        else:
            h = convt_layer(h, w["dec"][j - 1], bn, "relu", ops)
    return sigmoid(head_layer(h, w["head"], ops).float())


def generator_train(gens, x, policy: Policy, ops, remat: str | None = None):
    """The train form of one generator (``gens`` = (g,), NHWC x), or of
    two on a pair axis (x (2,N,H,W,3), pair p through ``gens[p]``), in the
    regions of ``remat``."""
    cd = policy.compute_dtype
    if len(gens) == 1:
        bns = gens[0]._bn_layers()
    else:
        enc, lat, dec = zip(*(g._bn_layers() for g in gens))
        bns = (list(zip(*enc)), lat, list(zip(*dec)))

    def weights(part=None):
        return generator_weights(gens, cd, part)

    def whole_net(x, w=None):
        w = weights() if w is None else w
        return _decode(_encode(x, w, bns, ops), w, bns, ops)

    x = to_band(x, mesh_of(ops))
    return run_regions(remat, x.to(cd).contiguous(), whole_net, weights,
                       lambda x: _encode(x, weights("enc"), bns, ops),
                       lambda z: _decode(z, weights("dec"), bns, ops))


def weights_version(module: nn.Module) -> tuple:
    """The ``_version`` counters of a module's parameters and buffers: a
    key that changes whenever any of them is updated in place."""
    return tuple(t._version for t in (*module.parameters(), *module.buffers()))
