"""The DiscoGAN loss graph: forwards, losses, curriculum mixing (the port
of the JAX package's ``train/graph.py``, with its defaults: the
discriminator's real and fake forwards run one after the other).

The reference per-iteration graph (ref image_translation.py:342-382), in
its exact call order, which matters because every train-mode forward
advances the BatchNorm running statistics:

    AB  = G_B(A);  BA  = G_A(B)
    ABA = G_A(AB); BAB = G_B(BA)
    recon_A = MSE(ABA, A); recon_B = MSE(BAB, B)
    D_A on A then BA -> (dis_loss_A, gen_loss_A, fm_loss_A)
    D_B on B then AB -> (dis_loss_B, gen_loss_B, fm_loss_B)

Curriculum and arch-mode mixing (ref :366-382):

    rate = starting_rate if iters < gan_curriculum else default_rate
    gen_loss_A_total = (fm_B*0.9 + gen_B*0.1)*(1-rate) + recon_A*rate
    gen_loss_B_total = (fm_A*0.9 + gen_A*0.1)*(1-rate) + recon_B*rate
    discogan: gen = A_total + B_total,            dis = dis_A + dis_B
    recongan: gen = A_total,                      dis = dis_B
    gan:      gen = gen_B*0.1 + fm_B*0.9,         dis = dis_B
"""

from __future__ import annotations

import torch

from ..core.precision import F32, Policy
from ..ops.losses import feature_matching_loss, gan_losses, mse_loss

ARCH_MODES = ("discogan", "recongan", "gan")


def discogan_losses(models: dict, A: torch.Tensor, B: torch.Tensor, *,
                    policy: Policy = F32, plain: bool = False,
                    skip_first_fm: bool = False) -> dict:
    """Run the full forward graph with the models in their current mode.
    models: gen_A, gen_B, dis_A, dis_B. Returns the eight raw loss
    components the reference logs. ``skip_first_fm`` leaves the first
    discriminator feature out of the feature-matching losses (the angle
    trainer, ref angle_pairing.py:114-115)."""
    kw = dict(policy=policy, plain=plain)
    AB = models["gen_B"](A, **kw)
    BA = models["gen_A"](B, **kw)
    ABA = models["gen_A"](AB, **kw)
    BAB = models["gen_B"](BA, **kw)
    recon_A = mse_loss(ABA, A)
    recon_B = mse_loss(BAB, B)

    A_real, A_feats_real = models["dis_A"](A, **kw)
    A_fake, A_feats_fake = models["dis_A"](BA, **kw)
    B_real, B_feats_real = models["dis_B"](B, **kw)
    B_fake, B_feats_fake = models["dis_B"](AB, **kw)
    dis_loss_A, gen_loss_A = gan_losses(A_real, A_fake)
    fm_loss_A = feature_matching_loss(A_feats_real, A_feats_fake,
                                      skip_first=skip_first_fm)
    dis_loss_B, gen_loss_B = gan_losses(B_real, B_fake)
    fm_loss_B = feature_matching_loss(B_feats_real, B_feats_fake,
                                      skip_first=skip_first_fm)
    return {"gen_A": gen_loss_A, "gen_B": gen_loss_B, "fm_A": fm_loss_A,
            "fm_B": fm_loss_B, "recon_A": recon_A, "recon_B": recon_B,
            "dis_A": dis_loss_A, "dis_B": dis_loss_B}


def mix_losses(losses: dict, rate, arch: str):
    """Curriculum mixing + arch-mode totals. Returns (gen_total, dis_total)."""
    if arch not in ARCH_MODES:
        raise ValueError(f"model_arch must be one of {ARCH_MODES}, got {arch!r}")
    rate = torch.as_tensor(rate, dtype=torch.float32,
                           device=losses["gen_A"].device)
    gen_loss_A_total = ((losses["fm_B"] * 0.9 + losses["gen_B"] * 0.1)
                        * (1.0 - rate) + losses["recon_A"] * rate)
    gen_loss_B_total = ((losses["fm_A"] * 0.9 + losses["gen_A"] * 0.1)
                        * (1.0 - rate) + losses["recon_B"] * rate)
    if arch == "discogan":
        return (gen_loss_A_total + gen_loss_B_total,
                losses["dis_A"] + losses["dis_B"])
    if arch == "recongan":
        return gen_loss_A_total, losses["dis_B"]
    return losses["gen_B"] * 0.1 + losses["fm_B"] * 0.9, losses["dis_B"]


def trainable_subsets(arch: str):
    """(generator keys, discriminator keys) each optimizer updates. Torch's
    zero_grad(set_to_none=True) + Adam skipping None gradients mean that a
    model no loss term reaches gets no update at all: recongan's generator
    loss reaches both generators (through ABA = G_A(G_B(A))) but only
    dis_B; gan mode reaches only gen_B and dis_B."""
    if arch == "discogan":
        return ("gen_A", "gen_B"), ("dis_A", "dis_B")
    if arch == "recongan":
        return ("gen_A", "gen_B"), ("dis_B",)
    return ("gen_B",), ("dis_B",)
