"""The DiscoGAN loss graph: forwards, losses, curriculum mixing (the port
of the JAX package's ``train/graph.py``). Its variants, each the same
losses and weight gradients bit for bit:

- ``dis_only`` (the lean D step) skips the ABA/BAB forwards;
- ``remat`` runs each network forward in rematerialized regions
  (``_checkpoint_policies``; models/regions.py);
- ``concat_dis`` runs each discriminator's real and fake forwards as one
  pass (``Discriminator.forward_pair``);
- ``discogan_losses_paired`` runs each A-side/B-side pair of forwards as
  one pass on a pair axis.

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

Under data parallelism with cross-rank statistics (``stats_dp``, the
parallel.DataParallel train/step.py passes under ``bn_sync``, which every
forward carries in its ops table) the BatchNorm statistics and the
feature-matching means are the global batch's, and the reported losses are
the ranks' means (JAX ``graph.py:165-168``, there ``pmean`` of each
component; here one all-reduce of them all after the backward,
``parallel.DataParallel.mean_losses``). On a mesh (``stats_dp`` a
parallel.gspmd.MeshParallel) the same holds over its data axis, the
networks run on their shards (ops/sharding.py), and under spatial sharding
the reconstructions' bands are gathered whole for their losses.
"""

from __future__ import annotations

import torch

from ..core.precision import F32, Policy
from ..models.discriminator import discriminator_train
from ..models.generator import generator_train
from ..ops.autograd import train_ops
from ..ops.losses import feature_matching_loss, gan_losses, mse_loss
from ..ops.sharding import mesh_from, whole

ARCH_MODES = ("discogan", "recongan", "gan")


def _checkpoint_policies(remat_policy: str | None):
    """(generator, discriminator) region policies for a remat granularity
    (models/regions.py):

    None / "full" -- each network forward is one region: only its input
                     and output are kept, the backward runs it again;
    "latent"      -- the generator's encoder (to the latent, which is kept)
                     and its decoder are two regions; a discriminator one;
    "conv"        -- every convolution's output is kept, and the backward
                     rebuilds only the BatchNorm and activation chains.
    """
    if remat_policy == "conv":
        return "conv", "conv"
    if remat_policy == "latent":
        return "latent", "full"
    if remat_policy not in (None, "full"):
        raise ValueError("remat_policy must be one of None/'full'/'latent'/'conv', "
                         f"got {remat_policy!r}")
    return "full", "full"


def _regions(remat: bool, remat_policy: str | None, remat_dis: bool | None):
    """(generator regions, discriminator regions): None where a forward
    keeps all its activations. remat_dis=False keeps the discriminators'
    (their forwards are encoder-only, so their activations are small);
    None follows ``remat``."""
    if not remat:
        return None, None
    g, d = _checkpoint_policies(remat_policy)
    return g, (d if remat_dis is None or remat_dis else None)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def _losses(A_real, A_feats_real, A_fake, A_feats_fake, B_real, B_feats_real,
            B_fake, B_feats_fake, recon_A, recon_B, skip_first_fm: bool,
            stats_dp) -> dict:
    dis_loss_A, gen_loss_A = gan_losses(A_real, A_fake)
    fm_loss_A = feature_matching_loss(A_feats_real, A_feats_fake,
                                      skip_first=skip_first_fm, stats_dp=stats_dp)
    dis_loss_B, gen_loss_B = gan_losses(B_real, B_fake)
    fm_loss_B = feature_matching_loss(B_feats_real, B_feats_fake,
                                      skip_first=skip_first_fm, stats_dp=stats_dp)
    return {"gen_A": gen_loss_A, "gen_B": gen_loss_B, "fm_A": fm_loss_A,
            "fm_B": fm_loss_B, "recon_A": recon_A, "recon_B": recon_B,
            "dis_A": dis_loss_A, "dis_B": dis_loss_B}


def discogan_losses(models: dict, A: torch.Tensor, B: torch.Tensor, *,
                    policy: Policy = F32, plain: bool = False,
                    skip_first_fm: bool = False, remat: bool = False,
                    remat_policy: str | None = None, remat_dis: bool | None = None,
                    dis_only: bool = False, concat_dis: bool = False,
                    stats_dp=None) -> dict:
    """Run the full forward graph with the models in their current mode.
    models: gen_A, gen_B, dis_A, dis_B. Returns the eight raw loss
    components the reference logs. ``skip_first_fm`` leaves the first
    discriminator feature out of the feature-matching losses (the angle
    trainer, ref angle_pairing.py:114-115).

    dis_only=True (the lean D step, TrainConfig.lean_dis) skips the ABA/BAB
    forwards: the discriminator loss never reads them, and train-mode
    BatchNorm normalizes with batch statistics, so the weight trajectory is
    the same bit for bit; only the generators' running statistics take 2
    updates a D step instead of 4. recon_A and recon_B report 0, so logged
    iterations take the full graph (train/loop.py).

    remat / remat_policy / remat_dis: rematerialized regions
    (``_checkpoint_policies``); concat_dis: each discriminator's real and
    fake forwards as one pass; stats_dp: the BatchNorm statistics and the
    feature-matching means over its ranks."""
    g_remat, d_remat = _regions(remat, remat_policy, remat_dis)
    kw = dict(policy=policy, plain=plain, stats_dp=stats_dp)
    AB = models["gen_B"](A, remat=g_remat, **kw)
    BA = models["gen_A"](B, remat=g_remat, **kw)
    if dis_only:
        recon_A = recon_B = _zero(A)
    else:
        ABA = models["gen_A"](AB, remat=g_remat, **kw)
        BAB = models["gen_B"](BA, remat=g_remat, **kw)
        mp = mesh_from(stats_dp)
        recon_A = mse_loss(whole(ABA, mp), A)
        recon_B = mse_loss(whole(BAB, mp), B)

    if concat_dis:
        (A_real, A_feats_real), (A_fake, A_feats_fake) = models["dis_A"].forward_pair(
            A, BA, remat=d_remat, **kw)
        (B_real, B_feats_real), (B_fake, B_feats_fake) = models["dis_B"].forward_pair(
            B, AB, remat=d_remat, **kw)
    else:
        A_real, A_feats_real = models["dis_A"](A, remat=d_remat, **kw)
        A_fake, A_feats_fake = models["dis_A"](BA, remat=d_remat, **kw)
        B_real, B_feats_real = models["dis_B"](B, remat=d_remat, **kw)
        B_fake, B_feats_fake = models["dis_B"](AB, remat=d_remat, **kw)
    return _losses(A_real, A_feats_real, A_fake, A_feats_fake, B_real, B_feats_real,
                   B_fake, B_feats_fake, recon_A, recon_B, skip_first_fm, stats_dp)


def discogan_losses_paired(models: dict, A: torch.Tensor, B: torch.Tensor, *,
                           policy: Policy = F32, plain: bool = False,
                           skip_first_fm: bool = False, remat: bool = False,
                           remat_policy: str | None = None,
                           remat_dis: bool | None = None,
                           dis_only: bool = False, stats_dp=None) -> dict:
    """The same loss graph with every A-side/B-side pair of forwards as
    one pass on a pair axis (JAX ``discogan_losses_paired``, there a vmap
    over stacked parameters): each port kernel launches once for both
    networks of a pair. The pair schedule keeps the reference call order
    that the running statistics see: (G_B, G_A) on (A, B), then (G_A, G_B)
    on (AB, BA), then (D_A, D_B) on (A, B) and on (BA, AB); each member's
    BatchNorm takes its own statistics."""
    g_remat, d_remat = _regions(remat, remat_policy, remat_dis)
    ops = train_ops(plain, stats_dp)
    gen_A, gen_B, dis_A, dis_B = (models[k] for k in ("gen_A", "gen_B", "dis_A", "dis_B"))
    AB_in = torch.stack([A, B])
    out1 = generator_train((gen_B, gen_A), AB_in, policy, ops, g_remat)
    AB, BA = out1[0], out1[1]
    if dis_only:
        recon_A = recon_B = _zero(A)
    else:
        out2 = whole(generator_train((gen_A, gen_B), out1, policy, ops, g_remat),
                     mesh_from(stats_dp))
        recon_A = mse_loss(out2[0], A)
        recon_B = mse_loss(out2[1], B)
    real, real_feats = discriminator_train((dis_A, dis_B), AB_in, policy, ops, d_remat)
    fake, fake_feats = discriminator_train((dis_A, dis_B), torch.stack([BA, AB]), policy,
                                           ops, d_remat)
    return _losses(real[0], [f[0] for f in real_feats], fake[0], [f[0] for f in fake_feats],
                   real[1], [f[1] for f in real_feats], fake[1], [f[1] for f in fake_feats],
                   recon_A, recon_B, skip_first_fm, stats_dp)


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
