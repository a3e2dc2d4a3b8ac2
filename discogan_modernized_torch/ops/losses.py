"""Loss primitives of the reference loss graph (ref image_translation.py
:136-168, :267-268), the port of the JAX package's ``ops/losses.py``.

- ``bce_loss``: torch ``F.binary_cross_entropy`` with mean reduction: the
  log terms clamped at -100, and a bounded backward,
  (p - t) / max(p * (1 - p), 1e-12) / N, which the JAX package's custom
  VJP copies. A saturated discriminator (p exactly 0 or 1) then trains on.
- ``mse_loss``: nn.MSELoss.
- ``feature_matching_loss``: per discriminator feature, the mean of the
  squared difference of the batch means (HingeEmbeddingLoss with all-ones
  targets reduces to that), summed over features; ``skip_first`` drops the
  first feature (ref angle_pairing.py:114-115); with ``stats_dp`` (a
  parallel.DataParallel) the batch means are the global batch's (JAX
  ``ops/losses.py:72-90``).
- ``gan_losses``: dis = 0.5 * (BCE(real, 1) + BCE(fake, 0)), gen =
  BCE(fake, 1), after the (B,1,1,1) -> (B,1) reshape (ref :151-154).

All reductions run in f32 whatever the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy(probs.float(), targets.float())


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()


def feature_matching_loss(real_feats, fake_feats, *, skip_first: bool = False,
                          stats_dp=None):
    """Sum over features of mean((mean_N(real) - mean_N(fake))^2); 0 where
    no feature is left (a 16px discriminator has one). ``stats_dp``: the
    batch means over its ranks."""
    device = real_feats[0].device if real_feats else None
    if skip_first:
        real_feats, fake_feats = real_feats[1:], fake_feats[1:]
    total = torch.zeros((), dtype=torch.float32, device=device)
    for rf, ff in zip(real_feats, fake_feats):
        rm, fm = rf.float().mean(0), ff.float().mean(0)
        if stats_dp is not None:
            rm, fm = stats_dp.rank_mean(rm), stats_dp.rank_mean(fm)
        diff = rm - fm
        total = total + diff.square().mean()
    return total


def gan_losses(dis_real: torch.Tensor, dis_fake: torch.Tensor):
    """(dis_loss, gen_loss) for one discriminator's real/fake probabilities."""
    batch = dis_real.shape[0]
    dis_real = dis_real.reshape(batch, -1)
    dis_fake = dis_fake.reshape(batch, -1)
    ones = torch.ones_like(dis_real, dtype=torch.float32)
    zeros = torch.zeros_like(dis_fake, dtype=torch.float32)
    dis_loss = (bce_loss(dis_real, ones) + bce_loss(dis_fake, zeros)) * 0.5
    gen_loss = bce_loss(dis_fake, ones)
    return dis_loss, gen_loss
