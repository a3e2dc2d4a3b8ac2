"""Data parallelism over the ranks of a process group (the port of the JAX
package's ``parallel/dp.py``, there ``shard_map`` over a mesh axis).

Each rank holds the whole train state and trains on its own shard of the
data; after each step's backward the ranks' gradients are all-reduced, so
the parameters and Adam moments stay equal on every rank. Two BatchNorm
modes (``TrainConfig.bn_sync``):

- local (the default, as DDP keeps BatchNorm): each rank normalizes with
  its own batch's statistics and keeps its own running statistics; the
  gradients are averaged over the ranks. Rank 0's running statistics are
  what the trainer saves (JAX ``dp.py:55-69``: replica 0's).
- sync: the batch statistics are the global batch's (the forwards'
  ``stats_dp``, ops/autograd.py's ``train_ops``: each BatchNorm's
  statistics and the feature-matching loss's batch means are all-reduced,
  their cotangents too), every rank
  holds the same running statistics, and the differentiated loss is the
  rank's share of the global mean (its total over the world size), so the
  gradients are summed (JAX ``train/step.py:264-266``: ``psum`` under
  sync, ``pmean`` otherwise). A step then equals one process's step on the
  concatenated batch, up to the order of the sums.

``DataParallel`` holds the group and, per trainable subset and dtype, one
flat gradient buffer, allocated at the subset's first step and reused, so
that a step captured in a CUDA graph reduces into the same memory at every
replay. The gradients are reduced in their own dtype (bf16 under slim
state "all"), as JAX reduces them. The logged losses are the ranks' means
in both modes (JAX ``dp.py:95-99``).

``collectives`` counts the all-reduces issued, as ``ops/_build.launches``
counts the kernels' launches: a captured step's are counted at its
capture (``train/chunk.py``), not at its replays.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

collectives = {"all_reduce": 0}


def reset_collectives() -> None:
    collectives["all_reduce"] = 0


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks in place, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    collectives["all_reduce"] += 1
    return t


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of a per-rank value; its backward is the
    mean of the ranks' cotangents (each rank differentiates its own share
    of the global loss)."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.mean(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.mean(g.contiguous().clone()), None


class DataParallel:
    """The ranks of ``group`` (the default group when None) and their
    gradient buffers; ``bn_sync``: cross-rank BatchNorm statistics."""

    def __init__(self, group=None, *, bn_sync: bool = False):
        self.group = group
        self.world = dist.get_world_size(group)
        self.bn_sync = bn_sync
        self._flat: dict = {}  # (subset, dtype) -> flat gradient buffer

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t``, in place (not differentiable)."""
        return all_reduce_sum(t, self.group).div_(self.world)

    def rank_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t`` inside the autograd graph."""
        return _RankMean.apply(t, self)

    @torch.no_grad()
    def reduce_grads(self, subset: str, grads) -> list:
        """The ranks' sum (bn_sync) or mean (local BN) of ``grads``, through
        one flat buffer per dtype of ``subset``'s gradients; returns views of
        it, one a gradient, valid until the subset's next reduction."""
        grads = list(grads)
        out = [None] * len(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            numel = sum(grads[i].numel() for i in idx)
            key = (subset, dtype)
            flat = self._flat.get(key)
            if flat is None or flat.numel() != numel or flat.device != grads[idx[0]].device:
                flat = self._flat[key] = torch.empty(numel, dtype=dtype,
                                                     device=grads[idx[0]].device)
            torch.cat([grads[i].reshape(-1) for i in idx], out=flat)
            all_reduce_sum(flat, self.group)
            if not self.bn_sync:
                flat.div_(self.world)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view(grads[i].shape)
        return out

    @torch.no_grad()
    def mean_losses(self, losses: dict) -> dict:
        """The ranks' mean of each logged loss, in one all-reduce."""
        keys = list(losses)
        stacked = self.mean(torch.stack([losses[k].float() for k in keys]))
        return dict(zip(keys, stacked.unbind(0)))
