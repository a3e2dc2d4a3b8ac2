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

``collectives`` counts the collectives issued, one key a kind
(``all_reduce``, and the mesh modes' ``all_gather`` and the saves'
``gather``, parallel/gspmd.py),
as ``ops/_build.launches`` counts the kernels' launches: a captured step's
are counted at its capture (``train/chunk.py``), not at its replays.
``Group`` is the ranks of one process group and their means, which
``DataParallel`` and the mesh's groups build on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

collectives = {"all_reduce": 0, "all_gather": 0, "gather": 0}


def reset_collectives() -> None:
    for kind in collectives:
        collectives[kind] = 0


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks in place, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    collectives["all_reduce"] += 1
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t``s stacked on a new leading axis, in group rank order,
    counted. NCCL gathers into one buffer on the card; gloo gathers through
    host memory (it has no all-gather of CUDA tensors), so a rank on a card
    it shares over gloo copies its part out and the result back."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        src = t.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts).to(t.device)
    collectives["all_gather"] += 1
    return out


def gather(t: torch.Tensor, group) -> list | None:
    """The ranks' ``t``s on the group's first rank, on the CPU, in group rank
    order (None on the other ranks), counted. Under NCCL the first rank
    receives them on its card, one tensor's parts at a time; gloo gathers
    through host memory."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    first = dist.get_global_rank(group, 0)
    mine = dist.get_rank() == first
    if dist.get_backend(group) != "nccl":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(n)] if mine else None
    dist.gather(t, parts, dst=first, group=group)
    collectives["gather"] += 1
    return [p.cpu() for p in parts] if mine else None


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


class Group:
    """The ranks of ``group`` (the default group when None)."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t``, in place (not differentiable)."""
        return all_reduce_sum(t, self.group).div_(self.world)

    def rank_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t`` inside the autograd graph."""
        return _RankMean.apply(t, self)


class DataParallel(Group):
    """The ranks of ``group`` (the default group when None) and their
    gradient buffers; ``bn_sync``: cross-rank BatchNorm statistics."""

    def __init__(self, group=None, *, bn_sync: bool = False):
        super().__init__(group)
        self.bn_sync = bn_sync
        self._flat: dict = {}  # (subset, dtype[, group]) -> flat gradient buffer

    def _reduce(self, key, grads: list, idx: list, out: list, group) -> None:
        """Sum grads[i] for i in ``idx`` (one dtype) over ``group`` through
        the flat buffer ``key``, and put views of it into ``out``."""
        numel = sum(grads[i].numel() for i in idx)
        flat = self._flat.get(key)
        if flat is None or flat.numel() != numel or flat.device != grads[idx[0]].device:
            flat = self._flat[key] = torch.empty(numel, dtype=grads[idx[0]].dtype,
                                                 device=grads[idx[0]].device)
        torch.cat([grads[i].reshape(-1) for i in idx], out=flat)
        all_reduce_sum(flat, group)
        if not self.bn_sync:
            flat.div_(self.world)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)

    @torch.no_grad()
    def reduce_grads(self, subset: str, grads, params=None) -> list:
        """The ranks' sum (bn_sync) or mean (local BN) of ``grads``, through
        one flat buffer per dtype of ``subset``'s gradients; returns views of
        it, one a gradient, valid until the subset's next reduction.
        ``params`` (the gradients' parameters) is the mesh's business."""
        grads = list(grads)
        out = [None] * len(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            self._reduce((subset, dtype), grads, idx, out, self.group)
        return out

    @torch.no_grad()
    def mean_losses(self, losses: dict) -> dict:
        """The ranks' mean of each logged loss, in one all-reduce."""
        keys = list(losses)
        stacked = self.mean(torch.stack([losses[k].float() for k in keys]))
        return dict(zip(keys, stacked.unbind(0)))
