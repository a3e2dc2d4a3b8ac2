"""What the networks' train forwards share: their weights written into the
forms the kernels take, one network's or a pair's, and the rematerialized
regions a forward runs in.

``materialize`` casts each member's weight in its own memory order, then
writes it permuted into its slice of one buffer: the two passes a single
forward pays, and no stacking pass besides.

``run_regions`` runs a forward under one of train/graph.py's remat
policies with ``torch.utils.checkpoint`` (no reentry): "full" is one
region; "latent" two (the encoder to the latent, then the rest; a network
without that split takes one); "conv" one region that keeps every
convolution's output (ops/recompute.py), its weights derived outside the
region so the rebuild does not cast them again.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core import trace
from ..ops import recompute

REMAT_POLICIES = ("full", "latent", "conv")


def materialize(views: list, dtype: torch.dtype):
    """One view a member (a list of views a member: one a layer) -> a
    tensor in ``dtype``, contiguous in the view's order; with two members,
    a pair buffer with member p's in slice p. Each view is cast in its
    parameter's memory order first (``to`` keeps the strides), then
    copied in the view's order. Runs in the span ``cast`` (core/trace.py)."""
    with trace.span("cast"):
        return _materialize(views, dtype)


def _materialize(views: list, dtype: torch.dtype):
    if isinstance(views[0], list):
        return [_materialize(list(layer), dtype) for layer in zip(*views)]
    first = views[0]
    if len(views) == 1:
        return torch.empty(first.shape, dtype=dtype, device=first.device).copy_(
            first.to(dtype))
    out = torch.empty((len(views), *first.shape), dtype=dtype, device=first.device)
    for p, view in enumerate(views):
        out[p].copy_(view.to(dtype))
    return out


def _region(fn, *args, keep_convs: bool = False):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: recompute.contexts(keep_convs))


def run_regions(remat: str | None, x, whole, weights, encode=None, decode=None):
    """``whole(x)`` (``whole(x, w)`` with the weights given) under the
    policy ``remat``: None, "full", "latent" (``encode`` then ``decode``,
    where given) or "conv"."""
    if remat is None:
        return whole(x)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat!r}")
    if remat == "conv":
        return _region(whole, x, weights(), keep_convs=True)
    if remat == "latent" and encode is not None:
        return _region(decode, _region(encode, x))
    return _region(whole, x)
