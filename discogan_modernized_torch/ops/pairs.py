"""The pair axis of the kernels' wrappers (``PairStrides`` in
csrc/common.cuh): an operand may carry a leading axis of P pairs, and one
launch then computes P problems of one shape, pair p on slice p of each
operand. An operand without that axis (a weight, or a scale and offset) is
shared by every pair: its pair stride is 0. A call whose x has no pair axis
is a single call, as before.

Each pair runs the tile plan of a single call on its own operands, so a
pair launch gives the bits of P single launches; the plain versions loop
over the pairs of the single plain version, so they give the bits of P
single plain calls.
"""

from __future__ import annotations

import torch


def pairs_of(x: torch.Tensor, nd: int) -> int:
    """P where x (an operand of ``nd`` dims a problem) has a pair axis, else 0."""
    if x.dim() == nd + 1:
        return x.shape[0]
    if x.dim() != nd:
        raise ValueError(f"expected {nd} dims, or {nd + 1} with a pair axis, "
                         f"got {tuple(x.shape)}")
    return 0


def member(t, p: int, nd: int):
    """Pair p's operand: slice p of a paired operand, or the shared one."""
    return t if t is None or t.dim() == nd else t[p]


def pair_stride(t, nd: int) -> int:
    """Elements between two pairs' operands: one slice, or 0 where shared."""
    return 0 if t is None or t.dim() == nd else t[0].numel()


def check_members(fn: str, pairs: int, *operands) -> None:
    """Each paired operand has as many pairs as x."""
    for t in operands:
        if t is not None and t.shape[0] != pairs:
            raise ValueError(f"{fn}: {tuple(t.shape)} for {pairs} pairs")


def stack(outs: list):
    """The pairs' outputs (tensors, or tuples of them) stacked on a new
    leading axis."""
    if isinstance(outs[0], tuple):
        return tuple(stack([o[i] for o in outs]) for i in range(len(outs[0])))
    return torch.stack(outs)
