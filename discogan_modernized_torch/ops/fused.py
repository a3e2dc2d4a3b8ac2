"""BatchNorm's two elementwise/reduction passes, the port of the JAX
package's ``ops/pallas_fused.py``:

- ``batch_stats`` (kernel K1, csrc/batch_stats.cu): per-channel mean and
  biased variance of NHWC x in f32, one pass over E[x] and E[x^2] with
  var = max(E[x^2] - E[x]^2, 0), for train-mode BatchNorm;
- ``bn_act`` (kernel K2, csrc/bn_act.cu): y = act(x * scale + offset) per
  channel, in f32, stored in x's dtype; ``fused_batchnorm_act`` folds
  given statistics into (scale, offset) first.

``stats_plan`` and ``bn_act_plan`` give each kernel's launch (vector width,
threads, blocks, how a thread's channels are kept); the C entries check
them. A CPU tensor takes the plain version (``batch_stats_plain``,
``bn_act_plain``); a CUDA tensor launches the kernel or raises. Both take
a leading pair axis on x (ops/pairs.py): statistics per pair, and scale
and offset per pair ((P, C)) or shared ((C,)).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build, pairs as pr
from .activations import act_code, apply_act
from .batchnorm import BN_EPS, fold_bn
from .conv_k4s2p1 import H100_SMS

# K1: a block of STATS_THREADS threads, at most STATS_MAX_LANES across a
# row of 16-byte vectors (128 bytes: narrow channel tiles, so each tile's
# last block has few partials to sum), the rest on the next rows,
# STATS_UNROLL loads in flight a thread; about STATS_TARGET_BLOCKS blocks
# (two an SM) split the rows, each split of at least STATS_MIN_STEPS
# unrolled steps of every row lane. The last block of each channel tile
# sums the splits' partials, elected by a counter of its own; at most
# STATS_MAX_TILES counters a launch (tools/fused_ab.py times the
# alternatives).
STATS_THREADS, STATS_MAX_LANES, STATS_UNROLL, STATS_MIN_STEPS = 512, 8, 4, 4
STATS_TARGET_BLOCKS = 2 * H100_SMS
STATS_MAX_TILES = 1024
# K2: blocks of BN_THREADS, one vector a thread until the grid reaches
# BN_BLOCKS_PER_SM blocks an SM, then a grid-stride loop with BN_UNROLL loads
# in flight a thread on the fixed path; the fixed path takes at most
# BN_MAX_FIXED_BLOCKS blocks to make its stride a multiple of C.
BN_THREADS, BN_UNROLL, BN_BLOCKS_PER_SM = 256, 4, 8
BN_MAX_FIXED_BLOCKS = 4 * BN_BLOCKS_PER_SM * H100_SMS


def _vector(dtype) -> int:
    """Values of ``dtype`` in a 16-byte vector."""
    return 16 // dtype.itemsize


class StatsPlan(NamedTuple):
    width: int           # channels a thread loads at once: a 16-byte vector, or 1
    threads: int
    lanes: int           # threads across a row, `width` channels each
    row_lanes: int       # rows a block reads at once (threads // lanes)
    ctiles: int          # blocks across the channels (lanes * width each)
    splits: int          # blocks down the rows
    rows_per_split: int
    unroll: int          # loads in flight a thread
    shuffle: bool        # a warp folds its row lanes by shuffles (lanes divides 32)
    pairs: int = 1       # problems of the launch (the grid's z)

    def partial_floats(self, c: int) -> int:
        """The splits' partial sums and squares, of every pair."""
        return 2 * self.splits * c * self.pairs


def stats_plan(rows: int, c: int, dtype, pairs: int = 1) -> StatsPlan:
    """K1's plan for x viewed as (rows, c), a function of the shape alone
    (so is the order of its sums, and two launches give the same bits):
    16-byte vectors where C is a multiple of them, else one channel a
    thread; splits that fill about STATS_TARGET_BLOCKS blocks with the
    channel tiles, none shorter than STATS_MIN_STEPS unrolled steps of each
    row lane. ``pairs`` sizes the grid and the partials alone."""
    v = _vector(dtype)
    width = v if c % v == 0 else 1
    groups = c // width
    lanes = min(groups, STATS_MAX_LANES)
    row_lanes = STATS_THREADS // lanes
    ctiles = -(-groups // lanes)
    want = -(-STATS_TARGET_BLOCKS // ctiles)
    per = max(-(-rows // want), row_lanes * STATS_UNROLL * STATS_MIN_STEPS)
    return StatsPlan(width, STATS_THREADS, lanes, row_lanes, ctiles, -(-rows // per), per,
                     STATS_UNROLL, lanes < 32 and 32 % lanes == 0, pairs)


class BnActPlan(NamedTuple):
    width: int      # values of a 16-byte vector (8 bf16, 4 f32)
    fixed: bool     # a thread's channels never change (bn_act_vec_kernel)
    threads: int
    blocks: int
    unroll: int     # loads in flight a thread before its first store
    pairs: int = 1  # problems of the launch (the grid's y)


def bn_act_plan(numel: int, c: int, dtype, pairs: int = 1) -> BnActPlan:
    """K2's plan for ``numel`` values of C channels: a block for every
    BN_THREADS vectors, at most BN_BLOCKS_PER_SM an SM. Where C is a
    multiple of the vector, that count rounded up to a multiple that makes
    the grid's stride a multiple of C, so each thread keeps its channels.
    Else the general kernel, one vector a thread a step. ``numel`` counts
    one pair's values; ``pairs`` sizes the grid alone."""
    width = _vector(dtype)
    blocks = max(1, min(-(-(numel // width) // BN_THREADS), BN_BLOCKS_PER_SM * H100_SMS))
    if c % width == 0:
        groups = c // width
        period = groups // math.gcd(BN_THREADS, groups)
        fixed = -(-blocks // period) * period
        if fixed <= BN_MAX_FIXED_BLOCKS:
            return BnActPlan(width, True, BN_THREADS, fixed, BN_UNROLL, pairs)
    return BnActPlan(width, False, BN_THREADS, blocks, 1, pairs)


def _stats_workspace(x: torch.Tensor, tiles: int, floats: int):
    """K1's tile counters and partial sums, the call's own: one buffer from
    the caching allocator (so from the graph's pool under a capture), the
    counters first, padded to 16 bytes; the C entry zeroes them on the
    call's stream. Returns (tickets, partials)."""
    words = -(-tiles // 4) * 4
    ws = torch.empty(words + floats, dtype=torch.int32, device=x.device)
    return ws[:words], ws[words:].view(torch.float32)


def batch_stats_plain(x: torch.Tensor):
    """(mean, biased var) over all but the last axis, f32, one pass; per
    pair ((P, C) each) where NHWC x has a pair axis."""
    if x.dim() == 5:
        return pr.stack([batch_stats_plain(xp) for xp in x])
    x2 = x.reshape(-1, x.shape[-1]).float()
    mean = x2.mean(0)
    return mean, torch.clamp_min(x2.square().mean(0) - mean.square(), 0.0)


def batch_stats(x: torch.Tensor):
    """Per-channel (mean, biased var) of NHWC ``x`` as f32 (C,), (C,); of
    each pair, (P, C) and (P, C), where x has a pair axis."""
    if x.device.type == "cpu":
        return batch_stats_plain(x)
    paired = x.dim() == 5
    pairs = x.shape[0] if paired else 1
    c = x.shape[-1]
    rows = x.numel() // (c * pairs)
    _build.check_cuda_tensor("batch_stats x", x)
    plan = stats_plan(rows, c, x.dtype, pairs)
    if pairs * plan.ctiles > STATS_MAX_TILES:
        raise ValueError(f"batch_stats: {pairs} pairs of {plan.ctiles} channel "
                         f"tiles pass the {STATS_MAX_TILES} tickets")
    stats = torch.empty((2, pairs, c) if paired else (2, c), dtype=torch.float32,
                        device=x.device)
    tickets, part = _stats_workspace(x, pairs * plan.ctiles, plan.partial_floats(c))
    lib = _build.library()
    _build.launch("batch_stats", lib.discogan_batch_stats, x.data_ptr(),
                  part.data_ptr(), tickets.data_ptr(), stats[0].data_ptr(),
                  stats[1].data_ptr(), rows, c, _build.DTYPE_CODES[x.dtype], plan.width,
                  plan.threads, plan.lanes, plan.row_lanes, plan.ctiles, plan.splits,
                  plan.rows_per_split, plan.unroll, int(plan.shuffle), pairs, rows * c,
                  _build.stream_of(x))
    return stats[0], stats[1]


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 act: str | None = None) -> torch.Tensor:
    if x.dim() == 5:
        pr.check_members("bn_act_plain", x.shape[0], *(t for t in (scale, offset)
                                                       if t.dim() == 2))
        return pr.stack([bn_act_plain(xp, pr.member(scale, p, 1),
                                      pr.member(offset, p, 1), act)
                         for p, xp in enumerate(x)])
    y = x.float() * scale.float() + offset.float()
    return apply_act(y, act).to(x.dtype)


def bn_act(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
           act: str | None = None) -> torch.Tensor:
    """y = act(x * scale + offset) over the last (channel) axis of x. With
    a pair axis on NHWC x, scale and offset are (P, C) per pair or (C,)
    shared."""
    code = act_code(act)
    if x.device.type == "cpu":
        return bn_act_plain(x, scale, offset, act)
    c = x.shape[-1]
    pairs = x.shape[0] if x.dim() == 5 else 1
    nd = 2 if x.dim() == 5 and scale.dim() == 2 else 1
    _build.check_cuda_tensor("bn_act x", x)
    for name, t in (("scale", scale), ("offset", offset)):
        _build.check_cuda_tensor(f"bn_act {name}", t, dtype=torch.float32,
                                 ndim=nd)
        if t.shape[-1] != c or (nd == 2 and t.shape[0] != pairs):
            raise ValueError(f"bn_act {name}: {tuple(t.shape)} for {c} channels"
                             f" and {pairs} pairs")
    n = x.numel() // pairs
    plan = bn_act_plan(n, c, x.dtype, pairs)
    y = torch.empty_like(x)
    lib = _build.library()
    _build.launch("bn_act", lib.discogan_bn_act, x.data_ptr(),
                  scale.data_ptr(), offset.data_ptr(), y.data_ptr(),
                  n, c, code, _build.DTYPE_CODES[x.dtype], plan.width,
                  int(plan.fixed), plan.threads, plan.blocks, plan.unroll,
                  pairs, n, n, c if nd == 2 else 0, _build.stream_of(x))
    return y


def fused_batchnorm_act(x, mean, var, gamma, beta, *, eps: float = BN_EPS,
                        act: str | None = "leaky_relu"):
    """normalize + affine + activation with given statistics, one pass.

    x: (N,H,W,C); mean/var/gamma/beta: (C,). act: leaky_relu|relu|none."""
    scale, offset = fold_bn(gamma, beta, mean, var, eps)
    return bn_act(x, scale, offset, act)
