"""The read probe P (csrc/pipe_probe.cu), the port of
``benchmarks/pipe_probe.py::make_reader``.

The TPU kernel cuts x, viewed as a logical shape (N, H, W', C') or
(N, H, W*C), into blocks (1, th, W', C') of th full rows and takes each
block's max in f32; every grid step writes the same (1, 128) output block,
so the function returns the max of the last block in grid order, not the
max of the tensor. ``block_max`` returns every block's max (f32, one a
block, in grid order); ``probe_value`` returns its last, the TPU kernel's
value. The probe asked whether rows of 64 bf16 channels (128 bytes) stream
at the full memory rate; ``tools/pipe_probe.py`` asks it on the card.

A CPU tensor takes the plain version (``block_max_plain``: reshape and
amax over each block, exact in the input's type); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from .conv_k4s2p1 import H100_SMS

# A CUDA block of PROBE_THREADS threads reads whole row groups; about
# PROBE_TARGET_BLOCKS blocks (two waves of eight an SM) cover the tensor,
# none reading fewer than PROBE_MIN_GROUPS row groups.
PROBE_THREADS = 256
PROBE_TARGET_BLOCKS = 16 * H100_SMS
PROBE_MIN_GROUPS = 4


class ProbePlan(NamedTuple):
    nblocks: int          # TPU blocks, in grid order
    rows_per_block: int   # rows of ``row`` elements a TPU block
    row_vecs: int         # 16-byte vectors a row
    lanes: int            # threads across a row
    threads: int
    rows_per_split: int   # rows a CUDA block (a multiple of threads // lanes)
    splits: int           # CUDA blocks a TPU block


def check_geometry(shape, block) -> None:
    """Raise unless ``block`` cuts ``shape`` into full-row blocks of one
    image each, (1, th, *shape[2:]) with th dividing H: the geometry of
    every case of the TPU probe, where a block is contiguous."""
    shape, block = tuple(shape), tuple(block)
    if (len(shape) != len(block) or len(shape) < 3 or block[0] != 1
            or block[2:] != shape[2:] or block[1] < 1 or shape[1] % block[1]):
        raise ValueError(f"pipe probe: block {block} does not cut {shape} into "
                         "full-row blocks (1, th, ...) with th dividing H")


def probe_plan(shape, block, dtype) -> ProbePlan:
    """The kernel's launch for x viewed as ``shape`` in blocks ``block``:
    the last axis is a row; ``lanes`` = gcd(the row's 16-byte vectors,
    PROBE_THREADS) threads across it, the rest of the block on the next
    rows; each TPU block cut into splits of whole row groups."""
    check_geometry(shape, block)
    row = shape[-1]
    if row * dtype.itemsize % 16:
        raise ValueError(f"pipe probe: a row of {row} {dtype} values is not a whole "
                         "number of 16-byte vectors")
    nblocks = math.prod(shape) // math.prod(block)
    rows_per_block = math.prod(block) // row
    row_vecs = row * dtype.itemsize // 16
    lanes = math.gcd(row_vecs, PROBE_THREADS)
    at_once = PROBE_THREADS // lanes
    groups = -(-rows_per_block // at_once)
    want = max(1, min(groups // PROBE_MIN_GROUPS, -(-PROBE_TARGET_BLOCKS // nblocks)))
    per = -(-groups // want) * at_once
    return ProbePlan(nblocks, rows_per_block, row_vecs, lanes, PROBE_THREADS, per,
                     -(-rows_per_block // per))


def block_max_plain(x: torch.Tensor, shape, block) -> torch.Tensor:
    """Each block's max in grid order, f32 (nblocks,)."""
    check_geometry(shape, block)
    nblocks = math.prod(shape) // math.prod(block)
    return x.reshape(shape).reshape(nblocks, -1).amax(1).float()


def block_max(x: torch.Tensor, shape, block) -> torch.Tensor:
    """Each full-row block's max of x viewed as ``shape``, in grid order,
    f32 (nblocks,)."""
    if x.numel() != math.prod(shape):
        raise ValueError(f"pipe probe: {x.numel()} values cannot take the shape {tuple(shape)}")
    if x.device.type == "cpu":
        return block_max_plain(x, shape, block)
    _build.check_cuda_tensor("pipe_probe x", x)
    plan = probe_plan(shape, block, x.dtype)
    out = torch.empty(plan.nblocks, dtype=torch.float32, device=x.device)
    partials = _build.workspace(plan.nblocks * plan.splits if plan.splits > 1 else 0, x)
    lib = _build.library()
    _build.launch("pipe_probe", lib.discogan_pipe_probe, x.data_ptr(), _build.ptr(partials),
                  out.data_ptr(), plan.nblocks, plan.rows_per_block, plan.row_vecs,
                  _build.DTYPE_CODES[x.dtype], plan.lanes, plan.threads, plan.rows_per_split,
                  plan.splits, _build.stream_of(x))
    return out


def probe_value(x: torch.Tensor, shape, block) -> torch.Tensor:
    """The TPU probe's value: the last block's max (a 0-d f32 tensor)."""
    return block_max(x, shape, block)[-1]
