"""One Adam step over an optimizer's tensors in one launch a dtype group
(csrc/adam.cu), the optimizer's path on the card (train/optim.py
``Adam.apply``). It writes the bits of ``Adam._apply_plain``.

``adam_plan`` lays the launches out in plain Python: the tensors grouped by
their (parameter, gradient, moment) dtypes in order of first appearance, a
group split into launches of at most ``MAX_TENSORS`` (the kernel's 4 KB
argument block), and each tensor cut into chunks of ``CHUNK`` elements,
one block a chunk: a tensor whose gradient is in p's order past its head
(the elements before p's first 16-byte boundary), a conv weight whose
gradient is in another dense order (``gather_layout``) by pairs of its
channel dims, 16 taps a pair. The C entry checks the layout.
``multi_tensor_adam`` launches it over every tensor, and raises where
``refusal`` names a tensor or a scalar the kernel does not take: the card
has no other path.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

CHUNK = 8192        # elements a block
MAX_TENSORS = 52    # tensors a launch: csrc/adam.cu's argument block
MAX_NUMEL = 1 << 30  # the kernel's element indices are int32
META = 13           # ints a tensor in the entry's meta array
TAPS = 16           # a gathered pair's elements: a 4x4 kernel's taps
_ALIGN = 16
_DTYPES = (torch.float32, torch.bfloat16)
_FLAT = (0, 0, 0, 0, 0)


class Item(NamedTuple):
    slot: int      # the tensor's place in the optimizer (its seed word's)
    numel: int
    head: int      # elements before p's first 16-byte boundary, one a thread
    aligned: int   # bit k: operand k (p, g, m, v) is 16-byte aligned at the head
    chunks: int    # blocks over it
    gather: tuple  # gather_layout's (ys, px, py, gx, gt); zeros: g in p's order


class AdamLaunch(NamedTuple):
    dtypes: tuple  # (parameter, gradient, moments)
    items: tuple   # Item a tensor
    first: tuple   # each item's first block, then the grid's blocks

    @property
    def blocks(self) -> int:
        return self.first[-1]


def head_and_aligned(numel: int, addresses, itemsizes) -> tuple[int, int]:
    """(head, aligned) of a tensor whose operands p, g, m, v start at
    ``addresses`` with ``itemsizes``: the elements before p's first 16-byte
    boundary (at most numel), and which operands are 16-byte aligned
    there."""
    head = min(numel, (-addresses[0] % _ALIGN) // itemsizes[0])
    aligned = sum(1 << k for k, (a, s) in enumerate(zip(addresses, itemsizes))
                  if (a + head * s) % _ALIGN == 0)
    return head, aligned


def chunks_of(numel: int, head: int, chunk: int = CHUNK) -> int:
    """Blocks over a tensor: its elements past the head in chunks, at least
    one (the first also takes the head)."""
    return max(1, -(-(numel - head) // chunk))


def gather_layout(p: torch.Tensor, g: torch.Tensor):
    """(ys, px, py, gx, gt) where ``g`` holds a contiguous 4-D weight p's
    (d0, d1, kh, kw) elements, kh * kw = TAPS, in another dense order, with
    one of d0 and d1 (y; the other x) at stride 1 and the taps at one stride
    (the gradient of a permuted view, models/regions.py::materialize): tap
    t of pair (x, y) sits at x * px + y * py + t in p and at
    x * gx + y + t * gt in g. None for any other layout."""
    if (p.dim() != 4 or tuple(g.shape) != tuple(p.shape) or not p.is_contiguous()
            or p.shape[2] * p.shape[3] != TAPS):
        return None
    s = g.stride()
    gt = s[3] if p.shape[3] > 1 else s[2]
    if p.shape[2] > 1 and p.shape[3] > 1 and s[2] != p.shape[3] * s[3]:
        return None
    for y in (0, 1):
        x = 1 - y
        if s[y] != 1 and p.shape[y] != 1:
            continue
        dims = sorted((stride, extent) for stride, extent in
                      ((1, p.shape[y]), (s[x], p.shape[x]), (gt, TAPS)) if extent > 1)
        want = 1
        for stride, extent in dims:
            if stride != want:
                break
            want *= extent
        else:
            return p.shape[y], p.stride(x), p.stride(y), s[x], gt
    return None


def adam_plan(tensors, chunk: int = CHUNK, max_tensors: int = MAX_TENSORS) -> list:
    """The launches over ``tensors``: (slot, numel, dtypes, addresses,
    gather) each, dtypes the (p, g, m) dtypes, addresses p's, g's, m's and
    v's, gather ``gather_layout``'s or None."""
    groups: dict = {}
    for slot, numel, dtypes, addresses, gather in tensors:
        sizes = (dtypes[0].itemsize, dtypes[1].itemsize, dtypes[2].itemsize,
                 dtypes[2].itemsize)
        if gather is None:
            head, aligned = head_and_aligned(numel, addresses, sizes)
            item = Item(slot, numel, head, aligned, chunks_of(numel, head, chunk), _FLAT)
        else:
            aligned = head_and_aligned(numel, addresses, sizes)[1]
            item = Item(slot, numel, 0, aligned, -(-numel // chunk), tuple(gather))
        groups.setdefault(tuple(dtypes), []).append(item)
    out = []
    for dtypes, items in groups.items():
        for i in range(0, len(items), max_tensors):
            part = tuple(items[i:i + max_tensors])
            first = [0]
            for item in part:
                first.append(first[-1] + item.chunks)
            out.append(AdamLaunch(dtypes, part, tuple(first)))
    return out


def refusal(p, g, m, v, device) -> tuple:
    """(None, gather_layout or None) where the kernel takes this tensor: p,
    m and v contiguous on ``device``, g there too, contiguous or in a
    ``gather_layout`` (then p, m and v 16-byte aligned), all of one size
    under MAX_NUMEL, in f32 or bf16 (m and v alike); else (why not, None)."""
    if any(t.device != device for t in (p, g, m, v)):
        return (f"p, g, m, v on {p.device}, {g.device}, {m.device}, {v.device}, "
                f"not all on {device}"), None
    if not (p.dtype in _DTYPES and g.dtype in _DTYPES and m.dtype in _DTYPES
            and v.dtype == m.dtype):
        return f"dtypes p {p.dtype}, g {g.dtype}, m {m.dtype}, v {v.dtype}", None
    if not (0 < p.numel() < MAX_NUMEL and g.numel() == m.numel() == v.numel() == p.numel()):
        return (f"sizes p {p.numel()}, g {g.numel()}, m {m.numel()}, v {v.numel()} "
                f"(one size, 1 to {MAX_NUMEL - 1})"), None
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            return f"{name} is not contiguous", None
    if g.is_contiguous():
        return None, None
    gather = gather_layout(p, g)
    if gather is None:
        return (f"g's strides {tuple(g.stride())} are neither p's order nor a "
                "conv weight's permuted order"), None
    if any(t.data_ptr() % _ALIGN for t in (p, m, v)):
        return "g is in a permuted order and p, m or v is not 16-byte aligned", None
    return None, gather


def shard_ints(shape, shard) -> tuple[int, int, int]:
    """(block, wstride, offset) of a slice (optim.global_index's ``shard``):
    its element e is (e // block) * wstride + e % block + offset in the
    whole tensor; (0, 0, 0) for a whole tensor."""
    if shard is None:
        return 0, 0, 0
    whole, dim, start = shard
    inner = math.prod(whole[dim + 1:])
    return shape[dim] * inner, whole[dim] * inner, start * inner


def multi_tensor_adam(opt, grads: list, bc: torch.Tensor, seeds: torch.Tensor) -> None:
    """One step of ``opt`` (an optim.Adam, its parameters on the card) over
    all its tensors, from the device scalars ``bc`` (f32) and ``seeds``
    (int32), read with their strides. Raises ValueError, before any launch,
    for a scalar or a tensor (``refusal``) the kernel does not take."""
    device = opt.params[0].device
    for name, t, dtype, least in (("bc", bc, torch.float32, 2),
                                  ("seeds", seeds, torch.int32, len(opt.params))):
        if t.device != device or t.dtype != dtype or t.dim() != 1 or t.numel() < least:
            raise ValueError(f"Adam on {device}: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, not 1-D {dtype} of at least {least} on {device}")
    tensors = []
    for i, (p, g, m, v) in enumerate(zip(opt.params, grads, opt.m, opt.v, strict=True)):
        why, gather = refusal(p, g, m, v, device)
        if why is not None:
            raise ValueError(f"Adam on {device}: tensor {i} {tuple(p.shape)}: {why}")
        tensors.append((i, p.numel(), (p.dtype, g.dtype, m.dtype),
                        (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()), gather))
    lib = _build.library()
    stream = _build.stream_of(opt.params[0])
    b1, b2 = opt.beta1, opt.beta2
    for launch in adam_plan(tensors):
        n = len(launch.items)
        ptrs = (ctypes.c_longlong * (4 * n))()
        meta = (ctypes.c_int * (META * n))()
        for t, item in enumerate(launch.items):
            i = item.slot
            ptrs[4 * t:4 * t + 4] = tensors[i][3]
            meta[META * t:META * t + META] = [
                item.numel, launch.first[t], i, item.head, item.aligned,
                *shard_ints(opt.params[i].shape, opt.shards[i]), *item.gather]
        codes = [_build.DTYPE_CODES[d] for d in launch.dtypes]
        _build.launch("adam", lib.discogan_adam, ctypes.addressof(ptrs),
                      ctypes.addressof(meta), n, CHUNK, launch.blocks,
                      bc.data_ptr(), bc.stride(0), seeds.data_ptr(), seeds.stride(0),
                      opt.lr, b1, 1.0 - b1, b2, 1.0 - b2, opt.eps, opt.weight_decay,
                      int(bool(opt.weight_decay)), *codes, stream)
