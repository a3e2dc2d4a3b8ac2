"""The optimizer's multi-tensor kernel, on the CPU: its launch plan
(``ops/adam.py::adam_plan``), its C entry's arguments, and a numpy model of
csrc/adam.cu held against ``Adam._apply_plain``.

The kernel runs only on the card (tests/test_torch_adam_kernel.py holds it
there against the plain loop bit for bit). Here: the planner groups an
optimizer's tensors by dtype in order, splits a group at ``MAX_TENSORS``
and lays out one block a chunk; a numpy walk of the kernel's grid (each
block's tensor by a binary search over the first chunks, the head, the
16-byte vector steps and the tail) touches every element once; the
model's f32 arithmetic, in the kernel's order with its bf16 roundings and
its uint32 hash, gives the plain loop's bits on the CPU (a bf16 master
rounded with the card's hash in both); on the CPU ``apply`` takes the
plain loop and never the kernel; the wrapper's call matches the C entry's
ctypes signature; and on the card a tensor or a scalar the kernel does not
take raises before any launch (the card has no other path).
"""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops import _build
from discogan_modernized_torch.ops import adam as k
from discogan_modernized_torch.train import optim
from discogan_modernized_torch.train.optim import Adam
from tests.torch_threads import one_torch_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
MODES = {"off": (F32, F32), "mv": (F32, BF16), "all": (BF16, BF16)}  # (p and g, m and v)
SOURCE = Path(k.__file__).resolve().parents[1] / "csrc" / "adam.cu"


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def test_source_constants_match_the_planner():
    assert _constant("MAX_TENSORS") == k.MAX_TENSORS
    assert _constant("META") == k.META
    assert k.CHUNK % _constant("VEC") == 0
    assert _constant("TAPS") == k.TAPS


def _tensors(sizes, dtypes, base=0x7F0000000000, skew=0):
    """Planner input for tensors of ``sizes`` laid out as fresh allocations
    (512-byte aligned), the gradients ``skew`` elements off."""
    out, at = [], base
    for i, n in enumerate(sizes):
        sz = [d.itemsize for d in dtypes]
        addresses = (at, at + 1024 * 1024 + skew * sz[1], at + 2 * 1024 * 1024,
                     at + 3 * 1024 * 1024)
        out.append((i, n, dtypes, addresses, None))
        at += 4 * 1024 * 1024
    return out


def test_groups_by_dtype_in_order_of_first_appearance():
    mixed = [(0, 64, (F32, F32, BF16), (0,) * 4, None), (1, 64, (BF16, BF16, BF16), (0,) * 4, None),
             (2, 64, (F32, F32, BF16), (0,) * 4, None), (3, 64, (F32, F32, F32), (0,) * 4, None)]
    plan = k.adam_plan(mixed)
    assert [(p.dtypes, [i.slot for i in p.items]) for p in plan] == [
        ((F32, F32, BF16), [0, 2]), ((BF16, BF16, BF16), [1]), ((F32, F32, F32), [3])]


@pytest.mark.parametrize("count,want", [(1, [1]), (52, [52]), (53, [52, 1]), (88, [52, 36]),
                                        (110, [52, 52, 6])])
def test_argument_block_split(count, want):
    plan = k.adam_plan(_tensors([100] * count, (F32, F32, BF16)))
    assert [len(p.items) for p in plan] == want
    assert [i.slot for p in plan for i in p.items] == list(range(count))


def test_chunk_table():
    sizes = [64, 8192, 8193, 3 * 8192 + 5, 4 * 4 * 512 * 512]
    (launch,) = k.adam_plan(_tensors(sizes, (F32, F32, BF16)))
    assert [i.chunks for i in launch.items] == [1, 1, 2, 4, 512]
    assert launch.first == (0, 1, 2, 4, 8, 520)
    assert launch.blocks == 520
    assert all(i.head == 0 and i.aligned == 15 for i in launch.items)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p_skew,g_skew", [(0, 0), (0, 1), (3, 0), (5, 3), (2, 2)])
def test_head_and_alignment(mode, p_skew, g_skew):
    p_dtype, mv = MODES[mode]
    sizes = [p_dtype.itemsize, p_dtype.itemsize, mv.itemsize, mv.itemsize]
    addresses = [4096 + p_skew * sizes[0], 8192 + g_skew * sizes[1], 12288, 16384]
    head, aligned = k.head_and_aligned(1000, addresses, sizes)
    assert head < 16 // sizes[0] and (addresses[0] + head * sizes[0]) % 16 == 0
    for j in range(4):
        assert bool(aligned >> j & 1) == ((addresses[j] + head * sizes[j]) % 16 == 0)
    assert k.head_and_aligned(2, addresses, sizes)[0] == min(2, head)


def _walk(launch, chunk):
    """The kernel's grid over ``launch``: per item, each element's visits and
    whether a vector step took it."""
    visits = [np.zeros(i.numel, np.int64) for i in launch.items]
    vector = [np.zeros(i.numel, bool) for i in launch.items]
    first = launch.first
    for c in range(launch.blocks):
        lo, hi = 0, len(launch.items) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if first[mid] <= c else (lo, mid - 1)
        item, j = launch.items[lo], c - first[lo]
        if j == 0:
            visits[lo][:item.head] += 1
        start = item.head + j * chunk
        end = min(item.numel, start + chunk)
        vend = start + (end - start) // 8 * 8
        visits[lo][start:end] += 1
        vector[lo][start:vend] = True
    return visits, vector


@pytest.mark.parametrize("chunk", [8, 64, k.CHUNK])
@pytest.mark.parametrize("skew", [0, 1, 3])
def test_walk_covers_every_element_once(chunk, skew):
    sizes = [1, 3, 7, 8, 9, 13, 64, 65, 1023, 8193, 3 * 8192 + 5]
    for dtypes in ((F32, F32, F32), (F32, F32, BF16), (BF16, BF16, BF16)):
        tensors = [(i, n, dtypes, (a[0] + skew * dtypes[0].itemsize, *a[1:]), None)
                   for i, n, _, a, _ in _tensors(sizes, dtypes)]
        for launch in k.adam_plan(tensors, chunk=chunk, max_tensors=5):
            visits, vector = _walk(launch, chunk)
            for item, seen, vec in zip(launch.items, visits, vector):
                assert (seen == 1).all(), (item, chunk)
                assert not vec[:item.head].any()
                # vector steps start 16-byte aligned for p
                starts = np.flatnonzero(vec)[::8] if vec.any() else []
                assert all((s - item.head) % 8 == 0 for s in starts)


def _rne(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 -> f32, rounded to nearest even (finite values)."""
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def _hash(e: np.ndarray, seed: int) -> np.ndarray:
    """csrc/adam.cu's rounding_bits in uint32 arithmetic."""
    h = (e.astype(np.uint64) * 0x9E3779B1 + (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return (h >> 16).astype(np.uint32)


def _model(opt, grads, bc, seeds, slot, sqrt=np.sqrt):
    """One tensor's step as csrc/adam.cu computes it: (p, m, v) as f32.
    ``sqrt``: the kernel's is correctly rounded (``__fsqrt_rn``), as numpy's
    and the card's PyTorch's are."""
    f = np.float32
    p = opt.params[slot].float().numpy().ravel()
    g = grads[slot].float().numpy().ravel()
    m = opt.m[slot].float().numpy().ravel()
    v = opt.v[slot].float().numpy().ravel()
    bc1, bc2 = f(bc[0].item()), f(bc[1].item())
    lr, b1, omb1 = f(opt.lr), f(opt.beta1), f(1.0 - opt.beta1)
    b2, omb2, eps, wd = f(opt.beta2), f(1.0 - opt.beta2), f(opt.eps), f(opt.weight_decay)
    if opt.weight_decay:
        g = g + wd * p
    m = b1 * m + omb1 * g
    v = b2 * v + omb2 * (g * g)
    q = p - (lr * (m / bc1)) / (sqrt(v / bc2) + eps)
    if opt.params[slot].dtype == BF16:
        e = np.arange(q.size, dtype=np.int64)
        block, wstride, offset = k.shard_ints(opt.params[slot].shape, opt.shards[slot])
        if block:
            e = (e // block) * wstride + e % block + offset
        word = (q.view(np.uint32).astype(np.uint64) + _hash(e, int(seeds[slot])))
        q = (word & 0xFFFF0000).astype(np.uint32).view(np.float32)
    if opt.m[slot].dtype == BF16:
        m, v = _rne(m), _rne(v)
    return q, m, v


def _card_rounding(x, seed, shard=None):
    """stochastic_round_bf16's card branch, on the CPU: the hash's bits."""
    bits = x.float().contiguous().view(torch.int32)
    index = None if shard is None else optim.global_index(x.shape, shard, x.device)
    rnd = optim.rounding_bits(x.numel(), seed, x.device, index).view(x.shape)
    return ((bits + rnd) & -65536).view(torch.float32).to(BF16)


def _torch_sqrt(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).sqrt().numpy()


def _optimizer(shapes, mode, wd=1e-5, seed=0):
    p_dtype, mv = MODES[mode]
    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=gen).to(p_dtype) for s in shapes]
    return Adam(params, lr=2e-4, beta1=0.5, beta2=0.999, weight_decay=wd, mv_dtype=mv)


@pytest.mark.parametrize("wd", [1e-5, 0.0])
@pytest.mark.parametrize("mode", MODES)
def test_model_gives_the_plain_loops_bits(mode, wd, monkeypatch):
    """Five steps: the numpy model of the kernel against ``_apply_plain``
    (its bf16 masters rounded with the card's hash), bit for bit; one
    tensor a slice of a whole one (a mesh's model axis). The model takes
    the square root from PyTorch's CPU kernel here: its vectorized sqrt is
    off by one ulp on some inputs, which the card's is not."""
    monkeypatch.setattr(optim, "stochastic_round_bf16", _card_rounding)
    shapes = [(64, 3, 4, 4), (128,), (13,), (7, 9), (256, 128, 4, 4)]
    opt = _optimizer(shapes, mode, wd)
    opt.shards[3] = ((7, 27), 1, 9)  # columns 9..17 of a 7 x 27 tensor
    gen = torch.Generator().manual_seed(1)
    for step in range(1, 6):
        grads = [(torch.randn(p.shape, generator=gen) * 0.1).to(p.dtype) for p in opt.params]
        bc1, bc2, seeds = opt.step_scalars(step)
        bc = torch.tensor([bc1, bc2])
        seeds = torch.tensor(seeds, dtype=torch.int32)
        want = [_model(opt, grads, bc, seeds, i, _torch_sqrt) for i in range(len(shapes))]
        opt._apply_plain(grads, bc, seeds)
        for i, (q, m, v) in enumerate(want):
            assert np.array_equal(opt.params[i].float().numpy().ravel().view(np.uint32),
                                  q.view(np.uint32)), (step, i)
            assert np.array_equal(opt.m[i].float().numpy().ravel().view(np.uint32),
                                  m.view(np.uint32)), (step, i)
            assert np.array_equal(opt.v[i].float().numpy().ravel().view(np.uint32),
                                  v.view(np.uint32)), (step, i)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_apply_takes_the_plain_loop(mode, monkeypatch):
    def refuse(*_):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    shapes = [(64, 3, 4, 4), (128,), (13,)]
    opt, ref = _optimizer(shapes, mode), _optimizer(shapes, mode)
    for step in range(1, 3):
        grads = [torch.full(p.shape, 0.01 * step).to(p.dtype) for p in opt.params]
        opt.step += 1
        bc1, bc2, seeds = opt.step_scalars(opt.step)
        bc, seeds = torch.tensor([bc1, bc2]), torch.tensor(seeds, dtype=torch.int32)
        opt.apply(grads, bc, seeds)
        ref._apply_plain(grads, bc, seeds)
    assert _build.launches["adam"] == 0
    for a, b in zip(opt.params + opt.m + opt.v, ref.params + ref.m + ref.v):
        assert torch.equal(a, b)


class _Stand:
    """A CUDA tensor's stand-in: what ``multi_tensor_adam`` reads of one."""

    def __init__(self, shape, dtype, address, stride=1, device=torch.device("cuda", 0),
                 contiguous=True):
        self.shape, self.dtype, self.address, self._stride = tuple(shape), dtype, address, stride
        self.device, self._contiguous = device, contiguous

    def numel(self):
        return int(np.prod(self.shape))

    def data_ptr(self):
        return self.address

    def dim(self):
        return len(self.shape)

    def stride(self, _=0):
        return self._stride

    def is_contiguous(self):
        return self._contiguous


class _Entry:
    """The C entry's stand-in: its argument count against the ctypes
    signature, and the meta rows it was given."""

    def __init__(self):
        self.want = len(_build._SIGNATURES["discogan_adam"][1])
        self.calls = []

    def __call__(self, *args):
        assert len(args) == self.want
        n = args[2]
        meta = ctypes.cast(args[1], ctypes.POINTER(ctypes.c_int * (k.META * n))).contents
        ptrs = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_longlong * (4 * n))).contents
        self.calls.append((list(ptrs), list(meta), args[2:]))
        return 0


def test_wrapper_matches_the_entry_signature(monkeypatch):
    entry = _Entry()
    monkeypatch.setattr(_build, "library", lambda: SimpleNamespace(discogan_adam=entry))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    sizes = [(64, 3, 4, 4)] + [(13,)] * 57 + [(5, 8)]
    at = iter(range(1 << 40, 1 << 41, 1 << 20))
    opt = SimpleNamespace(params=[_Stand(s, F32, next(at)) for s in sizes],
                          m=[_Stand(s, BF16, next(at)) for s in sizes],
                          v=[_Stand(s, BF16, next(at)) for s in sizes],
                          shards=[None] * 58 + [((5, 16), 1, 8)],
                          lr=2e-4, beta1=0.5, beta2=0.999, eps=1e-8, weight_decay=1e-5)
    grads = [_Stand(s, F32, next(at) + 4) for s in sizes]
    bc = _Stand((2,), F32, next(at), stride=2)
    seeds = _Stand((59,), torch.int32, next(at), stride=2)
    k.multi_tensor_adam(opt, grads, bc, seeds)
    assert _build.launches["adam"] == 2
    (p0, meta0, rest0), (p1, meta1, rest1) = entry.calls
    assert rest0[:3] == (52, k.CHUNK, 1 + 51) and rest1[:3] == (7, k.CHUNK, 7)
    assert p0[:4] == [opt.params[0].address, grads[0].address, opt.m[0].address,
                      opt.v[0].address]
    # numel, first chunk, slot, head, aligned (g 4 bytes off), shard, gather
    assert meta0[:13] == [3072, 0, 0, 0, 0b1101, 0, 0, 0, 0, 0, 0, 0, 0]
    assert meta1[-13:] == [40, 6, 58, 0, 0b1101, 8, 16, 8, 0, 0, 0, 0, 0]
    assert rest0[3:7] == (bc.address, 2, seeds.address, 2)
    assert rest0[7:15] == (2e-4, 0.5, 0.5, 0.999, 1.0 - 0.999, 1e-8, 1e-5, 1)
    assert rest0[15:18] == (0, 0, 1)


def _card_optimizer(sizes, dtype=F32):
    at = iter(range(1 << 40, 1 << 41, 1 << 20))
    opt = SimpleNamespace(params=[_Stand(s, dtype, next(at)) for s in sizes],
                          m=[_Stand(s, dtype, next(at)) for s in sizes],
                          v=[_Stand(s, dtype, next(at)) for s in sizes],
                          shards=[None] * len(sizes),
                          lr=2e-4, beta1=0.5, beta2=0.999, eps=1e-8, weight_decay=1e-5)
    grads = [_Stand(s, dtype, next(at)) for s in sizes]
    bc = _Stand((2,), F32, next(at))
    seeds = _Stand((len(sizes),), torch.int32, next(at))
    return opt, grads, bc, seeds


def _refuse(monkeypatch, opt, grads, bc, seeds, match):
    def refuse(*_):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    with pytest.raises(ValueError, match=match):
        k.multi_tensor_adam(opt, grads, bc, seeds)


def test_off_card_scalars_go_to_the_plain_loop(monkeypatch):
    """Scalars off the parameters' card raise: the card has no plain path."""
    opt, grads, _, seeds = _card_optimizer([(8,), (16,)])
    _refuse(monkeypatch, opt, grads, torch.zeros(2), seeds, r"bc is .* on cpu")


@pytest.mark.parametrize("case,match", [
    ("bc f64", r"bc is torch.float64"), ("bc short", r"bc is .*\(1,\)"),
    ("seeds int64", r"seeds is torch.int64"), ("seeds short", r"seeds is .*\(1,\)"),
    ("g on cpu", r"tensor 1 \(16,\): .* not all on cuda:0"),
    ("m f16", r"tensor 1 \(16,\): dtypes .* m torch.float16"),
    ("p not contiguous", r"tensor 1 \(16,\): p is not contiguous"),
    ("v not contiguous", r"tensor 1 \(16,\): v is not contiguous"),
    ("g size", r"tensor 1 \(16,\): sizes p 16, g 15"),
    ("g layout", r"tensor 0 \(8, 2, 4, 4\): g's strides"),
    ("p unaligned, g permuted", r"tensor 0 \(8, 2, 4, 4\): .* not 16-byte aligned"),
])
def test_what_the_kernel_does_not_take_raises(monkeypatch, case, match):
    """On the card each scalar and tensor the kernel does not take raises a
    ValueError that names it and why, before any launch."""
    opt, grads, bc, seeds = _card_optimizer([(8, 2, 4, 4), (16,)])
    if case == "bc f64":
        bc = _Stand((2,), torch.float64, bc.address)
    elif case == "bc short":
        bc = _Stand((1,), F32, bc.address)
    elif case == "seeds int64":
        seeds = _Stand((2,), torch.int64, seeds.address)
    elif case == "seeds short":
        seeds = _Stand((1,), torch.int32, seeds.address)
    elif case == "g on cpu":
        grads[1] = _Stand((16,), F32, grads[1].address, device=torch.device("cpu"))
    elif case == "m f16":
        opt.m[1] = _Stand((16,), torch.float16, opt.m[1].address)
    elif case == "p not contiguous":
        opt.params[1] = _Stand((16,), F32, opt.params[1].address, contiguous=False)
    elif case == "v not contiguous":
        opt.v[1] = _Stand((16,), F32, opt.v[1].address, contiguous=False)
    elif case == "g size":
        grads[1] = _Stand((15,), F32, grads[1].address)
    else:
        # A real 4-D gradient's strides on a stand-in: transposed taps
        # (no gather layout), or a conv weight's permuted order.
        order = (0, 1, 3, 2) if case == "g layout" else (2, 3, 1, 0)
        g = _laid_out((8, 2, 4, 4), order)
        grads[0] = SimpleNamespace(shape=g.shape, dtype=F32, device=torch.device("cuda", 0),
                                   numel=g.numel, stride=g.stride, dim=g.dim,
                                   is_contiguous=lambda: False, data_ptr=lambda: 1 << 40)
        if case != "g layout":
            opt.params[0] = _Stand((8, 2, 4, 4), F32, opt.params[0].address + 4)
    _refuse(monkeypatch, opt, grads, bc, seeds, match)


# (p shape, the order g is laid out in (a permutation of p's dims), the
# layout's name): the conv weights' gradients as materialize's views leave
# them: enc/dis convs' (2, 3, 1, 0), decoder convTs' (0, 2, 3, 1), the
# head's (2, 3, 0, 1).
GATHERED = [((64, 3, 4, 4), (2, 3, 1, 0), "conv stem"), ((256, 128, 4, 4), (2, 3, 1, 0), "conv"),
            ((1, 512, 4, 4), (2, 3, 1, 0), "dis head"), ((512, 256, 4, 4), (0, 2, 3, 1), "convT"),
            ((100, 128, 4, 4), (0, 2, 3, 1), "dec0"), ((64, 3, 4, 4), (2, 3, 0, 1), "head"),
            ((64, 3, 4, 4), (0, 2, 3, 1), "head as convT")]


def _laid_out(shape, order):
    """A tensor of ``shape`` whose memory holds it in ``order``, with its
    logical index as its value."""
    dense = torch.arange(int(np.prod(shape)), dtype=torch.float64).view(shape)
    return dense.permute(order).contiguous().permute(np.argsort(order).tolist())


@pytest.mark.parametrize("shape,order", [(s, o) for s, o, _ in GATHERED],
                         ids=[name for _, _, name in GATHERED])
def test_gather_layout_addresses_every_tap(shape, order):
    p = torch.zeros(shape)
    g = _laid_out(shape, order)
    ys, px, py, gx, gt = k.gather_layout(p, g)
    raw = torch.as_strided(g, (g.numel(),), (1,))  # g's memory in order
    pairs = p.numel() // k.TAPS
    q = np.arange(pairs)
    x, y = q // ys, q % ys
    t = np.arange(k.TAPS)
    e = (x * px + y * py)[:, None] + t
    at = (x * gx + y)[:, None] + t * gt
    assert sorted(e.ravel()) == list(range(p.numel()))
    assert sorted(at.ravel()) == list(range(p.numel()))
    assert np.array_equal(raw.numpy()[at.ravel()], e.ravel())  # g's value is its index


@pytest.mark.parametrize("case", ["contiguous taps swapped", "not dense", "3-D", "taps 9"])
def test_gather_layout_refuses(case):
    p = torch.zeros(64, 32, 4, 4)
    if case == "contiguous taps swapped":
        g = _laid_out((64, 32, 4, 4), (3, 2, 1, 0))  # kw outer of kh
    elif case == "not dense":
        g = torch.zeros(4, 4, 32, 128).permute(3, 2, 0, 1)[:64]
    elif case == "3-D":
        p, g = torch.zeros(64, 32, 16), torch.zeros(16, 32, 64).permute(2, 1, 0)
    else:
        p, g = torch.zeros(64, 32, 3, 3), _laid_out((64, 32, 3, 3), (2, 3, 1, 0))
    assert k.gather_layout(p, g) is None


def test_the_weights_gradients_are_gathered():
    """Every gradient of a 16px train step (f32, on the CPU) is contiguous
    or in a gather layout; the layouts seen are the conv weights'."""
    from discogan_modernized_torch.core.precision import default_policy
    from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                      loss_and_grads)

    cfg = TrainConfig(image_size=16, precision="f32", slim_state="mv")
    ts = init_train_state(0, cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    A, B = torch.rand(2, 2, 16, 16, 3, generator=gen)
    gathered = 0
    for which, opt in (("gen", ts.opt_gen), ("dis", ts.opt_dis)):
        _, grads = loss_and_grads(ts, A, B, torch.tensor(0.9), cfg, default_policy("f32"),
                                  which)
        for p, g in zip(opt.params, grads):
            if not g.is_contiguous():
                assert k.gather_layout(p, g) is not None, (which, tuple(p.shape), g.stride())
                gathered += 1
    assert gathered == 18  # the 16px networks' conv and convT weights


def _pair_of(q, pairs, ys, px, py):
    """csrc/adam.cu's gathered walk: pair q's (x, y), in rows of Y_ROW
    neighbouring y with x fastest where p keeps x contiguous."""
    xs = pairs // ys
    rows = min(ys, _constant("Y_ROW")) if py > px else ys
    r, in_row = q // (rows * xs), q % (rows * xs)
    w = np.minimum(rows, ys - r * rows)
    x = in_row // w
    return x, r * rows + in_row - x * w


@pytest.mark.parametrize("shape,order", [(s, o) for s, o, _ in GATHERED],
                         ids=[name for _, _, name in GATHERED])
def test_gathered_warps_read_whole_sectors(shape, order):
    """In the walk's order, a warp's 8 pairs are 8 neighbouring y of one x
    (one 32-byte f32 sector of g a tap) wherever y has 8; where p keeps x
    contiguous, neighbouring warps take neighbouring x."""
    ys, px, py, gx, gt = k.gather_layout(torch.zeros(shape), _laid_out(shape, order))
    pairs = int(np.prod(shape)) // k.TAPS
    x, y = _pair_of(np.arange(pairs), pairs, ys, px, py)
    for w in range(0, pairs - 7, 8):
        xw, yw = x[w:w + 8], y[w:w + 8]
        if ys % 8 == 0:
            assert (xw == xw[0]).all() and (np.diff(yw) == 1).all()
    if py > px and ys % 8 == 0 and pairs // ys > 1:
        assert x[8] == x[0] + 1 and y[8] == y[0]


@pytest.mark.parametrize("chunk", [16, 256, k.CHUNK])
def test_gathered_walk_covers_every_element_once(chunk):
    tensors = []
    for slot, (shape, order, _) in enumerate(GATHERED):
        layout = k.gather_layout(torch.zeros(shape), _laid_out(shape, order))
        tensors.append((slot, int(np.prod(shape)), (F32, F32, BF16), (1 << 20,) * 4, layout))
    for launch in k.adam_plan(tensors, chunk=chunk, max_tensors=3):
        p_seen = [np.zeros(i.numel, np.int64) for i in launch.items]
        g_seen = [np.zeros(i.numel, np.int64) for i in launch.items]
        for c in range(launch.blocks):
            t = max(i for i in range(len(launch.items)) if launch.first[i] <= c)
            item, j = launch.items[t], c - launch.first[t]
            ys, px, py, gx, gt = item.gather
            per = chunk // k.TAPS
            q = np.arange(j * per, min(item.numel // k.TAPS, (j + 1) * per))
            x, y = _pair_of(q, item.numel // k.TAPS, ys, px, py)
            taps = np.arange(k.TAPS)
            np.add.at(p_seen[t], ((x * px + y * py)[:, None] + taps).ravel(), 1)
            np.add.at(g_seen[t], ((x * gx + y)[:, None] + taps * gt).ravel(), 1)
        for item, ps, gs in zip(launch.items, p_seen, g_seen):
            assert (ps == 1).all() and (gs == 1).all(), item
            assert item.head == 0 and item.chunks == -(-item.numel // chunk)
