"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is not available, as on the CPU hosts
that run the rest of the suite. On a machine with the card (and without
JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Each kernel is also captured in a CUDA graph and replayed on new inputs,
single and as a pair launch, at one 512px batch-8 training shape: the
replays give an eager launch's bits.

Shapes: the 512px forward's and training step's (small batches where it
is quick) and the odd ones that take the kernels' edge paths (ragged rows,
non-square maps, channel counts off the tile, partial bands, more than one
column segment, split and unsplit reductions). Inputs are bf16 or f32;
tolerance 1e-4 (f32) or 2e-2 (bf16, which the kernel and the plain version
round at different places), relative to max(1, max|ref|); statistics, which
both sides take from f32 sums of exact products, 1e-4 in either dtype. The
reductions use no float atomics: two launches give the same bits. With a
pair axis (P = 2, ops/pairs.py) each kernel launches once, and each pair's
outputs equal a single launch's on its operands bit for bit.
"""

import pytest
import torch

from discogan_modernized_torch.core.precision import BF16, F32, configure
from discogan_modernized_torch.ops.conv_k4s2p1 import (conv2d_k4s2p1,
                                                       conv2d_k4s2p1_dw,
                                                       conv2d_k4s2p1_dw_plain,
                                                       conv2d_k4s2p1_plain)
from discogan_modernized_torch.ops.fused import (batch_stats, batch_stats_plain,
                                                 bn_act, bn_act_plain)
from discogan_modernized_torch.ops.halo_conv import (halo_conv2d_k4s2p1,
                                                     halo_conv2d_k4s2p1_dw,
                                                     halo_conv2d_k4s2p1_dw_plain,
                                                     halo_conv2d_k4s2p1_plain)
from discogan_modernized_torch.ops.head import head_convt, head_convt_plain

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, dtype, *shape, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)


def _close(got, want, dtype, tol=None):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    limit = (tol or TOL[dtype]) * max(1.0, want.float().abs().max().item())
    assert err <= limit, err


@pytest.fixture(params=DTYPES, ids=["f32", "bf16"])
def dtype(request):
    configure(F32 if request.param == torch.float32 else BF16)
    return request.param


# K1's and K2's edge shapes (chip_smoke.py's FUSED_EDGE): C 3 (off the
# 16-byte vectors, an odd count: the general path and its scalar tail), C 24
# (three vectors a row), one row, rows fewer than K1's target splits, C 2048
# at batch 1, a ragged last split.
FUSED_EDGE = [(3, 5, 7, 3), (2, 5, 7, 24), (1, 1, 1, 256), (1, 10, 10, 64),
              (1, 4, 4, 2048), (3, 37, 41, 128)]


@pytest.mark.parametrize("shape,act", [((2, 8, 8, 128), "leaky"),
                                       ((3, 5, 5, 100), "relu"),
                                       ((4, 4, 4, 2048), None),
                                       ((8, 256, 256, 64), "relu"),
                                       *[(s, "leaky") for s in FUSED_EDGE]])
def test_bn_act(gen, dtype, shape, act):
    """Both kernels: C a multiple of the vector keeps its channels
    (bn_act_vec_kernel), the rest (bf16 C 100, C 3) takes bn_act_any_kernel;
    one launch each."""
    from discogan_modernized_torch.ops import _build

    c = shape[-1]
    x = _rand(gen, dtype, *shape)
    s = torch.rand(c, device="cuda", generator=gen) + 0.5
    o = torch.randn(c, device="cuda", generator=gen)
    before = _build.launches["bn_act"]
    got = bn_act(x, s, o, act)
    assert _build.launches["bn_act"] == before + 1
    _close(got, bn_act_plain(x, s, o, act), dtype)


@pytest.mark.parametrize("n,h,w,ci,co,affine", [
    (2, 32, 32, 3, 64, False), (3, 6, 10, 16, 72, True), (3, 10, 6, 32, 40, True),
    (2, 6, 10, 96, 136, True), (4, 128, 128, 128, 256, True),
    (4, 16, 16, 1024, 2048, True), (4, 8, 8, 2048, 2048, True),
    (1, 128, 128, 128, 256, True), (1, 16, 16, 1024, 2048, True),
    (1, 8, 8, 2048, 2048, True)])
def test_conv_k4s2p1(gen, dtype, n, h, w, ci, co, affine):
    x = _rand(gen, dtype, n, h, w, ci)
    wt = _rand(gen, dtype, 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    s = torch.rand(co, device="cuda", generator=gen) if affine else None
    o = torch.randn(co, device="cuda", generator=gen) if affine else None
    _close(conv2d_k4s2p1(x, wt, scale=s, offset=o, act="leaky"),
           conv2d_k4s2p1_plain(x, wt, scale=s, offset=o, act="leaky"), dtype)


@pytest.mark.parametrize("stats", [False, True], ids=["epilogue", "stats"])
@pytest.mark.parametrize("n,h,w,ci,co", [
    (1, 128, 128, 128, 256), (4, 128, 128, 128, 256), (8, 128, 128, 128, 256),
    (8, 64, 64, 256, 512), (8, 32, 32, 512, 1024), (4, 16, 16, 1024, 2048),
    (8, 8, 8, 2048, 2048), (2, 16, 16, 64, 72), (16, 64, 64, 64, 72),
    (1, 8, 8, 2048, 2048), (3, 14, 10, 64, 128), (9, 62, 62, 64, 128),
    (5, 32, 32, 256, 128), (2, 32, 32, 32, 64), (2, 6, 10, 96, 136),
    (2, 16, 16, 1, 64), (8, 512, 512, 3, 64), (3, 14, 10, 3, 64), (2, 32, 32, 4, 128)])
def test_conv_k4s2p1_tensor_cores(gen, n, h, w, ci, co, stats):
    """bf16 on the route conv_plan gives: the wgmma kernel at enc2 (batch 1,
    4, 8: split, and 128 x 256 tiles), enc3-enc6 and its edge shapes (CO 72
    split and unsplit, M under one 64-row tile, a ragged M split and
    unsplit, a split that does not divide the 64 K steps in 13 parts); the
    FMA kernel at CI 32 and 96; the stem's kernel at CI 1, 3 and 4. One
    launch each; the statistics within 1e-4."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.conv_k4s2p1 import conv_plan

    configure(BF16)
    want_path = "wgmma_stem" if ci <= 4 else "wgmma" if ci % 64 == 0 else "fma"
    assert conv_plan(n, h, w, ci, co, torch.bfloat16).path == want_path
    x = _rand(gen, torch.bfloat16, n, h, w, ci)
    wt = _rand(gen, torch.bfloat16, 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    s = None if stats else torch.rand(co, device="cuda", generator=gen) + 0.5
    o = None if stats else torch.randn(co, device="cuda", generator=gen) * 0.1
    act = None if stats else "leaky"
    before = _build.launches["conv_k4s2p1"]
    got = conv2d_k4s2p1(x, wt, scale=s, offset=o, act=act, with_stats=stats)
    assert _build.launches["conv_k4s2p1"] == before + 1
    want = conv2d_k4s2p1_plain(x, wt, scale=s, offset=o, act=act, with_stats=stats)
    if not stats:
        _close(got, want, torch.bfloat16)
        return
    _close(got[0], want[0], torch.bfloat16)
    for g, w_ in zip(got[1], want[1]):
        _close(g, w_, torch.bfloat16, tol=1e-4)


@pytest.mark.parametrize("n,h,w,ci,co,affine", [
    (2, 16, 16, 8, 16, False), (3, 14, 22, 8, 24, True), (2, 32, 32, 16, 16, True),
    (3, 40, 64, 16, 8, True), (1, 512, 512, 16, 8, True), (4, 256, 256, 64, 128, True)])
def test_halo_conv(gen, dtype, n, h, w, ci, co, affine):
    x = _rand(gen, dtype, n, h, w, ci)
    wt = _rand(gen, dtype, 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    s = torch.rand(co, device="cuda", generator=gen) if affine else None
    o = torch.randn(co, device="cuda", generator=gen) if affine else None
    _close(halo_conv2d_k4s2p1(x, wt, scale=s, offset=o, act="leaky"),
           halo_conv2d_k4s2p1_plain(x, wt, scale=s, offset=o, act="leaky"), dtype)


@pytest.mark.parametrize("affine", [True, False], ids=["epilogue", "raw"])
@pytest.mark.parametrize("n,h,w,ci,co", [
    (1, 256, 256, 64, 128), (4, 256, 256, 64, 128), (8, 256, 256, 64, 128),
    (4, 58, 40, 32, 72), (8, 46, 256, 32, 128), (8, 24, 256, 16, 128),
    (2, 24, 200, 16, 24), (1, 20, 300, 64, 136), (3, 10, 6, 48, 16)])
def test_halo_conv_tensor_cores(gen, n, h, w, ci, co, affine):
    """The bf16 wgmma path at enc1 (batch 1, 4, 8) and its edge cases: rows
    per block that do not divide the map (29 rows in bands of 2; 23 in
    bands of 6) or are odd (3), strips narrower than 64 (20; 100 = 64 + 36;
    150 = 64 + 64 + 22), CO off the 64 tile (72, 24, 136), CI of 16, 32
    and 48, non-square maps. One launch each, on the tensor-core route."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.halo_conv import tc_plan

    configure(BF16)
    assert tc_plan(n, h, w, ci, co, torch.bfloat16) is not None
    x = _rand(gen, torch.bfloat16, n, h, w, ci)
    wt = _rand(gen, torch.bfloat16, 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    s = torch.rand(co, device="cuda", generator=gen) + 0.5 if affine else None
    o = torch.randn(co, device="cuda", generator=gen) * 0.1 if affine else None
    act = "leaky" if affine else None
    before = _build.launches["halo_conv_k4s2p1"]
    got = halo_conv2d_k4s2p1(x, wt, scale=s, offset=o, act=act)
    assert _build.launches["halo_conv_k4s2p1"] == before + 1
    _close(got, halo_conv2d_k4s2p1_plain(x, wt, scale=s, offset=o, act=act),
           torch.bfloat16)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 8, 8, 16, 1), (1, 40, 24, 8, 3), (2, 8, 300, 16, 3), (1, 6, 10, 24, 8),
    (4, 256, 256, 64, 3)])
def test_head_convt(gen, dtype, n, h, w, ci, co):
    x = _rand(gen, dtype, n, h, w, ci)
    wt = _rand(gen, dtype, 4, 4, ci, co, scale=(16 * co) ** -0.5)
    _close(head_convt(x, wt), head_convt_plain(x, wt), dtype)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (1, 256, 256, 64, 3), (4, 256, 256, 64, 3), (8, 256, 256, 64, 3),
    (2, 10, 24, 64, 3), (1, 6, 40, 16, 1), (1, 8, 300, 32, 3), (60, 10, 24, 64, 3),
    (40, 58, 40, 16, 3), (2, 6, 40, 48, 3), (2, 1, 256, 64, 3), (2, 2, 128, 64, 8),
    (24, 16, 40, 32, 8), (1, 16, 256, 128, 3), (30, 20, 40, 128, 8)])
def test_head_convt_tensor_cores(gen, n, h, w, ci, co):
    """The bf16 tensor-core path (head_convt_mma_kernel) at the 512px head
    and stems' dx (batch 1, 4, 8) and its edge shapes: W off a multiple of
    16 (24, 40), three strips (300), bands that do not divide H (10 in bands
    of 3, 58 in bands of 10), H 1, 2 and 6, CO 1, 3 and 8, CI 16, 32, 48,
    64 and 128 (CI 128 with CO 8 on a ring of 4 rows), batch 1 and 2. One
    launch each, on the tensor-core route."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.head import head_plan

    configure(BF16)
    assert head_plan(n, h, w, ci, co, torch.bfloat16) is not None
    x = _rand(gen, torch.bfloat16, n, h, w, ci)
    wt = _rand(gen, torch.bfloat16, 4, 4, ci, co, scale=(16 * co) ** -0.5)
    before = _build.launches["head_convt"]
    got = head_convt(x, wt)
    assert _build.launches["head_convt"] == before + 1
    _close(got, head_convt_plain(x, wt), torch.bfloat16)


def test_cuda_tensor_never_takes_the_plain_version(gen):
    """A CUDA input launches the kernel (its count rises) or raises."""
    from discogan_modernized_torch.ops import _build

    x = _rand(gen, torch.float32, 1, 8, 8, 8)
    before = _build.launches["conv_k4s2p1"]
    conv2d_k4s2p1(x, _rand(gen, torch.float32, 4, 4, 8, 8))
    assert _build.launches["conv_k4s2p1"] == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_k4s2p1(x.transpose(1, 2), _rand(gen, torch.float32, 4, 4, 8, 8))


@pytest.mark.parametrize("fn", [conv2d_k4s2p1, halo_conv2d_k4s2p1])
def test_misaligned_view_raises(gen, fn):
    """A contiguous bf16 view at an odd storage offset is refused, not given
    a slower path."""
    shape = (1, 32, 32, 32)
    buf = _rand(gen, torch.bfloat16, 1 + 32 * 32 * 32)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fn(x, _rand(gen, torch.bfloat16, 4, 4, 32, 32))


@pytest.mark.parametrize("shape", [(4, 128, 128, 128), (3, 5, 5, 128), (8, 1, 1, 100),
                                   (2, 4, 4, 2048), (2, 256, 256, 64), (3, 5, 5, 100),
                                   *FUSED_EDGE])
def test_batch_stats(gen, dtype, shape):
    x = (_rand(gen, torch.float32, *shape) + 0.5).to(dtype)
    got, want = batch_stats(x), batch_stats_plain(x)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol=1e-4)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (4, 128, 128, 128, 256), (4, 16, 16, 1024, 2048), (2, 8, 8, 2048, 2048),
    (3, 6, 10, 16, 72), (2, 6, 10, 96, 136)])
def test_conv_k4s2p1_with_stats(gen, dtype, n, h, w, ci, co):
    """Unsplit and split-K tensor-core paths (bf16) and the FMA path."""
    x = _rand(gen, dtype, n, h, w, ci)
    wt = _rand(gen, dtype, 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    y, (mean, mean_sq) = conv2d_k4s2p1(x, wt, with_stats=True)
    y0, (mean0, mean_sq0) = conv2d_k4s2p1_plain(x, wt, with_stats=True)
    _close(y, y0, dtype)
    _close(mean, mean0, dtype, tol=1e-4)
    _close(mean_sq, mean_sq0, dtype, tol=1e-4)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 64, 64, 3, 64), (4, 16, 16, 64, 128), (2, 16, 16, 1024, 2048),
    (2, 32, 32, 128, 256), (3, 6, 10, 16, 72), (1, 8, 8, 24, 40),
    (2, 16, 16, 16, 64), (2, 32, 32, 32, 64), (3, 16, 16, 48, 72),
    (1, 8, 8, 2048, 2048), (3, 14, 10, 16, 72), (2, 128, 128, 128, 256),
    (2, 16, 16, 1, 8), (2, 32, 32, 4, 72)])
def test_conv_k4s2p1_dw(gen, dtype, n, h, w, ci, co):
    """In bf16 the wgmma kernel with parity planes (W/2 a multiple of 8) and
    per-tap windows (W/2 of 5 and 4), with and without its split over M
    (enc2 at batch 2), at CI 16/32/48 under one channel block, CO off the
    128 tile (72, 40), M under one chunk (enc6 at batch 1: 16 pixels) and
    ragged (105 pixels); the stem's kernel at CI 1, 3 and 4. In f32 the FMA
    kernel, split over M for the stem."""
    x = _rand(gen, dtype, n, h, w, ci)
    dy = _rand(gen, dtype, n, h // 2, w // 2, co, scale=0.1)
    _close(conv2d_k4s2p1_dw(x, dy), conv2d_k4s2p1_dw_plain(x, dy), dtype)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 16, 16, 8, 16), (3, 14, 22, 8, 24), (1, 64, 40, 16, 8),
    (2, 256, 256, 64, 128), (8, 256, 256, 64, 128), (1, 256, 256, 64, 128),
    (2, 64, 64, 16, 128), (1, 48, 256, 32, 72), (2, 40, 128, 48, 136),
    (2, 128, 128, 64, 24), (3, 30, 40, 16, 72), (1, 10, 208, 64, 128)])
def test_halo_conv_k4s2p1_dw(gen, dtype, n, h, w, ci, co):
    """In bf16 the wgmma kernel (halo_dw_wgmma_kernel) at enc1 at batch 1,
    2 and 8 (split over M), with parity planes and per-tap windows (W/2 of
    11, 20), at CI 8/16/32/48 under one channel block, CO off the 128 tile
    (8, 16, 24, 72, 136) and a ragged M; in f32 the FMA kernel. One launch
    each."""
    from discogan_modernized_torch.ops import _build

    x = _rand(gen, dtype, n, h, w, ci)
    dy = _rand(gen, dtype, n, h // 2, w // 2, co, scale=0.1)
    before = _build.launches["halo_conv_k4s2p1_dw"]
    got = halo_conv2d_k4s2p1_dw(x, dy)
    assert _build.launches["halo_conv_k4s2p1_dw"] == before + 1
    _close(got, halo_conv2d_k4s2p1_dw_plain(x, dy), dtype)


def test_two_launches_give_the_same_bits(gen, dtype):
    """Every reduction across blocks (K1 at C 128, 64, 100 and 2048, split
    over several blocks; K3's statistics on each of its
    paths: in bf16 the wgmma kernel split and unsplit, with a split that
    does not divide its K steps, and the stem's, in f32 the FMA kernel;
    K4's split sums on the stem's and the tensor-core path in bf16 and the
    FMA path in f32; K5b's on its wgmma path in bf16 and its FMA path in
    f32) sums its partials in a fixed order."""
    x = _rand(gen, dtype, 2, 256, 256, 64)
    dy = _rand(gen, dtype, 2, 128, 128, 128, scale=0.1)
    xd = _rand(gen, dtype, 2, 16, 16, 1024)
    wd = _rand(gen, dtype, 4, 4, 1024, 2048, scale=1 / 128)
    xu = _rand(gen, dtype, 2, 128, 128, 128)
    wu = _rand(gen, dtype, 4, 4, 128, 256, scale=1 / 45)
    x0 = _rand(gen, dtype, 2, 64, 64, 3)
    dy0 = _rand(gen, dtype, 2, 32, 32, 64)
    x2 = _rand(gen, dtype, 2, 128, 128, 128)
    dy2 = _rand(gen, dtype, 2, 64, 64, 256, scale=0.1)
    xs = _rand(gen, dtype, 5, 32, 32, 256)
    ws = _rand(gen, dtype, 4, 4, 256, 128, scale=1 / 64)
    ws0 = _rand(gen, dtype, 4, 4, 3, 64, scale=1 / 7)
    k1 = [_rand(gen, dtype, *shape) for shape in
          ((2, 64, 64, 64), (8, 16, 16, 100), (8, 8, 8, 2048))]
    calls = [lambda: batch_stats(x),
             *[lambda t=t: batch_stats(t) for t in k1],
             lambda: conv2d_k4s2p1(xd, wd, with_stats=True)[1],  # split-K
             lambda: conv2d_k4s2p1(xu, wu, with_stats=True)[1],  # unsplit
             lambda: (lambda r: (r[0], *r[1]))(  # 64 K steps in 13 parts: y too
                 conv2d_k4s2p1(xs, ws, with_stats=True)),
             lambda: conv2d_k4s2p1(x0, ws0, with_stats=True)[1],  # the stem
             lambda: conv2d_k4s2p1_dw(x0, dy0),  # the stem: its parts summed
             lambda: conv2d_k4s2p1_dw(x2, dy2),  # enc2 at batch 2, split over M
             lambda: halo_conv2d_k4s2p1_dw(x, dy)]
    for call in calls:
        a, b = call(), call()
        torch.cuda.synchronize()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


# ---- the pair axis (ops/pairs.py): one launch over P = 2 problems ---------

def _members(t, p, nd=4):
    return t if t is None or t.dim() == nd else t[p]


def _flat(out):
    """An output's tensors in order (y; y and the statistics; mean and var)."""
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


def _pair_check(kernel, fn, plain, operands, dtype, nd=None, **kw):
    """One pair launch: one count of ``kernel``, each pair's outputs bit for
    bit those of a single launch on its operands, and within the dtype's
    tolerance of the plain pair version (the statistics within 1e-4)."""
    from discogan_modernized_torch.ops import _build

    nd = nd or (4,) * len(operands)
    before = _build.launches[kernel]
    got = fn(*operands, **kw)
    assert _build.launches[kernel] == before + 1
    for p in range(2):
        single = fn(*(_members(t, p, d) for t, d in zip(operands, nd)), **kw)
        torch.cuda.synchronize()
        for a, b in zip(_flat(got), _flat(single)):
            assert torch.equal(a[p], b), (kernel, p)
    for i, (a, b) in enumerate(zip(_flat(got), _flat(plain(*operands, **kw)))):
        _close(a, b, dtype, 1e-4 if a.dtype == torch.float32 and i else None)


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("shape,act", [((8, 8, 8, 128), "leaky"), ((4, 5, 5, 100), "relu"),
                                       ((8, 256, 256, 64), "relu"), ((1, 4, 4, 2048), None),
                                       ((2, 5, 7, 24), "leaky")])
def test_bn_act_pairs(gen, dtype, shape, act, shared):
    c = shape[-1]
    lead = () if shared else (2,)
    x = _rand(gen, dtype, 2, *shape)
    s = torch.rand(*lead, c, device="cuda", generator=gen) + 0.5
    o = torch.randn(*lead, c, device="cuda", generator=gen)
    _pair_check("bn_act", bn_act, bn_act_plain, (x, s, o), dtype, nd=(4, 1, 1), act=act)


@pytest.mark.parametrize("shape", [(8, 128, 128, 128), (3, 5, 5, 128), (8, 1, 1, 100),
                                   (3, 37, 41, 128), (1, 4, 4, 2048), (8, 4, 4, 2048)])
def test_batch_stats_pairs(gen, dtype, shape):
    x = _rand(gen, dtype, 2, *shape)
    _pair_check("batch_stats", batch_stats, batch_stats_plain, (x,), dtype)


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("stats", [False, True], ids=["epilogue", "stats"])
@pytest.mark.parametrize("dt,n,h,w,ci,co", [
    (torch.bfloat16, 8, 512, 512, 3, 64),      # the stem
    (torch.bfloat16, 8, 128, 128, 128, 256),   # enc2 at batch 8: unsplit
    (torch.bfloat16, 8, 8, 8, 2048, 2048),     # enc6 at batch 8: split K
    (torch.bfloat16, 1, 16, 16, 1024, 2048),   # a split that leaves a ragged part
    (torch.bfloat16, 3, 10, 6, 64, 40),        # 64-row tiles, CO off the tile
    (torch.float32, 3, 6, 10, 16, 72),         # the FMA kernel
    (torch.float32, 2, 32, 32, 3, 64)])
def test_conv_k4s2p1_pairs(gen, dt, n, h, w, ci, co, stats, shared):
    configure(F32 if dt == torch.float32 else BF16)
    x = _rand(gen, dt, 2, n, h, w, ci)
    wt = _rand(gen, dt, *(() if shared else (2,)), 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    kw = {"with_stats": True} if stats else {"act": "leaky"}
    _pair_check("conv_k4s2p1", conv2d_k4s2p1, conv2d_k4s2p1_plain, (x, wt), dt, **kw)


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
def test_conv_k4s2p1_pairs_affine(gen, shared):
    """The serving epilogue with a scale and offset per pair or shared."""
    configure(BF16)
    x = _rand(gen, torch.bfloat16, 2, 4, 32, 32, 128)
    wt = _rand(gen, torch.bfloat16, 2, 4, 4, 128, 256, scale=1 / 45)
    lead = () if shared else (2,)
    s = torch.rand(*lead, 256, device="cuda", generator=gen)
    o = torch.randn(*lead, 256, device="cuda", generator=gen)
    _pair_check("conv_k4s2p1", lambda x, w, s, o, **kw: conv2d_k4s2p1(x, w, scale=s, offset=o,
                                                                        **kw),
                lambda x, w, s, o, **kw: conv2d_k4s2p1_plain(x, w, scale=s, offset=o, **kw),
                (x, wt, s, o), torch.bfloat16, nd=(4, 4, 1, 1), act="leaky")


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("dt,n,h,w,ci,co", [
    (torch.bfloat16, 8, 256, 256, 64, 128),    # enc1 at 512px, batch 8
    (torch.bfloat16, 1, 200, 136, 32, 64),     # partial bands and strips
    (torch.float32, 2, 128, 128, 16, 24)])     # the FMA kernel
def test_halo_conv_pairs(gen, dt, n, h, w, ci, co, shared):
    configure(F32 if dt == torch.float32 else BF16)
    x = _rand(gen, dt, 2, n, h, w, ci)
    wt = _rand(gen, dt, *(() if shared else (2,)), 4, 4, ci, co, scale=(16 * ci) ** -0.5)
    _pair_check("halo_conv_k4s2p1", halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain, (x, wt), dt,
                act="leaky")


@pytest.mark.parametrize("dt,n,h,w,ci,co", [
    (torch.bfloat16, 8, 256, 256, 64, 3),      # the head at 512px, batch 8
    (torch.bfloat16, 8, 256, 256, 64, 3),
    (torch.bfloat16, 2, 37, 150, 128, 8),      # partial bands, two strips
    (torch.float32, 2, 16, 16, 64, 3)])        # the FMA kernel
def test_head_convt_pairs(gen, dt, n, h, w, ci, co):
    configure(F32 if dt == torch.float32 else BF16)
    x = _rand(gen, dt, 2, n, h, w, ci)
    wt = _rand(gen, dt, 2, 4, 4, ci, co, scale=(4 * ci) ** -0.5)
    _pair_check("head_convt", head_convt, head_convt_plain, (x, wt), dt)


@pytest.mark.parametrize("dt,n,h,w,ci,co", [
    (torch.bfloat16, 8, 512, 512, 3, 64),      # the stem's dw: its parts summed
    (torch.bfloat16, 8, 128, 128, 128, 256),   # enc2: parity planes
    (torch.bfloat16, 8, 8, 8, 1024, 2048),     # enc5: split over M
    (torch.bfloat16, 2, 12, 20, 64, 72),       # per-tap windows (WO % 8 != 0)
    (torch.float32, 2, 16, 16, 32, 64)])       # the FMA kernel
def test_conv_k4s2p1_dw_pairs(gen, dt, n, h, w, ci, co):
    configure(F32 if dt == torch.float32 else BF16)
    x = _rand(gen, dt, 2, n, h, w, ci)
    dy = _rand(gen, dt, 2, n, h // 2, w // 2, co, scale=0.1)
    _pair_check("conv_k4s2p1_dw", conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain, (x, dy), dt)


@pytest.mark.parametrize("dt,n,h,w,ci,co", [
    (torch.bfloat16, 8, 256, 256, 64, 128),    # enc1's dw at 512px, batch 8
    (torch.bfloat16, 1, 256, 200, 32, 64),
    (torch.float32, 2, 128, 128, 16, 24)])     # the FMA kernel, split rows
def test_halo_conv_k4s2p1_dw_pairs(gen, dt, n, h, w, ci, co):
    configure(F32 if dt == torch.float32 else BF16)
    x = _rand(gen, dt, 2, n, h, w, ci)
    dy = _rand(gen, dt, 2, n, h // 2, w // 2, co, scale=0.1)
    _pair_check("halo_conv_k4s2p1_dw", halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain,
                (x, dy), dt)


def test_pair_stride_off_16_bytes_raises(gen):
    """A pair whose operand would start off a 16-byte boundary is refused,
    as a misaligned view is: no slower path."""
    x = _rand(gen, torch.bfloat16, 2, 3, 5, 7, 3)  # 315 values a pair: 630 bytes
    s = torch.ones(2, 3, device="cuda")
    with pytest.raises(RuntimeError):
        bn_act(x, s, s, "relu")


# ---- CUDA graphs: each kernel captured, then replayed on new inputs --------

# One 512px batch-8 training shape a kernel (bf16): (fn, operand shapes, the
# operands' scales, keyword arguments). K1 at dec6 takes several splits, so
# its tile counters take part.
CAPTURE_CASES = {
    "batch_stats": (batch_stats, [(8, 256, 256, 64)], [1.0], {}),
    "bn_act": (lambda x, s, o: bn_act(x, s, o, "leaky"),
               [(8, 256, 256, 64), (64,), (64,)], [1.0, 1.0, 1.0], {}),
    "conv_k4s2p1": (conv2d_k4s2p1, [(8, 128, 128, 128), (4, 4, 128, 256)], [1.0, 1 / 45],
                    {"with_stats": True}),
    "conv_k4s2p1_dw": (conv2d_k4s2p1_dw, [(8, 128, 128, 128), (8, 64, 64, 256)], [1.0, 0.1],
                       {}),
    "halo_conv_k4s2p1": (halo_conv2d_k4s2p1, [(8, 256, 256, 64), (4, 4, 64, 128)],
                         [1.0, 1 / 32], {"act": "leaky"}),
    "halo_conv_k4s2p1_dw": (halo_conv2d_k4s2p1_dw, [(8, 256, 256, 64), (8, 128, 128, 128)],
                            [1.0, 0.1], {}),
    "head_convt": (head_convt, [(8, 256, 256, 64), (4, 4, 64, 3)], [1.0, 1 / 16], {}),
}


@pytest.mark.parametrize("paired", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("kernel", list(CAPTURE_CASES))
def test_captured_kernel_replays_equal_eager_launches(gen, kernel, paired):
    """Each kernel, single and as a pair launch (operands per pair),
    captured in a CUDA graph after one eager launch on a side stream; the
    graph replayed twice with new inputs copied into its static inputs;
    each replay's outputs equal an eager launch's on the same inputs bit
    for bit, and the capture counted one launch, the replays none."""
    from discogan_modernized_torch.ops import _build

    configure(BF16)
    fn, shapes, scales, kw = CAPTURE_CASES[kernel]
    lead = (2,) if paired else ()

    def operands():
        out = []
        for shape, scale in zip(shapes, scales):
            if len(shape) == 1:  # K2's scale and offset: f32
                out.append(torch.rand(*lead, *shape, device="cuda", generator=gen) + 0.5)
            else:
                out.append(_rand(gen, torch.bfloat16, *lead, *shape, scale=scale))
        return out

    static = operands()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.launches[kernel]
    with torch.cuda.graph(graph):
        out = fn(*static, **kw)
    assert _build.launches[kernel] == before + 1
    for _ in range(2):
        new = operands()
        for t, n in zip(static, new):
            t.copy_(n)
        before = _build.launches[kernel]
        graph.replay()
        assert _build.launches[kernel] == before
        want = fn(*new, **kw)
        torch.cuda.synchronize()
        for a, b in zip(_flat(out), _flat(want)):
            assert torch.equal(a, b), kernel


# -- the eval forward's kernels as registered ops (ops/library.py) -----------

# case -> (N, H, CI, CO, with the epilogue's scale and offset) of a conv at a
# 512px batch-4 forward shape: the stem's and enc2's for K3, enc1's for K5f.
OP_CONVS = {"conv_stem": (4, 512, 3, 64, False), "conv": (4, 128, 64, 128, True),
            "halo": (4, 256, 64, 128, True)}
OP_NAMES = [*OP_CONVS, "bn_act", "head"]
OP_LAUNCHES = {"conv_stem": "conv_k4s2p1", "conv": "conv_k4s2p1",
               "halo": "halo_conv_k4s2p1", "bn_act": "bn_act", "head": "head_convt"}


def _op_inputs(name, gen, dtype) -> list:
    """Case ``name``'s tensors, x first."""
    if name in OP_CONVS:
        n, h, ci, co, affine = OP_CONVS[name]
        out = [_rand(gen, dtype, n, h, h, ci), _rand(gen, dtype, 4, 4, ci, co, scale=0.1)]
        if affine:
            out += [_rand(gen, torch.float32, co).abs(), _rand(gen, torch.float32, co)]
        return out
    if name == "bn_act":
        return [_rand(gen, dtype, 4, 8, 8, 512), _rand(gen, torch.float32, 512),
                _rand(gen, torch.float32, 512)]
    return [_rand(gen, dtype, 4, 256, 256, 64), _rand(gen, dtype, 4, 4, 64, 3, scale=0.1)]


def _call(name, tensors, registered: bool):
    """Case ``name`` through its registered op, or its wrapper directly."""
    from discogan_modernized_torch.ops import library

    if name in OP_CONVS:
        x, w, *affine = tensors
        scale, offset = affine if affine else (None, None)
        fn = ((library.halo_op if registered else halo_conv2d_k4s2p1) if name == "halo"
              else (library.conv_op if registered else conv2d_k4s2p1))
        return fn(x, w, scale=scale, offset=offset, act="leaky")
    if name == "bn_act":
        return (library.bn_act_op if registered else bn_act)(*tensors, "relu")
    return (library.head_op if registered else head_convt)(*tensors)


@pytest.mark.parametrize("name", OP_NAMES)
def test_registered_op_equals_its_wrapper(gen, dtype, name):
    """Each discogan:: op on CUDA tensors launches its kernel once and
    gives its wrapper's bits."""
    from discogan_modernized_torch.ops import _build

    tensors = _op_inputs(name, gen, dtype)
    want = _call(name, tensors, registered=False)
    _build.reset_launches()
    got = _call(name, tensors, registered=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {OP_LAUNCHES[name]: 1}
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", OP_NAMES)
def test_registered_op_fake_under_a_symbolic_batch(gen, name):
    """torch.export of one call of the op with a symbolic batch: the fake
    implementation gives the real output's shape past the batch, a
    symbolic batch, and the real output's dtype."""
    tensors = _op_inputs(name, gen, torch.bfloat16)
    real = _call(name, tensors, registered=True)

    class Call(torch.nn.Module):
        def forward(self, x):
            return _call(name, [x, *tensors[1:]], registered=True)

    program = torch.export.export(Call(), (tensors[0],),
                                  dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    node = next(n for n in program.graph.nodes
                if n.op == "call_function" and str(n.target).startswith("discogan."))
    fake = node.meta["val"]
    assert not isinstance(fake.shape[0], int)
    assert tuple(fake.shape[1:]) == tuple(real.shape[1:]) and fake.dtype == real.dtype


# The read probe P (ops/pipe_probe.py): each block geometry of the TPU
# probe at a small size and at a ragged one (rows off the block's row
# groups, a row of 3 vectors, one block), bf16 and f32, with NaN and -inf
# planted; the block maxima equal the plain version's bit for bit (max is
# exact in any order), one launch each.
PROBE_CASES = [((2, 8, 8, 16), (1, 4, 8, 16)), ((2, 8, 4, 32), (1, 2, 4, 32)),
               ((2, 8, 128), (1, 4, 128)), ((32, 256, 16384), (1, 128, 16384)),
               ((3, 37, 5, 24), (1, 37, 5, 24)), ((1, 6, 2048), (1, 6, 2048))]


@pytest.mark.parametrize("shape,block", PROBE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pipe_probe(gen, shape, block, dtype):
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.pipe_probe import (block_max, block_max_plain,
                                                          probe_value)

    x = _rand(gen, dtype, *shape).reshape(-1)
    x[7] = float("-inf")
    before = _build.launches["pipe_probe"]
    got = block_max(x, shape, block)
    assert _build.launches["pipe_probe"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, block_max_plain(x, shape, block))
    assert torch.equal(probe_value(x, shape, block), got[-1])
    x[-1] = float("nan")
    assert torch.isnan(block_max(x, shape, block)[-1])
