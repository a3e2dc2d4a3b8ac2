"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is not available, as on the CPU hosts
that run the rest of the suite. On a machine with the card (and without
JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Shapes: the 512px forward's and training step's (small batches where it
is quick) and the odd ones that take the kernels' edge paths (ragged rows,
non-square maps, channel counts off the tile, partial bands, more than one
column segment, split and unsplit reductions). Inputs are bf16 or f32;
tolerance 1e-4 (f32) or 2e-2 (bf16, which the kernel and the plain version
round at different places), relative to max(1, max|ref|); statistics, which
both sides take from f32 sums of exact products, 1e-4 in either dtype. The
reductions use no float atomics: two launches give the same bits.
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
