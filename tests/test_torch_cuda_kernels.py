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


@pytest.mark.parametrize("shape,act", [((2, 8, 8, 128), "leaky"),
                                       ((3, 5, 5, 100), "relu"),
                                       ((4, 4, 4, 2048), None)])
def test_bn_act(gen, dtype, shape, act):
    c = shape[-1]
    x = _rand(gen, dtype, *shape)
    s = torch.rand(c, device="cuda", generator=gen) + 0.5
    o = torch.randn(c, device="cuda", generator=gen)
    _close(bn_act(x, s, o, act), bn_act_plain(x, s, o, act), dtype)


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


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 8, 8, 16, 1), (1, 40, 24, 8, 3), (2, 8, 300, 16, 3), (1, 6, 10, 24, 8),
    (4, 256, 256, 64, 3)])
def test_head_convt(gen, dtype, n, h, w, ci, co):
    x = _rand(gen, dtype, n, h, w, ci)
    wt = _rand(gen, dtype, 4, 4, ci, co, scale=(16 * co) ** -0.5)
    _close(head_convt(x, wt), head_convt_plain(x, wt), dtype)


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
                                   (2, 4, 4, 2048), (2, 256, 256, 64)])
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
    (2, 32, 32, 128, 256), (3, 6, 10, 16, 72), (1, 8, 8, 24, 40)])
def test_conv_k4s2p1_dw(gen, dtype, n, h, w, ci, co):
    """The stem's split-M FMA path, the tensor-core path with and without
    splits, and channel counts off its tile (the FMA path in bf16)."""
    x = _rand(gen, dtype, n, h, w, ci)
    dy = _rand(gen, dtype, n, h // 2, w // 2, co, scale=0.1)
    _close(conv2d_k4s2p1_dw(x, dy), conv2d_k4s2p1_dw_plain(x, dy), dtype)


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 16, 16, 8, 16), (3, 14, 22, 8, 24), (1, 64, 40, 16, 8),
    (2, 256, 256, 64, 128)])
def test_halo_conv_k4s2p1_dw(gen, dtype, n, h, w, ci, co):
    x = _rand(gen, dtype, n, h, w, ci)
    dy = _rand(gen, dtype, n, h // 2, w // 2, co, scale=0.1)
    _close(halo_conv2d_k4s2p1_dw(x, dy), halo_conv2d_k4s2p1_dw_plain(x, dy), dtype)


def test_two_launches_give_the_same_bits(gen, dtype):
    """Every reduction across blocks (K1, K3's statistics on both of its
    paths, K4's and K5b's split sums) sums its partials in a fixed order."""
    x = _rand(gen, dtype, 2, 256, 256, 64)
    dy = _rand(gen, dtype, 2, 128, 128, 128, scale=0.1)
    xd = _rand(gen, dtype, 2, 16, 16, 1024)
    wd = _rand(gen, dtype, 4, 4, 1024, 2048, scale=1 / 128)
    xu = _rand(gen, dtype, 2, 128, 128, 128)
    wu = _rand(gen, dtype, 4, 4, 128, 256, scale=1 / 45)
    x0 = _rand(gen, dtype, 2, 64, 64, 3)
    dy0 = _rand(gen, dtype, 2, 32, 32, 64)
    calls = [lambda: batch_stats(x),
             lambda: conv2d_k4s2p1(xd, wd, with_stats=True)[1],  # split-K
             lambda: conv2d_k4s2p1(xu, wu, with_stats=True)[1],  # unsplit
             lambda: conv2d_k4s2p1_dw(x0, dy0),
             lambda: halo_conv2d_k4s2p1_dw(x, dy)]
    for call in calls:
        a, b = call(), call()
        torch.cuda.synchronize()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)
