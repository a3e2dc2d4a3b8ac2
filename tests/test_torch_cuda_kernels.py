"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is not available, as on the CPU hosts
that run the rest of the suite. On a machine with the card (and without
JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Shapes: the 512px forward's (batch 4 where it is quick) and the odd ones
that take the kernels' edge paths (ragged rows, non-square maps, channel
counts off the tile, partial bands, more than one column segment). Inputs
are bf16 or f32; tolerance 1e-4 (f32) or 2e-2 (bf16, which the kernel and
the plain version round at different places), relative to max(1, max|ref|).
"""

import pytest
import torch

from discogan_modernized_torch.core.precision import BF16, F32, configure
from discogan_modernized_torch.ops.conv_k4s2p1 import conv2d_k4s2p1, conv2d_k4s2p1_plain
from discogan_modernized_torch.ops.fused import bn_act, bn_act_plain
from discogan_modernized_torch.ops.halo_conv import (halo_conv2d_k4s2p1,
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


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), err


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
