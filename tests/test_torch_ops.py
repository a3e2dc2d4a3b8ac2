"""The port's kernel modules against the JAX package's Pallas kernels.

Each case feeds the same numpy-seeded inputs to the Pallas function, run in
interpret mode on the CPU as tests/test_pallas*.py run it, and to the
port's wrapper, which on a CPU tensor takes its plain PyTorch version.
f32 throughout; tolerance atol = rtol = 1e-4 (f32 accumulation order).
Shapes are the smallest of the existing Pallas tests, including the
ragged and non-square ones.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.ops import conv as jax_conv
from discogan_modernized_tpu.ops.pallas_conv import conv2d_k4s2p1 as jax_k3
from discogan_modernized_tpu.ops.pallas_fused import fused_batchnorm_act as jax_k2
from discogan_modernized_tpu.ops.pallas_halo_conv import halo_conv2d_k4s2p1 as jax_k5f
from discogan_modernized_tpu.ops.pallas_head import head_convt_fwd as jax_k6
from discogan_modernized_torch.ops import _build
from discogan_modernized_torch.ops.conv import init_conv_
from discogan_modernized_torch.ops.conv_k4s2p1 import conv2d_k4s2p1
from discogan_modernized_torch.ops.fused import fused_batchnorm_act
from discogan_modernized_torch.ops.halo_conv import halo_conv2d_k4s2p1, takes_halo
from discogan_modernized_torch.ops.head import head_convt
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "none"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 5, 5, 100)])
def test_k2_fused_bn_act(act, shape):
    """Second shape: 75 rows, not a multiple of the Pallas row tile."""
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    mean = rng.randn(c).astype(np.float32) * 0.1
    var = rng.rand(c).astype(np.float32) + 0.5
    gamma = rng.rand(c).astype(np.float32) + 0.5
    beta = rng.randn(c).astype(np.float32) * 0.1
    want = jax_k2(*map(jnp.asarray, (x, mean, var, gamma, beta)), act=act,
                  tile_rows=32, interpret=True)
    port = fused_batchnorm_act(*map(torch.from_numpy, (x, mean, var, gamma, beta)),
                               act=act)
    close(port, want)


@pytest.mark.parametrize("shape", [
    (2, 32, 3, 64),     # 3-channel boundary (enc0's K = 48)
    (3, 8, 100, 64),    # channels not a multiple of 128
    (4, 16, 64, 128),   # mid layer
])
def test_k3_conv_bare(shape):
    n, h, ci, co = shape
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.05).astype(np.float32)
    want = jax_k3(jnp.asarray(x), jnp.asarray(w), interpret=True)
    close(conv2d_k4s2p1(torch.from_numpy(x), torch.from_numpy(w)), want)


@pytest.mark.parametrize("shape,act", [((4, 16, 64, 128), "leaky"),
                                       ((2, 32, 3, 64), "relu")])
def test_k3_conv_epilogue(shape, act):
    n, h, ci, co = shape
    rng = np.random.RandomState(1)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.05).astype(np.float32)
    s = rng.rand(co).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    want = jax_k3(jnp.asarray(x), jnp.asarray(w), scale=jnp.asarray(s),
                  offset=jnp.asarray(b), act=act, interpret=True)
    port = conv2d_k4s2p1(torch.from_numpy(x), torch.from_numpy(w),
                         scale=torch.from_numpy(s), offset=torch.from_numpy(b),
                         act=act)
    close(port, want)


@pytest.mark.parametrize("n,h,w_,ci,co", [
    (2, 16, 16, 8, 16),
    (2, 64, 32, 16, 8),     # multiple row tiles, non-square
    (1, 8, 8, 8, 8),        # single tile
])
def test_k5f_halo_conv_bare(n, h, w_, ci, co):
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    want = jax_k5f(jnp.asarray(x), jnp.asarray(w), interpret=True)
    close(halo_conv2d_k4s2p1(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_k5f_halo_conv_epilogue():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    w = (rng.randn(4, 4, 8, 16) * 0.1).astype(np.float32)
    sc = rng.rand(16).astype(np.float32)
    of = rng.randn(16).astype(np.float32)
    want = jax_k5f(jnp.asarray(x), jnp.asarray(w), scale=jnp.asarray(sc),
                   offset=jnp.asarray(of), act="leaky", interpret=True)
    port = halo_conv2d_k4s2p1(torch.from_numpy(x), torch.from_numpy(w),
                              scale=torch.from_numpy(sc),
                              offset=torch.from_numpy(of), act="leaky")
    close(port, want)


def test_k5f_preconditions_and_route():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        halo_conv2d_k4s2p1(x, torch.zeros(4, 4, 3, 8))
    # At 512px only enc1 (256px map, 64 channels) takes the halo kernel.
    assert takes_halo(torch.zeros(1, 256, 256, 64), torch.zeros(4, 4, 64, 128))
    assert not takes_halo(torch.zeros(1, 512, 512, 3), torch.zeros(4, 4, 3, 64))
    assert not takes_halo(torch.zeros(1, 128, 128, 128),
                          torch.zeros(4, 4, 128, 256))
    assert not takes_halo(torch.zeros(1, 32, 32, 64), torch.zeros(4, 4, 64, 128))


@pytest.mark.parametrize("layout", ["flat6", "kmajor"])
@pytest.mark.parametrize("n,h,w_,ci,co", [
    (2, 16, 16, 8, 3),
    (2, 8, 8, 16, 1),      # single out channel
    (1, 40, 24, 8, 3),     # non-square, multi-tile rows
    (3, 64, 32, 8, 2),     # multiple row tiles
])
def test_k6_head_convt(layout, n, h, w_, ci, co):
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    want = jax_k6(jnp.asarray(x), jnp.asarray(w), layout=layout, interpret=True)
    port = head_convt(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(port.shape) == (n, 2 * h, 2 * w_, co)
    close(port, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="even"):
        conv2d_k4s2p1(torch.zeros(1, 5, 4, 8), torch.zeros(4, 4, 8, 8))
    with pytest.raises(ValueError, match="NHWC"):
        head_convt(torch.zeros(1, 4, 4, 8), torch.zeros(4, 4, 3, 8))
    with pytest.raises(ValueError, match="unknown activation"):
        conv2d_k4s2p1(torch.zeros(1, 4, 4, 8), torch.zeros(4, 4, 8, 8),
                      act="gelu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_tensor("x", torch.zeros(2))


@pytest.mark.parametrize("in_ch,out_ch", [(3, 64), (2048, 100), (100, 2048)])
def test_init_bounds_match_jax(in_ch, out_ch):
    """Torch-default uniform bounds, with ConvTranspose2d's fan_in quirk:
    the port's modules against conv_init / conv_transpose_init."""
    key = jax.random.PRNGKey(0)
    g = torch.Generator().manual_seed(0)
    for jax_init, module, fan in (
            (jax_conv.conv_init, torch.nn.Conv2d(in_ch, out_ch, 4, bias=False),
             in_ch),
            (jax_conv.conv_transpose_init,
             torch.nn.ConvTranspose2d(in_ch, out_ch, 4, bias=False), out_ch)):
        bound = 1 / math.sqrt(fan * 16)
        init_conv_(module, g)
        want = np.asarray(jax_init(key, in_ch, out_ch, 4))
        assert want.size == module.weight.numel()
        for a in (want, module.weight.detach().numpy()):
            assert a.min() >= -bound and a.max() <= bound
            assert a.max() - a.min() > 1.9 * bound  # the whole range is used


# ---- the pair axis (ops/pairs.py) -------------------------------------------
# Each plain version with a leading pair axis of 2 against jax.vmap of the
# Pallas function in interpret mode (batching a pallas_call adds a grid
# axis); a weight that both pairs share (pair stride 0) against vmap with
# that operand unbatched, and its y against one Pallas call on the
# concatenated batch. Each pair's output is also bit for bit the single
# plain call's on that pair's operands.

from discogan_modernized_tpu.ops.pallas_conv import conv2d_k4s2p1_dw as jax_k4  # noqa: E402
from discogan_modernized_tpu.ops.pallas_fused import batch_stats as jax_k1  # noqa: E402
from discogan_modernized_tpu.ops.pallas_halo_conv import (  # noqa: E402
    halo_conv2d_k4s2p1_dw as jax_k5b)
from discogan_modernized_torch.ops.conv_k4s2p1 import conv2d_k4s2p1_dw  # noqa: E402
from discogan_modernized_torch.ops.fused import batch_stats  # noqa: E402
from discogan_modernized_torch.ops.halo_conv import halo_conv2d_k4s2p1_dw  # noqa: E402


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _equal_to_singles(port, single):
    """Each pair's outputs (a tensor or a tuple of them), bit for bit those
    of ``single(p)``."""
    flat = lambda o: [t for x in o for t in flat(x)] if isinstance(o, tuple) else [o]  # noqa: E731
    for p in range(2):
        for a, b in zip(flat(port), flat(single(p))):
            assert torch.equal(a[p], b)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 5, 5, 100)])
def test_k1_batch_stats_pairs(shape):
    x = np.random.RandomState(2).randn(2, *shape).astype(np.float32)
    want = jax.vmap(lambda v: jax_k1(v, tile_rows=32, interpret=True))(jnp.asarray(x))
    (xt,) = _t(x)
    port = batch_stats(xt)
    for p, w in zip(port, want):
        close(p, w)
    _equal_to_singles(port, lambda p: batch_stats(xt[p]))


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 5, 5, 100)])
def test_k2_fused_bn_act_pairs(shape):
    rng = np.random.RandomState(3)
    c = shape[-1]
    x = rng.randn(2, *shape).astype(np.float32)
    mean, beta = (rng.randn(2, c).astype(np.float32) * 0.1 for _ in range(2))
    var, gamma = (rng.rand(2, c).astype(np.float32) + 0.5 for _ in range(2))
    want = jax.vmap(lambda *a: jax_k2(*a, act="leaky_relu", tile_rows=32, interpret=True))(
        *map(jnp.asarray, (x, mean, var, gamma, beta)))
    args = _t(x, mean, var, gamma, beta)
    port = fused_batchnorm_act(*args, act="leaky_relu")
    close(port, want)
    _equal_to_singles(port, lambda p: fused_batchnorm_act(*(a[p] for a in args),
                                                          act="leaky_relu"))


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("shape", [(2, 32, 3, 64), (4, 16, 64, 128)])
def test_k3_conv_pairs(shape, shared):
    n, h, ci, co = shape
    rng = np.random.RandomState(4)
    x = rng.randn(2, n, h, h, ci).astype(np.float32)
    w = (rng.randn(*(() if shared else (2,)), 4, 4, ci, co) * 0.05).astype(np.float32)
    fn = lambda a, b: jax_k3(a, b, with_stats=True, interpret=True)  # noqa: E731
    want_y, (want_m, want_q) = jax.vmap(fn, in_axes=(0, None if shared else 0))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, w)
    port_y, (port_m, port_q) = conv2d_k4s2p1(xt, wt, with_stats=True)
    for p, want in ((port_y, want_y), (port_m, want_m), (port_q, want_q)):
        close(p, want)
    _equal_to_singles((port_y, port_m, port_q), lambda p: (
        lambda r: (r[0], *r[1]))(conv2d_k4s2p1(xt[p], wt if shared else wt[p], with_stats=True)))
    if shared:  # stride 0: one call on the concatenated batch
        close(port_y.reshape(2 * n, h // 2, h // 2, co),
              jax_k3(jnp.asarray(x.reshape(2 * n, h, h, ci)), jnp.asarray(w), interpret=True))


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
def test_k5f_halo_conv_pairs(shared):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 2, 16, 16, 8).astype(np.float32)
    w = (rng.randn(*(() if shared else (2,)), 4, 4, 8, 16) * 0.1).astype(np.float32)
    sc = rng.rand(2, 16).astype(np.float32)
    of = rng.randn(2, 16).astype(np.float32)
    fn = lambda a, b, s, o: jax_k5f(a, b, scale=s, offset=o, act="leaky",  # noqa: E731
                                    interpret=True)
    want = jax.vmap(fn, in_axes=(0, None if shared else 0, 0, 0))(
        *map(jnp.asarray, (x, w, sc, of)))
    xt, wt, st, ot = _t(x, w, sc, of)
    port = halo_conv2d_k4s2p1(xt, wt, scale=st, offset=ot, act="leaky")
    close(port, want)
    _equal_to_singles(port, lambda p: halo_conv2d_k4s2p1(
        xt[p], wt if shared else wt[p], scale=st[p], offset=ot[p], act="leaky"))
    if shared:  # stride 0, no affine: one call on the concatenated batch
        close(halo_conv2d_k4s2p1(xt, wt).reshape(4, 8, 8, 16),
              jax_k5f(jnp.asarray(x.reshape(4, 16, 16, 8)), jnp.asarray(w), interpret=True))


def test_k6_head_convt_pairs():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 2, 16, 16, 8).astype(np.float32)
    w = (rng.randn(2, 4, 4, 8, 3) * 0.1).astype(np.float32)
    want = jax.vmap(lambda a, b: jax_k6(a, b, interpret=True))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x, w)
    port = head_convt(xt, wt)
    close(port, want)
    _equal_to_singles(port, lambda p: head_convt(xt[p], wt[p]))


@pytest.mark.parametrize("fn,jax_fn,shape", [
    (conv2d_k4s2p1_dw, jax_k4, (2, 16, 16, 16, 32)),
    (halo_conv2d_k4s2p1_dw, jax_k5b, (2, 16, 16, 8, 16))])
def test_k4_k5b_weight_gradient_pairs(fn, jax_fn, shape):
    n, h, w_, ci, co = shape
    rng = np.random.RandomState(7)
    x = rng.randn(2, n, h, w_, ci).astype(np.float32)
    dy = rng.randn(2, n, h // 2, w_ // 2, co).astype(np.float32)
    want = jax.vmap(lambda a, b: jax_fn(a, b, interpret=True))(jnp.asarray(x), jnp.asarray(dy))
    xt, dyt = _t(x, dy)
    port = fn(xt, dyt)
    assert tuple(port.shape) == (2, 4, 4, ci, co)
    close(port, want)
    _equal_to_singles(port, lambda p: fn(xt[p], dyt[p]))


def test_pair_operands_are_checked():
    """A paired operand with another count of pairs than x is refused."""
    x = torch.zeros(2, 1, 8, 8, 16)
    with pytest.raises(ValueError, match="pairs"):
        conv2d_k4s2p1(x, torch.zeros(3, 4, 4, 16, 8))
    with pytest.raises(ValueError, match="pairs"):
        conv2d_k4s2p1_dw(x, torch.zeros(3, 1, 4, 4, 8))
