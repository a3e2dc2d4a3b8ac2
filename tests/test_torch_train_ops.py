"""The port's training-side ops against the JAX package.

Kernels: the same numpy-seeded inputs go to the Pallas function, run in
interpret mode on the CPU as tests/test_pallas*.py run it, and to the
port's wrapper, which on a CPU tensor takes its plain PyTorch version, at
those tests' shapes and tolerances: K1 1e-5, K3's statistics 1e-4, K4 1e-3
(atol; f32 sums over up to 4096 products), K5b 2e-3. The autograd
functions, train-form BatchNorm and the losses are held against
``jax.grad`` of the JAX package's functions (1e-5 relative to the largest
value: f32 accumulation order). f32 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from discogan_modernized_tpu.ops import losses as jax_losses
from discogan_modernized_tpu.ops.batchnorm import batchnorm_apply
from discogan_modernized_tpu.ops.conv import conv_transpose2d as jax_convT
from discogan_modernized_tpu.ops.pallas_conv import conv2d_k4s2p1 as jax_k3
from discogan_modernized_tpu.ops.pallas_conv import conv2d_k4s2p1_dw as jax_k4
from discogan_modernized_tpu.ops.pallas_fused import batch_stats as jax_k1
from discogan_modernized_tpu.ops.pallas_halo_conv import (
    halo_conv2d_k4s2p1_dw as jax_k5b)
from discogan_modernized_torch.ops import losses
from discogan_modernized_torch.ops.autograd import (PLAIN_OPS, batch_stats_fn,
                                                    bn_act_fn, conv,
                                                    conv_batch_stats, head_fn,
                                                    train_bn_act)
from discogan_modernized_torch.ops.batchnorm import batchnorm
from discogan_modernized_torch.ops.conv_k4s2p1 import (conv2d_k4s2p1,
                                                       conv2d_k4s2p1_dw)
from discogan_modernized_torch.ops.fused import batch_stats
from discogan_modernized_torch.ops.halo_conv import (halo_conv2d_k4s2p1_dw,
                                                     takes_halo)
from tests.torch_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(False)


def close_rel(port, want, tol=GRAD_TOL, what=""):
    """max |port - want| <= tol * max(1, max |want|)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    want = np.asarray(want)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    err = np.abs(port - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def jax_conv(x, w):
    return lax.conv_general_dilated(x, w, (2, 2), [(1, 1), (1, 1)],
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    precision=lax.Precision.HIGHEST)


@pytest.mark.parametrize("shape,tile_rows", [((4, 8, 8, 128), 64),
                                             ((3, 5, 5, 128), 32)])
def test_k1_batch_stats(shape, tile_rows):
    """Second shape: 75 rows, ragged against the Pallas row tile."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) + 0.5
    mean, var = jax_k1(jnp.asarray(x), tile_rows=tile_rows, interpret=True)
    pm, pv = batch_stats(t(x))
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(var), atol=1e-5, rtol=1e-5)


def test_k3_with_stats():
    """test_pallas_conv.py::test_fused_epilogue_and_stats's shape."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 16, 64).astype(np.float32)
    w = (rng.randn(4, 4, 64, 128) * 0.05).astype(np.float32)
    y, (mean, mean_sq) = jax_k3(jnp.asarray(x), jnp.asarray(w),
                                with_stats=True, interpret=True)
    py, (pm, pq) = conv2d_k4s2p1(t(x), t(w), with_stats=True)
    for port, want in ((py, y), (pm, mean), (pq, mean_sq)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("n,h,w_,ci,co", [(2, 16, 16, 64, 128), (1, 16, 16, 128, 256),
                                          (2, 16, 16, 64, 72), (3, 14, 10, 64, 128)])
def test_k3_with_stats_at_plan_edges(n, h, w_, ci, co):
    """The shapes where K3's wgmma plan (ops/conv_k4s2p1.py::conv_plan)
    changes hands, at a small size: CI 64 and 128 (one and two 64-channel
    steps a tap), CO 72 (off the 128-column tile) and a ragged M (105
    pixels); the same tolerance as test_k3_with_stats."""
    rng = np.random.RandomState(4)
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * (16 * ci) ** -0.5).astype(np.float32)
    y, (mean, mean_sq) = jax_k3(jnp.asarray(x), jnp.asarray(w),
                                with_stats=True, interpret=True)
    py, (pm, pq) = conv2d_k4s2p1(t(x), t(w), with_stats=True)
    for port, want in ((py, y), (pm, mean), (pq, mean_sq)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("n,h,ci,co", [(4, 16, 64, 128), (2, 32, 3, 64)])
def test_k4_conv_dw(n, h, ci, co):
    """The second shape is the 3-channel stem's."""
    rng = np.random.RandomState(2)
    x = (rng.randn(n, h, h, ci) * 0.1).astype(np.float32)
    dy = rng.randn(n, h // 2, h // 2, co).astype(np.float32)
    want = jax_k4(jnp.asarray(x), jnp.asarray(dy), interpret=True)
    np.testing.assert_allclose(conv2d_k4s2p1_dw(t(x), t(dy)).numpy(),
                               np.asarray(want), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("n,h,w_,ci,co", [(2, 16, 16, 8, 16), (1, 32, 32, 64, 128),
                                          (2, 64, 32, 16, 8)])
def test_k5b_halo_conv_dw(n, h, w_, ci, co):
    """tests/test_pallas_halo_conv.py's shapes."""
    rng = np.random.RandomState(2)
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    dy = rng.randn(n, h // 2, w_ // 2, co).astype(np.float32)
    want = jax_k5b(jnp.asarray(x), jnp.asarray(dy), interpret=True)
    np.testing.assert_allclose(halo_conv2d_k4s2p1_dw(t(x), t(dy)).numpy(),
                               np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("route", ["k1", "k3"])
def test_batchnorm_train_form(route):
    """Normalized output, running statistics and count against
    batchnorm_apply(training=True), and the gradients of a weighted sum of
    the output for x (through the conv or K1), gamma and beta. Route k3:
    the statistics come from the conv's fused output; k1: from K1."""
    rng = np.random.RandomState(3)
    c = 16
    x = rng.randn(3, 8, 8, 8).astype(np.float32)
    w = (rng.randn(4, 4, 8, c) * 0.2).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    rmean = (rng.randn(c) * 0.1).astype(np.float32)
    rvar = (rng.rand(c) + 0.5).astype(np.float32)
    r = rng.randn(3, 4, 4, c).astype(np.float32)
    state = {"mean": jnp.asarray(rmean), "var": jnp.asarray(rvar),
             "count": jnp.asarray(5, jnp.int32)}

    def jax_loss(x, w, gamma, beta):
        y, new_state = batchnorm_apply({"scale": gamma, "bias": beta}, state,
                                       jax_conv(x, w), training=True)
        return jnp.sum(y * r), (y, new_state)

    (_, (y, new_state)), grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(x, w, gamma, beta)

    bn = batchnorm(c)
    with torch.no_grad():
        bn.weight.copy_(t(gamma))
        bn.bias.copy_(t(beta))
        bn.running_mean.copy_(t(rmean))
        bn.running_var.copy_(t(rvar))
        bn.num_batches_tracked.fill_(5)
    px, pw = t(x).requires_grad_(), t(w).requires_grad_()
    if route == "k3":
        out = conv_batch_stats(px, pw, PLAIN_OPS)
    else:
        yc = conv(px, pw, PLAIN_OPS)
        out = (yc, *batch_stats_fn(yc, PLAIN_OPS))
    py = train_bn_act(bn, *out, None, PLAIN_OPS)
    (py * t(r)).sum().backward()

    close_rel(py, y, what="y")
    close_rel(bn.running_mean, new_state["mean"], what="running_mean")
    close_rel(bn.running_var, new_state["var"], what="running_var")
    assert int(bn.num_batches_tracked) == int(new_state["count"]) == 6
    for name, port, want in zip(("x", "w", "gamma", "beta"),
                                (px.grad, pw.grad, bn.weight.grad, bn.bias.grad),
                                grads):
        close_rel(port, want, what=name)


def test_batchnorm_train_refuses_one_value_per_channel():
    bn = batchnorm(4)
    y = torch.zeros(1, 1, 1, 4)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        train_bn_act(bn, y, *batch_stats_fn(y, PLAIN_OPS), "relu", PLAIN_OPS)


@pytest.mark.parametrize("shape,act", [((2, 16, 16, 3, 8), "leaky"),
                                       ((2, 8, 8, 16, 24), None),
                                       ((1, 128, 128, 8, 8), None)])
def test_conv_function_gradients(shape, act):
    """dx and dw of the conv function (with K3's statistics where the layer
    has no activation) against jax.grad of the XLA conv. The shapes take
    the stem's dx through K6 (3 channels), cuDNN's conv2d_input, and the
    halo route's K5b."""
    n, h, ci, co = shape[0], shape[1], shape[3], shape[4]
    rng = np.random.RandomState(4)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    ry = rng.randn(n, h // 2, h // 2, co).astype(np.float32)
    rm, rq = rng.randn(2, co).astype(np.float32)
    stats = act is None and not takes_halo(t(x), t(w))

    def jax_loss(x, w):
        y = jax_conv(x, w)
        if act == "leaky":
            y = jnp.where(y >= 0, y, 0.2 * y)
        total = jnp.sum(y * ry)
        if stats:
            total += jnp.sum(y.mean((0, 1, 2)) * rm)
            total += jnp.sum(jnp.square(y).mean((0, 1, 2)) * rq)
        return total

    gx, gw = jax.grad(jax_loss, argnums=(0, 1))(x, w)
    px, pw = t(x).requires_grad_(), t(w).requires_grad_()
    if stats:
        y, mean, mean_sq = conv(px, pw, PLAIN_OPS, with_stats=True)
        total = (y * t(ry)).sum() + (mean * t(rm)).sum() + (mean_sq * t(rq)).sum()
    else:
        total = (conv(px, pw, PLAIN_OPS, act=act) * t(ry)).sum()
    total.backward()
    close_rel(px.grad, gx, what="dx")
    close_rel(pw.grad, gw, what="dw")


def test_head_and_bn_act_gradients():
    """K6's function (dx, dw through cuDNN) against jax.grad of the JAX
    convT, and K2's (x, scale, offset; ReLU mask) against plain autodiff."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = (rng.randn(4, 4, 16, 3) * 0.1).astype(np.float32)
    r = rng.randn(2, 16, 16, 3).astype(np.float32)
    gx, gw = jax.grad(lambda x, w: jnp.sum(jax_convT(x, w, stride=2, padding=1)
                                           * r), argnums=(0, 1))(x, w)
    px, pw = t(x).requires_grad_(), t(w).requires_grad_()
    (head_fn(px, pw, PLAIN_OPS) * t(r)).sum().backward()
    close_rel(px.grad, gx, what="head dx")
    close_rel(pw.grad, gw, what="head dw")

    s = (rng.rand(16) + 0.5).astype(np.float32)
    o = rng.randn(16).astype(np.float32)
    rr = rng.randn(2, 8, 8, 16).astype(np.float32)

    def jax_loss(x, s, o):
        return jnp.sum(jnp.maximum(x * s + o, 0) * rr)

    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(x, s, o)
    args = [t(a).requires_grad_() for a in (x, s, o)]
    (bn_act_fn(*args, "relu", PLAIN_OPS) * t(rr)).sum().backward()
    for a, want in zip(args, grads):
        close_rel(a.grad, want, what="bn_act")


def test_bce_saturated_values_and_gradients():
    """Probabilities of exactly 0 and 1: torch's -100 clamp in the value and
    its bounded gradient, as the JAX package's custom VJP has them."""
    p = np.array([[0.0], [1.0], [0.3], [1e-9]], np.float32)
    for target in (np.ones_like(p), np.zeros_like(p)):
        want, g = jax.value_and_grad(jax_losses.bce_loss)(jnp.asarray(p),
                                                          jnp.asarray(target))
        pp = t(p).requires_grad_()
        got = losses.bce_loss(pp, t(target))
        got.backward()
        close_rel(got, want, what="bce")
        assert np.isfinite(pp.grad.numpy()).all()
        np.testing.assert_allclose(pp.grad.numpy(), np.asarray(g), rtol=1e-6)


def test_gan_fm_and_mse_losses():
    rng = np.random.RandomState(6)
    real = rng.rand(4, 1, 1, 1).astype(np.float32)
    fake = rng.rand(4, 1, 1, 1).astype(np.float32)
    feats_r = [rng.randn(4, 4, 4, 8).astype(np.float32) for _ in range(3)]
    feats_f = [rng.randn(4, 4, 4, 8).astype(np.float32) for _ in range(3)]
    jd, jg = jax_losses.gan_losses(jnp.asarray(real), jnp.asarray(fake))
    pd, pg = losses.gan_losses(t(real), t(fake))
    close_rel(pd, jd)
    close_rel(pg, jg)
    for skip in (False, True):
        want = jax_losses.feature_matching_loss(feats_r, feats_f, skip_first=skip)
        got = losses.feature_matching_loss([t(a) for a in feats_r],
                                           [t(a) for a in feats_f], skip_first=skip)
        close_rel(got, want)
    close_rel(losses.mse_loss(t(feats_r[0]), t(feats_f[0])),
              jax_losses.mse_loss(feats_r[0], feats_f[0]))
