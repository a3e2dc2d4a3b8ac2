"""The halo route's BatchNorm gradient (ops/autograd.py ``conv_batch_stats``
where ``takes_halo``), bf16, on the CPU's plain versions of K5f, K1 and
K5b, at a halo shape: x 2x128x128x64, w 4x4x64x128 (the 512px step's
generator enc1 and discriminator conv2 take 256x256x64 inputs, cut here to
128x128, the route's smallest width).

K5f's y has two gradients, through K2 (the BatchNorm-act one) and through
K1's (mean, var) (the statistics' one), which nearly cancel. Both are kept
in f32, K2's handed to the conv's backward through a ``_Link``, summed there
and cast to bf16 once; that dy feeds K5b (dw) and the input gradient. The
old composition (each function's part cast to bf16 apart, then added in
bf16 by autograd) read the discriminators' conv2 gradient 1.12-1.27x the
f32 reference's norm at 512px batch 32 on the card; so did K2's part cast
to bf16 with the statistics' part added in f32. The F10 case here tells
the compositions apart on a fixed seed.

Which layers of the 512px and 64px models take the route is read off the
models' own train forwards on the meta device (no arithmetic), from the
benchmark's configuration files.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from discogan_modernized_torch.core import trace
from discogan_modernized_torch.core.precision import BF16
from discogan_modernized_torch.models.discriminator import Discriminator, discriminator_train
from discogan_modernized_torch.models.generator import Generator, generator_train
from discogan_modernized_torch.ops import recompute
from discogan_modernized_torch.ops.autograd import (PLAIN_OPS, batch_stats_fn, conv,
                                                    conv_batch_stats, train_bn_act)
from discogan_modernized_torch.ops.activations import NEGATIVE_SLOPE
from discogan_modernized_torch.ops.batchnorm import batchnorm, fold_bn
from discogan_modernized_torch.ops.fused import batch_stats_plain
from discogan_modernized_torch.ops.halo_conv import halo_conv2d_k4s2p1_plain, takes_halo
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B16 = torch.bfloat16
X_SHAPE, W_SHAPE, CO = (2, 128, 128, 64), (4, 4, 64, 128), 128
# dx, dw and gamma's gradient against the f32 layer on the same bf16-valued
# operands: the relative error of the norm read at most 9.4e-3 (dx, dw) and
# 2.9e-3 (gamma) on seeds 0-7. At this size the bf16 forward (y, then the
# statistics read off it) sets that error; the old composition read 9.5e-3.
GRAD_REL = 2e-2


def operands(seed: int, pairs: int = 0):
    """x, w (bf16), the loss's weights r, and the BatchNorm's gamma and beta;
    with ``pairs`` a leading pair axis on x, w and r."""
    g = torch.Generator().manual_seed(seed)
    lead = (pairs,) if pairs else ()
    x = torch.randn(*lead, *X_SHAPE, generator=g).to(B16)
    bound = 1.0 / (16 * X_SHAPE[-1]) ** 0.5
    w = ((torch.rand(*lead, *W_SHAPE, generator=g) * 2 - 1) * bound).to(B16)
    r = torch.randn(*lead, X_SHAPE[0], X_SHAPE[1] // 2, X_SHAPE[2] // 2, CO, generator=g)
    gamma = torch.rand(CO, generator=g) + 0.5
    beta = torch.randn(CO, generator=g) * 0.1
    return x, w, r, gamma, beta


def norm_layer(gamma, beta, pairs: int = 0):
    bns = []
    for _ in range(max(pairs, 1)):
        bn = batchnorm(CO)
        with torch.no_grad():
            bn.weight.copy_(gamma)
            bn.bias.copy_(beta)
        bns.append(bn)
    return tuple(bns) if pairs else bns[0]


def old_stats(x, w, ops):
    """The composition before the fix: K5f through ``conv``, then K1 through
    ``batch_stats_fn``, each with its own backward."""
    y = conv(x, w, ops)
    return (y, *batch_stats_fn(y, ops))


class Recorder:
    """PLAIN_OPS with K5f's, K1's and K5b's calls counted and K5b's dy kept."""

    def __init__(self):
        self.dys, self.calls = [], {"halo": 0, "stats": 0, "halo_dw": 0}
        self.ops = dict(PLAIN_OPS, halo=self._count("halo"), stats=self._count("stats"),
                        halo_dw=self._halo_dw)

    def _count(self, key):
        def fn(*args, **kwargs):
            self.calls[key] += 1
            return PLAIN_OPS[key](*args, **kwargs)
        return fn

    def _halo_dw(self, x, dy):
        self.calls["halo_dw"] += 1
        self.dys.append(dy)
        return PLAIN_OPS["halo_dw"](x, dy)


def run_layer(seed: int, stats=conv_batch_stats, pairs: int = 0, keep=None, dtype=B16):
    """The loss sum(r * K2(BatchNorm(conv(x, w)))) and its backward; with
    ``keep`` (False: the "full" policy, True: "conv") inside a
    rematerialized region. (x.grad, w.grad, gamma's grad, the recorder)."""
    x, w, r, gamma, beta = operands(seed, pairs)
    x, w = x.to(dtype).requires_grad_(), w.to(dtype).requires_grad_()
    bn, rec = norm_layer(gamma, beta, pairs), Recorder()

    def body(x, w):
        return train_bn_act(bn, *stats(x, w, rec.ops), "leaky", rec.ops)

    if keep is None:
        out = body(x, w)
    else:
        out = checkpoint(body, x, w, use_reentrant=False, preserve_rng_state=False,
                         context_fn=lambda: recompute.contexts(keep))
    (out.float() * r).sum().backward()
    dgamma = torch.stack([b.weight.grad for b in bn]) if pairs else bn.weight.grad
    return x.grad, w.grad, dgamma, rec


def gradient_parts(seed: int):
    """(g_bnact, g_stats): y's gradient through K2 and through its
    statistics, each computed by plain torch in f32: K2's from the
    activation's output and the loss's weights, the statistics' from
    (mean, var)'s gradients, which autograd takes through the BatchNorm's
    fold from the layer's leaves."""
    x, w, r, gamma, beta = operands(seed)
    y, mean, var = conv_batch_stats(x, w, PLAIN_OPS)
    yl, ml, vl = (t.detach().requires_grad_() for t in (y, mean, var))
    bn = norm_layer(gamma, beta)
    out = train_bn_act(bn, yl, ml, vl, "leaky", PLAIN_OPS)
    (out.float() * r).sum().backward()
    gy = r.to(out.dtype).float()  # the loss's gradient of K2's bf16 output
    scale, _ = fold_bn(bn.weight, bn.bias, mean, var, bn.eps)
    g_bnact = torch.where(out >= 0, gy, gy * NEGATIVE_SLOPE) * scale.detach()
    cnt = y.numel() // CO
    g_var = torch.where(var > 0, vl.grad, torch.zeros_like(vl.grad))
    g_stats = ml.grad / cnt + (y.float() - mean) * (2.0 * g_var / cnt)
    assert g_bnact.dtype == g_stats.dtype == torch.float32
    assert torch.equal(yl.grad, g_bnact.to(B16))  # K2's part, as autograd gets it
    return g_bnact, g_stats


def test_forward_is_k5f_then_k1_bit_for_bit():
    x, w, *_ = operands(0)
    assert takes_halo(x, w)
    y, mean, var = conv_batch_stats(x, w, PLAIN_OPS)
    want_y = halo_conv2d_k4s2p1_plain(x, w)
    want_mean, want_var = batch_stats_plain(want_y)
    assert y.dtype == B16 and mean.dtype == var.dtype == torch.float32
    assert torch.equal(y, want_y)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    got = old_stats(x, w, PLAIN_OPS)
    assert all(torch.equal(a, b) for a, b in zip(got, (y, mean, var)))


@pytest.mark.parametrize("seed", [0, 1])
def test_y_gradient_is_the_f32_sum_cast_once(seed):
    g_bnact, g_stats = gradient_parts(seed)
    *_, rec = run_layer(seed)
    assert rec.calls == {"halo": 1, "stats": 1, "halo_dw": 1}
    (dy,) = rec.dys
    assert dy.dtype == B16
    assert torch.equal(dy, (g_bnact + g_stats).to(B16))


def test_the_old_compositions_differ_f10():
    """Each part cast to bf16, then added in bf16 (the composition before
    the fix), and K2's part cast to bf16 with the statistics' added in f32:
    each differs from the f32 sum cast once on this seed."""
    g_bnact, g_stats = gradient_parts(0)
    *_, old = run_layer(0, stats=old_stats)
    (dy_old,) = old.dys
    assert torch.equal(dy_old, g_bnact.to(B16) + g_stats.to(B16))
    new = (g_bnact + g_stats).to(B16)
    half = (g_bnact.to(B16).float() + g_stats).to(B16)
    for other in (dy_old, half):
        differ = (other != new).float().mean().item()
        assert differ > 0.01, differ


@pytest.mark.parametrize("seed", [0, 3])
def test_dx_and_dw_against_the_f32_layer(seed):
    """dx, dw and gamma's gradient within GRAD_REL (relative norm) of the
    same layer in f32 on the same (bf16-valued) operands."""
    got = run_layer(seed)[:3]
    want = run_layer(seed, dtype=torch.float32)[:3]
    for name, g, f in zip(("dx", "dw", "dgamma"), got, want):
        rel = ((g.float() - f).norm() / f.norm()).item()
        assert rel <= GRAD_REL, (name, rel)


def test_pair_axis_equals_two_single_layers():
    """Two layers on a pair axis (a weight each) hand back each member's
    single-layer gradients bit for bit."""
    x, w, *_ = operands(5, pairs=2)
    assert takes_halo(x, w)
    pair = run_layer(5, pairs=2)
    y, mean, var = conv_batch_stats(x, w, PLAIN_OPS)
    assert mean.shape == var.shape == (2, CO)
    for p in range(2):
        member = operands(5, pairs=2)
        xs, ws, rs, gamma, beta = (member[0][p], member[1][p], member[2][p], *member[3:])
        ys, ms, vs = conv_batch_stats(xs, ws, PLAIN_OPS)
        assert torch.equal(y[p], ys) and torch.equal(mean[p], ms) and torch.equal(var[p], vs)
        xs, ws = xs.requires_grad_(), ws.requires_grad_()
        bn, rec = norm_layer(gamma, beta), Recorder()
        out = train_bn_act(bn, *conv_batch_stats(xs, ws, rec.ops), "leaky", rec.ops)
        (out.float() * rs).sum().backward()
        assert torch.equal(pair[3].dys[0][p], rec.dys[0])
        assert torch.equal(pair[0][p], xs.grad) and torch.equal(pair[1][p], ws.grad)
        assert torch.equal(pair[2][p], bn.weight.grad)


@pytest.mark.parametrize("keep", [False, True], ids=["full", "conv"])
def test_remat_rebuilds_to_the_same_bits(keep):
    """Inside a rematerialized region ("full": the rebuild runs K5f again;
    "conv": it hands back K5f's recorded y) K1 runs again on the rebuild,
    and every gradient equals the plain forward's bit for bit."""
    want = run_layer(2)
    got = run_layer(2, keep=keep)
    assert got[3].calls == {"halo": 1 if keep else 2, "stats": 2, "halo_dw": 1}
    assert torch.equal(got[3].dys[0], want[3].dys[0])
    for g, f in zip(got[:3], want[:3]):
        assert torch.equal(g, f)


def test_the_halo_span_covers_the_route_forward_and_backward():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_layer(0)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(trace.PREFIX + "halo") == 2  # the forward, the backward
    assert names.count(trace.PREFIX + "bn_backward") >= 1
    x, w, *_ = operands(0)
    k3 = (x[..., :8, :8, :], torch.ones(4, 4, 64, 128, dtype=B16))
    assert not takes_halo(*k3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        conv_batch_stats(*k3, PLAIN_OPS)[0].float().sum()
    assert trace.PREFIX + "halo" not in [e.name() for e in prof.profiler.kineto_results.events()]


def _halo_layers(config: str) -> dict:
    """net -> [(x shape, w shape)] of the convs the train forwards of the
    configuration's generator and discriminator send to K5f, read on the
    meta device at batch 2."""
    size = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    size = size["image_size"]
    seen = {"gen": [], "dis": []}
    net = ["gen"]

    def halo(x, w, **kwargs):
        seen[net[0]].append((tuple(x.shape), tuple(w.shape)))
        return PLAIN_OPS["halo"](x, w, **kwargs)

    ops = dict(PLAIN_OPS, halo=halo)
    with torch.device("meta"):
        g, d = Generator(size).train(), Discriminator(size).train()
        x = torch.empty(2, size, size, 3)
    with torch.no_grad():
        generator_train((g,), x, BF16, ops)
        net[0] = "dis"
        discriminator_train((d,), x, BF16, ops)
    return seen, g, d


def test_routing_at_512px_is_generator_enc1_and_discriminator_conv2():
    seen, g, d = _halo_layers("discogan512")
    assert seen == {"gen": [((2, 256, 256, 64), (4, 4, 64, 128))],
                    "dis": [((2, 256, 256, 64), (4, 4, 64, 128))]}
    # the layers by name: the only convs whose weight is (128, 64, 4, 4)
    names = {net: [n for n, mod in m.named_modules() if isinstance(mod, torch.nn.Conv2d)
                   and tuple(mod.weight.shape) == (128, 64, 4, 4)]
             for net, m in (("gen", g), ("dis", d))}
    assert names == {"gen": ["encoder.2"], "dis": ["conv2"]}


def test_routing_at_64px_takes_no_layer():
    seen, *_ = _halo_layers("discogan64")
    assert seen == {"gen": [], "dis": []}
