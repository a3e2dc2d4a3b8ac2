"""The plain reference of the DiscoGAN training step, in float32 PyTorch.

It follows the published DiscoGAN (Kim et al., arXiv:1703.05192) as the
reference trainer runs it (``image_translation.py`` and ``model.py`` of the
PyTorch DiscoGAN): encoder-decoder generators of k4/s2/p1 convolutions
with BatchNorm, LeakyReLU(0.2) in the encoder and ReLU in the decoder, a
4x4 VALID convolution to a 100-channel latent and back, a sigmoid output;
PatchGAN-to-scalar discriminators whose BatchNorm'd LeakyReLU outputs feed
the feature-matching loss; BCE, MSE and feature-matching losses mixed by
the curriculum rate; one D step on every third iteration and a G step on
the others, each an Adam step of its networks (``rounding.adam_update``).

Activations are NCHW here, weights in torch's layouts; the program under
test works in NHWC with its own weight forms and kernels, and nothing of it
is imported. Every convolution and product goes through ``Ops``, so the
control can run the same step with its operands in a lower precision
(``Ops("fp8")``: float8 e4m3 operands and e5m2 output gradients, each
tensor scaled to the format's range, products accumulated in float32).

``leaf_specs`` lists the four networks' parameters in the order the
reference architecture registers them (gen_A, gen_B, dis_A, dis_B): that
order names each tensor's index in its optimizer, which the stochastic
rounding's seeds follow.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import rounding

LATENT = 100
SLOPE = 0.2
BN_EPS = 1e-5


def channels(image_size: int) -> list[int]:
    n = int(math.log2(image_size)) - 2
    return [min(64 * 2 ** i, 2048) for i in range(n)]


def _gen_specs(size: int) -> list:
    """(name, shape, fan_in) of one generator's leaves; fan_in None for a
    BatchNorm weight (1) or bias (0). A ConvTranspose2d weight is (I, O, k,
    k) and torch's init takes its fan_in from dim 1."""
    c = channels(size)
    out = [("enc0.w", (c[0], 3, 4, 4), 3 * 16)]
    for i in range(1, len(c)):
        out += [(f"enc{i}.w", (c[i], c[i - 1], 4, 4), c[i - 1] * 16),
                (f"enc{i}.g", (c[i],), None), (f"enc{i}.b", (c[i],), None)]
    out += [("latent.w", (LATENT, c[-1], 4, 4), c[-1] * 16),
            ("latent.g", (LATENT,), None), ("latent.b", (LATENT,), None),
            ("dec0.w", (LATENT, c[-1], 4, 4), c[-1] * 16),
            ("dec0.g", (c[-1],), None), ("dec0.b", (c[-1],), None)]
    rev = c[::-1]
    for j in range(1, len(c)):
        out += [(f"dec{j}.w", (rev[j - 1], rev[j], 4, 4), rev[j] * 16),
                (f"dec{j}.g", (rev[j],), None), (f"dec{j}.b", (rev[j],), None)]
    out.append(("head.w", (c[0], 3, 4, 4), 3 * 16))
    return out


def _dis_specs(size: int) -> list:
    c = channels(size)
    out = [("conv1.w", (c[0], 3, 4, 4), 3 * 16)]
    for i in range(1, len(c)):
        out += [(f"conv{i + 1}.w", (c[i], c[i - 1], 4, 4), c[i - 1] * 16),
                (f"bn{i + 1}.g", (c[i],), None), (f"bn{i + 1}.b", (c[i],), None)]
    out.append((f"conv{len(c) + 1}.w", (1, c[-1], 4, 4), c[-1] * 16))
    return out


NETS = ("gen_A", "gen_B", "dis_A", "dis_B")


def leaf_specs(image_size: int) -> dict:
    """net -> [(name, shape, fan_in)], in registration order."""
    return {net: (_gen_specs if net.startswith("gen") else _dis_specs)(image_size)
            for net in NETS}


def make_weights(image_size: int, seed: int, device, nets=NETS) -> dict:
    """net -> [f32 tensor a leaf] of ``nets``: each conv weight
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default), drawn in one call
    from a generator on ``device`` seeded with ``seed``; BatchNorm weights
    1, biases 0."""
    specs = {net: s for net, s in leaf_specs(image_size).items() if net in nets}
    conv = [(net, k) for net in specs for k, (_, _, fan) in enumerate(specs[net])
            if fan is not None]
    sizes = [math.prod(specs[net][k][1]) for net, k in conv]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {net: [None] * len(specs[net]) for net in specs}
    for (net, k), part in zip(conv, flat.split(sizes)):
        name, shape, fan = specs[net][k]
        bound = 1.0 / math.sqrt(fan)
        out[net][k] = part.view(shape).mul_(2 * bound).sub_(bound)
    for net in specs:
        for k, (name, shape, fan) in enumerate(specs[net]):
            if fan is None:
                fill = 1.0 if name.endswith(".g") else 0.0
                out[net][k] = torch.full(shape, fill, dtype=torch.float32, device=device)
    return out


# -- lower precisions: the control's, and a witness of the program's ---------

def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` and back. A float8 format first scales x's
    largest magnitude to the format's largest value (per tensor)."""
    if fmt == torch.bfloat16:
        return x.to(fmt).to(x.dtype)
    top = torch.finfo(fmt).max
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _RoundIn(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient passes."""

    @staticmethod
    def forward(ctx, x, fmt):
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGradOut(torch.autograd.Function):
    """Forward: the output (rounded where ``fmt_out`` is given); backward:
    its gradient rounded to ``fmt_grad``."""

    @staticmethod
    def forward(ctx, y, fmt_out, fmt_grad):
        ctx.fmt_grad = fmt_grad
        return y.clone() if fmt_out is None else _round(y, fmt_out)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt_grad), None, None


# precision -> (operands, stored outputs, output gradients)
FORMATS = {"f32": None,
           "bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
           "fp8": (torch.float8_e4m3fn, None, torch.float8_e5m2)}


class Ops:
    """The step's convolutions and products in float32, or with their
    operands, outputs and output gradients rounded as ``precision`` says:
    "fp8" is the control of a bf16 configuration (e4m3 operands, e5m2
    gradients, each tensor scaled to its format's range); "bf16" a witness
    of what bf16 rounding alone does."""

    def __init__(self, precision: str = "f32"):
        self.formats = FORMATS[precision]

    def _run(self, fn, x, w, **kw):
        if self.formats is None:
            return fn(x, w, **kw)
        f_in, f_out, f_grad = self.formats
        y = fn(_RoundIn.apply(x, f_in), _RoundIn.apply(w, f_in), **kw)
        return _RoundGradOut.apply(y, f_out, f_grad)

    def conv(self, x, w, stride=2, padding=1):
        return self._run(F.conv2d, x, w, stride=stride, padding=padding)

    def convt(self, x, w, stride=2, padding=1):
        return self._run(F.conv_transpose2d, x, w, stride=stride, padding=padding)


def _bn(y, g, b):
    mean = y.mean((0, 2, 3), keepdim=True)
    var = y.var((0, 2, 3), unbiased=False, keepdim=True)
    return (y - mean) * torch.rsqrt(var + BN_EPS) * g.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def generator(p: list, x, ops: Ops):
    """p: one generator's leaves (``_gen_specs`` order), cast to f32 at each
    call; x NCHW."""
    it = iter([w.float() for w in p])
    h = F.leaky_relu(ops.conv(x, next(it)), SLOPE)
    n = (len(p) - 2) // 6  # encoder convs
    for _ in range(1, n):
        w, g, b = next(it), next(it), next(it)
        h = F.leaky_relu(_bn(ops.conv(h, w), g, b), SLOPE)
    w, g, b = next(it), next(it), next(it)
    h = F.leaky_relu(_bn(ops.conv(h, w, 1, 0), g, b), SLOPE)
    w, g, b = next(it), next(it), next(it)
    h = F.relu(_bn(ops.convt(h, w, 1, 0), g, b))
    for _ in range(1, n):
        w, g, b = next(it), next(it), next(it)
        h = F.relu(_bn(ops.convt(h, w), g, b))
    return torch.sigmoid(ops.convt(h, next(it)))


def discriminator(p: list, x, ops: Ops):
    """(prob (N,), features) of one discriminator; x NCHW."""
    it = iter([w.float() for w in p])
    h = F.leaky_relu(ops.conv(x, next(it)), SLOPE)
    feats = []
    for _ in range((len(p) - 2) // 3):
        w, g, b = next(it), next(it), next(it)
        h = F.leaky_relu(_bn(ops.conv(h, w), g, b), SLOPE)
        feats.append(h)
    return torch.sigmoid(ops.conv(h, next(it), 1, 0)).reshape(-1), feats


def _bce(p, target: float):
    return F.binary_cross_entropy(p, torch.full_like(p, target))


def _fm(real, fake):
    total = real[0].new_zeros(())
    for r, f in zip(real, fake):
        total = total + (r.mean(0) - f.mean(0)).square().mean()
    return total


def step_loss(p: dict, A, B, rate: float, which: str, ops: Ops):
    """The ``which`` ("gen" or "dis") total of the DiscoGAN loss graph on
    NHWC batches A, B; the D total does not read the reconstructions."""
    A, B = (t.permute(0, 3, 1, 2).float() for t in (A, B))
    AB, BA = generator(p["gen_B"], A, ops), generator(p["gen_A"], B, ops)
    realA, feats_realA = discriminator(p["dis_A"], A, ops)
    fakeA, feats_fakeA = discriminator(p["dis_A"], BA, ops)
    realB, feats_realB = discriminator(p["dis_B"], B, ops)
    fakeB, feats_fakeB = discriminator(p["dis_B"], AB, ops)
    if which == "dis":
        return (0.5 * (_bce(realA, 1.0) + _bce(fakeA, 0.0))
                + 0.5 * (_bce(realB, 1.0) + _bce(fakeB, 0.0)))
    recon_A = (generator(p["gen_A"], AB, ops) - A).square().mean()
    recon_B = (generator(p["gen_B"], BA, ops) - B).square().mean()
    gen_A, gen_B = _bce(fakeA, 1.0), _bce(fakeB, 1.0)
    fm_A, fm_B = _fm(feats_realA, feats_fakeA), _fm(feats_realB, feats_fakeB)
    return (((fm_B * 0.9 + gen_B * 0.1) * (1 - rate) + recon_A * rate)
            + ((fm_A * 0.9 + gen_A * 0.1) * (1 - rate) + recon_B * rate))


def follow(weights: dict, batches: list, kinds: list, rates: list, opt: dict,
           slim_state: str, ops: Ops | None = None) -> dict:
    """Run len(batches) iterations of the step from ``weights`` (net -> f32
    leaves, as handed to the program); ``kinds`` "dis"/"gen" each.

    The masters are stored as the configuration states (bf16 under "all",
    rounded to nearest at the start), the moments in bf16 under "mv" and
    "all". Returns the readings: each step's trained total (``losses``),
    each optimizer's first gradient as it takes it, g + weight_decay * p,
    by leaf (``grad_norms``: net group -> [norm]), and each leaf's change
    after all the steps (``change_norms``)."""
    ops = ops or Ops()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False  # f32 products
    try:
        return _follow(weights, batches, kinds, rates, opt, slim_state, ops)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _follow(weights, batches, kinds, rates, opt, slim_state, ops) -> dict:
    groups = {"gen": ("gen_A", "gen_B"), "dis": ("dis_A", "dis_B")}
    p_dtype = torch.bfloat16 if slim_state == "all" else torch.float32
    mv_dtype = torch.float32 if slim_state == "off" else torch.bfloat16
    stored = {net: [w.to(p_dtype, copy=True) for w in ws] for net, ws in weights.items()}
    start = {net: [w.float().clone() for w in ws] for net, ws in stored.items()}
    moments = {which: ([torch.zeros_like(w, dtype=mv_dtype)
                        for net in nets for w in stored[net]],
                       [torch.zeros_like(w, dtype=mv_dtype)
                        for net in nets for w in stored[net]])
               for which, nets in groups.items()}
    steps = {"gen": 0, "dis": 0}
    losses, grad_norms = [], {}
    for (A, B), kind, rate in zip(batches, kinds, rates):
        which = "gen" if kind == "gen" else "dis"
        # The reference takes its gradients in f32; a lower precision takes
        # them in the stored masters' dtype, each network call's part
        # rounded to it and summed there, as bf16 masters' gradients are.
        live = {net: [(w.detach().float() if ops.formats is None else w.detach().clone())
                      .requires_grad_(net in groups[which]) for w in ws]
                for net, ws in stored.items()}
        loss = step_loss(live, A, B, rate, which, ops)
        leaves = [w for net in groups[which] for w in live[net]]
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.item())
        steps[which] += 1
        params = [w for net in groups[which] for w in stored[net]]
        if which not in grad_norms:
            grad_norms[which] = torch.stack(
                [(g.float() + opt["weight_decay"] * p.float()).norm()
                 for g, p in zip(grads, params)]).tolist()
        rounding.adam_update(params, list(grads), *moments[which], steps[which], opt)
        del live, leaves, grads, loss
    change = {which: torch.stack([(stored[net][k].float() - start[net][k]).norm()
                                  for net in nets for k in range(len(stored[net]))]).tolist()
              for which, nets in groups.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
