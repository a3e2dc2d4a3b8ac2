"""Torch-semantics Adam with L2-into-gradient weight decay (the port of the
JAX package's ``train/optim.py``).

The reference uses torch.optim.Adam(lr=2e-4, betas=(0.5, 0.999),
weight_decay=1e-5) over the chained generator parameters and the chained
discriminator parameters (ref image_translation.py:271-287): weight decay
added to the gradient before the moment updates (not AdamW's decoupled
rule), eps = 1e-8 outside the sqrt, bias correction. The update runs in
the JAX package's order, in f32:

    g = g + wd * p;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
    p = p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

``mv_dtype`` is the moments' storage dtype: f32 (slim state "off"), or
bf16 (slim states "mv" and "all": cast up, updated in f32, cast back).

A parameter stored in bf16 (slim state "all") is written back with
unbiased stochastic rounding, as the JAX package's ``adam_update`` does:
round-to-nearest at bf16's 8-bit mantissa drops updates smaller than
about 0.4% of the parameter and stalls training, while stochastic
rounding keeps them in expectation. The random bits are stateless, a pure
function of (Adam step, tensor index, element index): each tensor's seed
is a fixed function of (step, index) (``rounding_seed``, of which the
bits take the low 32: ``seed_word``). On the card each element's 16 bits
are a counter-based hash of (seed, element index) (``rounding_bits``,
murmur3's 32-bit finalizer, in int32 tensor ops), so a step captured in a
CUDA graph draws new bits at every replay from the seeds it is given; on
the CPU they come from ``torch.randint`` under a CPU generator seeded with
the seed word, as before the card had graphs. Either way a resumed run
draws what the uninterrupted one drew, and a parameter split over a mesh's
model axis (``Adam.shards``) draws its elements' bits of the whole tensor. The bits are not JAX's threefry:
the two packages round the same value to the same pair of neighbours but
not always to the same one.

``update`` takes one step from the host's step count. ``apply`` takes it
from device scalars (the bias corrections and the rounding seeds) and
reads no host value, so a captured step replays it (train/chunk.py); it
leaves ``step``, the host's mirror that checkpoints save, to the caller.
Both divide by the bias corrections as tensors on the parameters'
device, so the two give the same bits.
"""

from __future__ import annotations

import torch

from ..core import trace

_SEED_BASE = 0x5EED
_MASK64 = (1 << 64) - 1


def rounding_seed(step: int, index: int) -> int:
    """The seed of tensor ``index``'s rounding bits at Adam step ``step``:
    (step, index) mixed by splitmix64's finalizer, so that every bit of
    the seed depends on both (``rounding_bits`` takes its low 32 bits)."""
    z = ((_SEED_BASE << 48) ^ (step << 16) ^ index) + 0x9E3779B97F4A7C15
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1  # 63 bits


def seed_word(seed: int) -> int:
    """A rounding seed's low 32 bits as a signed int32 value."""
    w = seed & 0xFFFFFFFF
    return w - (1 << 32) if w >= 1 << 31 else w


# The hash's multipliers as int32 values: the golden ratio's (2^32 / phi)
# and murmur3's two finalizer constants.
_GOLDEN = seed_word(0x9E3779B1)
_FMIX = ((16, seed_word(0x85EBCA6B)), (13, seed_word(0xC2B2AE35)), (16, None))


def global_index(shape, shard, device) -> torch.Tensor:
    """The flat indices in its whole tensor of each element of a slice of
    ``shape``: ``shard`` = (the whole tensor's shape, the sliced axis, the
    slice's first index on it); int32."""
    whole, dim, start = shard
    inner = 1
    for s in whole[dim + 1:]:
        inner *= s
    block = shape[dim] * inner
    n = 1
    for s in shape:
        n *= s
    local = torch.arange(n, dtype=torch.int32, device=device)
    return (local // block) * (whole[dim] * inner) + local % block + start * inner


def rounding_bits(n: int, seed, device, index: torch.Tensor | None = None) -> torch.Tensor:
    """n values in [0, 2^16): element e's is the top half of murmur3's
    finalizer of e * golden + seed, in int32 arithmetic that wraps as
    uint32's does (the shifts masked to be logical). ``seed`` is a seed
    word (``seed_word``), a Python int or an int32 tensor of one value on
    ``device``. ``index``: each element's e where it is not its place
    (a slice of a tensor: ``global_index``)."""
    h = (torch.arange(n, dtype=torch.int32, device=device) if index is None
         else index.clone())
    h.mul_(_GOLDEN).add_(seed)
    for shift, mul in _FMIX:
        h.bitwise_xor_(h.bitwise_right_shift(shift).bitwise_and_((1 << (32 - shift)) - 1))
        if mul is not None:
            h.mul_(mul)
    return h.bitwise_right_shift_(16).bitwise_and_(0xFFFF)


def stochastic_round_bf16(x: torch.Tensor, seed, shard=None) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding: add 16 random bits below bf16's
    mantissa cutoff to the f32 word, then truncate. A carry out of the
    mantissa is exactly the round-up to the next representable value, so
    the rule holds across exponent boundaries. ``seed``: a seed word (a
    Python int, or an int32 tensor of one value on x's device); the bits
    are ``rounding_bits`` on the card, a CPU generator's on the CPU.
    ``shard``: x is a slice of a whole tensor (``global_index``'s), and
    takes the bits of its elements' places there."""
    bits = x.float().contiguous().view(torch.int32)
    if x.device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFF)
        if shard is None:
            rnd = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32, generator=gen)
        else:
            whole, dim, start = shard
            rnd = torch.randint(0, 1 << 16, whole, dtype=torch.int32,
                                generator=gen).narrow(dim, start, x.shape[dim])
    else:
        index = None if shard is None else global_index(x.shape, shard, x.device)
        rnd = rounding_bits(x.numel(), seed, x.device, index).view(x.shape)
    bits = (bits + rnd) & -65536  # 0xFFFF0000 as an int32
    return bits.view(torch.float32).to(torch.bfloat16)


def _on_device(values: list, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``; to the card from pinned memory
    without a wait (the host runs on while the copy is queued)."""
    t = torch.tensor(values, dtype=dtype)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


class Adam:
    def __init__(self, params, *, lr: float, beta1: float = 0.5,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mv_dtype: torch.dtype = torch.float32):
        self.params = list(params)
        self.lr, self.beta1, self.beta2 = lr, beta1, beta2
        self.eps, self.weight_decay = eps, weight_decay
        self.m = [torch.zeros_like(p, dtype=mv_dtype) for p in self.params]
        self.v = [torch.zeros_like(p, dtype=mv_dtype) for p in self.params]
        self.step = 0
        # Per parameter: None, or where it is a slice of a whole tensor (a
        # mesh's tensor parallelism: stochastic_round_bf16's ``shard``).
        self.shards: list = [None] * len(self.params)

    def step_scalars(self, step: int):
        """(bc1, bc2, seeds) of Adam step ``step``: the bias corrections
        1 - beta^t in f32, and each parameter's rounding seed word (0 for
        a parameter that is not bf16)."""
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1, bc2 = float(1.0 - self.beta1 ** t), float(1.0 - self.beta2 ** t)
        seeds = [seed_word(rounding_seed(step, i)) if p.dtype == torch.bfloat16 else 0
                 for i, p in enumerate(self.params)]
        return bc1, bc2, seeds

    def update(self, grads) -> None:
        """One step with ``grads``, one per parameter, in order; its
        scalars from the host's step count."""
        self.step += 1
        bc1, bc2, seeds = self.step_scalars(self.step)
        device = self.params[0].device
        self.apply(grads, _on_device([bc1, bc2], torch.float32, device),
                   _on_device(seeds, torch.int32, device))

    @torch.no_grad()
    def apply(self, grads, bc: torch.Tensor, seeds: torch.Tensor) -> None:
        """One step with ``grads`` from device scalars: ``bc`` the two bias
        corrections (f32), ``seeds`` the parameters' rounding seed words
        (int32, one a parameter; ``step_scalars``). ``step`` is left alone.
        Runs in the span ``adam`` (core/trace.py)."""
        bc1, bc2 = bc[0], bc[1]
        b1, b2 = self.beta1, self.beta2
        with trace.span("adam"):
            for i, (p, g, m, v) in enumerate(
                    zip(self.params, grads, self.m, self.v, strict=True)):
                g = g.float()
                p32 = p.float()
                if self.weight_decay:
                    g = g + self.weight_decay * p32
                m_new = b1 * m.float() + (1.0 - b1) * g
                v_new = b2 * v.float() + (1.0 - b2) * g.square()
                upd = self.lr * (m_new / bc1) / ((v_new / bc2).sqrt() + self.eps)
                if p.dtype == torch.bfloat16:
                    # Not p.sub_, which would round to nearest in bf16.
                    p.copy_(stochastic_round_bf16(p32 - upd, seeds[i], self.shards[i]))
                else:
                    p.sub_(upd)
                m.copy_(m_new)
                v.copy_(v_new)
