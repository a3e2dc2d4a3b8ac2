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
rounding keeps them in expectation. The random bits are stateless: each
tensor's draw is seeded by a fixed function of (Adam step, tensor index),
so a resumed run draws what the uninterrupted one drew. They come from
``torch.randint`` (Philox on the card), not from JAX's threefry, so the
two packages round the same value to the same pair of neighbours but not
always to the same one.
"""

from __future__ import annotations

import torch

_SEED_BASE = 0x5EED
_MASK64 = (1 << 64) - 1


def rounding_seed(step: int, index: int) -> int:
    """The seed of tensor ``index``'s rounding bits at Adam step ``step``:
    (step, index) mixed by splitmix64's finalizer, so that every bit of
    the seed depends on both (the CPU generator keeps only the low 32
    bits of a seed; Philox on the card takes all 64)."""
    z = ((_SEED_BASE << 48) ^ (step << 16) ^ index) + 0x9E3779B97F4A7C15
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1  # 63 bits


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding: add 16 uniform random bits below
    bf16's mantissa cutoff to the f32 word, then truncate. A carry out of
    the mantissa is exactly the round-up to the next representable value,
    so the rule holds across exponent boundaries."""
    bits = x.float().contiguous().view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                        device=x.device, generator=generator)
    bits = (bits + rnd) & -65536  # 0xFFFF0000 as an int32
    return bits.view(torch.float32).to(torch.bfloat16)


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
        self._generator = None  # made on the parameters' device at first use

    def _rounding_generator(self, index: int):
        if self._generator is None:
            self._generator = torch.Generator(device=self.params[0].device)
        return self._generator.manual_seed(rounding_seed(self.step, index))

    @torch.no_grad()
    def update(self, grads) -> None:
        """One step with ``grads``, one per parameter, in order."""
        self.step += 1
        t = torch.tensor(float(self.step), dtype=torch.float32)
        bc1 = 1.0 - self.beta1 ** t
        bc2 = 1.0 - self.beta2 ** t
        b1, b2 = self.beta1, self.beta2
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
                p.copy_(stochastic_round_bf16(
                    p32 - upd, self._rounding_generator(i)))
            else:
                p.sub_(upd)
            m.copy_(m_new)
            v.copy_(v_new)
