"""Frozen copy of the rules the trainer's optimizer states, which the
reference must follow to hold the same state: Adam with weight decay added
to the gradient (torch semantics), bias corrections in float32, moments
stored in bfloat16 under the slim states "mv" and "all", and bfloat16
master weights under "all", written back with unbiased stochastic rounding.

The rounding bits are a pure function of (Adam step, tensor index, element
index): a seed per tensor from splitmix64's finalizer, and on the card
murmur3's 32-bit finalizer of (element index * golden ratio + seed); on the
CPU a CPU ``torch.Generator`` seeded with the seed word. These are the
configuration's rules, copied here so that the yardstick does not move when
the program does.
"""

from __future__ import annotations

import torch

_SEED_BASE = 0x5EED
_MASK64 = (1 << 64) - 1


def rounding_seed(step: int, index: int) -> int:
    z = ((_SEED_BASE << 48) ^ (step << 16) ^ index) + 0x9E3779B97F4A7C15
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def seed_word(seed: int) -> int:
    w = seed & 0xFFFFFFFF
    return w - (1 << 32) if w >= 1 << 31 else w


_GOLDEN = seed_word(0x9E3779B1)
_FMIX = ((16, seed_word(0x85EBCA6B)), (13, seed_word(0xC2B2AE35)), (16, None))


def rounding_bits(n: int, seed: int, device) -> torch.Tensor:
    """n values in [0, 2^16): the top half of murmur3's finalizer of
    e * golden + seed, in int32 arithmetic that wraps as uint32's does."""
    h = torch.arange(n, dtype=torch.int32, device=device)
    h.mul_(_GOLDEN).add_(seed)
    for shift, mul in _FMIX:
        h.bitwise_xor_(h.bitwise_right_shift(shift).bitwise_and_((1 << (32 - shift)) - 1))
        if mul is not None:
            h.mul_(mul)
    return h.bitwise_right_shift_(16).bitwise_and_(0xFFFF)


def stochastic_round_bf16(x: torch.Tensor, seed: int) -> torch.Tensor:
    """f32 -> bf16: add 16 random bits below bf16's mantissa, truncate."""
    bits = x.float().contiguous().view(torch.int32)
    if x.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed & 0xFFFFFFFF)
        rnd = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32, generator=gen)
    else:
        rnd = rounding_bits(x.numel(), seed, x.device).view(x.shape)
    return ((bits + rnd) & -65536).view(torch.float32).to(torch.bfloat16)


def bias_corrections(step: int, beta1: float, beta2: float) -> tuple[float, float]:
    """1 - beta^t for both moments, computed in float32."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(1.0 - beta1 ** t), float(1.0 - beta2 ** t)


def adam_update(params: list, grads: list, m: list, v: list, step: int, opt: dict) -> None:
    """One Adam step in place over lists of leaves. ``params`` hold the
    stored masters (bf16 leaves take stochastic rounding with the seed of
    (step, their index)); ``m`` and ``v`` the stored moments."""
    b1, b2 = opt["beta1"], opt["beta2"]
    bc1, bc2 = bias_corrections(step, b1, b2)
    device = params[0].device
    bc1 = torch.tensor(bc1, dtype=torch.float32, device=device)
    bc2 = torch.tensor(bc2, dtype=torch.float32, device=device)
    with torch.no_grad():
        for i, (p, g, mi, vi) in enumerate(zip(params, grads, m, v, strict=True)):
            g = g.float()
            p32 = p.float()
            g = g + opt["weight_decay"] * p32
            m_new = b1 * mi.float() + (1.0 - b1) * g
            v_new = b2 * vi.float() + (1.0 - b2) * g.square()
            upd = opt["learning_rate"] * (m_new / bc1) / ((v_new / bc2).sqrt() + 1e-8)
            if p.dtype == torch.bfloat16:
                p.copy_(stochastic_round_bf16(p32 - upd, seed_word(rounding_seed(step, i))))
            else:
                p.sub_(upd)
            mi.copy_(m_new)
            vi.copy_(v_new)
