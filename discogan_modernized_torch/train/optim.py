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
bf16 (slim state "mv": cast up, updated in f32, cast back). The master
parameters stay f32 and are updated in place, which raises their
``_version`` counters.
"""

from __future__ import annotations

import torch


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

    @torch.no_grad()
    def update(self, grads) -> None:
        """One step with ``grads``, one per parameter, in order."""
        self.step += 1
        t = torch.tensor(float(self.step), dtype=torch.float32)
        bc1 = 1.0 - self.beta1 ** t
        bc2 = 1.0 - self.beta2 ** t
        b1, b2 = self.beta1, self.beta2
        for p, g, m, v in zip(self.params, grads, self.m, self.v, strict=True):
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p
            m_new = b1 * m.float() + (1.0 - b1) * g
            v_new = b2 * v.float() + (1.0 - b2) * g.square()
            p.sub_(self.lr * (m_new / bc1) / ((v_new / bc2).sqrt() + self.eps))
            m.copy_(m_new)
            v.copy_(v_new)
