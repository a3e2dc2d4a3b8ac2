"""Elementwise activations: LeakyReLU(0.2) in the encoder, ReLU in the
decoder, Sigmoid on the output (ref model.py:9-36, :116-143).

The kernels take the activation as a code (``ACT_CODES``); ``apply_act``
is the same choice in plain PyTorch, for the kernels' plain versions.
"""

from __future__ import annotations

import torch

NEGATIVE_SLOPE = 0.2

# Names used by the JAX package's kernels ("leaky" in the conv kernels,
# "leaky_relu" in the fused BN kernel), mapped to csrc/common.cuh's Act.
ACT_CODES = {None: 0, "none": 0, "relu": 1, "leaky": 2, "leaky_relu": 2}


def leaky_relu(x: torch.Tensor, negative_slope: float = NEGATIVE_SLOPE):
    return torch.where(x >= 0, x, x * negative_slope)


def relu(x: torch.Tensor):
    return torch.clamp_min(x, 0)


def sigmoid(x: torch.Tensor):
    return torch.sigmoid(x)


def act_code(act: str | None) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r} "
                         f"(expected one of {sorted(map(str, ACT_CODES))})")
    return ACT_CODES[act]


def apply_act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    code = act_code(act)
    if code == 1:
        return relu(x)
    if code == 2:
        return leaky_relu(x)
    return x
