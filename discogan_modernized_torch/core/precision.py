"""Precision policy (the JAX package's core/precision.py, for the card).

F32 keeps every operand in float32, as the reference does. BF16 feeds the
convolutions and products bfloat16 operands with float32 accumulation,
while BatchNorm math and the final sigmoid stay float32. The default is
bf16 on CUDA and f32 on the CPU, where the tests hold the port to the JAX
package at 1e-4.

A float32 convolution on the card goes through cuDNN in TF32 by default,
which keeps about three decimal digits: ``configure`` turns TF32 off for
cuDNN and matmul under F32, the counterpart of the JAX package's
``lax.Precision.HIGHEST`` for f32 operands. Under BF16 it keeps bf16
products out of cuBLAS's reduced-precision reductions, so they accumulate
in f32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """compute_dtype: conv/matmul operands and the activations between
    layers. Weights are stored in f32; accumulation and BN math are f32."""

    name: str
    compute_dtype: torch.dtype = torch.float32


F32 = Policy("f32")
BF16 = Policy("bf16", compute_dtype=torch.bfloat16)


def default_policy(precision: str | None = None,
                   device: torch.device | str = "cpu") -> Policy:
    """Resolve "bf16" | "f32" | None (auto: bf16 on CUDA, f32 elsewhere)."""
    if precision in ("f32", "float32"):
        return F32
    if precision in ("bf16", "bfloat16"):
        return BF16
    if precision is not None:
        raise ValueError(
            f"unknown precision {precision!r} (expected bf16|f32|None)")
    return BF16 if torch.device(device).type == "cuda" else F32


def configure(policy: Policy) -> None:
    """Set the process's cuDNN/cuBLAS precision switches for ``policy``."""
    if policy.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
