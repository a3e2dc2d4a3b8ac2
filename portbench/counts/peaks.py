"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), the same arithmetic as the program's kernel bounds: a bound is the
larger of flops over the math type's peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float, math_type: str = "bf16") -> float:
    return max(flops / PEAK_FLOPS[math_type], nbytes / HBM_BYTES_PER_S)
