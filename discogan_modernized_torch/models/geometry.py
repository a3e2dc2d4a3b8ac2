"""Network geometry derived from image size.

The reference hardcodes a 512px-only stack: seven stride-2 k=4 "halving"
convs (512 -> 4) and a 4x4 VALID conv to the 1x1 latent (ref model.py:8-35).
Depth is derived here: n_halvings = log2(size) - 2, with the reference's
channel schedule 64*2^i capped at 2048, so that at 512 the stack is layer
for layer model.py and every power-of-two size >= 8 works.
"""

from __future__ import annotations

import math

BASE_CH = 64
MAX_CH = 64 * 32  # 2048
LATENT_CH = 100
KERNEL = 4


def n_halvings(image_size: int) -> int:
    if image_size < 8 or (image_size & (image_size - 1)) != 0:
        raise ValueError(
            f"image_size must be a power of two >= 8, got {image_size}")
    return int(math.log2(image_size)) - 2


def encoder_channels(image_size: int) -> list[int]:
    """Output channels of each stride-2 conv. 512 -> [64,128,...,2048,2048]."""
    return [min(BASE_CH * (2 ** i), MAX_CH)
            for i in range(n_halvings(image_size))]
