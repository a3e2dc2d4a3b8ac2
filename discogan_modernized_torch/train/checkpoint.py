"""Loading the reference-layout generator checkpoints.

The reference saves one raw ``state_dict`` per model as
``{gen_A,gen_B,dis_A,dis_B}_{<iters>|final}.pth`` (ref
image_translation.py:419-432), and its inference reads the generators by
those names (inference.py:127-132). The JAX package writes the same files.
Only ``torch.load(weights_only=True)`` is used: a file that is not a plain
tensor state dict is refused, never unpickled.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..models.generator import Generator


def load_reference_weights(path, image_size: int,
                           device: torch.device | str = "cpu") -> Generator:
    """One reference-layout generator ``.pth`` -> an eval-mode Generator on
    ``device``; the keys must match exactly (strict)."""
    sd = torch.load(Path(path), map_location="cpu", weights_only=True)
    gen = Generator(image_size)
    gen.load_state_dict(sd, strict=True)
    return gen.to(device).eval()
