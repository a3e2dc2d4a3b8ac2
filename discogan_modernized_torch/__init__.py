"""discogan_modernized_torch — the PyTorch and CUDA port of the DiscoGAN
framework, for an NVIDIA H100, beside the JAX package it is held against.

It serves the eval-mode generator (``cli/inference.py``,
``tools/serve.py``) and trains (``cli/image_translation.py`` on the
synthetic and real-data tasks, ``cli/angle_pairing.py``; resumable with
``--resume``) through seven hand-written Hopper kernels in ``csrc/`` (see
ops/). It imports ``torch`` and never ``jax``; its entry points run on the
card unless asked for the CPU.
"""

__version__ = "0.1.0"
