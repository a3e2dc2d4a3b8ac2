"""discogan_modernized_torch — the PyTorch and CUDA port of the DiscoGAN
framework, for an NVIDIA H100, beside the JAX package it is held against.

The first slice is the serving path: the eval-mode generator forward behind
``cli/inference.py`` and ``tools/serve.py``, through four hand-written
Hopper kernels in ``csrc/`` (see ops/). It imports ``torch`` and never
``jax``; its entry points run on the card unless asked for the CPU.
"""

__version__ = "0.1.0"
