"""Training data: the synthetic task and the per-epoch batch iterator.

``synthetic_pair`` is the JAX package's deterministic random task
(``--task_name=synthetic``); real-data tasks and their decode cache are
not ported yet. ``epoch_batches`` yields one epoch of (A, B) batches with
independent per-domain shuffles (unpaired training, ref dataset.py:24-35),
copied to the device a batch at a time.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_pair(n: int, image_size: int, seed: int = 0):
    """Deterministic random image pairs (N,H,W,3) f32 in [0,1)."""
    rng = np.random.RandomState(seed)
    a = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    b = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    return a, b


def n_batches(data_A, data_B, batch_size: int) -> int:
    return min(len(data_A), len(data_B)) // batch_size


def epoch_batches(data_A: np.ndarray, data_B: np.ndarray, batch_size: int,
                  device, rng: np.random.RandomState):
    """One epoch of (A, B) NHWC f32 batches on ``device``; the last partial
    batch is dropped."""
    pa = rng.permutation(len(data_A))
    pb = rng.permutation(len(data_B))
    for i in range(n_batches(data_A, data_B, batch_size)):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        yield (torch.from_numpy(data_A[pa[sl]]).to(device),
               torch.from_numpy(data_B[pb[sl]]).to(device))
