"""The sample grid of the trainer (ref image_translation.py:170-209): an
n_samples x 6 matplotlib grid titled A / B / A->B / B->A / A->B->A /
B->A->B, saved as samples_iter_{it}.png. Where matplotlib is not installed
(as on the card machine), ``save_sample_grid`` prints one line and saves
nothing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_sample_grid(test_A, test_B, AB, BA, ABA, BAB, save_dir, iteration,
                     n_samples: int = 5) -> None:
    """Images are NHWC float arrays in [0,1]."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: sample grid of iteration "
              f"{iteration} not saved")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    n_samples = min(n_samples, len(test_A))
    fig, axes = plt.subplots(n_samples, 6, figsize=(18, 3 * n_samples))
    titles = ["A", "B", "A->B", "B->A", "A->B->A", "B->A->B"]
    for i in range(n_samples):
        images = [test_A[i], test_B[i], AB[i], BA[i], ABA[i], BAB[i]]
        for j, (img, title) in enumerate(zip(images, titles)):
            ax = axes[i, j] if n_samples > 1 else axes[j]
            ax.imshow(np.clip(np.asarray(img), 0, 1))
            ax.set_title(title)
            ax.axis("off")
    plt.tight_layout()
    plt.savefig(save_dir / f"samples_iter_{iteration}.png")
    plt.close(fig)
