"""The trainers' sample dumps (ref image_translation.py:170-209 and
angle_pairing.py:366-431): an n_samples x 6 matplotlib grid titled A / B /
A->B / B->A / A->B->A / B->A->B, saved as samples_iter_{it}.png, and, for
the angle-pairing trainer, each test image's six views as JPEGs
({idx}.A.jpg, {idx}.AB.jpg, ...) in numbered subdirectories. Where
matplotlib is not installed, each prints one line and saves nothing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot(what: str):
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {what} not saved")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_sample_grid(test_A, test_B, AB, BA, ABA, BAB, save_dir, iteration,
                     n_samples: int = 5) -> None:
    """Images are NHWC float arrays in [0,1]."""
    plt = _pyplot(f"sample grid of iteration {iteration}")
    if plt is None:
        return

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


def save_individual_images(test_A, test_B, AB, BA, ABA, BAB, subdir_path,
                           max_images: int) -> None:
    """Per-test-image JPEG dumps (ref angle_pairing.py:366-423)."""
    plt = _pyplot(f"test images of {subdir_path}")
    if plt is None:
        return
    subdir_path = Path(subdir_path)
    subdir_path.mkdir(parents=True, exist_ok=True)
    n = min(len(test_A), len(test_B), max_images)
    views = {"A": test_A, "B": test_B, "AB": AB, "BA": BA, "ABA": ABA, "BAB": BAB}
    for idx in range(n):
        for tag, arr in views.items():
            val = np.clip(np.asarray(arr[idx]), 0, 1) * 255.0
            plt.figure(figsize=(6, 6))
            plt.imshow(val.astype(np.uint8))
            plt.axis("off")
            plt.savefig(subdir_path / f"{idx}.{tag}.jpg",
                        bbox_inches="tight", pad_inches=0)
            plt.close()
