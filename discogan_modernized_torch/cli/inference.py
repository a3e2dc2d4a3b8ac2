"""Inference CLI (ref inference.py), on the card by default.

Loads gen_B_final.pth for AtoB / gen_A_final.pth for BtoA from the model
dir (ref :127-132), and the reverse generator once when it is there (the
reference reloaded it per image, :183-186). It translates a file or a
directory of jpg/png images in batches of ``--batch_size``, prints the p50
per-image latency, and saves an Input/Generated[/Reconstructed] panel as
<stem>_result.png (ref :70-112) when matplotlib is installed. Eval-mode BN
(running statistics) matches the reference's .eval() calls.

``translate_batch`` is the array-level step, usable without PIL or
matplotlib. The JAX CLI's ``--exported`` artifact mode is not ported yet.

    python -m discogan_modernized_torch.cli.inference \
        --model_path=<dir> --input_path=<imgs> --image_size=512
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import Policy, configure, default_policy
from ..data.preprocess import load_image
from ..models.generator import Generator
from ..train.checkpoint import load_reference_weights
from .common import inference_parser, parse_with_config


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def save_images(input_image, generated_image, reverse_generated_image,
                save_path):
    """1x3 (or 1x2) Input/Generated/Reconstructed panel (ref :70-112).
    Images are HWC float arrays in [0,1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [("Input", input_image), ("Generated", generated_image)]
    if reverse_generated_image is not None:
        panels.append(("Reconstructed", reverse_generated_image))
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(np.clip(np.asarray(img), 0, 1))
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)


def load_generators(model_path, direction: str, image_size: int,
                    device) -> tuple[Generator, Generator | None]:
    """(forward generator, reverse generator or None) for ``direction``."""
    model_dir = Path(model_path)
    fwd_name = "gen_B" if direction == "AtoB" else "gen_A"
    rev_name = "gen_A" if direction == "AtoB" else "gen_B"
    fwd = load_reference_weights(model_dir / f"{fwd_name}_final.pth",
                                 image_size, device)
    rev_path = model_dir / f"{rev_name}_final.pth"
    rev = (load_reference_weights(rev_path, image_size, device)
           if rev_path.exists() else None)
    return fwd, rev


def translate_batch(fwd: Generator, rev: Generator | None, images,
                    policy: Policy) -> tuple[np.ndarray, np.ndarray | None]:
    """(N,H,W,3) float images in [0,1] -> (generated, reconstructed or None)
    as float32 numpy arrays."""
    device = fwd.encoder[0].weight.device
    x = torch.as_tensor(np.asarray(images, np.float32)).to(device)
    y = fwd(x, policy=policy)
    r = rev(y, policy=policy) if rev is not None else None
    return y.cpu().numpy(), (r.cpu().numpy() if r is not None else None)


def main(argv=None):
    args = parse_with_config(inference_parser(), argv)
    device = resolve_device(args.device)
    policy = default_policy(args.precision, device)
    configure(policy)

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    batch_n = max(1, int(args.batch_size))

    fwd_name = "gen_B" if args.direction == "AtoB" else "gen_A"
    try:
        fwd, rev = load_generators(args.model_path, args.direction,
                                   args.image_size, device)
        print(f"모델 로드 성공: {Path(args.model_path) / (fwd_name + '_final.pth')}")
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        print(f"모델 로드 실패: {e}")
        print("다음 파일이 있는지 확인하세요:")
        for f in Path(args.model_path).glob("*.pth"):
            print(f" - {f}")
        return 1

    panels = have_matplotlib()
    if not panels:
        print("matplotlib is not installed: result panels are not saved")

    input_path = Path(args.input_path)
    if input_path.is_dir():
        image_files = sorted(input_path.glob("*.jpg")) + sorted(input_path.glob("*.png"))
    else:
        image_files = [input_path]

    latencies: list[float] = []
    pending: list[tuple] = []  # (file, image)
    flushes = 0

    def flush():
        nonlocal flushes
        if not pending:
            return
        imgs = np.stack([im for _, im in pending])
        # Pad to the batch size so every chunk runs the same shapes.
        pad = batch_n - len(pending) if batch_n > 1 else 0
        x = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:],
                                           np.float32)]) if pad else imgs
        t0 = time.perf_counter()
        gen_np, rec_np = translate_batch(fwd, rev, x, policy)
        # Per-image latency = batch time / rows computed (padding included).
        dt = (time.perf_counter() - t0) / x.shape[0]
        # The first batch builds the kernels and derives the weights'
        # operand copies; p50 is the steady state.
        if flushes > 0:
            latencies.extend([dt] * len(pending))
        flushes += 1
        for i, (f, im) in enumerate(pending):
            if panels:
                out = output_dir / f"{Path(f).stem}_result.png"
                save_images(im, gen_np[i],
                            rec_np[i] if rec_np is not None else None, out)
                print(f"저장 완료: {out}")
        pending.clear()

    for img_file in image_files:
        print(f"Processing: {img_file}")
        img = load_image(img_file, args.image_size, args.domain,
                         args.dataset_type)
        if img is None:
            continue
        pending.append((img_file, img))
        if len(pending) >= batch_n:
            flush()
    flush()

    if latencies:
        p50 = sorted(latencies)[len(latencies) // 2]
        print(f"p50 per-image latency: {p50 * 1000:.2f} ms")
    print(f"모든 이미지 처리 완료. 결과는 {output_dir}에 저장되었습니다.")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
