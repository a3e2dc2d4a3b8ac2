"""Inference CLI (ref inference.py), on the card by default.

Loads gen_B_final.pth for AtoB / gen_A_final.pth for BtoA from the model
dir (ref :127-132), and the reverse generator once when it is there (the
reference reloaded it per image, :183-186). It translates a file or a
directory of jpg/png images in batches of ``--batch_size``, prints the p50
per-image latency, and saves an Input/Generated[/Reconstructed] panel as
<stem>_result.png (ref :70-112) when matplotlib is installed. Eval-mode BN
(running statistics) matches the reference's .eval() calls.

``translate_batch`` is the array-level step, usable without PIL or
matplotlib.

``--exported`` (and ``--exported_rev`` for the reconstruction) runs from
``torch.export`` artifacts (tools/export_model.py) instead of a
checkpoint: the weights and the precision are inside. The artifact's input
must match ``--image_size``, and a static batch ``--batch_size``; where the
sidecar is there, its generator must be the one ``--direction`` serves and
its precision ``--precision`` where that is given. Each artifact's program
is made into a module once and called for every batch.

    python -m discogan_modernized_torch.cli.inference \
        --model_path=<dir> --input_path=<imgs> --image_size=512
    python -m discogan_modernized_torch.cli.inference \
        --exported=<dir>/gen_B_final.pt2 --input_path=<imgs> --image_size=512
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
    return run_batch(lambda x: fwd(x, policy=policy),
                     None if rev is None else (lambda y: rev(y, policy=policy)),
                     images, fwd.encoder[0].weight.device)


@torch.no_grad()
def run_batch(run_fwd, run_rev, images, device) -> tuple[np.ndarray, np.ndarray | None]:
    """``translate_batch`` through callables: a generator's forward or an
    artifact's module."""
    x = torch.as_tensor(np.asarray(images, np.float32)).to(device)
    y = run_fwd(x)
    r = run_rev(y) if run_rev is not None else None
    return y.cpu().numpy(), (r.cpu().numpy() if r is not None else None)


def load_artifact(path, image_size: int, device):
    """(an artifact's program as a module on ``device``, made once; its
    static batch or None where it is symbolic). Raises ValueError where its
    input is not ``image_size`` or its platforms do not list ``device``."""
    from ..tools.export_model import artifact_input_shape, load_exported

    program = load_exported(path, device)
    b, *hwc = artifact_input_shape(program)
    if tuple(hwc) != (image_size, image_size, 3):
        raise ValueError(f"artifact {path} expects input {(b or 'b', *hwc)}, which does "
                         f"not match --image_size={image_size}")
    return program.module(), b


def artifact_for_batch(path, image_size: int, batch: int, device):
    """``load_artifact``'s module, refusing (SystemExit) an artifact of
    another input size or of a static batch other than ``batch``."""
    try:
        module, b = load_artifact(path, image_size, device)
    except ValueError as e:
        raise SystemExit(str(e))
    if b is not None and b != batch:
        raise SystemExit(f"artifact {path} was exported with static batch {b}; pass "
                         f"--batch_size={b} or re-export with --batch 0 (symbolic)")
    return module


def check_sidecar(path, direction: str, precision: str | None) -> str | None:
    """The artifact's baked precision from its sidecar, after checking that
    its generator is ``direction``'s and its precision ``precision`` (where
    given); None without a sidecar."""
    from ..tools.export_model import load_artifact_sidecar

    meta = load_artifact_sidecar(path)
    if meta is None:
        print("참고: 사이드카 .json 이 없어 --direction/--precision 교차 검증은 "
              "생략합니다 (생성기와 정밀도는 아티팩트에 고정됨)")
        return None
    want = "gen_B" if direction == "AtoB" else "gen_A"
    if meta.get("generator") and meta["generator"] != want:
        raise SystemExit(
            f"artifact {path} holds {meta['generator']} (exported for --direction "
            f"{meta.get('direction')}); --direction {direction} needs {want}: pass the "
            "matching direction or re-export")
    baked = meta.get("precision")
    if precision and baked not in (None, precision):
        raise SystemExit(
            f"--precision {precision} conflicts with the artifact's baked compute dtype "
            f"({baked}): precision is fixed at export; re-export with --precision "
            f"{precision}")
    return baked


def main(argv=None):
    args = parse_with_config(inference_parser(), argv)
    device = resolve_device(args.device)
    if not (args.exported or args.model_path):
        print("inference: --model_path 또는 --exported 가 필요합니다")
        return 2

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    batch_n = max(1, int(args.batch_size))

    if args.exported:
        baked = check_sidecar(args.exported, args.direction, args.precision)
        configure(default_policy(baked or args.precision, device))
        run_fwd = artifact_for_batch(args.exported, args.image_size, batch_n, device)
        run_rev = (artifact_for_batch(args.exported_rev, args.image_size, batch_n, device)
                   if args.exported_rev else None)
        print(f"아티팩트 로드 성공: {args.exported}")
    else:
        policy = default_policy(args.precision, device)
        configure(policy)
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
        run_fwd = lambda x: fwd(x, policy=policy)  # noqa: E731
        run_rev = None if rev is None else (lambda y: rev(y, policy=policy))

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
        gen_np, rec_np = run_batch(run_fwd, run_rev, x, device)
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
