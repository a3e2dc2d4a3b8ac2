"""Trainer CLI (ref image_translation.py), on the card by default.

    python -m discogan_modernized_torch.cli.image_translation \
        --task_name=edges2shoes --image_size=512 --batch_size=8 --epochs=1

The dataset tree sits under DISCOGAN_DATASETS_ROOT (default ./datasets);
``--task_name=synthetic`` needs none. ``--resume <model dir>`` continues a
run from its train state.

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

from ..train.loop import run_training
from .common import parse_with_config, translation_parser


def main(argv=None):
    args = parse_with_config(translation_parser(), argv)
    return run_training(args)


if __name__ == "__main__":
    main()
