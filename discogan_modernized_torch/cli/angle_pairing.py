"""Angle-pairing trainer CLI (ref angle_pairing.py), on the card by default.

    python -m discogan_modernized_torch.cli.angle_pairing \
        --task_name=car2car --image_size=64 --epochs=10

The reference script cannot import (it imports get_cars/get_chairs/
get_faces_3d, which its dataset.py never defines); the resolvers are
restored in ``data/resolvers.py``. Its loss-graph variants hold: the FM
loss skips the first discriminator feature (ref :114-115) and the log
line has no FM field (ref :350-354). ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU.
"""

from __future__ import annotations

from ..train.loop import run_training
from .common import angle_parser, parse_with_config


def main(argv=None):
    args = parse_with_config(angle_parser(), argv)
    return run_training(args, angle_variant=True)


if __name__ == "__main__":
    main()
