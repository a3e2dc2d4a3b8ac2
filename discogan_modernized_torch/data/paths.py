"""Dataset path registry (ref dataset.py:14-22), the port's copy of the JAX
package's ``data/paths.py``.

Same layout as the reference (README.md:67-76), rooted at ./datasets by
default and overridable with DISCOGAN_DATASETS_ROOT (the reference
hardcodes the relative path: the "환경에 맞게 조정 필요" comment at
dataset.py:13).
"""

from __future__ import annotations

import os
from pathlib import Path


def dataset_root() -> Path:
    return Path(os.environ.get("DISCOGAN_DATASETS_ROOT", "./datasets"))


def task_paths() -> dict:
    root = dataset_root()
    return {
        "celebA": root / "celebA",
        "edges2handbags": root / "edges2handbags",
        "edges2shoes": root / "edges2shoes",
        "facescrub": root / "facescrub",
        "rendered_chairs": root / "rendered_chairs",
        "face_3d": root / "PublicMM1" / "05_renderings",
        "face_real": root / "real_face",
        "cars": root / "data" / "cars",
        "custom": root / "custom",
    }
