"""A cell of the benchmark cut to a size the CPU runs in seconds: its
configuration at 16px, batch 4, 16 images a domain, on the port's plain
CPU path (no card: the harness's look for one is skipped)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

torch.set_num_threads(1)


def tiny_spec(cell: str = "train64.b64", precision: str = "f32", root: Path = ROOT,
              image_size: int = 16, batch: int = 4, config: str | None = None,
              slim_state: str | None = None) -> dict:
    """``cell``'s spec cut to size; ``config`` runs it with another
    configuration file's step settings (``configs/<config>.json``), and
    ``slim_state`` with another slim state."""
    spec = copy.deepcopy(harness.cell_spec(cell, root))
    if config:
        spec["config"] = harness.load_json(root / "portbench" / "configs" / f"{config}.json")
    spec["config"]["image_size"] = image_size
    spec["config"]["train"]["precision"] = precision
    if slim_state:
        spec["config"]["train"]["slim_state"] = slim_state
    spec["traffic"]["batch"] = batch
    spec["traffic"]["dataset"] = {"images_per_domain": 4 * batch}
    spec["traffic"]["warm_chunks"] = 1
    spec["traffic"]["trace_chunks"] = 1
    return spec


def run_tiny(spec: dict, seed: int = 12345, trace: bool = False, seconds: float = 0.0) -> dict:
    return harness.driver(spec).run(spec, seed, seconds, trace, torch.device("cpu"), 0.0)
