"""The reference-layout checkpoints, and the trainer's train state.

The reference saves one raw ``state_dict`` per model as
``{gen_A,gen_B,dis_A,dis_B}_{<iters>|final}.pth`` (ref
image_translation.py:419-432), and its inference reads the generators by
those names (inference.py:127-132). The JAX package writes the same files,
and so does ``save_reference_layout`` here: f32 tensors (int64
``num_batches_tracked``) that the reference's modules load with
``strict=True``. ``save_train_state`` also keeps the Adam moments and step
counts beside them (``train_state.pt`` and ``train_state_meta.json``).
Loading uses only ``torch.load(weights_only=True)``: a file that is not a
plain tensor state dict is refused, never unpickled.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from ..models.generator import Generator


def load_reference_weights(path, image_size: int,
                           device: torch.device | str = "cpu") -> Generator:
    """One reference-layout generator ``.pth`` -> an eval-mode Generator on
    ``device``; the keys must match exactly (strict)."""
    sd = torch.load(Path(path), map_location="cpu", weights_only=True)
    gen = Generator(image_size)
    gen.load_state_dict(sd, strict=True)
    return gen.to(device).eval()


MODEL_NAMES = ("gen_A", "gen_B", "dis_A", "dis_B")


def _cpu_state(module) -> dict:
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
            for k, v in module.state_dict().items()}


def save_reference_layout(model_path, models: dict, tag) -> None:
    """Write the four ``{name}_{tag}.pth`` files (tag: an iteration or
    "final")."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    for name in MODEL_NAMES:
        torch.save(_cpu_state(models[name]), model_path / f"{name}_{tag}.pth")


def save_train_state(model_path, ts, iters: int, meta: dict | None = None) -> None:
    """The networks, both Adam states and the iteration count, written
    under temporary names and moved into place."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    state = {
        "models": {name: _cpu_state(m) for name, m in ts.models.items()},
        **{key: {"m": [t.cpu() for t in opt.m], "v": [t.cpu() for t in opt.v],
                 "step": opt.step}
           for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis))},
    }
    tmp = model_path / "train_state.pt.tmp"
    torch.save(state, tmp)
    os.replace(tmp, model_path / "train_state.pt")
    tmp_meta = model_path / "train_state_meta.json.tmp"
    tmp_meta.write_text(json.dumps({"iters": iters, **(meta or {})}))
    os.replace(tmp_meta, model_path / "train_state_meta.json")
