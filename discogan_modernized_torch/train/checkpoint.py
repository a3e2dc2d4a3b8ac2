"""The reference-layout checkpoints, and the trainer's train state.

The reference saves one raw ``state_dict`` per model as
``{gen_A,gen_B,dis_A,dis_B}_{<iters>|final}.pth`` (ref
image_translation.py:419-432), and its inference reads the generators by
those names (inference.py:127-132). The JAX package writes the same files,
and so does ``save_reference_layout`` here: f32 tensors (int64
``num_batches_tracked``) that the reference's modules load with
``strict=True``. ``save_train_state`` keeps the whole train state beside
them: the networks in their stored dtypes (bf16 parameters under slim
state "all"), the running statistics, both Adam states with their step
counts (``train_state.pt``), and the iteration count with what the state
was trained as (``train_state_meta.json``). ``load_train_state`` restores
it for ``--resume`` and refuses a state whose slim state, architecture or
image size differs from the run's. Loading uses only
``torch.load(weights_only=True)``: a file that is not a plain tensor state
dict is refused, never unpickled.
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


def _raw_state(module) -> dict:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_train_state(model_path, ts, iters: int, meta: dict | None = None) -> None:
    """The networks, both Adam states and the iteration count, written
    under temporary names and moved into place."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    state = {
        "models": {name: _raw_state(m) for name, m in ts.models.items()},
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


# The meta keys that fix the state's layout: a resume must match them.
LAYOUT_KEYS = ("arch", "image_size", "slim_state")


def train_variants(cfg) -> dict:
    """The train step's graph variants (train/graph.py), which leave the
    state's layout as it is."""
    return {"paired": cfg.paired, "lean_dis": cfg.lean_dis,
            "concat_dis": cfg.concat_dis and not cfg.paired, "remat": cfg.use_remat,
            "remat_policy": cfg.remat_policy or "full",
            "remat_dis": bool(cfg.use_remat and cfg.remat_dis)}


def train_state_meta(cfg, **extra) -> dict:
    """What a train state was trained as; ``load_train_state`` checks its
    layout keys and says where the variants differ."""
    from .step import resolve_slim_state

    return {"arch": cfg.model_arch, "image_size": cfg.image_size,
            "slim_state": resolve_slim_state(cfg), "variants": train_variants(cfg),
            **extra}


def load_train_state(model_path, ts, cfg) -> int:
    """Restore ``save_train_state``'s files into ``ts`` in place (the
    networks, their running statistics and both Adam states) and return
    the saved iteration count. ``ts`` is a fresh state of the same
    configuration: a state whose slim state, architecture or image size
    differs from ``cfg`` is refused. Other graph variants (paired, lean_dis,
    remat, concat_dis) leave the layout as it is: a resume under them is
    taken, and one line says what changed."""
    model_path = Path(model_path)
    meta_file = model_path / "train_state_meta.json"
    if not meta_file.is_file():
        raise FileNotFoundError(
            f"--resume {model_path}: no train state there "
            "(train_state_meta.json and train_state.pt)")
    meta = json.loads(meta_file.read_text())
    want = train_state_meta(cfg)
    differ = {k: (meta.get(k), want[k]) for k in LAYOUT_KEYS if meta.get(k) != want[k]}
    if differ:
        raise ValueError(
            f"--resume {model_path}: the train state was saved as "
            + ", ".join(f"{k}={saved!r}" for k, (saved, _) in differ.items())
            + "; this run has "
            + ", ".join(f"{k}={now!r}" for k, (_, now) in differ.items()))
    saved_variants = meta.get("variants")
    if saved_variants is not None and saved_variants != want["variants"]:
        print(f"--resume {model_path}: graph variants change (same state layout): "
              + ", ".join(f"{k} {saved_variants.get(k)!r} -> {v!r}"
                          for k, v in want["variants"].items()
                          if saved_variants.get(k) != v))
    state = torch.load(model_path / "train_state.pt", map_location="cpu",
                       weights_only=True)
    with torch.no_grad():
        for name, m in ts.models.items():
            m.load_state_dict(state["models"][name], strict=True)
        for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
            saved = state[key]
            for mine, theirs in ((opt.m, saved["m"]), (opt.v, saved["v"])):
                if len(mine) != len(theirs) or any(
                        a.shape != b.shape or a.dtype != b.dtype
                        for a, b in zip(mine, theirs)):
                    raise ValueError(f"--resume {model_path}: {key}'s moments do "
                                     "not match this run's parameters")
                for a, b in zip(mine, theirs):
                    a.copy_(b)
            opt.step = int(saved["step"])
    return int(meta["iters"])
