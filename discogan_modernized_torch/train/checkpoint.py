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
counts, and the iteration count with what the state was trained as and
the backend that wrote it (``train_state_meta.json``).
``load_train_state`` restores it for ``--resume``, whichever backend wrote
it (a meta without the key, as the port wrote before it had a second
backend, is npz), and refuses a state whose slim state, architecture or
image size differs from the run's.

Two backends, named as the JAX package's ``--ckpt_backend`` choices and
writing under the same names (JAX train/checkpoint.py:109-235), so that the
flag means the same files on a user's disk; their content is the port's
own format, which neither package reads of the other's:

- ``npz``: the whole state in one ``train_state.pt`` (a ``torch.save``
  dict), written by one process; under tensor parallelism the trainer
  gathers it onto rank 0 first (parallel/gspmd.py ``gather_train_state``).
- ``orbax``: the directory ``train_state_orbax/``, written by every rank of
  a distributed run at once, each its own slices (JAX's orbax save is
  collective in the same way): one ``part_m{m}.pt`` a place m on the model
  axis (``torch.save`` of a flat dict of tensors: a split tensor's slice m,
  and in part 0 every tensor that is not split), written by the ranks of
  data row 0 (the other rows hold equal copies), and ``index.json``: each
  tensor's key, whole shape, dtype, split axis and the file of each of its
  parts, and the Adam steps. Under data parallelism or spatial sharding
  nothing is split, and rank 0 writes the whole state as part 0. The save
  follows JAX's crash-safe protocol: a stale ``train_state_orbax.new/`` is
  removed, or promoted where it is the only complete checkpoint left; the
  parts are written into ``.new``; the ranks fence (a failed write on any
  rank stops every rank there, the previous checkpoint untouched); rank 0
  writes the index (which makes ``.new`` complete), swaps ``.new`` in, the
  ranks fence again, and rank 0 alone writes the meta. A load falls back to
  a complete ``.new`` where the final directory is missing and promotes it;
  a process that loses that race reads the winner's directory. The whole
  state is read back on the CPU, so a save moves between meshes of any
  shape and a one-process run (the caller places it again).

Loading uses only ``torch.load(weights_only=True)`` (and ``json``): a file
that is not a plain tensor state dict is refused, never unpickled, which
is why the sharded backend is not ``torch.distributed.checkpoint``, whose
metadata file is a pickle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from ..core.distributed import fence
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


BACKENDS = ("npz", "orbax")
ORBAX_DIR = "train_state_orbax"
ORBAX_NEW = ORBAX_DIR + ".new"
INDEX = "index.json"
OPTS = ("opt_gen", "opt_dis")


@dataclasses.dataclass
class StateSlices:
    """A rank's part of a train state, as the orbax backend writes it:
    ``tensors`` by key (``state_slices``' names), each this rank's slice of
    a split tensor or a whole one; ``split``, key -> (axis, whole shape) of
    the split ones; the Adam steps by optimizer; this rank's place ``part``
    among the model axis's ``parts``; ``writes``: whether it writes at all
    (a rank off data row 0 holds copies of that row's tensors)."""
    tensors: dict
    split: dict
    steps: dict
    part: int = 0
    parts: int = 1
    writes: bool = True


def state_slices(ts, writes: bool = True) -> StateSlices:
    """A whole train state (one process's, or what ``gather_train_state``
    returns) as one part: ``models/<network>/<state_dict key>`` and
    ``<opt_gen|opt_dis>/<m|v>/<index>``."""
    tensors = {f"models/{name}/{k}": v.detach()
               for name, m in ts.models.items() for k, v in m.state_dict().items()}
    for key in OPTS:
        opt = getattr(ts, key)
        for part in ("m", "v"):
            tensors.update((f"{key}/{part}/{i}", t.detach())
                           for i, t in enumerate(getattr(opt, part)))
    return StateSlices(tensors, {}, {key: getattr(ts, key).step for key in OPTS},
                       writes=writes)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _replace_json(path: Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def _save_orbax(model_path: Path, sl: StateSlices, iters: int) -> None:
    """Every rank's part of the collective save (the module docstring's
    protocol; JAX train/checkpoint.py:150-190)."""
    primary = _rank() == 0
    final, new = model_path / ORBAX_DIR, model_path / ORBAX_NEW
    if primary and new.exists():
        if not final.exists() and (new / INDEX).is_file():
            # A crash between an earlier swap's rmtree and its rename left the
            # complete .new as the only checkpoint: promote it before reusing
            # the name.
            os.rename(new, final)
        else:
            shutil.rmtree(new)
    fence(f"ckpt_pre_{iters}")
    error = None
    try:
        mine = {k: t for k, t in sl.tensors.items() if k in sl.split or sl.part == 0}
        if sl.writes and mine:
            new.mkdir(parents=True, exist_ok=True)
            name = f"part_m{sl.part}.pt"
            torch.save(mine, new / (name + ".tmp"))
            os.replace(new / (name + ".tmp"), new / name)
    except Exception as e:  # noqa: BLE001 -- every rank must reach the fence
        error = e
    if fence(f"ckpt_written_{iters}", error is not None):
        if error is not None:
            raise error
        raise RuntimeError(f"train state save at iteration {iters}: another rank's write "
                           f"failed; {final} is as it was")
    if primary:
        files = [f"part_m{m}.pt" for m in range(sl.parts)]
        _replace_json(new / INDEX, {
            "format": "discogan_modernized_torch train state, one file a model-axis place",
            "parts": sl.parts, "steps": sl.steps,
            "tensors": {k: {"shape": list(sl.split[k][1] if k in sl.split else t.shape),
                            "dtype": str(t.dtype).removeprefix("torch."),
                            "split": sl.split[k][0] if k in sl.split else None,
                            "files": files if k in sl.split else files[:1]}
                        for k, t in sl.tensors.items()}})
        # The swap's one window, between the rmtree and the rename, leaves the
        # complete .new, which the load and the next save promote.
        if final.exists():
            shutil.rmtree(final)
        os.rename(new, final)
    fence(f"ckpt_post_{iters}")


def save_train_state(model_path, ts, iters: int, meta: dict | None = None,
                     backend: str = "npz") -> None:
    """The networks, both Adam states and the iteration count, written
    under temporary names and moved into place. ``backend`` "npz": ``ts`` is
    a whole state, written by the one process that calls this. "orbax": a
    collective where a process group is up (every rank calls it, with its
    ``StateSlices``, parallel/gspmd.py ``local_train_state``), else one
    process's whole state; rank 0 writes the meta."""
    if backend not in BACKENDS:
        raise ValueError(f"train state backend {backend!r} is not one of {BACKENDS}")
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    if backend == "orbax":
        _save_orbax(model_path, ts if isinstance(ts, StateSlices) else state_slices(ts),
                    iters)
        if _rank() != 0:
            return  # the meta is rank 0's
    else:
        state = {
            "models": {name: _raw_state(m) for name, m in ts.models.items()},
            **{key: {"m": [t.cpu() for t in opt.m], "v": [t.cpu() for t in opt.v],
                     "step": opt.step}
               for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis))},
        }
        tmp = model_path / "train_state.pt.tmp"
        torch.save(state, tmp)
        os.replace(tmp, model_path / "train_state.pt")
    _replace_json(model_path / "train_state_meta.json",
                  {"iters": iters, "backend": backend, **(meta or {})})


def _orbax_dir(model_path) -> Path:
    """The orbax save's directory to read: the final one, or where only a
    complete ``.new`` is left (a crash inside the swap), that one promoted;
    a process that loses the promotion to another reads the winner's."""
    model_path = Path(model_path)
    final, new = model_path / ORBAX_DIR, model_path / ORBAX_NEW
    if not final.exists() and (new / INDEX).is_file():
        try:
            os.rename(new, final)
        except OSError:
            if not final.exists():  # a read-only file system: read it in place
                return new
    return final


def _load_orbax(model_path: Path) -> dict:
    """An orbax save as ``train_state.pt``'s dict: each tensor's parts
    joined on the CPU along its split axis."""
    d = _orbax_dir(model_path)
    if not (d / INDEX).is_file():
        raise FileNotFoundError(f"--resume {model_path}: no complete {ORBAX_DIR}/ there")
    index = json.loads((d / INDEX).read_text())
    entries = index["tensors"]
    parts = {name: torch.load(d / name, map_location="cpu", weights_only=True, mmap=True)
             for name in sorted({f for e in entries.values() for f in e["files"]})}
    state = {"models": {}, **{key: {"m": {}, "v": {}, "step": index["steps"][key]}
                              for key in OPTS}}
    for key, e in entries.items():
        pieces = [parts[f][key] for f in e["files"]]
        t = pieces[0] if e["split"] is None else torch.cat(pieces, e["split"])
        if list(t.shape) != e["shape"] or str(t.dtype).removeprefix("torch.") != e["dtype"]:
            raise ValueError(f"--resume {model_path}: {key} reads {tuple(t.shape)} "
                             f"{t.dtype}; the index says {e['shape']} {e['dtype']}")
        top, group, name = key.split("/", 2)
        (state["models"].setdefault(group, {}) if top == "models"
         else state[top][group])[name] = t
    for key in OPTS:
        for part in ("m", "v"):
            moments = state[key][part]
            state[key][part] = [moments[str(i)] for i in range(len(moments))]
    return state


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
    networks, their running statistics and both Adam states), from the
    backend the meta names, and return the saved iteration count. ``ts`` is
    a fresh state of the same configuration: a state whose slim state,
    architecture or image size differs from ``cfg`` is refused. Other graph
    variants (paired, lean_dis, remat, concat_dis) leave the layout as it
    is: a resume under them is taken, and one line says what changed."""
    model_path = Path(model_path)
    meta_file = model_path / "train_state_meta.json"
    if not meta_file.is_file():
        raise FileNotFoundError(
            f"--resume {model_path}: no train state there "
            "(train_state_meta.json and train_state.pt or train_state_orbax/)")
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
    if meta.get("backend", "npz") == "orbax":
        state = _load_orbax(model_path)
    else:
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
