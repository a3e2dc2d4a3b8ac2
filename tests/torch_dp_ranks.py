"""Ranks of a gloo process group for tests/test_torch_dp.py: ``run`` starts
``world`` processes (torch.multiprocessing, spawn), each of one torch
thread, joins them in a group, calls one of this module's functions with
(rank, world, payload) and hands back each rank's result. Payloads and
results travel as pickles of numpy arrays in a directory, so no tensor
crosses a process boundary. The port only: the JAX side stays in the
test's process.
"""

import functools
import hashlib
import os
import pickle
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from discogan_modernized_torch.cli.common import distributed_parser, parse_with_config
from discogan_modernized_torch.core.distributed import Ranks, any_rank
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.parallel import DataParallel
from discogan_modernized_torch.train import chunk as chunk_module
from discogan_modernized_torch.train import step as step_module
from discogan_modernized_torch.train.chunk import LOSS_KEYS, ChunkProgram
from discogan_modernized_torch.train.loop import run_training
from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                  kinds_in_range, make_lean_dis_step,
                                                  make_train_steps)


def run(fn: str, payload: dict, tmp_path, world: int = 2) -> list:
    """``fn``'s result on each of ``world`` gloo ranks, in rank order."""
    tmp_path = str(tmp_path)
    with open(os.path.join(tmp_path, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_entry, args=(world, port, tmp_path, fn), nprocs=world, join=True)
    out = []
    for rank in range(world):
        path = os.path.join(tmp_path, f"result{rank}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        os.remove(path)
    os.remove(os.path.join(tmp_path, "payload.pkl"))
    return out


def _entry(rank, world, port, tmp_path, fn):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(tmp_path, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = globals()[fn](rank, world, payload)
        with open(os.path.join(tmp_path, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def state_arrays(ts) -> dict:
    """Every tensor of a train state (the networks' state dicts, the Adam
    moments and steps) as numpy, by name."""
    out = {f"{k}.{n}": t.float().numpy() if t.is_floating_point() else t.numpy()
           for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        out[f"{key}.step"] = np.asarray(opt.step)
        out.update({f"{key}.m{i}": t.float().numpy() for i, t in enumerate(opt.m)})
        out.update({f"{key}.v{i}": t.float().numpy() for i, t in enumerate(opt.v)})
    return out


def rank_rows(a: np.ndarray, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of a global batch (the JAX mesh's shard)."""
    n = len(a) // world
    return torch.from_numpy(a[rank * n:(rank + 1) * n])


def steps(rank, world, p) -> dict:
    """One D and one G step (``p["batches"]``, global) from the JAX state
    ``p["jts"]`` under ``p["cfg"]``: the losses of each and the final state."""
    cfg = TrainConfig(**p["cfg"])
    ts = train_state_from_jax(p["jts"], cfg)
    dp = DataParallel(bn_sync=cfg.bn_sync)
    gen_step, dis_step = make_train_steps(cfg, F32, dp)
    log = []
    for it, (A, B) in enumerate(p["batches"]):
        step = dis_step if cfg.is_dis_iter(it) else gen_step
        losses = step(ts, rank_rows(A, rank, world), rank_rows(B, rank, world),
                      cfg.rate_for(it))
        log.append({k: float(v) for k, v in losses.items()})
    return {"log": log, "state": state_arrays(ts)}


def remat_steps(rank, world, p) -> dict:
    """``steps`` under ``p["cfg"]`` (remat on), and under it with remat off."""
    return {"remat": steps(rank, world, p),
            "plain": steps(rank, world, dict(p, cfg=dict(p["cfg"], remat=False)))}


def batch_recorders(calls: list) -> list:
    """(module, name, replacement) for the trainer's two calls of
    ``loss_and_grads`` (the per-step path's and the chunk program's): each
    replacement appends the step's (A, B) to ``calls`` as numpy, then runs
    the step."""
    def wrap(fn):
        @functools.wraps(fn)
        def recorded(ts, A, B, *args, **kwargs):
            calls.append((A.numpy().copy(), B.numpy().copy()))
            return fn(ts, A, B, *args, **kwargs)
        return recorded
    return [(m, "loss_and_grads", wrap(m.loss_and_grads))
            for m in (step_module, chunk_module)]


def cli_batches(rank, world, p) -> list:
    """The distributed trainer on this rank (the ranks of one host), once
    for each flag list of ``p["argvs"]``: the (A, B) of each of its steps,
    a list a run."""
    out = []
    for argv in p["argvs"]:
        calls = []
        patches = batch_recorders(calls)
        for module, name, fn in patches:
            setattr(module, name, fn)
        args = parse_with_config(distributed_parser(), argv)
        run_training(args, ranks=Ranks(rank, world, rank, torch.device("cpu"), "gloo", world))
        for module, name, fn in patches:
            setattr(module, name, fn.__wrapped__)
        out.append(calls)
    return out


def chunks(rank, world, p) -> dict:
    """``p["n"]`` iterations from seed 2 on this rank's shard of a seeded
    dataset, per step and in chunks of ``p["chunks"]`` (the chunk program),
    each under DP: both final states, and the losses of both."""
    cfg = TrainConfig(**p["cfg"])
    rng = np.random.RandomState(1)
    data = [torch.from_numpy(rng.rand(24, 16, 16, 3).astype(np.float32)[rank::world])
            for _ in range(2)]
    ia, ib = (rng.randint(0, 24 // world, size=(p["n"], 4)) for _ in range(2))
    per_step, chunked = init_train_state(2, cfg), init_train_state(2, cfg)
    dp_step, dp_chunk = DataParallel(bn_sync=cfg.bn_sync), DataParallel(bn_sync=cfg.bn_sync)
    gen_step, dis_step = make_train_steps(cfg, F32, dp_step)
    steps_ = {"gen": gen_step, "dis": dis_step,
              "lean": make_lean_dis_step(cfg, F32, dp_step)}
    want = []
    for i in range(p["n"]):
        losses = steps_[cfg.step_kind(i)](per_step, data[0][ia[i]], data[1][ib[i]],
                                          cfg.rate_for(i))
        want.append([float(losses[k]) for k in LOSS_KEYS])
    program = ChunkProgram(chunked, cfg, F32, *data, 4, max(p["chunks"]),
                           kinds_in_range(cfg, 0, p["n"]), dp=dp_chunk)
    got, i = [], 0
    for k in p["chunks"]:
        got += program(ia[i:i + k], ib[i:i + k], i).tolist()
        i += k
    return {"per_step": state_arrays(per_step), "chunked": state_arrays(chunked),
            "want": want, "got": got}


def agree(rank, world, p) -> list:
    """``core.distributed.any_rank`` with the flag set on rank r alone, for
    each r of ``p["set_on"]``, then on no rank."""
    ranks = Ranks(rank, world, rank, torch.device("cpu"), "gloo")
    return [any_rank(rank == r, ranks) for r in p["set_on"]] + [any_rank(False, ranks)]


# -- the (data, model) mesh (tests/test_torch_mesh.py, test_torch_spatial.py) --

def _arrays(ts) -> dict:
    """``state_arrays`` copied (an f32 tensor's array shares its memory)."""
    return {k: np.array(v, copy=True) for k, v in state_arrays(ts).items()}


def digest(arrays: dict) -> dict:
    """Each array's bytes, hashed: two states' digests are equal where their
    arrays are equal bit for bit."""
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def _states(rank, states: dict) -> dict:
    """What a mesh rank hands back of its states (a value None where the
    rank holds none: a gathered state off rank 0): their digests, and on
    rank 0 the arrays too (a 64px state is ~260 MB)."""
    out = {f"{k}_digest": digest(v) for k, v in states.items() if v is not None}
    if rank == 0:
        out.update(states)
    return out


def _gathered(ts, mp):
    """The whole state parallel/gspmd.py ``gather_train_state`` puts on rank
    0, as numpy; None on the other ranks."""
    from discogan_modernized_torch.parallel.gspmd import gather_train_state

    whole = gather_train_state(ts, mp)
    return None if whole is None else _arrays(whole)


def _own(ts, mp) -> dict:
    """This rank's own tensors of a placed state: their digest, shapes and
    place on the model axis (``not_pieces`` reads them)."""
    own = _arrays(ts)
    return {"digest": digest(own), "shapes": {k: v.shape for k, v in own.items()},
            "m": mp.mesh.m}


def not_pieces(own: dict, whole: dict) -> list:
    """The names of ``own``'s (``_own``'s) tensors that are not their rank's
    piece of the whole state ``whole`` (arrays): along the axis where their
    shapes differ, piece m of equal pieces; whole where they agree."""
    piece = {}
    for k, w in whole.items():
        shape = own["shapes"][k]
        dim = next((i for i, (a, b) in enumerate(zip(shape, w.shape)) if a != b), None)
        piece[k] = w if dim is None else np.take(
            w, np.arange(own["m"] * shape[dim], (own["m"] + 1) * shape[dim]), axis=dim)
    got = digest(piece)
    return [k for k in got if got[k] != own["digest"][k]]


def _mesh(world, p):
    from discogan_modernized_torch.core.mesh import make_mesh
    from discogan_modernized_torch.parallel.gspmd import MeshParallel

    tp = p.get("tp", world)
    return MeshParallel(make_mesh(world // tp, tp), spatial=p.get("spatial", False))


def _mesh_state(p, cfg, mp):
    """The state to place: the JAX state ``p["jts"]``, else seed ``p["seed"]``'s."""
    from discogan_modernized_torch.parallel.gspmd import place_train_state

    ts = (train_state_from_jax(p["jts"], cfg) if "jts" in p
          else init_train_state(p.get("seed", 0), cfg))
    return place_train_state(ts, mp, cfg, "cpu")


def _mesh_run(ts, cfg, mp, batches, kinds, counts=None) -> list:
    """The steps of ``kinds`` on this rank's rows of the global ``batches``
    (the data axis's shard); the losses of each, and each step's collectives
    appended to ``counts``."""
    from discogan_modernized_torch.parallel import collectives, reset_collectives
    from discogan_modernized_torch.parallel.gspmd import (make_gspmd_lean_dis_step,
                                                          make_gspmd_train_steps)

    gen_step, dis_step = make_gspmd_train_steps(cfg, mp, F32)
    steps = {"gen": gen_step, "dis": dis_step,
             "lean": make_gspmd_lean_dis_step(cfg, mp, F32)}
    d, n_data = mp.mesh.d, mp.mesh.n_data
    log = []
    for it, ((A, B), kind) in enumerate(zip(batches, kinds)):
        reset_collectives()
        losses = steps[kind](ts, rank_rows(A, d, n_data), rank_rows(B, d, n_data),
                             cfg.rate_for(it))
        log.append({k: float(v) for k, v in losses.items()})
        if counts is not None:
            counts.append(dict(collectives))
    return log


def mesh_steps(rank, world, p) -> dict:
    """``p["kinds"]`` steps on a mesh of ``p["tp"]`` model ranks
    (``p["spatial"]``), from the placed state; with ``p["same_state"]`` each
    step from its own placement of that state. The losses, each step's
    collectives, this rank's own final tensors (``_own``), and on rank 0
    the whole state(s) gathered, as numpy."""
    cfg = TrainConfig(**p["cfg"])
    mp = _mesh(world, p)
    out = {"log": [], "counts": [], "states": [], "own": []}
    runs = ([[b, k] for b, k in zip(p["batches"], p["kinds"])] if p.get("same_state")
            else [[p["batches"], p["kinds"]]])
    for run_ in runs:
        batches, kinds = (([run_[0]], [run_[1]]) if p.get("same_state") else run_)
        ts = _mesh_state(p, cfg, mp)
        out["log"] += _mesh_run(ts, cfg, mp, batches, kinds, out["counts"])
        out["own"].append(_own(ts, mp))
        state = _gathered(ts, mp)
        if rank == 0:
            out["states"].append(state)
    out["digests"] = [own["digest"] for own in out["own"]]
    out["split"] = {k: sorted(v) for k, v in mp.shards.items()}
    return out


def mesh_place_gather(rank, world, p) -> dict:
    """A seeded state placed on the mesh and gathered back (on rank 0), as
    numpy, with the state before placing; the names of this rank's placed
    tensors that are not its pieces of that state."""
    cfg = TrainConfig(**p["cfg"])
    mp = _mesh(world, p)
    whole = _arrays(init_train_state(p["seed"], cfg))
    ts = _mesh_state(p, cfg, mp)
    local = {n: tuple(t.shape) for n, t in ts.models["gen_A"].named_parameters()}
    return {"local": local, "not_pieces": not_pieces(_own(ts, mp), whole),
            **_states(rank, {"whole": whole, "gathered": _gathered(ts, mp)})}


def mesh_chunks(rank, world, p) -> dict:
    """``p["n"]`` iterations on a tensor-parallel mesh from one seeded state,
    per step and through the chunk program in chunks of ``p["chunks"]``, on
    this rank's data row's shard of a seeded dataset: both final states
    (this rank's own tensors; on rank 0 the whole, gathered) and the losses
    of both."""
    cfg = TrainConfig(**p["cfg"])
    mp = _mesh(world, p)
    size, b = cfg.image_size, p["batch"]
    rng = np.random.RandomState(1)
    n_data, d = mp.mesh.n_data, mp.mesh.d
    data = [torch.from_numpy(rng.rand(12, size, size, 3).astype(np.float32)[d::n_data])
            for _ in range(2)]
    ia, ib = (rng.randint(0, 12 // n_data, size=(p["n"], b)) for _ in range(2))
    per_step = _mesh_state(p, cfg, mp)
    gen_step, dis_step = make_train_steps(cfg, F32, mp)
    steps_ = {"gen": gen_step, "dis": dis_step, "lean": make_lean_dis_step(cfg, F32, mp)}
    want = []
    for i in range(p["n"]):
        losses = steps_[cfg.step_kind(i)](per_step, data[0][ia[i]], data[1][ib[i]],
                                          cfg.rate_for(i))
        want.append([float(losses[k]) for k in LOSS_KEYS])
    mp_chunk = _mesh(world, p)
    chunked = _mesh_state(p, cfg, mp_chunk)
    program = ChunkProgram(chunked, cfg, F32, *data, b, max(p["chunks"]),
                           kinds_in_range(cfg, 0, p["n"]), dp=mp_chunk)
    got, i = [], 0
    for k in p["chunks"]:
        got += program(ia[i:i + k], ib[i:i + k], i).tolist()
        i += k
    return {"want": want, "got": got, "own": [_own(t, mp) for t in (per_step, chunked)],
            **_states(rank, {"per_step": _gathered(per_step, mp),
                             "chunked": _gathered(chunked, mp_chunk)})}


def mesh_resume(rank, world, p) -> dict:
    """Saves moved between meshes: on a mesh of ``p["tp_from"]`` model ranks,
    ``p["n"]`` steps from a seeded state, its whole state saved as the
    trainer saves it (gathered onto rank 0, which writes it); then on a
    mesh of ``p["tp_to"]`` model ranks that save loaded into a fresh state
    and placed, gathered at once (``loaded``) and after ``p["n"]`` more
    steps (``resumed``), beside the same ``p["n"]`` steps from the first
    mesh's state placed on the second without the disk (``continued``; rank
    0 sends every rank the gathered state). Every rank's own tensors of the
    resumed and the continued state, too."""
    from discogan_modernized_torch.parallel.gspmd import (gather_train_state,
                                                          place_train_state)
    from discogan_modernized_torch.train.checkpoint import (load_train_state,
                                                            save_train_state,
                                                            train_state_meta)

    cfg = TrainConfig(**p["cfg"])
    first = _mesh(world, dict(p, tp=p["tp_from"]))
    ts = _mesh_state(p, cfg, first)
    _mesh_run(ts, cfg, first, p["batches"], p["kinds"])
    saved = gather_train_state(ts, first)
    if rank == 0:
        save_train_state(p["dir"], saved, p["n"], train_state_meta(cfg))
    sent = [saved if rank == 0 else None]
    dist.broadcast_object_list(sent, src=0)
    saved = sent[0]
    out = {"saved": _arrays(saved) if rank == 0 else None}
    second = _mesh(world, dict(p, tp=p["tp_to"]))
    fresh = init_train_state(99, cfg)
    assert load_train_state(p["dir"], fresh, cfg) == p["n"]
    loaded = place_train_state(fresh, second, cfg, "cpu")
    out["loaded"] = _gathered(loaded, second)
    _mesh_run(loaded, cfg, second, p["batches"], p["kinds"])
    out["resumed"] = _gathered(loaded, second)
    continued = place_train_state(_plain_copy(saved, cfg), second, cfg, "cpu")
    _mesh_run(continued, cfg, second, p["batches"], p["kinds"])
    out["continued"] = _gathered(continued, second)
    return {"own": [_own(t, second) for t in (loaded, continued)], **_states(rank, out)}


def _plain_copy(state, cfg):
    """A one-process TrainState holding ``state``'s tensors (a gathered
    state), as ``load_train_state`` would restore them."""
    ts = init_train_state(99, cfg)
    with torch.no_grad():
        for k, m in ts.models.items():
            m.load_state_dict(state.models[k].state_dict(), strict=True)
        for mine, theirs in ((ts.opt_gen, state.opt_gen), (ts.opt_dis, state.opt_dis)):
            for a, b in zip(mine.m + mine.v, theirs.m + theirs.v):
                a.copy_(b)
            mine.step = theirs.step
    return ts


def mesh_cli(rank, world, p) -> list:
    """The distributed trainer on this rank, once for each flag list of
    ``p["argvs"]`` (run_training with this process's ranks); the printed
    lines of each run."""
    import contextlib
    import io

    out = []
    for argv in p["argvs"]:
        args = parse_with_config(distributed_parser(), argv)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            run_training(args, ranks=Ranks(rank, world, rank, torch.device("cpu"), "gloo",
                                           world))
        out.append(text.getvalue())
    return out
