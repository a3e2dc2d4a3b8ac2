"""Ranks of a gloo process group for tests/test_torch_dp.py: ``run`` starts
``world`` processes (torch.multiprocessing, spawn), each of one torch
thread, joins them in a group, calls one of this module's functions with
(rank, world, payload) and hands back each rank's result. Payloads and
results travel as pickles of numpy arrays in a directory, so no tensor
crosses a process boundary. The port only: the JAX side stays in the
test's process.
"""

import functools
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
        with open(os.path.join(tmp_path, f"result{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
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
