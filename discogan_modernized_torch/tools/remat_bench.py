"""Remat granularity A/B of the 512px train step on the card (the port of
the JAX package's ``tools/remat_bench.py``).

    python -m discogan_modernized_torch.tools.remat_bench [--size 512]
        [--batch 192] [--policies off,full,latent,conv] [--rounds 3]
        [--steps 3] [--precision bf16|f32]

Each policy (train/graph.py's ``_checkpoint_policies``; "off" keeps every
activation) trains the DiscoGAN step at ``--size`` and ``--batch`` in bf16
(or ``--precision f32``, TF32 off: the trainers' exact-parity mode, e.g.
``--policies off --batch 8`` for the f32 steps at the trainer's batch)
under slim_state=mv, from one seeded state, in blocks of ``--steps``
iterations of D, G, G; the policies take turns, round by round, in one
process, since the host moves a step's time from run to run. It prints
each policy's median D and G step (CUDA events, the first block of each
policy not counted), its peak memory (``torch.cuda.max_memory_allocated``
over its blocks) and the card's name and power limit, and ends in one JSON
line. A policy that runs out of memory is reported as such and takes no
further turns; no time is kept for it. The default batch, 192, is the
largest at which the 512px step ran with remat off on an NVIDIA H100 80GB
HBM3 at 700 W (73.35 GiB; 224 ran out of memory; PERF.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from ..core.device import resolve_device
from ..core.precision import BF16, F32, configure
from .timing import smi_line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--policies", type=str, default="off,full,latent,conv")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3, help="iterations a block (D, G, G, ...)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("remat_bench times the card: --device must be cuda")

    from ..train.step import (TrainConfig, init_train_state, make_optimizers,
                              make_train_steps)

    policy = BF16 if args.precision == "bf16" else F32
    configure(policy)
    base = TrainConfig(image_size=args.size, precision=args.precision, slim_state="mv")
    policies = args.policies.split(",")
    cfgs = {name: (dataclasses.replace(base, remat=False) if name == "off" else
                   dataclasses.replace(base, remat=True, remat_policy=name, remat_dis=True))
            for name in policies}
    print(smi_line())
    ts = init_train_state(0, base, device)
    g = torch.Generator(device=device).manual_seed(0)
    A, B = (torch.rand(args.batch, args.size, args.size, 3, device=device, generator=g)
            for _ in range(2))
    times = {name: {"dis": [], "gen": []} for name in policies}
    peak = dict.fromkeys(policies, 0)
    dead = {}
    for rnd in range(args.rounds):
        for name in policies:
            if name in dead:
                continue
            cfg = cfgs[name]
            ts.opt_gen, ts.opt_dis = make_optimizers(ts.models, cfg)
            gen_step, dis_step = make_train_steps(cfg, policy)
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            try:
                for j in range(args.steps):
                    kind = "dis" if cfg.is_dis_iter(j) else "gen"
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    (dis_step if kind == "dis" else gen_step)(ts, A, B, 0.01)
                    end.record()
                    end.synchronize()
                    if rnd > 0:
                        times[name][kind].append(start.elapsed_time(end))
            except torch.cuda.OutOfMemoryError as e:
                dead[name] = f"out of memory: {str(e).splitlines()[0][:160]}"
                print(f"round {rnd} {name}: {dead[name]}", flush=True)
                ts.opt_gen = ts.opt_dis = None
                torch.cuda.empty_cache()
                continue
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated(device))
            print(f"round {rnd} {name}: peak {peak[name] / 2**30:.2f} GiB", flush=True)
    out = {"size": args.size, "batch": args.batch, "precision": args.precision,
           "card": smi_line(), "policies": {}}
    for name in policies:
        if name in dead:
            out["policies"][name] = {"failed": dead[name]}
            continue
        med = {k: statistics.median(v) for k, v in times[name].items() if v}
        out["policies"][name] = {"dis_ms": med.get("dis"), "gen_ms": med.get("gen"),
                                 "peak_gib": peak[name] / 2**30}
        print(f"{name}: D {med.get('dis', float('nan')):.3f} ms, G "
              f"{med.get('gen', float('nan')):.3f} ms (medians over rounds 1..; CUDA "
              f"events), peak {peak[name] / 2**30:.2f} GiB")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
