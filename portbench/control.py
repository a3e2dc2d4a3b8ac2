"""The readings that a cell's limits are set from, on the card at the cell's
own sizes (not run by the benchmark's runs):

- ``program``: the program's checked steps against the reference, one seed
  after another in one process (the state and the dataset drawn anew in
  place from each seed, the captured graphs replayed);
- ``control``: the reference in the cell's ``control`` precision (float8
  operands for a bf16 cell) in the program's place, against the float32
  reference;
- ``fault_half``: the reference with half of each batch left out;
- ``witness_bf16`` (``--witness``): the reference with bf16 operands,
  outputs and gradients, beside each program seed.

    python3 portbench/control.py --workload <cell> --program-seeds 1 2 ... \\
        --control-seeds 7 8 9 [--images 128] [--witness] [--out chiprun_out/control.jsonl]

A state left unchanged reads 1 on ``change_gap`` and ``grad_gap`` by
their definition, and needs no run. ``--images`` sets the images a domain
(the batches of the three checked iterations are drawn from them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import check, harness  # noqa: E402
from portbench.reference import discogan as ref_mod  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--images", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--witness", action="store_true",
                   help="also read the reference in bf16 beside each program seed")
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload, ROOT)
    return calibrate(spec, args)


def calibrate(spec: dict, args) -> int:
    import torch

    device = torch.device(args.device)
    drv = harness.driver(spec)
    images = args.images or 4 * spec["traffic"]["batch"]
    out = open(args.out, "a") if args.out else None
    rows = []

    names = {which: [f"{net}.{leaf[0]}" for net in nets
                     for leaf in ref_mod.leaf_specs(spec["config"]["image_size"])[net]]
             for which, nets in (("dis", ("dis_A", "dis_B")), ("gen", ("gen_A", "gen_B")))}

    def emit(kind, seed, got, base, seconds):
        per = check.leaf_gaps(got, base)
        worst = {k: sorted(((g, names[w][i]) for w, gs in v.items()
                            for i, g in enumerate(gs) if g is not None), reverse=True)[:4]
                 for k, v in per.items()}
        row = {"workload": spec["name"], "kind": kind, "seed": seed,
               "numbers": check.gaps(got, base), "worst_leaves": worst,
               "readings": got, "reference": base,
               "seconds": seconds, "card": (torch.cuda.get_device_name(device)
                                            if device.type == "cuda" else "cpu")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    readings = {}
    if args.program_seeds:
        bench = drv.Bench(spec, args.program_seeds[0], device, images)
        for i, seed in enumerate(args.program_seeds):
            if i:
                bench.reseed(seed)
            readings[seed] = (bench.checked_steps(), [tuple(t.cpu() for t in b)
                                                      for b in bench.batches()])
        bench.free()
    for seed, (prog, batches) in readings.items():
        t = time.perf_counter()
        batches = [tuple(x.to(device) for x in b) for b in batches]
        ref = drv.reference_readings(spec, seed, batches, device)
        emit("program", seed, prog, ref, time.perf_counter() - t)
        if args.witness:
            other = drv.reference_readings(spec, seed, batches, device, precision="bf16")
            emit("witness_bf16", seed, other, ref, time.perf_counter() - t)
    for seed in args.control_seeds:
        size, batch = spec["config"]["image_size"], spec["traffic"]["batch"]
        data = [torch.empty((images, size, size, 3), device=device) for _ in range(2)]
        drv.fill_data(data, seed, device)  # the dataset alone, no program
        batches = drv.gather_batches(data, drv.Feed(seed, images, images, batch), device)
        del data
        t = time.perf_counter()
        ref = drv.reference_readings(spec, seed, batches, device)
        for kind, kw in (("control", {"precision": spec["cell"]["control"]}),
                         ("fault_half", {"half": True})):
            other = drv.reference_readings(spec, seed, batches, device, **kw)
            emit(kind, seed, other, ref, time.perf_counter() - t)
        del batches
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for kind in ("program", "witness_bf16", "control", "fault_half"):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            print(json.dumps({"summary": kind, "n": len(got),
                              "max": {k: max(g[k] for g in got) for k in got[0]},
                              "min": {k: min(g[k] for g in got) for k in got[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
