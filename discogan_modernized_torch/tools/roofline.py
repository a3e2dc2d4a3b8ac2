"""A roofline window for each of the port's train step programs (the port
of the JAX package's ``tools/roofline.py``).

For the G step, the D step and the lean D step at one configuration:

  flops        the analytic count of every conv and convT of the step:
               step_itemize's per-layer count times the step's
               multiplicities (a dx and a dw take a forward's flops);
  io_bytes_lo  a lower bound on the bytes: each of those ops reads its
               operands once and writes its result once, plus Adam's
               update of the trainable subset (the master parameter and
               both moments read and written, the gradient read) under
               the slim mode's storage types;
  roofline_lo  max(flops / 989 TFLOP/s, io_bytes_lo / 3.35 TB/s);
  measured_ms  with ``--measure``: ms an iteration of that step alone on
               the chunked path (train/chunk.py: CUDA graphs replayed from
               the dataset on the card), whose device is busy all but
               1-3% of a chunk;
  light_speed  roofline_lo_ms / measured_ms.

The JAX tool read XLA's flops and "bytes accessed" of the compiled program
and parsed its optimized HLO for the operand I/O; the port runs eagerly
and has no compiled program to read, so that parsing has no counterpart
here and neither has its upper bound (``roofline_hi``). Nor can
``torch.utils.flop_counter`` count the port's kernels (ctypes calls and
``discogan::`` ops), so the count is analytic; the BatchNorm, activation
and loss passes are left out of both counts (a few flops a byte). The
steps run without remat (the JAX tool's ``--remat``): the multiplicities
count no forward recomputed in a backward.

    python -m discogan_modernized_torch.tools.roofline \\
        [--image_size 64] [--batch 64] [--lean] [--slim mv] [--measure]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .step_itemize import (MULTIPLICITIES, _dis_layers, _gen_layers, layer_flops,
                           layer_io_bytes)
from .timing import HBM_BYTES_PER_S, PEAK_FLOPS

PROGRAMS = {"gen_step": "gen", "dis_step": "dis", "dis_step_lean": "lean"}


def _multiplicities(kind: str) -> dict:
    """The step's MULTIPLICITIES; the full D step runs the generators'
    ABA/BAB forwards too (4, where the lean one runs 2)."""
    if kind == "lean":
        return MULTIPLICITIES["dis"]
    if kind == "dis":
        return dict(MULTIPLICITIES["dis"], gen=(4, 0, 0, None))
    return MULTIPLICITIES["gen"]


def adam_bytes(image_size: int, which: str, slim: str) -> int:
    """Bytes of one Adam update of the ``which`` subset (the two
    generators or the two discriminators): each parameter read and
    written, its gradient read, both moments read and written."""
    from ..train.step import _param_counts

    gen_p, dis_p = _param_counts(image_size)
    n = 2 * (gen_p if which == "gen" else dis_p)
    p_bytes = 2 if slim == "all" else 4
    m_bytes = 4 if slim == "off" else 2
    return n * (3 * p_bytes + 4 * m_bytes)


def step_counts(image_size: int, batch: int, itemsize: int, slim: str, kind: str) -> dict:
    """flops and io_bytes_lo of one step of ``kind`` ("gen", "dis", "lean")."""
    flops = io = 0
    for rows, net in ((_gen_layers(image_size), "gen"), (_dis_layers(image_size), "dis")):
        fwd_n, dx_n, dw_n, first_dx_n = _multiplicities(kind)[net]
        for i, (_, op, size, cin, cout, _epi) in enumerate(rows):
            dxn = first_dx_n if i == 0 and first_dx_n is not None else dx_n
            f = layer_flops(op, size, cin, cout, batch)
            b = layer_io_bytes(op, size, cin, cout, batch, itemsize)
            flops += (fwd_n + dxn + dw_n) * f
            io += fwd_n * b["fwd"] + dxn * b["dx"] + dw_n * b["dw"]
    io += adam_bytes(image_size, "gen" if kind == "gen" else "dis", slim)
    return {"flops": flops, "io_bytes_lo": io}


def report(counts: dict, peak: float, bw: float, measured_ms: float | None = None) -> dict:
    t_flops = counts["flops"] / peak * 1e3
    t_bytes = counts["io_bytes_lo"] / bw * 1e3
    t_lo = max(t_flops, t_bytes)
    rep = dict(counts, t_flops_ms=t_flops, roofline_lo_ms=t_lo,
               bound="operations" if t_flops >= t_bytes else "bytes",
               intensity=counts["flops"] / max(counts["io_bytes_lo"], 1))
    if measured_ms is not None:
        rep["measured_ms"] = measured_ms
        rep["light_speed"] = t_lo / measured_ms
    return rep


def measure_ms(cfg, kind: str, batch: int, steps: int, device, calls: int = 4) -> float:
    """ms an iteration of ``kind`` alone on the chunked path: a
    ChunkProgram whose every iteration is that kind (update_interval set
    so), its graphs captured on the first call, then ``calls`` chunks of
    ``steps`` iterations between two CUDA events."""
    from ..core.precision import default_policy
    from ..train.chunk import ChunkProgram
    from ..train.step import init_train_state

    big = 1 << 30
    if kind == "gen":  # iterations 1..steps of an interval beyond them
        cfg, it0 = dataclasses.replace(cfg, update_interval=steps + 1, lean_dis=False), 1
    else:  # every iteration a D one; unlogged under lean_dis
        cfg, it0 = dataclasses.replace(cfg, update_interval=1, lean_dis=kind == "lean",
                                       log_interval=big), 1
    policy = default_policy(cfg.precision, device)
    ts = init_train_state(0, cfg, device)
    rng = np.random.RandomState(0)
    pool = 4 * batch
    g = torch.Generator(device=device).manual_seed(0)
    data = [torch.rand(pool, cfg.image_size, cfg.image_size, 3, generator=g, device=device)
            for _ in range(2)]
    program = ChunkProgram(ts, cfg, policy, *data, batch, steps, {kind}, graphs=True)

    def chunk():
        idx = rng.randint(0, pool, size=(2, steps, batch))
        program(idx[0], idx[1], it0)

    chunk()  # eager, then the capture
    chunk()
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        chunk()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * steps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lean", action="store_true", help="also report the lean D-step program")
    p.add_argument("--slim", default="mv", choices=["off", "mv", "all"])
    p.add_argument("--measure", action="store_true",
                   help="time each program on the card, on the chunked path")
    p.add_argument("--steps_per_call", type=int, default=6,
                   help="iterations a chunk when measuring")
    p.add_argument("--peak_tflops", type=float, default=PEAK_FLOPS[torch.bfloat16] / 1e12)
    p.add_argument("--hbm_gbs", type=float, default=HBM_BYTES_PER_S / 1e9)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from ..core.precision import BF16, configure
    from ..train.step import TrainConfig
    from .timing import require_card, smi_line

    device = None
    if args.measure:
        device = require_card("roofline --measure")
        configure(BF16)
        print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    cfg = TrainConfig(image_size=args.image_size, precision="bf16", slim_state=args.slim,
                      remat=False)
    peak, bw = args.peak_tflops * 1e12, args.hbm_gbs * 1e9
    out = {"config": {"image_size": args.image_size, "batch": args.batch, "lean": args.lean,
                      "slim": args.slim, "remat": "off"},
           "peak_tflops": args.peak_tflops, "hbm_gbs": args.hbm_gbs, "programs": {}}
    if device is not None:
        out["card"] = smi_line()
    for name, kind in PROGRAMS.items():
        if kind == "lean" and not args.lean:
            continue
        counts = step_counts(args.image_size, args.batch, BF16.compute_dtype.itemsize,
                             args.slim, kind)
        measured = (measure_ms(cfg, kind, args.batch, args.steps_per_call, device)
                    if args.measure else None)
        rep = report(counts, peak, bw, measured)
        out["programs"][name] = rep
        if not args.json:
            meas = (f"  measured {rep['measured_ms']:.3f} ms  light-speed "
                    f"{rep['light_speed']:.1%}" if measured is not None else "")
            print(f"{name:16s} flops {rep['flops'] / 1e9:8.1f} GF  io_lo "
                  f"{rep['io_bytes_lo'] / 1e9:.2f} GB  t_flops {rep['t_flops_ms']:.3f} ms  "
                  f"roofline_lo {rep['roofline_lo_ms']:.3f} ms{meas}", flush=True)
        if device is not None:
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
