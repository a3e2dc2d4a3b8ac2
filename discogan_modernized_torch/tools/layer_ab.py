"""One layer op of the train step, the port's kernel against one PyTorch
call, timed in turns on the card (the port of the JAX package's
``tools/layer_ab.py``).

The op is one row of ``step_itemize``'s layer table (``--layer``, a
substring of its name: "enc1", "dec3", "dis2"), in the modes fwd, dx and
dw. The JAX tool's A/B axis, ``--copts`` (sets of XLA compiler options),
has no meaning under CUDA; its place is taken by ``--impls``: "kernel",
the op as the port's train forward runs it (K3, or K5f where the route
takes it, and their backwards K4/K5b; cuDNN's dx; K6 for the head and the
stem's dx), and "library", the one PyTorch call for the same function
(``F.conv2d``, ``F.conv_transpose2d`` and their autograd backwards). The
latent products and the decoder's convTs have no kernel of the port, so
both impls time the same calls there. The impls take turns round by
round in one process; each time is the best over the rounds of a median
of CUDA-event timed calls, each after a device sleep long enough for the
host to issue the op's launches (tools/timing.py).

    python -m discogan_modernized_torch.tools.layer_ab --size 512 --batch 32 \\
        --layer enc1 --modes fwd,dx,dw --impls kernel,library [--rounds 3]

Prints one JSON line per (layer, mode): us per impl, and each over the
first impl's.
"""

from __future__ import annotations

import argparse
import json

import torch

from .step_itemize import _dis_layers, _gen_layers, layer_modes

IMPLS = ("kernel", "library")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--layer", type=str, required=True,
                    help="substring of the step_itemize layer name, e.g. 'enc1' or "
                         "'dec3' or 'dis2'")
    ap.add_argument("--modes", type=str, default="fwd,dx,dw")
    ap.add_argument("--impls", type=str, default="kernel,library")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    from ..core.precision import BF16, configure
    from .timing import LAYER_SLEEP_CYCLES, Timer, require_card, smi_line

    impls = [s.strip() for s in args.impls.split(",") if s.strip()]
    if not impls or set(impls) - set(IMPLS):
        raise SystemExit(f"--impls takes {', '.join(IMPLS)}, got {args.impls!r}")
    modes = args.modes.split(",")
    if set(modes) - {"fwd", "dx", "dw"}:
        raise SystemExit(f"unknown mode in {args.modes!r}")
    rows = [r for r in _gen_layers(args.size) + _dis_layers(args.size) if args.layer in r[0]]
    if not rows:
        raise SystemExit(f"no layer matches {args.layer!r}")
    device = require_card("layer_ab")
    configure(BF16)
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    timer = Timer(sleep_cycles=LAYER_SLEEP_CYCLES)
    out = []
    for name, kind, size, cin, cout, _epi in rows:
        calls = {impl: layer_modes(kind, size, cin, cout, args.batch, BF16.compute_dtype,
                                   device, impl) for impl in impls}
        for mode in modes:
            best = dict.fromkeys(impls, float("inf"))
            for _ in range(args.rounds):
                for impl in impls:  # in turns
                    best[impl] = min(best[impl], timer.ms(calls[impl][mode]) * 1e3)
            base = best[impls[0]]
            row = {"layer": name, "mode": mode, "us": {k: round(t, 1) for k, t in best.items()},
                   "vs_base": {k: round(t / base, 3) for k, t in best.items()}}
            out.append(row)
            print(json.dumps(row), flush=True)
        del calls
    return out


if __name__ == "__main__":
    main()
