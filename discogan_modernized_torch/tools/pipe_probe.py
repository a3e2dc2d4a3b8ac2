"""The read probe P on the card (the port of ``benchmarks/pipe_probe.py``):
do rows of 64 bf16 channels (128 bytes) stream at the full memory rate?

On the TPU the probe asked it of the Pallas block pipeline at the head
kernel's input, (32, 256, 256, 64) bf16 (268,435,456 bytes), read in full-
row blocks of six geometries (``CASES``: 128-byte rows, 256-byte rows, or
flat bands of W*C; 32 or 128 rows a block). Here each case runs the port's
kernel (ops/pipe_probe.py, csrc/pipe_probe.cu) on one seeded tensor:
``block_max`` is held equal to its plain version and ``probe_value`` to
its last block, then timed beside ``x.clone()`` (a read and a write),
``torch.amax(x)`` (the library's read of the same bytes) and the bound,
the bytes over 3.35 TB/s (80.1 us). Times are medians of CUDA-event timed
calls, L2 evicted before each (tools/timing.py); GB/s are the tensor's
bytes over the time.

    python -m discogan_modernized_torch.tools.pipe_probe [--out FILE]

Prints the card's name and power limit, a line a case, and one JSON line
``{case: {"us", "GB_s", ...}}`` with the JAX file's keys (written to
``--out`` too where given).
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

N, H, W, CI = 32, 256, 256, 64
CASES = {
    # (logical shape for the reader, block)
    "4d_th32_lane64": ((N, H, W, CI), (1, 32, W, CI)),
    "4d_th128_lane64": ((N, H, W, CI), (1, 128, W, CI)),
    "4d_th32_lane128": ((N, H, W // 2, 2 * CI), (1, 32, W // 2, 2 * CI)),
    "4d_th128_lane128": ((N, H, W // 2, 2 * CI), (1, 128, W // 2, 2 * CI)),
    "3d_th32_flat": ((N, H, W * CI), (1, 32, W * CI)),
    "3d_th128_flat": ((N, H, W * CI), (1, 128, W * CI)),
}


def seeded_input(device, seed: int = 1) -> torch.Tensor:
    """The probe's tensor: N(0, 1) * 0.05 in bf16, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(N * H * W * CI, generator=g, device=device) * 0.05).bfloat16()


def check(x: torch.Tensor, shape, block) -> float:
    """Hold the kernel's block maxima equal to the plain version's and the
    probe's value to the last of them; returns max |difference| (0)."""
    from ..ops.pipe_probe import block_max, block_max_plain, probe_value

    got, want = block_max(x, shape, block), block_max_plain(x, shape, block)
    if not torch.equal(got, want):
        raise AssertionError(f"pipe probe {shape} in {block}: block maxima differ from the "
                             f"plain version's by {float((got - want).abs().max())}")
    if not torch.equal(probe_value(x, shape, block), want[-1]):
        raise AssertionError(f"pipe probe {shape} in {block}: the value is not the last "
                             "block's max")
    return float((got - want).abs().max())


def run(timer, x: torch.Tensor) -> dict:
    """Each case checked and timed; {case: {...}} in us and GB/s."""
    from ..ops.pipe_probe import block_max, block_max_plain
    from .timing import bound_ms

    nbytes = x.numel() * x.element_size()
    gb = nbytes / 1e9
    flat = x.view(N, H, W, CI)
    clone_us = timer.ms(lambda: x.clone()) * 1e3
    amax_us = timer.ms(lambda: torch.amax(flat)) * 1e3
    out = {}
    for name, (shape, block) in CASES.items():
        err = check(x, shape, block)
        us = timer.ms(lambda: block_max(x, shape, block)) * 1e3
        plain_us = timer.ms(lambda: block_max_plain(x, shape, block)) * 1e3
        nblocks = math.prod(shape) // math.prod(block)
        # one f32 max an element; x read once, a float written a block
        bound, by = bound_ms(x.numel(), nbytes + 4 * nblocks, torch.float32)
        out[name] = {"us": us, "GB_s": gb / (us * 1e-6), "plain_us": plain_us,
                     "clone_us": clone_us, "clone_GB_s": gb / (clone_us * 1e-6),
                     "amax_us": amax_us, "amax_GB_s": gb / (amax_us * 1e-6),
                     "bound_us": bound * 1e3, "bound_by": by, "max_abs_err": err}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from .timing import Timer, require_card, smi_line

    device = require_card("pipe_probe")
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    x = seeded_input(device)
    out = run(Timer(), x)
    for name, r in out.items():
        print(f"{name:18s} {r['us']:8.1f} us {r['GB_s']:7.1f} GB/s   plain {r['plain_us']:8.1f} "
              f"us   x.clone() {r['clone_us']:8.1f} us ({r['clone_GB_s']:.1f} GB/s)   amax "
              f"{r['amax_us']:8.1f} us ({r['amax_GB_s']:.1f} GB/s)   bound {r['bound_us']:.1f} "
              "us", flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
