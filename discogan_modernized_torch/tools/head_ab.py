"""Where K6's time goes on the card: interleaved A/B of the tensor-core
head (``head_convt_mma_kernel``, csrc/head_convt.cu) against variants of
its own source that drop one part of its work, beside one PyTorch call for
the same function and plain memory passes over the same tensors, in bf16 at
the 512px head (x (N,256,256,64) -> y (N,512,512,3)).

Variants, each a text patch of the source built alone into its own library
(their outputs are wrong, except the kernel's; only their times count):
  kernel        the kernel as the wrapper launches it (held against the
                plain version first, 2e-2 of max|ref|)
  copies only   no wgmma, no epilogue lines, no stores: the row copies alone
  no copies     no row copies after the ring's first fill: the wgmmas, B's
                build and the epilogue
  no stores     the epilogue's global stores dropped
  aligned       every window read from the warpgroup's first staged pixel
                (no one-pixel shifts of the wgmma operand)
  3 windows     three of the nine windows' wgmmas, no row copies
References: ``F.conv_transpose2d``; ``x.clone()`` (reads and writes x);
``torch.amax(x)`` (reads x); ``y.fill_`` (writes y). Times are chip_smoke's
(median of 20 runs, L2 evicted, a device sleep before each), in turns
(a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.head_ab [--batch 8 4 1] [--rounds 3]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "head_ab"
HEAD = (256, 256, 64, 3)  # h, w, ci, co of the head at 512px

_NO_MMA = ("wgmma_m64nNk16_kk(acc[step & 1], k_desc(a_addr), k_desc(b_addr), step >= 2);",
           "(void)a_addr; (void)b_addr;")
_LINE = "*reinterpret_cast<uint32_t*>(lines + (2 * g + a) * line_elems(co) + off) ="
_NO_LINES = (_LINE, "if (off < 0) " + _LINE)
_STORE = "*reinterpret_cast<uint4*>(dst + k * 8) = *reinterpret_cast<const uint4*>(line + k * 8);"
_NO_STORES = (_STORE, "if (lead < 0) " + _STORE)
_NO_COPIES = ("stage(t + SLOTS, t + SLOTS <= nrows + 1);", "stage(t + SLOTS, false);")
VARIANTS = {
    "kernel": [],
    "copies only": [_NO_MMA, _NO_LINES, _NO_STORES],
    "no copies": [_NO_COPIES],
    "no stores": [_NO_STORES],
    "aligned": [("+ (win % 3) * 128 + (ks & 3) * 32;", "+ (ks & 3) * 32;")],
    "3 windows": [_NO_COPIES, ("for (int win = 0; win < 9; ++win)",
                               "for (int win = 0; win < 3; ++win)")],
}


def start_variants(names=None) -> dict:
    """Start the build of each variant (of ``names``, default all:
    tools/variants.py); ``run`` times the variants built."""
    from . import variants

    return variants.start({name: ("head_convt.cu", patches)
                           for name, patches in VARIANTS.items()
                           if names is None or name in names}, OUT)


def _k6_call(fn, x, wt, y, plan):
    """One variant's C entry on (x, wt) into y with ``plan``
    (ops/head.py's ``head_plan``), its arguments as ops/head.py's wrapper
    passes them (one problem on the pair axis); returns y."""
    from ..ops import _build

    n, h, w, ci = x.shape
    err = fn(x.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, w, ci, wt.shape[3],
             _build.DTYPE_CODES[x.dtype], *plan[:4], plan.smem_bytes, 1, x.numel(), 0,
             _build.stream_of(x))
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")
    return y


def run(batches, rounds, started=None) -> int:
    """The A/B at each batch; ``started``: ``start_variants()``'s builds
    (started here where None)."""
    import torch
    import torch.nn.functional as F

    from ..ops.head import head_convt_plain, head_plan
    from . import variants
    from .timing import HBM_BYTES_PER_S, Timer, smi_line

    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    fns = variants.load(started or start_variants(), "discogan_head_convt")
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    for n in batches:
        h, w, ci, co = HEAD
        x = torch.randn(n, h, w, ci, device="cuda", generator=g).bfloat16()
        wt = (torch.randn(4, 4, ci, co, device="cuda", generator=g) * (16 * co) ** -0.5).bfloat16()
        y = torch.empty(n, 2 * h, 2 * w, co, dtype=x.dtype, device="cuda")
        plan = head_plan(n, h, w, ci, co, x.dtype, torch.cuda.get_device_properties(0)
                         .multi_processor_count)

        def variant(fn):
            return _k6_call(fn, x, wt, y, plan)

        variant(fns["kernel"])
        want = head_convt_plain(x, wt)
        err = (y.float() - want.float()).abs().max().item()
        if not err <= 2e-2 * max(1.0, want.float().abs().max().item()):
            raise AssertionError(f"batch {n}: the kernel is off the plain version by {err}")
        x_nchw, w_iohw = x.permute(0, 3, 1, 2), wt.permute(2, 3, 0, 1).contiguous()
        calls = {name: (lambda fn=fn: variant(fn)) for name, fn in fns.items()}
        calls.update({
            "conv_transpose2d": lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2, padding=1),
            "x.clone()": lambda: x.clone(), "amax(x)": lambda: torch.amax(x),
            "y.fill_": lambda: y.fill_(1.0)})
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timer.ms(calls[name]))
        bound = (x.numel() + y.numel()) * 2 / HBM_BYTES_PER_S * 1e3
        print(f"batch {n} (plan {tuple(plan)}; bytes bound {bound:.4f} ms; the kernel's max "
              f"error {err:.3e}), ms per call in {rounds} rounds:", flush=True)
        for name, ts in times.items():
            print(f"  {name:18} " + " ".join(f"{t:.4f}" for t in ts), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 4, 1])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("head_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(args.batch, args.rounds)


if __name__ == "__main__":
    sys.exit(main())
