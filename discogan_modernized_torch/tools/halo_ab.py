"""Where K5f's f32 time goes on the card: interleaved A/B of its CUDA-core
kernel (``halo_fma_kernel``, csrc/halo_conv_k4s2p1.cu) against variants of
its own source and plan, beside K3's f32 kernel (``conv_fma_kernel``, the
generic conv's route) and one PyTorch call for the same function, in f32
(TF32 off) at enc1 of the 512px model (x (N,256,256,64) -> y
(N,128,128,128)).

Variants, each a text patch of the source built alone into its own library
and called with its own plan (the outputs of those that drop work are
wrong; only their times count):
  kernel        the kernel as the wrapper launches it (held against the
                plain version first, 1e-4 of max|ref|): 4 x 32 blocks
  2 x 64        blocks of 2 output rows of 64 columns
  1 x 128       blocks of one 128-pixel output row
  3 stages      a ring of 3 stages (copies 2 chunks ahead)
  no copies     no copies after the ring's first fill: the FMAs, the
                shared-memory reads, the barriers and the epilogue
  x reads kw&1  taps kw = 2, 3 read the x addresses of kw = 0, 1 (loads
                the compiler may share)
  no w reads    every tap and chunk reads the same weights, which the
                compiler keeps in registers: the FMAs without w's
                shared-memory reads
References: ``conv2d_k4s2p1`` (K3's conv_fma_kernel at the same shape) and
``F.conv2d``. Times are tools/timing.py's (median of 20 runs, L2 evicted, a
device sleep before each), in turns (a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.halo_ab [--batch 8 4 1] [--rounds 2]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "halo_ab"
ENC1 = (256, 256, 64, 128)  # h, w, ci, co of enc1 at 512px

_STAGES = ("constexpr int STAGES = 4;     // the ring",
           "constexpr int STAGES = 3;     // the ring")
# name -> (text patches, block columns, ring stages): an empty patch list
# shares the kernel's library
VARIANTS = {
    "kernel": ([], None, None),
    "2 x 64": ([], 64, None),
    "1 x 128": ([], 128, None),
    "3 stages": ([_STAGES], None, 3),
    "no copies": ([("    stage(q + STAGES - 1, q + STAGES - 1 < nchunks);\n",
                    "    stage(q + STAGES - 1, false);\n")], None, None),
    "x reads kw&1": ([("a[i] = *reinterpret_cast<const float4*>(xs + 4 * (kh * XC + kw) + 32 * i);",
                       "a[i] = *reinterpret_cast<const float4*>(xs + 4 * (kh * XC + (kw & 1)) "
                       "+ 32 * i);")], None, None),
    "no w reads": ([("const float4 v = *reinterpret_cast<const float4*>(wr + 32 * jj);",
                     "const float4 v = *reinterpret_cast<const float4*>(ws + 32 * jj + 4 * kk);")],
                   None, None),
}


def start_variants(names=None) -> dict:
    """Start the build of each variant with patches (of ``names``, default
    all: tools/variants.py); ``run`` times them with the others."""
    from . import variants

    return variants.start({name: ("halo_conv_k4s2p1.cu", patches)
                           for name, (patches, _, _) in VARIANTS.items()
                           if patches and (names is None or name in names)}, OUT)


def _k5f_call(fn, name, x, wt, y):
    """(plan, call) of one variant's C entry on (x, wt) into y with its own
    plan (``halo_fma_plan``'s, at the variant's block columns and ring),
    passing the arguments as ops/halo_conv.py's wrapper does (one problem
    on the pair axis, no epilogue)."""
    from ..ops import _build
    from ..ops.halo_conv import HALO_FMA_PIXELS, HALO_PATH_CODES, halo_fma_plan

    n, h, w, ci = x.shape
    co = wt.shape[3]
    _, cols, stages = VARIANTS[name]
    plan = halo_fma_plan(n, h, w, ci, co)
    if cols is not None:
        rows = HALO_FMA_PIXELS // cols
        plan = plan._replace(rows=rows, cols=cols, grid=(
            plan.grid[0], -(-(h // 2) // rows) * -(-(w // 2) // cols), n))
    if stages is not None:
        plan = plan._replace(stages=stages)
    plan = plan._replace(smem_bytes=plan.stages * (4 * plan.x_units + 16 * plan.ci_chunk
                                                   * plan.co_tile) * 4)

    def call():
        err = fn(x.data_ptr(), wt.data_ptr(), None, None, y.data_ptr(), n, h, w, ci, co, 0,
                 _build.DTYPE_CODES[x.dtype], HALO_PATH_CODES["fma"], plan.rows, plan.cols,
                 plan.stages, plan.grid[0], plan.grid[1], plan.smem_bytes, 1, x.numel(), 0, 0,
                 _build.stream_of(x))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return plan, call


def run(batches, rounds, started=None) -> int:
    """The A/B at each batch; ``started``: ``start_variants()``'s builds
    (started here where None)."""
    import torch
    import torch.nn.functional as F

    from ..ops import _build
    from ..ops.conv_k4s2p1 import conv2d_k4s2p1
    from ..ops.halo_conv import halo_conv2d_k4s2p1_plain
    from . import variants
    from .timing import Timer, bound_ms, smi_line

    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    built = variants.load(started or start_variants(), "discogan_halo_conv_k4s2p1")
    kernel_fn = _build.library().discogan_halo_conv_k4s2p1
    fns = {name: built.get(name, kernel_fn) for name in VARIANTS}
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    h, w, ci, co = ENC1
    for n in batches:
        x = torch.randn(n, h, w, ci, device="cuda", generator=g)
        wt = torch.randn(4, 4, ci, co, device="cuda", generator=g) * (16 * ci) ** -0.5
        y = torch.empty(n, h // 2, w // 2, co, device="cuda")
        calls = {}
        for name in VARIANTS:
            plan, calls[name] = _k5f_call(fns[name], name, x, wt, y)
            if name == "kernel":
                kplan = plan
                calls[name]()
                want = halo_conv2d_k4s2p1_plain(x, wt)
                err = (y - want).abs().max().item()
                if not err <= 1e-4 * max(1.0, want.abs().max().item()):
                    raise AssertionError(f"b{n}: the kernel is off the plain version by {err}")
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        calls["K3 fma"] = lambda: conv2d_k4s2p1(x, wt)
        calls["library"] = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timer.ms(calls[name]))
        bound, _ = bound_ms(2 * n * (h // 2) * (w // 2) * 16 * ci * co,
                            (x.numel() + wt.numel() + y.numel()) * 4, torch.float32)
        print(f"enc1 b{n} f32 (plan {kplan.rows} x {kplan.cols}, {kplan.stages} stages, grid "
              f"{kplan.grid}; the kernel's max error {err:.3e}; bound {bound:.4f} ms), ms per "
              f"call in {rounds} rounds:", flush=True)
        for name, ts in times.items():
            print(f"  {name:10} " + " ".join(f"{t:.4f}" for t in ts)
                  + f"  ({bound / min(ts):.3f} of the bound)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 4, 1])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("halo_ab: CUDA is not available", file=sys.stderr)
        return 2
    from ..core.precision import F32, configure

    configure(F32)  # TF32 off for the library's convolution
    return run(args.batch, args.rounds)


if __name__ == "__main__":
    sys.exit(main())
