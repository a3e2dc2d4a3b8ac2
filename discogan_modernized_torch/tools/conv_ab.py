"""Where K3's time goes on the card: interleaved A/B of the wgmma halving
conv (``conv_wgmma_kernel``, csrc/conv_k4s2p1.cu) against variants of its
own source and plan, beside one PyTorch call for the same function, in bf16
at the 512px layers (enc2..enc6, and the stem enc0); with ``--dtype f32``,
of its f32 kernel on the CUDA cores (``conv_fma_kernel``) at the f32
layers (TF32 off), against F32_VARIANTS.

Variants, each a text patch of the source built alone into its own library,
and each called with its own plan (the outputs of those that drop work are
wrong; only their times count):
  kernel        the kernel as the wrapper launches it (held against the
                plain version first, 2e-2 of max|ref|)
  128x128       the plan without 128 x 256 tiles
  copies only   no wgmmas: the cp.async ring, the barriers and the epilogue
  no copies     no copies after the ring's first fill: the wgmmas, the
                barriers and the epilogue
  no epilogue   the main loop alone
  deeper ring   128 x 128 tiles with 6 stages (copies 4 steps ahead), 64-row
                tiles with 8
  2 blocks/SM   128 x 128 tiles with 3 stages, two blocks an SM (at most
                128 registers a thread)
F32_VARIANTS (``--dtype f32``):
  kernel        conv_fma_kernel as the wrapper launches it (held against
                the plain version first, 1e-4 of max|ref|)
  no copies     no copies after the ring's first fill: the FMAs, the
                shared-memory reads, the barriers and the epilogue
  fenced wait   the wait for the copies with the async-proxy fence the
                wgmma kernels need
  4 stages      a ring of 4 stages (copies 3 steps ahead)
  16-wide steps K steps of 16 where 16-byte copies fill them (not 32)
  2 blocks/SM   every tile at 128 registers a thread, two blocks an SM, the
                split's wave twice as wide
Reference: ``F.conv2d`` (with ``torch.var_mean`` where the call takes the
statistics). Times are tools/timing.py's (median of 20 runs, L2 evicted, a
device sleep before each), in turns (a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.conv_ab [--rounds 2] [--dtype bf16|f32]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "conv_ab"
# (label, (n, h, w, ci, co), with the statistics): the training forward's
# layers at batch 8, and the serving forward's at batch 4 and 1
SHAPES = [("enc2 b8 stats", (8, 128, 128, 128, 256), True),
          ("enc3 b8 stats", (8, 64, 64, 256, 512), True),
          ("enc4 b8 stats", (8, 32, 32, 512, 1024), True),
          ("enc5 b8 stats", (8, 16, 16, 1024, 2048), True),
          ("enc6 b8 stats", (8, 8, 8, 2048, 2048), True),
          ("enc2 b4", (4, 128, 128, 128, 256), False),
          ("enc3 b4", (4, 64, 64, 256, 512), False),
          ("enc2 b1", (1, 128, 128, 128, 256), False),
          ("enc6 b1", (1, 8, 8, 2048, 2048), False),
          ("enc0 b8", (8, 512, 512, 3, 64), False)]

# (label, (n, h, w, ci, co), with the statistics) in f32: the batch-4
# forward's layers and the batch-8 training forward's
F32_SHAPES = [("enc0 b4", (4, 512, 512, 3, 64), False),
              ("enc2 b4", (4, 128, 128, 128, 256), False),
              ("enc3 b4", (4, 64, 64, 256, 512), False),
              ("enc4 b4", (4, 32, 32, 512, 1024), False),
              ("enc5 b4", (4, 16, 16, 1024, 2048), False),
              ("enc6 b4", (4, 8, 8, 2048, 2048), False),
              ("enc2 b8 stats", (8, 128, 128, 128, 256), True),
              ("enc3 b8 stats", (8, 64, 64, 256, 512), True),
              ("enc4 b8 stats", (8, 32, 32, 512, 1024), True),
              ("enc5 b8 stats", (8, 16, 16, 1024, 2048), True),
              ("enc6 b8 stats", (8, 8, 8, 2048, 2048), True)]

_NO_MMA = [(f"wgmma_m64n{n}k16(acc, da, db, (q | s) != 0);", "(void)da, (void)db;")
           for n in (256, 128, 64)]
_RING = ("  cp_async_wait();\n"
         "  __syncthreads();  // every warpgroup's wgmmas are done: the ring is free\n")


def _stages(s128, s64):
    """The C entry's dispatch and the instantiations, at other ring depths."""
    return [(f"bm == {bm} && bn == 128 && stages == {old}",
             f"bm == {bm} && bn == 128 && stages == {new}")
            for bm, old, new in ((128, 5, s128), (64, 6, s64))] + [
            (f"run(wg::launch<{bm}, 128, {old}>)", f"run(wg::launch<{bm}, 128, {new}>)")
            for bm, old, new in ((128, 5, s128), (64, 6, s64))]


# name -> (patches, plan constants)
VARIANTS = {
    "kernel": ([], {}),
    "128x128": ([], {"CONV_BN_WIDE": 1 << 30}),
    "copies only": (_NO_MMA, {}),
    "no copies": ([("stage(q + STAGES - 2 < nsteps);", "stage(false);")], {}),
    "no epilogue": ([(_RING, _RING + "  if (act >= 0) return;\n")], {}),
    "deeper ring": (_stages(6, 8), {"CONV_STAGES": {(128, 256): 4, (128, 128): 6, (64, 128): 8}}),
    "2 blocks/SM": (_stages(3, 6) + [("__launch_bounds__(THREADS, 1)\n    conv_wgmma_kernel",
                                      "__launch_bounds__(THREADS, BN == 256 ? 1 : 2)\n"
                                      "    conv_wgmma_kernel")],
                    {"CONV_BN_WIDE": 1 << 30,
                     "CONV_STAGES": {(128, 256): 4, (128, 128): 3, (64, 128): 6}}),
}


F32_VARIANTS = {
    "kernel": ([], {}),
    "no copies": ([("stage(q + STAGES - 1 < nsteps);", "stage(false);")], {}),
    "fenced wait": ([("copies_landed<STAGES - 2>();", "hopper::cp_async_wait<STAGES - 2>();")],
                    {}),
    "4 stages": ([("constexpr int STAGES = 3;        // the ring",
                   "constexpr int STAGES = 4;        // the ring")], {"CONV_FMA_STAGES": 4}),
    "16-wide steps": ([("return VEC ? 32 : 16;", "return 16;")], {"CONV_FMA_BK_VEC": 16}),
    "2 blocks/SM": ([("return BM * BN == 128 * 128 ? 1 : 2;", "return 2;")],
                    {"CONV_FMA_BLOCKS_PER_SM": {(128, 128): 2, (64, 128): 2, (128, 64): 2}}),
}
TABLES = {"bf16": (VARIANTS, SHAPES), "f32": (F32_VARIANTS, F32_SHAPES)}


@contextlib.contextmanager
def _plan_constants(**values):
    """Plan with some of ops/conv_k4s2p1.py's constants replaced."""
    from ..ops import conv_k4s2p1 as k3

    old = {name: getattr(k3, name) for name in values}
    for name, v in values.items():
        setattr(k3, name, v)
    try:
        yield
    finally:
        for name, v in old.items():
            setattr(k3, name, v)


def start_variants(names=None, dtype: str = "bf16") -> dict:
    """Start the build of each variant of ``dtype``'s table (of ``names``,
    default all: tools/variants.py); ``run`` times the variants built."""
    from . import variants

    return variants.start({name: ("conv_k4s2p1.cu", patches)
                           for name, (patches, _) in TABLES[dtype][0].items()
                           if names is None or name in names}, OUT / dtype)


def _k3_call(fn, name, x, wt, y, st, act, sms):
    """(plan, call) of one variant's C entry on (x, wt) into y (and st, the
    statistics, where it is not None), with its own plan, passing the
    arguments as ops/conv_k4s2p1.py's wrapper does (one problem on the pair
    axis)."""
    import torch

    from ..ops import _build
    from ..ops.conv_k4s2p1 import CONV_PATH_CODES, conv_plan

    n, h, w, ci = x.shape
    co = wt.shape[3]
    table = F32_VARIANTS if x.dtype == torch.float32 else VARIANTS
    with _plan_constants(**table[name][1]):
        plan = conv_plan(n, h, w, ci, co, x.dtype, sms)
    ws = _build.workspace(plan.workspace_floats(co, st is not None), x)

    def call():
        err = fn(x.data_ptr(), wt.data_ptr(), None, None, y.data_ptr(),
                 _build.ptr(ws), _build.ptr(st), n, h, w, ci, co, act,
                 _build.DTYPE_CODES[x.dtype], CONV_PATH_CODES[plan.path],
                 plan.tile[0], plan.tile[1], plan.stages, plan.splits,
                 plan.steps_per_split, plan.grid[0], plan.grid[1],
                 plan.smem_bytes, plan.stat_rows, 1, x.numel(), 0, 0,
                 _build.stream_of(x))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return plan, call


def run(rounds, shapes=None, started=None, dtype: str = "bf16") -> int:
    """The A/B in ``dtype`` at ``shapes`` (default: its table's);
    ``started``: ``start_variants()``'s builds (started here where None)."""
    import torch
    import torch.nn.functional as F

    from ..ops.conv_k4s2p1 import conv2d_k4s2p1_plain
    from . import variants
    from .timing import Timer, smi_line

    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    fns = variants.load(started or start_variants(dtype=dtype), "discogan_conv_k4s2p1")
    tdtype, tol, path = ((torch.bfloat16, 2e-2, "wgmma") if dtype == "bf16"
                         else (torch.float32, 1e-4, "fma"))
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (n, h, w, ci, co), stats in shapes or TABLES[dtype][1]:
        x = torch.randn(n, h, w, ci, device="cuda", generator=g).to(tdtype)
        wt = (torch.randn(4, 4, ci, co, device="cuda", generator=g) * (16 * ci) ** -0.5).to(tdtype)
        y = torch.empty(n, h // 2, w // 2, co, dtype=x.dtype, device="cuda")
        st = torch.empty(2, co, device="cuda") if stats else None
        act = 0 if stats else 2  # the statistics' raw conv, or the serving leaky

        def variant(name):
            return _k3_call(fns[name], name, x, wt, y, st, act, sms)

        plan, kernel = variant("kernel")
        kernel()
        want = conv2d_k4s2p1_plain(x, wt, act=None if stats else "leaky")
        err = (y.float() - want.float()).abs().max().item()
        if not err <= tol * max(1.0, want.float().abs().max().item()):
            raise AssertionError(f"{label}: the kernel is off the plain version by {err}")
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        if stats:
            def lib():
                out = F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
                return torch.var_mean(out, dim=(0, 2, 3), correction=0)
        else:
            def lib():
                return F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
        calls = {name: variant(name)[1] for name in fns if plan.path == path
                 or name == "kernel"}
        calls["library"] = lib
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timer.ms(calls[name]))
        print(f"{label} (plan {plan.path} {plan.tile}, {plan.splits} splits; the kernel's max "
              f"error {err:.3e}), ms per call in {rounds} rounds:", flush=True)
        for name, ts in times.items():
            print(f"  {name:12} " + " ".join(f"{t:.4f}" for t in ts), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dtype", type=str, default="bf16", choices=list(TABLES))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("conv_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.dtype == "f32":
        from ..core.precision import F32, configure

        configure(F32)  # TF32 off for the library's convolution
    return run(args.rounds, dtype=args.dtype)


if __name__ == "__main__":
    sys.exit(main())
