"""Where the f32 weight gradients' time goes on the card: interleaved A/B of
a CUDA-core kernel against variants of its own source and plan, beside one
PyTorch call for the same function (``torch.nn.grad.conv2d_weight``,
cuDNN's wgrad, TF32 off), in f32. Two kernels (``--kernel``):

k4: K4's ``conv_dw_fma_kernel`` (csrc/conv_k4s2p1_dw.cu) at enc2 and enc5
of the 512px model (x (N,128,128,128), dy (N,64,64,256); x
(N,16,16,1024), dy (N,8,8,2048)). Variants:
  kernel        the kernel as the wrapper launches it (held against the
                plain version first, 1e-4 of max|ref|)
  no copies     no copies after the ring's first fill: the FMAs, the
                shared-memory reads, the barriers and the epilogue
  step 16       steps of 16 pixels (the 16-byte copies fill half as many
                rows a step, a barrier per 16 pixels)
  fewer stages  one stage fewer in each ring (4 -> 3 at one block an SM,
                3 -> 2 at two)
  1 block/SM    M split for one block an SM, each with the ring of 4
                stages and 167 registers a thread (the plan's two blocks an
                SM, 3 stages and 128 registers, let one block's fill and
                epilogue run beside the other's FMAs)

k5b: K5b's ``halo_dw_fma_kernel`` (csrc/halo_conv_k4s2p1_dw.cu) at enc1
(x (N,256,256,64), dy (N,128,128,128)); the kernel's window is a kernel
row's 256 dw rows in two halves of 256 threads that share each staged
segment, its steps 64 pixels, its ring 3 stages (198 KB), one block an SM.
Variants:
  kernel        as the wrapper launches it (checked as K4's)
  no copies     as K4's
  step 32       steps of 32 pixels (33 KB stages, a barrier per 32)
  step 16       steps of 16 pixels
  step 32, 4 stages  a ring of 4 stages of 32 pixels
  half row      windows of 128 dw rows (one dw_fma tile, 256 threads): two
                blocks stage the same dy run and most of one segment
  half row, 2/SM  windows of 128, steps of 32, two blocks an SM (128
                registers a thread): the first design

Each variant is a text patch of the source built alone into its own
library and called with its own plan (the outputs of those that drop work
are wrong; only their times count). Times are tools/timing.py's (median of
20 runs, L2 evicted, a device sleep before each), in turns (a, b, ..., b,
a, ...), beside the f32 bound (the FMAs at 67 TFLOP/s, or the bytes at
3.35 TB/s).

    python -m discogan_modernized_torch.tools.dw_ab [--kernel k4] [--layers enc2 enc5] [--batch 8] [--rounds 2]
    python -m discogan_modernized_torch.tools.dw_ab --kernel k5b --batch 8 1

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "dw_ab"
# h, w, ci, co of K4's layers of the 512px generator (enc1 takes K5b)
LAYERS = {"enc0": (512, 512, 3, 64), "enc2": (128, 128, 128, 256),
          "enc3": (64, 64, 256, 512), "enc4": (32, 32, 512, 1024),
          "enc5": (16, 16, 1024, 2048), "enc6": (8, 8, 2048, 2048)}
K5B_LAYERS = {"enc1": (256, 256, 64, 128)}

# name -> (text patches, ops/conv_k4s2p1.py constants of its plan): an empty
# patch list shares the kernel's library
VARIANTS = {
    "kernel": ([], {}),
    "no copies": ([("    stage(q + STAGES - 1 < nsteps);\n", "    stage(false);\n")], {}),
    "step 16": ([("constexpr int step_px() { return VA ? 32 : 16; }",
                  "constexpr int step_px() { return VA ? 16 : 16; }")], {"DW_FMA_STEP_VEC": 16}),
    "fewer stages": ([("constexpr int RING = 4, RING_WIDE = 3;",
                       "constexpr int RING = 3, RING_WIDE = 2;")],
                     {"DW_FMA_STAGES": 3, "DW_FMA_STAGES_WIDE": 2}),
    "1 block/SM": ([], {"DW_FMA_WIDE_BLOCKS": 1}),
}
# K5b's variants: text patches of csrc/halo_conv_k4s2p1_dw.cu, ops/halo_conv.py
# constants of their plan
_STEP_32 = ("constexpr int STEP = 64,", "constexpr int STEP = 32,")
_HALF_ROW = ("constexpr int WINDOW = 256;", "constexpr int WINDOW = 128;")
K5B_VARIANTS = {
    "kernel": ([], {}),
    "no copies": ([("    stage(q + RING - 1 < nsteps);\n", "    stage(false);\n")], {}),
    "step 32": ([_STEP_32], {"HALO_DW_STEP": 32}),
    "step 16": ([("constexpr int STEP = 64,", "constexpr int STEP = 16,")],
                {"HALO_DW_STEP": 16}),
    "step 32, 4 stages": ([_STEP_32, ("constexpr int RING = 3;", "constexpr int RING = 4;")],
                          {"HALO_DW_STEP": 32, "HALO_DW_STAGES": 4}),
    "half row": ([_HALF_ROW], {"HALO_DW_ROWS": 128}),
    "half row, 2/SM": ([_HALF_ROW, _STEP_32, ("constexpr int MIN_BLOCKS = 1;",
                                              "constexpr int MIN_BLOCKS = 2;")],
                       {"HALO_DW_ROWS": 128, "HALO_DW_STEP": 32, "HALO_DW_BLOCKS_PER_SM": 2}),
}
# --kernel -> (its csrc/ source, C entry, variants, layers)
KERNELS = {"k4": ("conv_k4s2p1_dw.cu", "discogan_conv_k4s2p1_dw", VARIANTS, LAYERS),
           "k5b": ("halo_conv_k4s2p1_dw.cu", "discogan_halo_conv_k4s2p1_dw", K5B_VARIANTS,
                   K5B_LAYERS)}


@contextlib.contextmanager
def _plan_constants(**values):
    """Plan with some of ops/conv_k4s2p1.py's (K4's) or ops/halo_conv.py's
    (K5b's HALO_DW_*) constants replaced."""
    from ..ops import conv_k4s2p1 as k4
    from ..ops import halo_conv as k5b

    where = {name: k5b if name.startswith("HALO_DW_") else k4 for name in values}
    old = {name: getattr(where[name], name) for name in values}
    for name, v in values.items():
        setattr(where[name], name, v)
    try:
        yield
    finally:
        for name, v in old.items():
            setattr(where[name], name, v)


def start_variants(names=None, kernel: str = "k4") -> dict:
    """Start the build of each of ``kernel``'s variants with patches (of
    ``names``, default all: tools/variants.py); ``run`` times them with the
    others."""
    from . import variants

    source, _, table, _ = KERNELS[kernel]
    return variants.start({name: (source, patches) for name, (patches, _) in table.items()
                           if patches and (names is None or name in names)}, OUT / kernel)


def _k4_call(fn, name, x, dy, dw, sms: int = 132):
    """(plan, call) of one variant's C entry on (x, dy) into dw with its own
    plan (``dw_fma_plan``'s under the variant's constants), passing the
    arguments as ops/conv_k4s2p1.py's wrapper does (one problem on the pair
    axis)."""
    from ..ops import _build
    from ..ops.conv_k4s2p1 import DW_PATH_CODES, dw_fma_plan

    n, h, w, ci = x.shape
    co = dy.shape[3]
    with _plan_constants(**VARIANTS[name][1]):
        plan = dw_fma_plan(n, h, w, ci, co, x.dtype, sms)
    ws = _build.workspace(plan.workspace_floats(ci, co), x)

    def call():
        err = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _build.ptr(ws), n, h, w, ci, co,
                 _build.DTYPE_CODES[x.dtype], DW_PATH_CODES[plan.path], plan.tile[0],
                 plan.tile[1], plan.stages, plan.splits, plan.steps_per_split, plan.blocks,
                 plan.smem_bytes, 1, x.numel(), dy.numel(), _build.stream_of(x))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return plan, call


def _k5b_call(fn, name, x, dy, dw, sms: int = 132):
    """(plan, call) of one K5b variant's C entry on (x, dy) into dw with its
    own plan (``halo_dw_fma_plan``'s under the variant's constants), its
    arguments from ops/halo_conv.py's ``halo_dw_entry_args``, as the
    wrapper's."""
    from ..ops import _build
    from ..ops.halo_conv import halo_dw_entry_args, halo_dw_fma_plan

    n, h, w, ci = x.shape
    co = dy.shape[3]
    with _plan_constants(**K5B_VARIANTS[name][1]):
        plan = halo_dw_fma_plan(n, h, w, ci, co, sms)
    ws = _build.workspace(plan.workspace_floats(ci, co), x)
    args = halo_dw_entry_args(x, dy, dw, ws, plan)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return plan, call


def _plan_text(kernel: str, plan) -> str:
    if kernel == "k5b":
        return (f"plan: windows of {plan.tile[0]} dw rows x {plan.tile[1]}, {plan.tile[2]} "
                f"pixels a step, {plan.stages} stages, {plan.splits} splits of "
                f"{plan.steps_per_split} rows, {plan.blocks} blocks")
    return (f"plan {plan.tile[0]} x {plan.tile[1]}, {plan.tile[2]} pixels a step, "
            f"{plan.stages} stages, {plan.splits} splits, {plan.blocks} blocks")


def run(layers, batches, rounds: int, started=None, names=None, kernel: str = "k4") -> int:
    """The A/B of ``kernel`` ("k4" or "k5b") at each layer and batch; ``started``:
    ``start_variants()``'s builds (started here where None); ``names``: the
    variants timed (default all)."""
    import torch
    from torch.nn import grad as nn_grad

    from ..core.precision import F32, configure
    from ..ops import _build
    from ..ops.conv_k4s2p1 import conv2d_k4s2p1_dw_plain
    from . import variants
    from .timing import Timer, bound_ms, smi_line

    configure(F32)  # TF32 off for cuDNN's wgrad and the plain version's products
    _, entry, table, shapes = KERNELS[kernel]
    names = [v for v in table if names is None or v in names]
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    built = variants.load(started or start_variants(names, kernel), entry)
    kernel_fn = getattr(_build.library(), entry)
    call_of = _k5b_call if kernel == "k5b" else _k4_call
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    for layer, n in ((layer, n) for layer in layers for n in batches):
        h, w, ci, co = shapes[layer]
        x = torch.randn(n, h, w, ci, device="cuda", generator=g)
        dy = torch.randn(n, h // 2, w // 2, co, device="cuda", generator=g) * 0.1
        dw = torch.empty(4, 4, ci, co, device="cuda")
        calls, plans = {}, {}
        for name in names:
            plans[name], calls[name] = call_of(built.get(name, kernel_fn), name, x, dy, dw,
                                               torch.cuda.get_device_properties(0)
                                               .multi_processor_count)
            if name == "kernel":
                calls[name]()
                want = conv2d_k4s2p1_dw_plain(x, dy)
                err = (dw - want).abs().max().item()
                if not err <= 1e-4 * max(1.0, want.abs().max().item()):
                    raise AssertionError(f"{layer} b{n}: the kernel is off the plain version "
                                         f"by {err}")
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        calls["cuDNN"] = lambda: nn_grad.conv2d_weight(x_nchw, (co, ci, 4, 4), dy_nchw,
                                                       stride=2, padding=1)
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timer.ms(calls[name]))
        m = n * (h // 2) * (w // 2)
        bound, by = bound_ms(2 * m * 16 * ci * co, (x.numel() + dy.numel() + dw.numel()) * 4,
                             torch.float32)
        print(f"{kernel} {layer} b{n} f32 ({_plan_text(kernel, plans['kernel'])}; the kernel's "
              f"max error {err:.3e}; bound {bound:.4f} ms by {by}), ms per call in {rounds} "
              "rounds:", flush=True)
        for name, ts in times.items():
            print(f"  {name:12} " + " ".join(f"{t:.4f}" for t in ts)
                  + f"  ({bound / min(ts):.3f} of the bound)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="k4")
    ap.add_argument("--layers", nargs="+", choices=[*LAYERS, *K5B_LAYERS],
                    help="default: enc2 enc5 (k4), enc1 (k5b)")
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    shapes = KERNELS[args.kernel][3]
    layers = args.layers or (["enc1"] if args.kernel == "k5b" else ["enc2", "enc5"])
    if any(layer not in shapes for layer in layers):
        ap.error(f"--kernel {args.kernel} takes --layers from {list(shapes)}")
    import torch

    if not torch.cuda.is_available():
        print("dw_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(layers, args.batch, args.rounds, kernel=args.kernel)


if __name__ == "__main__":
    sys.exit(main())
