"""Where K3's time goes on the card: interleaved A/B of the wgmma halving
conv (``conv_wgmma_kernel``, csrc/conv_k4s2p1.cu) against variants of its
own source and plan, beside one PyTorch call for the same function, in bf16
at the 512px layers (enc2..enc6, and the stem enc0).

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
Reference: ``F.conv2d`` (with ``torch.var_mean`` where the call takes the
statistics). Times are tools/timing.py's (median of 20 runs, L2 evicted, a
device sleep before each), in turns (a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.conv_ab [--rounds 2]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import shutil
import subprocess
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


def _build_variants() -> dict:
    """Each variant's C entry, from a patched copy of csrc/ built alone."""
    from ..ops import _build

    src = _build.CSRC / "conv_k4s2p1.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, (patches, _)) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        text = src.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch does not match the source once: {old}")
            text = text.replace(old, new)
        (d / src.name).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", str(d / src.name), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(str(d / "lib.so")).discogan_conv_k4s2p1
        fn.restype, fn.argtypes = _build._SIGNATURES["discogan_conv_k4s2p1"]
        fns[name] = fn
    return fns


def run(rounds) -> int:
    import torch
    import torch.nn.functional as F

    from ..ops import _build
    from ..ops.conv_k4s2p1 import CONV_PATH_CODES, conv2d_k4s2p1_plain, conv_plan
    from .timing import Timer, smi_line

    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    fns = _build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (n, h, w, ci, co), stats in SHAPES:
        x = torch.randn(n, h, w, ci, device="cuda", generator=g).bfloat16()
        wt = (torch.randn(4, 4, ci, co, device="cuda", generator=g) * (16 * ci) ** -0.5).bfloat16()
        y = torch.empty(n, h // 2, w // 2, co, dtype=x.dtype, device="cuda")
        st = torch.empty(2, co, device="cuda") if stats else None
        act = 0 if stats else 2  # the statistics' raw conv, or the serving leaky

        def variant(name):
            with _plan_constants(**VARIANTS[name][1]):
                plan = conv_plan(n, h, w, ci, co, x.dtype, sms)
            ws = _build.workspace(plan.workspace_floats(co, stats), x)

            def call():
                err = fns[name](x.data_ptr(), wt.data_ptr(), None, None, y.data_ptr(),
                                _build.ptr(ws), _build.ptr(st), n, h, w, ci, co, act,
                                _build.DTYPE_CODES[x.dtype], CONV_PATH_CODES[plan.path],
                                plan.tile[0], plan.tile[1], plan.stages, plan.splits,
                                plan.steps_per_split, plan.grid[0], plan.grid[1],
                                plan.smem_bytes, plan.stat_rows, _build.stream_of(x))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at launch")
            return plan, call

        plan, kernel = variant("kernel")
        kernel()
        want = conv2d_k4s2p1_plain(x, wt, act=None if stats else "leaky")
        err = (y.float() - want.float()).abs().max().item()
        if not err <= 2e-2 * max(1.0, want.float().abs().max().item()):
            raise AssertionError(f"{label}: the kernel is off the plain version by {err}")
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        if stats:
            def lib():
                out = F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
                return torch.var_mean(out, dim=(0, 2, 3), correction=0)
        else:
            def lib():
                return F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
        calls = {name: variant(name)[1] for name in VARIANTS if plan.path == "wgmma"
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("conv_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(args.rounds)


if __name__ == "__main__":
    sys.exit(main())
