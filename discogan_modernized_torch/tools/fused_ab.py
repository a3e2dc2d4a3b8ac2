"""Where K1's and K2's time goes on the card: interleaved A/B of the batch
statistics (``batch_stats_kernel``, csrc/batch_stats.cu) and the BatchNorm +
activation pass (``bn_act_vec_kernel``, csrc/bn_act.cu) against variants
of their own sources and plans, beside one PyTorch call for the same
function and ``x.clone()`` of the same tensor, in bf16 at the 512px
model's shapes.

Variants, each a text patch of the source built alone into its own library
(or a plan with other constants), called with its own plan (the outputs of
those that drop work are wrong; only their times count):
  K2 kernel        the kernel as the wrapper launches it (every variant's
                   output is held against the plain version first, 2e-2 of
                   max|ref|)
  K2 4 / 16 blocks/SM  at most 4 or 16 blocks an SM (the plan takes 8)
  K2 32 / 40 registers  __launch_bounds__ for 8 or 6 resident blocks an SM
  K2 L1 scales     scales and offsets read from L1 at each use, not kept in
                   registers, under __launch_bounds__ for 6 blocks
  K2 unroll 2      two loads in flight a thread, 8 resident blocks, at most
                   16 blocks an SM
  K2 general       bn_act_any_kernel: a channel index stepped per vector,
                   scales and offsets read per value
  K2 one pass      a block for every 256 vectors, however many (no loop)
  K2 stcs          streaming stores (st.global.cs) of y
  K1 kernel        the kernel as the wrapper launches it (every variant's
                   output but "no sum"'s is held against the plain version
                   first, 1e-4 of max|ref|)
  K1 two launches  the last block's sum over the splits as a second kernel
  K1 no sum        no sum over the splits (the partials only)
  K1 1 / 2 steps   splits of at least 1 or 2 unrolled steps of every row
                   lane (the plan takes 4: more splits where the rows are
                   few)
  K1 lanes 16 / 32 up to 16 or 32 threads across a row (the plan takes 8:
                   wider channel tiles, each summed by its own last
                   block); "lanes 32 1 step" is the first plan's
  K1 prefetch      prefetch.global.L2 of each thread's next step
  K1 interleaved   each block on every splits-th step of the rows (all
                   blocks sweep x together) rather than a contiguous range;
                   "il prefetch" with the prefetch too
  K1 3 blocks/SM   __launch_bounds__ for 3 resident blocks, 396 blocks
References: ``F.batch_norm`` in eval form (K2), ``torch.var_mean`` (K1),
``x.clone()``, and for K1 ``torch.sum(x)``, a read of x and nothing else.
The kernel and the references are also timed with L2 evicted by a read in
place of a write ("clean L2"): the gap shows what writing back the dirty
lines that the write leaves in L2 adds to each call. Times are chip_smoke's (median of 20 runs, L2 evicted, a
device sleep before each), in turns (a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.fused_ab [--rounds 2]

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
OUT = ROOT / "build" / "fused_ab"
# (label, (n, h, w, c)): the training step's calls at batch 8, and the
# serving forward's largest at batch 4
K2_SHAPES = [("dec6 b8", (8, 256, 256, 64)), ("enc1 b8", (8, 128, 128, 128)),
             ("enc2 b8", (8, 64, 64, 256)), ("enc3 b8", (8, 32, 32, 512)),
             ("enc5 b8", (8, 8, 8, 2048)), ("enc6 b8", (8, 4, 4, 2048)),
             ("dec6 b4", (4, 256, 256, 64))]
K1_SHAPES = [("dec6 b8", (8, 256, 256, 64)), ("dec5 b8", (8, 128, 128, 128)),
             ("dec4 b8", (8, 64, 64, 256)), ("dec3 b8", (8, 32, 32, 512)),
             ("dec1 b8", (8, 8, 8, 2048)), ("dec0 b8", (8, 4, 4, 2048)),
             ("latent b8", (8, 1, 1, 100))]

_TWO_LAUNCHES = [
    ("    last = atomicAdd(tickets + blockIdx.y, 1u) == static_cast<unsigned>(splits - 1);",
     "    last = false;"),
    ("template <typename T, int V>\nint launch(",
     "template <int FV, int SQ>\n__global__ void __launch_bounds__(MAX_THREADS)\n"
     "    finalize_kernel(const float* part, int splits, long long rows, int c, int width,\n"
     "                    float* mean, float* var) {\n"
     "  __shared__ __align__(16) float sh[2 * SQ];\n"
     "  const int c0 = blockIdx.x * width;\n"
     "  sum_splits<FV, SQ>(part, splits, rows, c, c0, min(width, c - c0), mean, var, sh);\n"
     "}\n\n"
     "template <typename T, int V>\nint launch("),
    ("                                                    rows_per_split, part, tickets, mean, var);\n"
     "  return launch_status();",
     "                                                    rows_per_split, part, tickets, mean, var);\n"
     "  if (splits > 1)\n"
     "    finalize_kernel<V == 1 ? 1 : 4, MAX_THREADS * V><<<ctiles, threads, 0, s>>>(\n"
     "        part, splits, rows, c, lanes * V, mean, var);\n"
     "  return launch_status();"),
]
_NO_SUM = [_TWO_LAUNCHES[0]]


def _prefetch(d):
    """prefetch.global.L2 of each thread's vectors d unrolled steps ahead."""
    return [("      float v[UNROLL][V];\n",
             "      float v[UNROLL][V];\n#pragma unroll\n"
             "      for (int u = 0; u < UNROLL; ++u) {\n"
             f"        if (r + ({d} * UNROLL + u) * row_lanes < r1)\n"
             "          asm volatile(\"prefetch.global.L2 [%0];\" :: "
             f"\"l\"(p + ({d} * UNROLL + u) * step));\n"
             "      }\n")]


# each block on every splits-th step of the rows (all blocks sweep x
# together) rather than on a contiguous range
_INTERLEAVED = [
    ("    long long r = r0 + row_lane;\n    const T* p = x + r * c + ch;\n"
     "    for (; r + (UNROLL - 1) * row_lanes < r1; r += UNROLL * row_lanes, p += UNROLL * step) {",
     "    const long long hop = static_cast<long long>(splits) * UNROLL * row_lanes;\n"
     "    long long r = static_cast<long long>(blockIdx.x) * UNROLL * row_lanes + row_lane;\n"
     "    const T* p = x + r * c + ch;\n"
     "    for (; r + (UNROLL - 1) * row_lanes < rows; r += hop, p += hop * c) {"),
    ("    for (; r < r1; r += row_lanes, p += step) {",
     "    for (; r < rows; r += row_lanes, p += step) {")]
_K1_LB3 = [("__launch_bounds__(MAX_THREADS)\n    batch_stats_kernel",
            "__launch_bounds__(MAX_THREADS, 3)\n    batch_stats_kernel")]

def _k2_blocks(n):
    """__launch_bounds__ for n resident blocks of bn_act_vec_kernel an SM."""
    return [("__launch_bounds__(MAX_THREADS)\n    bn_act_vec_kernel",
             f"__launch_bounds__(MAX_THREADS, {n})\n    bn_act_vec_kernel")]


# scales and offsets read from L1 at each use (asm volatile: not hoisted
# into registers), which frees 16 registers a thread
_K2_L1 = [("template <typename T>\n__global__ void __launch_bounds__(MAX_THREADS)\n"
           "    bn_act_vec_kernel",
           "__device__ __forceinline__ float ld_l1(const float* p) {\n"
           "  float v;\n"
           "  asm volatile(\"ld.global.nc.f32 %0, [%1];\" : \"=f\"(v) : \"l\"(p));\n"
           "  return v;\n}\n\n"
           "template <typename T>\n__global__ void __launch_bounds__(MAX_THREADS)\n"
           "    bn_act_vec_kernel"),
          ("        for (int k = 0; k < V; ++k) v[k] = apply_act(v[k] * s[k] + o[k], act);",
           "        for (int k = 0; k < V; ++k)\n"
           "          v[k] = apply_act(v[k] * ld_l1(scale + ch + k) + ld_l1(offset + ch + k), act);")]

# what is also timed with L2 evicted by a read
CLEAN = {"K2": ("K2 kernel", "F.batch_norm", "x.clone()"),
         "K1": ("K1 kernel", "torch.var_mean", "x.clone()", "torch.sum(x)")}

# name -> (source, patches, plan constants of ops/fused.py)
VARIANTS = {
    "K2 kernel": ("bn_act.cu", [], {}),
    "K2 4 blocks/SM": ("bn_act.cu", [], {"BN_BLOCKS_PER_SM": 4}),
    "K2 16 blocks/SM": ("bn_act.cu", [], {"BN_BLOCKS_PER_SM": 16}),
    "K2 32 registers": ("bn_act.cu", _k2_blocks(8), {}),
    "K2 40 registers": ("bn_act.cu", _k2_blocks(6), {}),
    "K2 L1 scales": ("bn_act.cu", _K2_L1 + _k2_blocks(6), {}),
    "K2 unroll 2": ("bn_act.cu", [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")]
                    + _k2_blocks(8), {"BN_UNROLL": 2, "BN_BLOCKS_PER_SM": 16}),
    "K2 general": ("bn_act.cu", [], {"BN_MAX_FIXED_BLOCKS": 0}),
    "K2 one pass": ("bn_act.cu", [], {"BN_BLOCKS_PER_SM": 1 << 20,
                                      "BN_MAX_FIXED_BLOCKS": 1 << 30}),
    "K2 stcs": ("bn_act.cu", [("        y[i + j * stride] = Vec16<T>::pack(v);",
                               "        __stcs(y + i + j * stride, Vec16<T>::pack(v));")], {}),
    "K1 kernel": ("batch_stats.cu", [], {}),
    "K1 two launches": ("batch_stats.cu", _TWO_LAUNCHES, {}),
    "K1 no sum": ("batch_stats.cu", _NO_SUM, {}),
    "K1 1 step": ("batch_stats.cu", [], {"STATS_MIN_STEPS": 1}),
    "K1 2 steps": ("batch_stats.cu", [], {"STATS_MIN_STEPS": 2}),
    "K1 lanes 16": ("batch_stats.cu", [], {"STATS_MAX_LANES": 16}),
    "K1 lanes 32": ("batch_stats.cu", [], {"STATS_MAX_LANES": 32}),
    "K1 lanes 32 1 step": ("batch_stats.cu", [], {"STATS_MAX_LANES": 32, "STATS_MIN_STEPS": 1}),
    "K1 prefetch": ("batch_stats.cu", _prefetch(1), {}),
    "K1 interleaved": ("batch_stats.cu", _INTERLEAVED, {}),
    "K1 il prefetch": ("batch_stats.cu", _INTERLEAVED + _prefetch(1), {}),
    "K1 3 blocks/SM": ("batch_stats.cu", _K1_LB3, {"STATS_TARGET_BLOCKS": 396}),
}


@contextlib.contextmanager
def _plan_constants(**values):
    """Plan with some of ops/fused.py's constants replaced."""
    from ..ops import fused

    old = {name: getattr(fused, name) for name in values}
    for name, v in values.items():
        setattr(fused, name, v)
    try:
        yield
    finally:
        for name, v in old.items():
            setattr(fused, name, v)


def _build_variants() -> dict:
    """Each variant's C entry, from a patched copy of csrc/ built alone."""
    from ..ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, (source, patches, _)) in enumerate(VARIANTS.items()):
        src = _build.CSRC / source
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        text = src.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch does not match the source once: {old}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", str(d / source), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        entry = "discogan_bn_act" if name.startswith("K2") else "discogan_batch_stats"
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.restype, fn.argtypes = _build._SIGNATURES[entry]
        fns[name] = fn
    return fns


def _k2_call(fn, name, x, s, o, y):
    from ..ops import _build
    from ..ops.fused import bn_act_plan

    with _plan_constants(**VARIANTS[name][2]):
        plan = bn_act_plan(x.numel(), x.shape[-1], x.dtype)

    def call():
        err = fn(x.data_ptr(), s.data_ptr(), o.data_ptr(), y.data_ptr(), x.numel(),
                 x.shape[-1], 1, _build.DTYPE_CODES[x.dtype], plan.width, int(plan.fixed),
                 plan.threads, plan.blocks, plan.unroll, _build.stream_of(x))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return plan, call


def _k1_call(fn, name, x, tickets):
    import torch

    from ..ops import _build
    from ..ops.fused import stats_plan

    c = x.shape[-1]
    rows = x.numel() // c
    with _plan_constants(**VARIANTS[name][2]):
        plan = stats_plan(rows, c, x.dtype)
    part = torch.empty(plan.partial_floats(c), dtype=torch.float32, device=x.device)
    stats = torch.empty(2, c, dtype=torch.float32, device=x.device)

    def call():
        err = fn(x.data_ptr(), part.data_ptr(), tickets.data_ptr(), stats[0].data_ptr(),
                 stats[1].data_ptr(), rows, c, _build.DTYPE_CODES[x.dtype], plan.width,
                 plan.threads, plan.lanes, plan.row_lanes, plan.ctiles, plan.splits,
                 plan.rows_per_split, plan.unroll, int(plan.shuffle), _build.stream_of(x))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return stats[0], stats[1]
    return plan, call


def _rounds(label, calls, rounds, timer, note):
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(timer.ms(calls[name]))
    print(f"{label} ({note}), ms per call in {rounds} rounds:", flush=True)
    for name, ts in times.items():
        print(f"  {name:16} " + " ".join(f"{t:.4f}" for t in ts), flush=True)


def run(rounds) -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ..ops.fused import STATS_MAX_TILES, batch_stats_plain, bn_act_plain

    print(torch.cuda.get_device_name(0), "|", chip_smoke.smi_line(), flush=True)
    fns = _build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    timer, clean = chip_smoke.Timer(), chip_smoke.Timer(clean=True)
    for label, shape in K2_SHAPES:
        c = shape[-1]
        x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
        s = torch.rand(c, device="cuda", generator=g) + 0.5
        o = torch.randn(c, device="cuda", generator=g) * 0.1
        y = torch.empty_like(x)
        calls = {}
        want = bn_act_plain(x, s, o, "relu")
        for name in (n for n in VARIANTS if n.startswith("K2")):
            plan, calls[name] = _k2_call(fns[name], name, x, s, o, y)
            if name == "K2 kernel":
                note = f"{plan.blocks} blocks, fixed {plan.fixed}"
            y.zero_()
            calls[name]()
            err = (y.float() - want.float()).abs().max().item()
            if not err <= 2e-2 * max(1.0, want.float().abs().max().item()):
                raise AssertionError(f"{label} {name}: off the plain version by {err}")
        x_nchw = x.permute(0, 3, 1, 2)
        zeros, ones = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        calls["F.batch_norm"] = lambda: F.batch_norm(x_nchw, zeros, ones, s, o, False, 0.0, 1e-5)  # noqa: E731,B023
        calls["x.clone()"] = lambda: x.clone()  # noqa: E731,B023
        _rounds(f"K2 {label}", calls, rounds, timer, note)
        _rounds(f"K2 {label} clean L2", {k: calls[k] for k in CLEAN["K2"]}, rounds, clean,
                note)
    tickets = torch.zeros(STATS_MAX_TILES, dtype=torch.int32, device="cuda")
    for label, shape in K1_SHAPES:
        c = shape[-1]
        x = (torch.randn(*shape, device="cuda", generator=g) + 0.5).bfloat16()
        want = batch_stats_plain(x)
        calls = {}
        for name in (n for n in VARIANTS if n.startswith("K1")):
            plan, calls[name] = _k1_call(fns[name], name, x, tickets)
            if name == "K1 kernel":
                note = f"{plan.splits} splits x {plan.ctiles} tiles"
            got = calls[name]()
            if name != "K1 no sum":
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                if not err <= 1e-4 * max(1.0, max(b.abs().max().item() for b in want)):
                    raise AssertionError(f"{label} {name}: off the plain version by {err}")
        calls["torch.var_mean"] = lambda: torch.var_mean(x.view(-1, c), dim=0, correction=0)  # noqa: E731,B023
        calls["x.clone()"] = lambda: x.clone()  # noqa: E731,B023
        calls["torch.sum(x)"] = lambda: torch.sum(x)  # noqa: E731,B023
        _rounds(f"K1 {label}", calls, rounds, timer, note)
        _rounds(f"K1 {label} clean L2", {k: calls[k] for k in CLEAN["K1"]}, rounds, clean,
                note)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(args.rounds)


if __name__ == "__main__":
    sys.exit(main())
