"""Where K6's time goes on the card: interleaved A/B of its kernels against
variants of their own source, beside one PyTorch call for the same
function, at the 512px head (x (N,256,256,64) -> y (N,512,512,3)).

bf16 (``--dtype bf16``, the default): the tensor-core head
(``head_convt_mma_kernel``, csrc/head_convt.cu), beside
``F.conv_transpose2d`` and plain memory passes over the same tensors.
Variants, each a text patch of the source built alone into its own library
(the kernel: the wrapper's library; their outputs are wrong, except the
kernel's; only their times count):
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
``torch.amax(x)`` (reads x); ``y.fill_`` (writes y).

f32 (``--dtype f32``, TF32 off): the CUDA-core head (``head_fma_kernel``)
against variants of its source and plan (ops/head.py's constants), beside
``F.conv_transpose2d`` and the f32 bound (bytes at 3.35 TB/s or FMAs at 67
TFLOP/s):
  kernel        the kernel as the wrapper launches it (held against the
                plain version first, 1e-4 of max|ref|)
  no copies     no copies after the ring's first fill: the FMAs, the
                shared-memory reads, the barriers and the epilogue
  copies only   no products and no global stores: the ring's loads alone
  no stores     the epilogue's global stores dropped
  no w reads    every tap reads the same weights, which the compiler keeps
                in registers: the FMAs without w's shared-memory reads
  3 stages      a ring of 3 stages (at rows 16: 229 KB)
  KC 4          chunks of 4 channels (half of each pixel's 32-byte sector a
                stage)
  rows 8        blocks of 8 input rows (4 warps, two blocks an SM)
  rows 16       blocks of 16 input rows (8 warps, one block an SM)
Times are tools/timing.py's (median of 20 runs, L2 evicted, a device sleep
before each), in turns (a, b, ..., b, a, ...).

    python -m discogan_modernized_torch.tools.head_ab [--dtype bf16|f32] [--batch 8 4 1] [--rounds 3]

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
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

_F32_STORE = ("*reinterpret_cast<uint4*>(dst + k * U) = "
              "*reinterpret_cast<const uint4*>(line + k * U);")
_F32_NO_STORES = (_F32_STORE, "if (lead < 0) " + _F32_STORE)
_F32_NO_FMAS = ("for (int g = 0; g < KC / 4; ++g) {", "for (int g = 0; g < 0; ++g) {")
# name -> (text patches, ops/head.py constants of its plan): an empty patch
# list shares the kernel's library, equal patch lists one build
F32_VARIANTS = {
    "kernel": ([], {}),
    "no copies": ([("    stage_chunk(q + STAGES - 1, q + STAGES - 1 < nchunks);\n",
                    "    stage_chunk(q + STAGES - 1, false);\n")], {}),
    "copies only": ([_F32_NO_FMAS, _F32_NO_STORES], {}),
    "no stores": ([_F32_NO_STORES], {}),
    "no w reads": ([("const float4 f = *reinterpret_cast<const float4*>(wt + 4 * m);",
                     "const float4 f = *reinterpret_cast<const float4*>(ws + 4 * m);")], {}),
    "3 stages": ([("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
                 {"FMA_STAGES": 3}),
    "KC 4": ([("constexpr int KC = 8;", "constexpr int KC = 4;")], {"FMA_KC": 4}),
    "rows 8": ([], {"FMA_ROWS": (8,)}),
    "rows 16": ([], {"FMA_ROWS": (16,)}),
}


@contextlib.contextmanager
def _plan_constants(**values):
    """Plan with some of ops/head.py's constants replaced."""
    from ..ops import head

    old = {name: getattr(head, name) for name in values}
    for name, v in values.items():
        setattr(head, name, v)
    try:
        yield
    finally:
        for name, v in old.items():
            setattr(head, name, v)


def _build_of(name: str):
    """The f32 variant whose build ``name`` takes: the first with its
    patches (None: the kernel's library)."""
    patches = F32_VARIANTS[name][0]
    return next((v for v, (p, _) in F32_VARIANTS.items() if p == patches), None) if patches \
        else None


def start_variants(names=None, dtype: str = "bf16") -> dict:
    """Start the build of each variant of ``dtype`` (of ``names``, default
    all: tools/variants.py); those without patches take the kernel's
    library, and in f32 those with equal patches one build (``_build_of``).
    ``run`` times the variants built."""
    from . import variants

    if dtype == "bf16":
        return variants.start({name: ("head_convt.cu", patches)
                               for name, patches in VARIANTS.items()
                               if patches and (names is None or name in names)}, OUT)
    builds = {_build_of(name) for name in F32_VARIANTS if names is None or name in names}
    return variants.start({name: ("head_convt.cu", F32_VARIANTS[name][0])
                           for name in F32_VARIANTS if name in builds}, OUT / "f32")


def entry_plan(name, n, h, w, ci, co, dtype, sms: int = 132):
    """The C entry's plan fields for variant ``name``: ``head_entry_plan``'s,
    in f32 under the variant's constants of ops/head.py."""
    import torch

    from ..ops import head

    with _plan_constants(**(F32_VARIANTS[name][1] if dtype == torch.float32 else {})):
        return head.head_entry_plan(n, h, w, ci, co, dtype, sms)


def _k6_call(fn, x, wt, y, plan):
    """One variant's C entry on (x, wt) into y with ``plan`` (ops/head.py's
    ``head_entry_plan`` fields), its arguments as ops/head.py's wrapper
    passes them (one problem on the pair axis); returns y."""
    from ..ops import _build
    from ..ops.head import HEAD_PATH_CODES

    n, h, w, ci = x.shape
    path, *fields = plan
    err = fn(x.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h, w, ci, wt.shape[3],
             _build.DTYPE_CODES[x.dtype], HEAD_PATH_CODES[path], *fields, 1, x.numel(), 0,
             _build.stream_of(x))
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")
    return y


def run(batches, rounds, started=None, dtype: str = "bf16", names=None) -> int:
    """The A/B at each batch in ``dtype``; ``started``: ``start_variants()``'s
    builds (started here where None); ``names``: the variants timed
    (default all)."""
    import torch
    import torch.nn.functional as F

    from ..core.precision import BF16, F32, configure
    from ..ops import _build
    from ..ops.head import head_convt_plain
    from . import variants
    from .timing import HBM_BYTES_PER_S, Timer, bound_ms, smi_line

    f32 = dtype == "f32"
    configure(F32 if f32 else BF16)  # f32: TF32 off for the library's convT
    table = F32_VARIANTS if f32 else VARIANTS
    names = [v for v in table if names is None or v in names]
    print(torch.cuda.get_device_name(0), "|", smi_line(), flush=True)
    built = variants.load(started or start_variants(names, dtype), "discogan_head_convt")
    kernel_fn = _build.library().discogan_head_convt
    if f32:
        built = {name: built[_build_of(name)] for name in names if _build_of(name)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    dt = torch.float32 if f32 else torch.bfloat16
    h, w, ci, co = HEAD
    for n in batches:
        x = torch.randn(n, h, w, ci, device="cuda", generator=g).to(dt)
        wt = (torch.randn(4, 4, ci, co, device="cuda", generator=g) * (16 * co) ** -0.5).to(dt)
        y = torch.empty(n, 2 * h, 2 * w, co, dtype=dt, device="cuda")
        plans = {name: entry_plan(name, n, h, w, ci, co, dt, sms) for name in names}
        calls = {name: (lambda fn=built.get(name, kernel_fn), plan=plans[name]:
                        _k6_call(fn, x, wt, y, plan)) for name in names}
        calls["kernel"]()
        want = head_convt_plain(x, wt)
        err = (y.float() - want.float()).abs().max().item()
        if not err <= (1e-4 if f32 else 2e-2) * max(1.0, want.float().abs().max().item()):
            raise AssertionError(f"batch {n}: the kernel is off the plain version by {err}")
        x_nchw, w_iohw = x.permute(0, 3, 1, 2), wt.permute(2, 3, 0, 1).contiguous()
        calls["conv_transpose2d"] = lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2,
                                                               padding=1)
        if not f32:
            calls.update({"x.clone()": lambda: x.clone(), "amax(x)": lambda: torch.amax(x),
                          "y.fill_": lambda: y.fill_(1.0)})
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(timer.ms(calls[name]))
        size = x.element_size()
        if f32:
            bound, by = bound_ms(2 * n * h * w * 16 * ci * co,
                                 (x.numel() + wt.numel() + y.numel()) * size, torch.float32)
        else:
            bound, by = (x.numel() + y.numel()) * size / HBM_BYTES_PER_S * 1e3, "bytes"
        print(f"batch {n} {dtype} (plan {plans['kernel']}; bound {bound:.4f} ms by {by}; the "
              f"kernel's max error {err:.3e}), ms per call in {rounds} rounds:", flush=True)
        for name, ts in times.items():
            print(f"  {name:18} " + " ".join(f"{t:.4f}" for t in ts)
                  + f"  ({bound / min(ts):.3f} of the bound)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 4, 1])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("head_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(args.batch, args.rounds, dtype=args.dtype)


if __name__ == "__main__":
    sys.exit(main())
