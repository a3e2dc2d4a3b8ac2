#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: builds the CUDA kernels from
``discogan_modernized_torch/csrc``, holds each against its plain PyTorch
version, and drives the 512px serving path through the inference CLI and
the serving daemon.

    python3 chip_smoke.py            # one NVIDIA GPU (H100), no arguments

Phases, each fatal on failure (the run then exits non-zero):
  1. device   CUDA present; the card's name and power limit.
  2. build    nvcc of csrc/*.cu into one library, timed.
  3. kernels  K2/K3/K5f/K6 at every shape of one 512px forward at batch 4
              (the CLI's) and at batch 1 (the daemon's, where K3 takes other
              split-K counts), plus one odd shape each, in f32 (TF32 off; tolerance 1e-4 of
              max(1, max|ref|)) and bf16 (2e-2: the kernel and the plain
              version round to bf16 at different places). Kernel, plain and
              library times are CUDA-event medians of 20 warm runs, each
              after a write that evicts L2; the bound is the larger of bytes
              over 3.35 TB/s and flops over the dtype's peak.
  4. path     two seeded 512px generators (running statistics calibrated on
              seeded images) saved as gen_A/gen_B_final.pth; the inference
              CLI on 8 seeded PNGs at batch 4; launch counts checked per
              forward (6 K3, 1 K5f, 8 K2, 1 K6); outputs finite, in [0,1],
              and equal to the plain versions' forward in f32 (1e-4), close
              in bf16 (PATH_TOL); the forward timed and profiled at batch 4
              and at batch 1.
  5. serve    the daemon at 512px: 3 /translate and 1 /reconstruct over
              HTTP (through Translator when PIL is missing), p50/p99 and
              each request's round trip; the daemon's Translator held
              against the plain forward at batch 1 in f32 and bf16; its
              latency on the main thread and from fresh threads.
  6. report   one JSON line of kernels, the nvidia-smi line, and the last
              line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Whole forward, kernels vs plain versions: (max, mean) absolute error of
# outputs in [0,1], for the translation and the reconstruction (both
# generators). Under bf16 the two round to bf16 at different places in each
# of 16 layers (32 for the reconstruction). The bf16 limits are about twice
# the readings on an H100 at batch 4 (max 5.3e-2 / 1.7e-1, mean 2.5e-3 /
# 8.9e-3).
PATH_TOL = {torch.float32: {"generated": (1e-4, 1e-4),
                            "reconstructed": (1e-4, 1e-4)},
            torch.bfloat16: {"generated": (0.1, 5e-3),
                             "reconstructed": (0.3, 1.5e-2)}}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
BATCH = 4
SIZE = 512
PER_FORWARD = {"conv_k4s2p1": 6, "halo_conv_k4s2p1": 1, "bn_act": 8,
               "head_convt": 1}
KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "bn_act": ("discogan_modernized_torch/csrc/bn_act.cu",
               "discogan_modernized_tpu/ops/pallas_fused.py:122"),
    "conv_k4s2p1": ("discogan_modernized_torch/csrc/conv_k4s2p1.cu",
                    "discogan_modernized_tpu/ops/pallas_conv.py:184"),
    "halo_conv_k4s2p1": ("discogan_modernized_torch/csrc/halo_conv_k4s2p1.cu",
                         "discogan_modernized_tpu/ops/pallas_halo_conv.py:158"),
    "head_convt": ("discogan_modernized_torch/csrc/head_convt.cu",
                   "discogan_modernized_tpu/ops/pallas_head.py:198"),
}


def phase(name):
    print(f"\n== {name}", flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

class Timer:
    """CUDA-event medians with L2 evicted before each timed run."""

    def __init__(self, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_cases():
    """(kernel, label, shape args, path) for every call: path "cli" for one
    512px forward at batch 4, "serve" for one at batch 1 (the daemon's),
    None for the odd shapes."""
    cases = []
    for batch, path in ((BATCH, "cli"), (1, "serve")):
        tag = "" if path == "cli" else " b1"
        chans = [64, 128, 256, 512, 1024, 2048, 2048]
        h, ci = SIZE, 3
        for i, co in enumerate(chans):
            kernel = "halo_conv_k4s2p1" if i == 1 else "conv_k4s2p1"
            cases.append((kernel, f"enc{i}{tag}", (batch, h, h, ci, co, i > 0), path))
            h, ci = h // 2, co
        cases.append(("bn_act", f"latent{tag}", (batch, 1, 1, 100, "leaky"), path))
        h = 4
        for j, c in enumerate([2048, 2048, 1024, 512, 256, 128, 64]):
            cases.append(("bn_act", f"dec{j}{tag}", (batch, h, h, c, "relu"), path))
            h *= 2
        cases.append(("head_convt", f"dec7{tag}", (batch, 256, 256, 64, 3), path))
    cases += [
        ("bn_act", "odd 75 rows", (3, 5, 5, 100, "leaky"), None),
        ("conv_k4s2p1", "odd 6x10", (3, 6, 10, 16, 72, True), None),
        ("halo_conv_k4s2p1", "odd 14x22", (3, 14, 22, 8, 24, True), None),
        ("head_convt", "odd 40x24", (1, 40, 24, 8, 3), None),
    ]
    return cases


def run_case(kernel, args, dtype, timer, g):
    from discogan_modernized_torch.ops.conv_k4s2p1 import (
        conv2d_k4s2p1, conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops.fused import bn_act, bn_act_plain
    from discogan_modernized_torch.ops.halo_conv import (
        halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops.head import head_convt, head_convt_plain

    dev = "cuda"
    size = torch.finfo(dtype).bits // 8

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    if kernel == "bn_act":
        n, h, w, c, act = args
        x = rand(n, h, w, c)
        s = torch.rand(c, device=dev, generator=g) + 0.5
        o = torch.randn(c, device=dev, generator=g) * 0.1
        x_nchw = x.permute(0, 3, 1, 2)
        zeros, ones = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        kern = lambda: bn_act(x, s, o, act)  # noqa: E731
        plain = lambda: bn_act_plain(x, s, o, act)  # noqa: E731
        # eval BatchNorm with mean 0 and var 1: the same per-channel affine
        lib = lambda: F.batch_norm(x_nchw, zeros, ones, s, o, False, 0.0, 1e-5)  # noqa: E731
        flops, nbytes = 2 * x.numel(), 2 * x.numel() * size + 8 * c
    elif kernel in ("conv_k4s2p1", "halo_conv_k4s2p1"):
        n, h, w, ci, co, affine = args
        x = rand(n, h, w, ci)
        wt = rand(4, 4, ci, co, scale=(16 * ci) ** -0.5)
        s = torch.rand(co, device=dev, generator=g) + 0.5 if affine else None
        o = torch.randn(co, device=dev, generator=g) * 0.1 if affine else None
        fn, plain_fn = ((conv2d_k4s2p1, conv2d_k4s2p1_plain)
                        if kernel == "conv_k4s2p1" else
                        (halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain))
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        kern = lambda: fn(x, wt, scale=s, offset=o, act="leaky")  # noqa: E731
        plain = lambda: plain_fn(x, wt, scale=s, offset=o, act="leaky")  # noqa: E731
        lib = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)  # noqa: E731
        m = n * (h // 2) * (w // 2)
        flops = 2 * m * 16 * ci * co
        nbytes = (x.numel() + wt.numel() + m * co) * size + (8 * co if affine else 0)
    else:
        n, h, w, ci, co = args
        x = rand(n, h, w, ci)
        wt = rand(4, 4, ci, co, scale=(16 * co) ** -0.5)
        x_nchw, w_iohw = x.permute(0, 3, 1, 2), wt.permute(2, 3, 0, 1).contiguous()
        kern = lambda: head_convt(x, wt)  # noqa: E731
        plain = lambda: head_convt_plain(x, wt)  # noqa: E731
        lib = lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2, padding=1)  # noqa: E731
        flops = 2 * n * h * w * 16 * ci * co
        nbytes = (x.numel() + wt.numel() + 4 * n * h * w * co) * size

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    limit = TOL[dtype] * max(1.0, want.float().abs().max().item())
    if not (err <= limit) or got.shape != want.shape:
        raise AssertionError(f"{kernel} {args} {DTYPE_NAMES[dtype]}: max error "
                             f"{err:.3e} > {limit:.3e}")
    bound, by = bound_ms(flops, nbytes, dtype)
    return {"err": err, "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
            "library_ms": timer.ms(lib), "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes}


def check_kernels(timer):
    from discogan_modernized_torch.core.precision import BF16, F32, configure

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    print(f"{'kernel':18} {'layer':12} {'dtype':5} {'max_err':>10} {'ms':>9} "
          f"{'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}  bound_by")
    for policy in (F32, BF16):
        configure(policy)
        dtype = policy.compute_dtype
        for kernel, label, args, path in kernel_cases():
            r = run_case(kernel, args, dtype, timer, g)
            results[(kernel, label, dtype)] = dict(r, path=path)
            print(f"{kernel:18} {label:12} {DTYPE_NAMES[dtype]:5} "
                  f"{r['err']:10.3e} {r['ms']:9.4f} {r['plain_ms']:9.4f} "
                  f"{r['library_ms']:9.4f} {r['bound_ms']:9.4f}  {r['bound_by']}",
                  flush=True)
    return results


def kernel_summary(results, launches):
    """Per kernel: the bf16 (serving default) times summed over the calls of
    one 512px batch-4 forward (and the kernel ms of one batch-1 forward),
    the largest bf16 error, and the largest f32 error."""
    out = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = {k: v for k, v in results.items() if k[0] == name}
        path_bf16 = [v for k, v in rows.items()
                     if v["path"] == "cli" and k[2] == torch.bfloat16]
        serve_bf16 = [v for k, v in rows.items()
                      if v["path"] == "serve" and k[2] == torch.bfloat16]
        t_ops = sum(v["flops"] / PEAK_FLOPS[torch.bfloat16] for v in path_bf16)
        t_bytes = sum(v["bytes"] / HBM_BYTES_PER_S for v in path_bf16)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["err"] for k, v in rows.items()
                               if k[2] == torch.bfloat16),
            "max_abs_err_f32": max(v["err"] for k, v in rows.items()
                                   if k[2] == torch.float32),
            "ms": sum(v["ms"] for v in path_bf16),
            "plain_ms": sum(v["plain_ms"] for v in path_bf16),
            "bound_ms": sum(v["bound_ms"] for v in path_bf16),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(v["library_ms"] for v in path_bf16),
            "calls_per_forward": len(path_bf16),
            "ms_batch1": sum(v["ms"] for v in serve_bf16),
        })
    return out


# -- phase 4: the serving path through the CLI -------------------------------

@torch.no_grad()
def make_checkpoint(model_dir: Path, seed: int, images: torch.Tensor) -> None:
    """A seeded random 512px generator whose running statistics are the
    batch statistics of ``images`` through its own layers (scaled by a
    seeded factor), so activations keep a realistic scale."""
    from discogan_modernized_torch.models.generator import Generator

    gen = Generator(SIZE, generator=torch.Generator().manual_seed(seed)).cuda()
    bns = [m for m in gen.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch = its statistics
    gen.train()
    gen.decoder(gen.encoder(images.permute(0, 3, 1, 2)))
    gen.eval()
    rng = torch.Generator(device="cuda").manual_seed(seed + 100)
    for bn in bns:
        bn.momentum = 0.1
        c = bn.num_features
        bn.running_var.mul_(torch.rand(c, device="cuda", generator=rng) * 0.5 + 0.75)
        bn.weight.copy_(torch.rand(c, device="cuda", generator=rng) * 0.5 + 0.75)
        bn.bias.copy_(torch.randn(c, device="cuda", generator=rng) * 0.1)
    torch.save({k: v.cpu() for k, v in gen.state_dict().items()},
               model_dir / f"gen_{'AB'[seed]}_final.pth")


def have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def per_forward_check(counts: dict, forwards: int, where: str) -> None:
    want = {k: v * forwards for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts}, want {want} "
                             f"({forwards} forwards)")
    print(f"{where}: launches {counts} = {forwards} forwards x {PER_FORWARD}")


def drive_cli(model_dir: Path, work: Path, images: np.ndarray) -> int:
    """The inference CLI at 512px, batch 4, through files; returns the
    number of generator forwards it ran."""
    from discogan_modernized_torch.cli import inference

    if have_pil():
        from PIL import Image

        src = work / "inputs"
        src.mkdir()
        for i, im in enumerate(images):
            Image.fromarray((im * 255).astype(np.uint8)).save(src / f"img{i}.png")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = inference.main([f"--model_path={model_dir}",
                                 f"--input_path={src}",
                                 f"--output_dir={work / 'outputs'}",
                                 f"--image_size={SIZE}",
                                 f"--batch_size={BATCH}"])
        text = out.getvalue()
        print("\n".join(line for line in text.splitlines()
                        if "p50" in line or "matplotlib" in line or "로드" in line))
        if rc != 0 or "p50 per-image latency" not in text:
            raise AssertionError(f"inference CLI failed (rc {rc}):\n{text}")
    else:
        print("PIL is not installed: driving the CLI's translate_batch")
        from discogan_modernized_torch.core.precision import default_policy

        fwd, rev = inference.load_generators(model_dir, "AtoB", SIZE, "cuda")
        policy = default_policy(None, "cuda")
        for i in range(0, len(images), BATCH):
            inference.translate_batch(fwd, rev, images[i:i + BATCH], policy)
    return 2 * (len(images) // BATCH)  # forward + reverse per batch


def hold_against_plain(where: str, name: str, policy, got: np.ndarray,
                       want: torch.Tensor) -> None:
    """Outputs finite, in [0,1], of the plain forward's shape and within
    PATH_TOL of it."""
    want = want.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{where} {name}: bad output {got.shape}")
    if got.min() < 0 or got.max() > 1:
        raise AssertionError(f"{where} {name}: outside [0,1]")
    diff = np.abs(got - want)
    err, mean_err = float(diff.max()), float(diff.mean())
    max_tol, mean_tol = PATH_TOL[policy.compute_dtype][name]
    if err > max_tol or mean_err > mean_tol:
        raise AssertionError(f"{where} {name} {policy.name}: kernels vs plain "
                             f"max error {err:.3e}, mean {mean_err:.3e}")
    print(f"{where} {name} {policy.name}: range [{got.min():.4f}, "
          f"{got.max():.4f}], std {got.std():.4f}, share in "
          f"(0.01, 0.99) {float(((got > 0.01) & (got < 0.99)).mean()):.3f}; "
          f"kernels vs plain max error {err:.3e}, mean {mean_err:.3e}")


def check_outputs(model_dir: Path, images: np.ndarray) -> None:
    """The CLI's batch translate on the card, against the same forward with
    the plain versions, in f32 and bf16; outputs finite and in [0,1]."""
    from discogan_modernized_torch.cli.inference import (load_generators,
                                                         translate_batch)
    from discogan_modernized_torch.core.precision import BF16, F32, configure

    fwd, rev = load_generators(model_dir, "AtoB", SIZE, "cuda")
    x = torch.from_numpy(images[:BATCH]).cuda()
    for policy in (F32, BF16):
        configure(policy)
        gen_np, rec_np = translate_batch(fwd, rev, images[:BATCH], policy)
        want_gen = fwd(x, policy=policy, plain=True)
        want_rec = rev(want_gen, policy=policy, plain=True)
        hold_against_plain(f"CLI batch {BATCH}", "generated", policy, gen_np, want_gen)
        hold_against_plain(f"CLI batch {BATCH}", "reconstructed", policy, rec_np,
                           want_rec)


def check_serve_outputs(model_dir: Path, images: np.ndarray) -> None:
    """The daemon's Translator (batch 1) on the card, against the same
    forward with the plain versions, in f32 and bf16."""
    from discogan_modernized_torch.core.precision import BF16, F32
    from discogan_modernized_torch.tools.serve import Translator

    for policy in (F32, BF16):
        tr = Translator(model_dir, "AtoB", SIZE, precision=policy.name)
        for im in images[:2]:
            x = torch.from_numpy(im[None]).cuda()
            want_gen = tr.fwd(x, policy=policy, plain=True)
            want_rec = tr.rev(want_gen, policy=policy, plain=True)
            hold_against_plain("Translator", "generated", policy,
                               tr.translate(im)[None], want_gen)
            hold_against_plain("Translator", "reconstructed", policy,
                               tr.reconstruct(im)[None], want_rec)
        tr.close()


KERNEL_SYMBOLS = {  # device function name -> the kernel it belongs to
    "conv_k4s2p1_kernel": "K3 conv_k4s2p1", "conv_tc_kernel": "K3 conv_k4s2p1",
    "splitk_epilogue_kernel": "K3 conv_k4s2p1",
    "halo_conv_kernel": "K5f halo_conv_k4s2p1", "halo_tc_kernel": "K5f halo_conv_k4s2p1",
    "bn_act_kernel": "K2 bn_act", "head_convt_kernel": "K6 head_convt"}


def profile_forward(fwd, x, policy) -> None:
    """Device time of one forward by kernel (torch.profiler), and the share
    of the window in which no kernel ran."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(x, policy=policy)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profiler: no device kernels recorded; breakdown not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = spans[-1][1] - spans[0][0]
    by_name = defaultdict(float)
    for e in kernels:
        label = next((v for k, v in KERNEL_SYMBOLS.items() if k in e.name),
                     "other: " + e.name[:70])
        by_name[label] += e.time_range.elapsed_us()
    print(f"profile of one forward: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window (idle share {1 - busy / window:.3f}), "
          f"{len(kernels)} kernels")
    for label, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.4f} ms  {us / busy:6.1%}  {label}")


def time_forward(model_dir: Path, images: np.ndarray, timer, batch: int) -> float:
    """One 512px bf16 forward on the card at ``batch``: CUDA-event ms
    through the kernels and through the plain versions, and its profile."""
    from discogan_modernized_torch.cli.inference import load_generators
    from discogan_modernized_torch.core.precision import BF16, configure

    configure(BF16)
    fwd, _ = load_generators(model_dir, "AtoB", SIZE, "cuda")
    x = torch.from_numpy(images[:batch]).cuda()
    ms = timer.ms(lambda: fwd(x, policy=BF16))
    plain_ms = timer.ms(lambda: fwd(x, policy=BF16, plain=True))
    print(f"forward 512px batch {batch} bf16: {ms:.3f} ms through the kernels, "
          f"{plain_ms:.3f} ms through the plain versions")
    profile_forward(fwd, x, BF16)
    return ms


# -- phase 5: the daemon ---------------------------------------------------

def drive_serve(model_dir: Path, images: np.ndarray):
    """3 translate + 1 reconstruct requests; returns (Translator, forwards)."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.tools.serve import Translator, parse_args, serve

    if not have_pil():
        print("PIL is not installed: driving Translator directly")
        tr = Translator(model_dir, "AtoB", SIZE)
        _build.reset_launches()
        for im in images[:3]:
            tr.translate(im)
        tr.reconstruct(images[3])
        return tr, 5
    from PIL import Image

    srv, tr = serve(parse_args([f"--model_path={model_dir}",
                                f"--image_size={SIZE}", "--port=0"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        bodies = []
        for im in images[:4]:
            buf = io.BytesIO()
            Image.fromarray((im * 255).astype(np.uint8)).save(buf, "PNG")
            bodies.append(buf.getvalue())
        round_trips = []
        _build.reset_launches()
        for body, path in zip(bodies, ["/translate"] * 3 + ["/reconstruct"]):
            req = urllib.request.Request(url + path, data=body,
                                         headers={"Content-Type": "image/png"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                reply = r.read()
            round_trips.append((time.perf_counter() - t0) * 1e3)
            out = np.array(Image.open(io.BytesIO(reply)))
            if out.shape != (SIZE, SIZE, 3):
                raise AssertionError(f"{path}: response of shape {out.shape}")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["device"] != "cuda":
            raise AssertionError(f"daemon not on the card: {health}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("serving thread did not stop")
    print("serve: round trips (ms, host clock, request sent to reply read): "
          + ", ".join(f"{t:.3f}" for t in round_trips) + "; Translator "
          "(forwards + copy back, ms): "
          + ", ".join(f"{t * 1e3:.3f}" for t in tr.latencies))
    return tr, 5


def serve_latency(tr, images: np.ndarray, reps: int = 20) -> None:
    """Translator.translate at batch 1, ``reps`` times from this thread and
    ``reps`` times each from a fresh thread (as ThreadingHTTPServer calls
    it; the Translator hands both to its one worker thread): host-clock p50
    and max of each."""
    def one(im, out):
        t0 = time.perf_counter()
        tr.translate(im)
        out.append((time.perf_counter() - t0) * 1e3)

    same, fresh = [], []
    for i in range(reps):
        one(images[i % len(images)], same)
    for i in range(reps):
        t = threading.Thread(target=one, args=(images[i % len(images)], fresh))
        t.start()
        t.join()
    for where, ts in (("this thread", same), ("fresh threads", fresh)):
        print(f"Translator.translate, {where}: p50 {statistics.median(ts):.3f} ms, "
              f"max {max(ts):.3f} ms over {reps}")


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {kind}")
    print(smi)

    from discogan_modernized_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    phase("kernels against their plain versions")
    timer = Timer()
    results = check_kernels(timer)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        phase("path: inference CLI at 512px")
        rng = np.random.RandomState(0)
        images = rng.rand(2 * BATCH, SIZE, SIZE, 3).astype(np.float32)
        model_dir = work / "model"
        model_dir.mkdir()
        calib = torch.from_numpy(rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)).cuda()
        for seed in (0, 1):
            make_checkpoint(model_dir, seed, calib)
        del calib
        t0 = time.perf_counter()
        _build.reset_launches()
        forwards = drive_cli(model_dir, work, images)
        counts = dict(_build.launches)
        print(f"CLI: {forwards} forwards in {time.perf_counter() - t0:.2f} s "
              "(first batch includes the weights' operand copies)")
        per_forward_check(counts, forwards, "CLI")
        check_outputs(model_dir, images)
        forward_ms = time_forward(model_dir, images, timer, BATCH)
        time_forward(model_dir, images, timer, 1)

        phase("serve at 512px")
        tr, forwards = drive_serve(model_dir, images)
        serve_counts = dict(_build.launches)
        per_forward_check(serve_counts, forwards, "serve")
        stats = tr.stats()
        print(f"serve: {stats['requests']} requests, p50 {stats['p50_ms']:.3f} ms, "
              f"p99 {stats['p99_ms']:.3f} ms")
        serve_latency(tr, images)
        tr.close()
        check_serve_outputs(model_dir, images)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase("report")
    launches = {k: counts[k] + serve_counts[k] for k in counts}
    summary = kernel_summary(results, launches)
    print(f"forward {forward_ms:.3f} ms; the four kernels' phase-3 medians "
          f"(each with L2 evicted) sum to {sum(k['ms'] for k in summary):.3f} ms")
    print(json.dumps({"kernels": summary}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
