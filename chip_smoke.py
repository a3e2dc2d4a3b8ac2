#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: builds the CUDA kernels from
``discogan_modernized_torch/csrc``, holds each against its plain PyTorch
version, drives the 512px serving path through the inference CLI and the
serving daemon, and trains the 512px DiscoGAN through the trainer CLI.

    python3 chip_smoke.py            # one NVIDIA GPU (H100), no arguments

Phases, each fatal on failure (the run then exits non-zero), each timed:
  1. device   CUDA present; the card's name and power limit.
  2. build    nvcc of csrc/*.cu into one library, timed.
  3. kernels  K2/K3/K5f/K6 at every shape of one 512px forward at batch 4
              (the CLI's) and at batch 1 (the daemon's, where K3 takes other
              split-K counts); all seven kernels (K1, K2, K3 with and
              without its statistics, K4, K5f, K5b, K6) at every shape of
              one 512px training step at batch 8; one odd shape each; K3
              (on its wgmma kernels: conv_wgmma_kernel for the deep layers,
              conv_stem_wgmma_kernel for the stem) at enc2..enc6 with and
              without its statistics at batch 1, 4 and 8, and at its edge
              shapes (K3_EDGE: CO 72, M under one 64-row tile, ragged M, a
              split that does not divide the K steps, CI 32 and 96 on the
              FMA kernel, stems of 1, 3 and 4 channels), each call's route
              (conv_plan) asserted, launched once, and with the statistics
              launched twice for the same bits; for K5f's tensor-core path
              enc1 at batch 1, 4 and 8 with and without the epilogue and
              its edge shapes (bands that do not divide the map, strips
              under 64 wide, CO off the 64 tile, CI 16/32/48, non-square
              maps), each with and without it; K4
              (the halving convs' weight gradient) at enc5 and enc6 at
              batch 1 and at its edge shapes (CI 16/32/48 under one channel
              block, CO 72, M under one chunk, a ragged M, enc2 at batch 2
              with a split, stems of 1 and 4 channels), each K4 call
              launched twice for the same bits; K5b (enc1's weight
              gradient) at enc1 at batch 1 and at its edge shapes (CI
              16/32/48 under one channel block, CO 24/72/136 off the 128
              tile, W/2 off a multiple of 8, a ragged M, two images), each
              K5b call launched twice for the same bits; K6 (the head and
              the stems' input gradient) at dec7 at batch 1, 4 and 8 and
              the stem dx at batch 8 on its tensor-core path, and at its
              edge shapes (K6_EDGE: W off a multiple of 16, three strips,
              bands that do not divide H, H 1 and 2, CO 1/3/8, CI
              16/32/48/64/128, a ring of 4 rows), each bf16 call on the
              tensor-core path (head_plan) and counted once; K1 and K2
              at their edge shapes (FUSED_EDGE: C 3 and 24, C 100 at 75
              rows, one row, rows fewer than K1's splits, C 2048 at batch
              1, a ragged last split), every K1 call launched twice for
              the same bits, each K1 and K2 call timed beside x.clone() of
              its input (the practical copy rate). In
              f32 (TF32 off; tolerance 1e-4 of max(1, max|ref|)) and bf16
              (2e-2: the kernel and the plain version round to bf16 at
              different places; statistics 1e-4 in both, from f32 sums of
              exact products on both sides). Kernel, plain and library times
              are CUDA-event medians of 20 warm runs, each after a write
              that evicts L2 and a device sleep that keeps the host's
              launches out of the window; the bound is the larger of bytes over 3.35
              TB/s and flops over the peak of the math's type (989 TFLOP/s
              for bf16 on the tensor cores, 67 for f32).
  4. path     two seeded 512px generators (running statistics calibrated on
              seeded images) saved as gen_A/gen_B_final.pth; the inference
              CLI on 8 seeded PNGs at batch 4; launch counts checked per
              forward (6 K3, 1 K5f, 8 K2, 1 K6); outputs finite, in [0,1],
              and equal to the plain versions' forward in f32 (1e-4), close
              in bf16 (PATH_TOL); the forward timed and profiled at batch 4
              and at batch 1, each profile showing K3's, K5f's and K6's time
              under their tensor-core kernels (conv_wgmma_kernel and
              conv_stem_wgmma_kernel with their split sums,
              halo_wgmma_kernel, head_convt_mma_kernel) and none under their
              FMA ones (nor under a WMMA one for K3), and K2's under
              bn_act_vec_kernel and bn_act_any_kernel (the latent's C of
              100) and none under the kernel they replaced.
  5. serve    the daemon at 512px: 3 /translate and 1 /reconstruct over
              HTTP (through Translator when PIL is missing), p50/p99 and
              each request's round trip; the daemon's Translator held
              against the plain forward at batch 1 in f32 and bf16; its
              latency on the main thread and from fresh threads.
  6. equivalence  one D step and one G step at 512px batch 2 in f32 from
              the same seeded weights, through the kernels and through the
              plain versions, on three seeded batches, under
              torch.use_deterministic_algorithms (cuDNN's and cuBLAS's
              deterministic algorithms): losses within EQUIV_LOSS_REL
              relative, each gradient tensor within EQUIV_GRAD_REL in norm
              or EQUIV_FLOOR_FACTOR times the plain path's own change when
              its images move by one ulp; the readings are printed, with
              the plain path run twice, which must agree bit for bit.
  7. train    the trainer CLI at 512px, batch 8, bf16, slim_state=mv, one
              epoch of the 256-image synthetic task (32 iterations: 11 D,
              21 G), with the launch counts of every D and G step checked
              against PER_STEP, every loss finite, ms per D and per G step
              (CUDA events, median after the first two iterations), img/s
              and peak memory; gen_B_final.pth through the inference CLI;
              a torch.profiler split of one G step, which shows K3's bf16
              time under its wgmma kernels and split sums, K4's under its
              wgmma kernels (conv_dw_wgmma_kernel,
              conv_dw_stem_kernel), K5b's under halo_dw_wgmma_kernel and
              K6's under head_convt_mma_kernel, and none under their FMA
              kernels; K2's as in phase 4 and K1's under its one-launch
              batch_stats_kernel, none under the two kernels it replaced.
  8. report   per-layer lines of K3 (with K5f at enc1) and K6 at their
              main-path shapes against the library call and the bound, and
              of K2 (batch 8, 4 and 1) and K1 (batch 8) with x.clone() of
              the same tensor beside them, with their sums per G step or
              forward;
              one JSON line of kernels, the nvidia-smi line, and the last
              line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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

# cuBLAS reads this when it starts: the equivalence step's deterministic
# mode (phase 6) needs it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
# The port must come from this checkout, never from an installed copy.
sys.path.insert(0, str(ROOT))
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
TRAIN_BATCH = 8
EQUIV_BATCH = 2
EQUIV_SEEDS = (7, 8, 9)  # the equivalence step's batches
# f32 equivalence step, kernels vs plain versions, both under deterministic
# algorithms (the plain path run twice gives the same bits): |loss
# difference| over |loss|, and per gradient tensor ||difference|| / ||g||.
# At batch 2 the gradients hang on LeakyReLU/ReLU masks and on BatchNorm
# over few values per channel, so rounding-level changes move them. On an
# H100 the plain path fed its images moved by one ulp moves them by up to
# 5.5e-3 / 9.1e-3 (D / G step) on the first batch, 1.4e-2 / 2.8e-2 on the
# second and 7.7e-3 / 0.87 on the third; kernels vs plain read 6.2e-3 /
# 1.3e-2, 2.0e-2 / 5.3e-2 and 7.6e-3 / 0.65, at most 1.9 times that
# sensitivity, and up to 1.1 in max |diff| / max |g|. A gradient may differ
# by EQUIV_GRAD_REL (about twice the first batch's worst reading) or by
# EQUIV_FLOOR_FACTOR times its batch's sensitivity, whichever is larger:
# the first batch's limit stays EQUIV_GRAD_REL. Losses agree to 4.4e-5.
EQUIV_LOSS_REL = 1e-4
EQUIV_GRAD_REL = 3e-2
EQUIV_FLOOR_FACTOR = 3
PER_FORWARD = {"conv_k4s2p1": 6, "halo_conv_k4s2p1": 1, "bn_act": 8,
               "head_convt": 1}
# Launches of one 512px training step: 4 generator and 4 discriminator
# forwards (K3 8 stems + 40 with statistics, K5f 8, K1 40, K2 80, K6 4),
# the weight gradients of the 4 forwards the step trains (K4 24, K5b 4),
# and on a G step the stems' input gradients (K6 4).
PER_STEP = {
    "dis": {"conv_k4s2p1": 48, "halo_conv_k4s2p1": 8, "batch_stats": 40,
            "bn_act": 80, "head_convt": 4, "conv_k4s2p1_dw": 24,
            "halo_conv_k4s2p1_dw": 4},
    "gen": {"conv_k4s2p1": 48, "halo_conv_k4s2p1": 8, "batch_stats": 40,
            "bn_act": 80, "head_convt": 8, "conv_k4s2p1_dw": 24,
            "halo_conv_k4s2p1_dw": 4},
}
KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "batch_stats": ("discogan_modernized_torch/csrc/batch_stats.cu",
                    "discogan_modernized_tpu/ops/pallas_fused.py:68"),
    "bn_act": ("discogan_modernized_torch/csrc/bn_act.cu",
               "discogan_modernized_tpu/ops/pallas_fused.py:122"),
    "conv_k4s2p1": ("discogan_modernized_torch/csrc/conv_k4s2p1.cu",
                    "discogan_modernized_tpu/ops/pallas_conv.py:184"),
    "conv_k4s2p1_dw": ("discogan_modernized_torch/csrc/conv_k4s2p1_dw.cu",
                       "discogan_modernized_tpu/ops/pallas_conv.py:245"),
    "halo_conv_k4s2p1": ("discogan_modernized_torch/csrc/halo_conv_k4s2p1.cu",
                         "discogan_modernized_tpu/ops/pallas_halo_conv.py:158"),
    "halo_conv_k4s2p1_dw": ("discogan_modernized_torch/csrc/halo_conv_k4s2p1_dw.cu",
                            "discogan_modernized_tpu/ops/pallas_halo_conv.py:230"),
    "head_convt": ("discogan_modernized_torch/csrc/head_convt.cu",
                   "discogan_modernized_tpu/ops/pallas_head.py:198"),
}
SERVING_KERNELS = ("bn_act", "conv_k4s2p1", "halo_conv_k4s2p1", "head_convt")
KIND_KERNEL = {"conv_stats": "conv_k4s2p1"}  # case kind -> kernel, where they differ


_phase_start = [None, None]


def phase(name):
    """Print the previous phase's duration, then this phase's header."""
    now = time.perf_counter()
    if _phase_start[0] is not None:
        print(f"-- {_phase_start[0]}: {now - _phase_start[1]:.1f} s", flush=True)
    _phase_start[:] = [name, now]
    print(f"\n== {name}", flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

class Timer:
    """CUDA-event medians with L2 evicted before each timed run, by a write
    of 96 MB (or with ``clean``, a read of it, which leaves no dirty lines
    for the timed call to write back). A device sleep (about 0.1 ms) before
    the start event lets the host enqueue the call while the device waits,
    so a call of a few small kernels is timed on the device and not on the
    host's launch path."""

    SLEEP_CYCLES = 200_000

    def __init__(self, reps: int = 20, clean: bool = False):
        self.reps = reps
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
        self.evict = self.flush.amax if clean else self.flush.zero_

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.evict()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """dtype: the type of the math (bf16 on the tensor cores, or f32)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# -- phase 3: kernels against their plain versions ---------------------------

CHANS = [64, 128, 256, 512, 1024, 2048, 2048]
DEC_CHANS = [2048, 2048, 1024, 512, 256, 128, 64]
# K5f's tensor-core edge shapes (n, h, w, ci, co): bands that do not divide
# the map (29 rows in bands of 2, 23 in bands of 6) or hold an odd count (3),
# strips under 64 wide (20; 100 = 64 + 36; 150 = 64 + 64 + 22), CO off the
# 64 tile (72, 24, 136), CI 16/32/48, non-square maps.
K5F_EDGE = [(4, 58, 40, 32, 72), (8, 46, 256, 32, 128), (8, 24, 256, 16, 128),
            (2, 24, 200, 16, 24), (1, 20, 300, 64, 136), (3, 10, 6, 48, 16)]
# K4's edge shapes (label, (n, h, w, ci, co)): CI 16/32/48 under one 64-channel
# block, CO off the 128 tile (72), M under one 64-pixel chunk (enc6 at batch
# 1: 16 pixels), a ragged M (105 pixels) on a map 5 wide, enc2 at batch 2
# with its split over M, stems of 1 and 4 channels.
K4_EDGE = [("ci16", (2, 16, 16, 16, 64)), ("ci32", (2, 32, 32, 32, 64)),
           ("ci48 co72", (3, 16, 16, 48, 72)), ("enc6 b1", (1, 8, 8, 2048, 2048)),
           ("enc5 b1", (1, 16, 16, 1024, 2048)), ("ragged M", (3, 14, 10, 16, 72)),
           ("enc2 b2", (2, 128, 128, 128, 256)), ("stem ci1", (2, 16, 16, 1, 8)),
           ("stem ci4", (2, 32, 32, 4, 72))]
# K5b's edge shapes (label, (n, h, w, ci, co)): CI 16/32/48 under one
# 64-channel block, CO off the 128 tile (24, 72, 136), W/2 not a multiple of
# 8 (the windows, 20 wide; 11 in "odd 14x22"), a ragged M (a last part
# shorter than the other and a last chunk of 8 pixels), two images.
K5B_EDGE = [("ci16", (2, 64, 64, 16, 128)), ("ci32 co72", (1, 48, 256, 32, 72)),
            ("ci48 co136", (2, 40, 128, 48, 136)), ("co24", (2, 128, 128, 64, 24)),
            ("w/2 20", (3, 30, 40, 16, 72)), ("ragged M", (1, 10, 208, 64, 128)),
            ("b2", (2, 256, 256, 64, 128))]

# K3's edge shapes (label, (n, h, w, ci, co)), each with the epilogue and
# with the statistics: CO 72 (off the 128 tile; split, and unsplit at 16
# images), M under one 64-row tile (enc6 at batch 1: 16 pixels), a ragged M
# (105 pixels split; 8649 unsplit), a split that does not divide the K
# steps (64 in 13 parts), CI 32 and 96 (the FMA kernel), stems of 1, 3 and 4
# channels (tests/test_torch_conv_plan.py holds the plans).
K3_EDGE = [("co72", (2, 16, 16, 64, 72)), ("co72 b16", (16, 64, 64, 64, 72)),
           ("m16", (1, 8, 8, 2048, 2048)), ("ragged M", (3, 14, 10, 64, 128)),
           ("ragged M b9", (9, 62, 62, 64, 128)), ("split 13", (5, 32, 32, 256, 128)),
           ("ci32", (2, 32, 32, 32, 64)), ("ci96", (2, 6, 10, 96, 136)),
           ("stem ci1", (2, 16, 16, 1, 64)), ("stem ci3", (3, 14, 10, 3, 64)),
           ("stem ci4", (2, 32, 32, 4, 128))]

# K6's tensor-core edge shapes (label, (n, h, w, ci, co)): W off a multiple
# of 16 (24, 40), three strips of 128 columns (300: the last 44 wide), bands
# that do not divide H (10 rows in bands of 3, 58 in bands of 10), H 1, 2
# and 6, CO 1, 3 and 8, CI 16/32/48/64/128 (CI 128 with CO 8 on a ring of 4
# rows), batch 1 and 2 (tests/test_torch_head_plan.py holds the plans).
K6_EDGE = [("w24", (2, 10, 24, 64, 3)), ("w40 co1", (1, 6, 40, 16, 1)),
           ("w300", (1, 8, 300, 32, 3)), ("h10 bands", (60, 10, 24, 64, 3)),
           ("h58 bands", (40, 58, 40, 16, 3)), ("h6 ci48", (2, 6, 40, 48, 3)),
           ("h1", (2, 1, 256, 64, 3)), ("h2 co8", (2, 2, 128, 64, 8)),
           ("ci32 co8", (24, 16, 40, 32, 8)), ("ci128", (1, 16, 256, 128, 3)),
           ("ci128 co8", (30, 20, 40, 128, 8))]


# K1's and K2's edge shapes (label, (n, h, w, c)), each case of both: C 3
# (bf16 and f32 off the 16-byte vectors: the general path, 315 elements, a
# scalar tail) and 24 (three vectors a row: a grid in multiples of 3 blocks),
# C 100 at 75 rows (bf16 general path, f32 25 vectors a row), one row, rows
# fewer than K1's target splits, C 2048 at batch 1 (enc6/dec0), a ragged
# last split (tests/test_torch_fused_plan.py holds the plans).
FUSED_EDGE = [("c3 odd", (3, 5, 7, 3)), ("c24", (2, 5, 7, 24)),
              ("odd 75 rows", (3, 5, 5, 100)), ("one row", (1, 1, 1, 256)),
              ("100 rows", (1, 10, 10, 64)), ("c2048 b1", (1, 4, 4, 2048)),
              ("ragged", (3, 37, 41, 128))]


def kernel_cases():
    """(kind, label, shape args, path, calls per G step) for every call:
    path "cli" for one 512px forward at batch 4, "serve" for one at batch 1
    (the daemon's), "train" for one training step at batch 8, None for the
    odd shapes. The calls per G step count a "train" case's shape in one G
    step (4 generator and 4 discriminator forwards, the generators' weight
    gradients, the stems' input gradients)."""
    cases = []
    for batch, path in ((BATCH, "cli"), (1, "serve")):
        tag = "" if path == "cli" else " b1"
        h, ci = SIZE, 3
        for i, co in enumerate(CHANS):
            kernel = "halo_conv_k4s2p1" if i == 1 else "conv_k4s2p1"
            cases.append((kernel, f"enc{i}{tag}",
                          (batch, h, h, ci, co, i > 0, "leaky"), path, 0))
            h, ci = h // 2, co
        cases.append(("bn_act", f"latent{tag}", (batch, 1, 1, 100, "leaky"), path, 0))
        h = 4
        for j, c in enumerate(DEC_CHANS):
            cases.append(("bn_act", f"dec{j}{tag}", (batch, h, h, c, "relu"), path, 0))
            h *= 2
        cases.append(("head_convt", f"dec7{tag}", (batch, 256, 256, 64, 3), path, 0))

    b, tr = TRAIN_BATCH, "train"
    cases.append(("conv_k4s2p1", "enc0 t", (b, SIZE, SIZE, 3, 64, False, "leaky"), tr, 8))
    cases.append(("halo_conv_k4s2p1", "enc1 t", (b, 256, 256, 64, 128, False, None), tr, 8))
    h, ci = 128, 128
    for i, co in enumerate(CHANS[2:], start=2):
        cases.append(("conv_stats", f"enc{i} t", (b, h, h, ci, co), tr, 8))
        h, ci = h // 2, co
    h = 128
    for i, c in enumerate(CHANS[1:], start=1):  # after enc1..enc6
        cases.append(("bn_act", f"enc{i} t", (b, h, h, c, "leaky"), tr, 8))
        h //= 2
    stats_shapes = [("enc1", (b, 128, 128, 128), 8), ("latent", (b, 1, 1, 100), 4)]
    cases.append(("bn_act", "latent t", (b, 1, 1, 100, "leaky"), tr, 4))
    h = 4
    for j, c in enumerate(DEC_CHANS):
        cases.append(("bn_act", f"dec{j} t", (b, h, h, c, "relu"), tr, 4))
        stats_shapes.append((f"dec{j}", (b, h, h, c), 4))
        h *= 2
    for label, shape, calls in stats_shapes:
        cases.append(("batch_stats", f"{label} t", shape, tr, calls))
    # the head's forward per generator forward, and the discriminators'
    # stems' input gradient (a convT of the same shape)
    cases.append(("head_convt", "dec7 t", (b, 256, 256, 64, 3), tr, 4))
    cases.append(("head_convt", "stem dx t", (b, 256, 256, 64, 3), tr, 4))
    h, ci = SIZE, 3
    for i, co in enumerate(CHANS):
        if i == 1:
            cases.append(("halo_conv_k4s2p1_dw", "enc1 dw", (b, h, h, ci, co), tr, 4))
        else:
            cases.append(("conv_k4s2p1_dw", f"enc{i} dw", (b, h, h, ci, co), tr, 4))
        h, ci = h // 2, co

    # K3 at every layer with and without its statistics at batch 1, 4 and 8
    # (the paths above hold the other halves), and its edge shapes
    h, ci = 128, 128
    for i, co in enumerate(CHANS[2:], start=2):
        for batch in (1, 4):
            cases.append(("conv_stats", f"enc{i} b{batch} st", (batch, h, h, ci, co), None, 0))
        cases.append(("conv_k4s2p1", f"enc{i} b8 ep", (b, h, h, ci, co, True, "leaky"), None, 0))
        h, ci = h // 2, co
    for label, (n, h, w, ci, co) in K3_EDGE:
        cases.append(("conv_k4s2p1", label, (n, h, w, ci, co, True, "leaky"), None, 0))
        cases.append(("conv_stats", label + " st", (n, h, w, ci, co), None, 0))

    for label, shape in FUSED_EDGE:
        cases.append(("bn_act", label, (*shape, "leaky"), None, 0))
        cases.append(("batch_stats", label, shape, None, 0))
    cases += [
        ("conv_k4s2p1", "odd 6x10", (3, 6, 10, 16, 72, True, "leaky"), None, 0),
        ("halo_conv_k4s2p1", "odd 14x22", (3, 14, 22, 8, 24, True, "leaky"), None, 0),
        ("halo_conv_k4s2p1", "enc1 b1 raw", (1, 256, 256, 64, 128, False, None), None, 0),
        ("halo_conv_k4s2p1", "enc1 b4 raw", (4, 256, 256, 64, 128, False, None), None, 0),
        ("halo_conv_k4s2p1", "enc1 b8 ep", (8, 256, 256, 64, 128, True, "leaky"), None, 0),
        *[("halo_conv_k4s2p1", f"odd {h}x{w}{' raw' if not affine else ''}",
           (n, h, w, ci, co, affine, "leaky" if affine else None), None, 0)
          for n, h, w, ci, co in K5F_EDGE for affine in (True, False)],
        ("head_convt", "odd 40x24", (1, 40, 24, 8, 3), None, 0),
        *[("head_convt", label, shape, None, 0) for label, shape in K6_EDGE],
        ("conv_stats", "odd 6x10", (3, 6, 10, 16, 72), None, 0),
        ("conv_k4s2p1_dw", "odd 6x10", (3, 6, 10, 16, 72), None, 0),
        *[("conv_k4s2p1_dw", label, shape, None, 0) for label, shape in K4_EDGE],
        ("halo_conv_k4s2p1_dw", "odd 14x22", (3, 14, 22, 8, 24), None, 0),
        ("halo_conv_k4s2p1_dw", "enc1 dw b1", (1, 256, 256, 64, 128), None, 0),
        *[("halo_conv_k4s2p1_dw", label, shape, None, 0) for label, shape in K5B_EDGE],
    ]
    return cases


def run_case(kernel, args, dtype, timer, g):
    from torch.nn import grad as nn_grad

    from discogan_modernized_torch.ops.conv_k4s2p1 import (
        conv2d_k4s2p1, conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain,
        conv2d_k4s2p1_plain, conv_plan)
    from discogan_modernized_torch.ops.fused import (
        batch_stats, batch_stats_plain, bn_act, bn_act_plain)
    from discogan_modernized_torch.ops.halo_conv import (
        halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain,
        halo_conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.head import (head_convt, head_convt_plain,
                                                    head_plan)

    dev = "cuda"
    size = torch.finfo(dtype).bits // 8

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    math_dtype = dtype
    stats_tol = None  # tolerance of the statistics outputs, where there are some
    copy = None  # x.clone(), the practical copy rate, beside K1 and K2
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
        copy = lambda: x.clone()  # noqa: E731
    elif kernel == "batch_stats":
        x = (rand(*args) + 0.5).to(dtype)
        c = args[-1]
        kern = lambda: batch_stats(x)  # noqa: E731
        plain = lambda: batch_stats_plain(x)  # noqa: E731
        lib = lambda: torch.var_mean(x.view(-1, c), dim=0, correction=0)  # noqa: E731
        flops, nbytes = 3 * x.numel(), x.numel() * size + 8 * c
        math_dtype, stats_tol = torch.float32, 1e-4
        copy = lambda: x.clone()  # noqa: E731
    elif kernel in ("conv_k4s2p1", "halo_conv_k4s2p1", "conv_stats"):
        if kernel == "conv_stats":
            n, h, w, ci, co = args
            affine, act = False, None
        else:
            n, h, w, ci, co, affine, act = args
        x = rand(n, h, w, ci)
        wt = rand(4, 4, ci, co, scale=(16 * ci) ** -0.5)
        s = torch.rand(co, device=dev, generator=g) + 0.5 if affine else None
        o = torch.randn(co, device=dev, generator=g) * 0.1 if affine else None
        fn, plain_fn = ((halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain)
                        if kernel == "halo_conv_k4s2p1" else
                        (conv2d_k4s2p1, conv2d_k4s2p1_plain))
        if kernel != "halo_conv_k4s2p1" and dtype == torch.bfloat16:  # K3's route
            want = "wgmma_stem" if ci <= 4 else "wgmma" if ci % 64 == 0 else "fma"
            assert conv_plan(n, h, w, ci, co, dtype).path == want
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
        m = n * (h // 2) * (w // 2)
        flops = 2 * m * 16 * ci * co
        nbytes = (x.numel() + wt.numel() + m * co) * size + (8 * co if affine else 0)
        if kernel == "conv_stats":
            kern = lambda: fn(x, wt, with_stats=True)  # noqa: E731
            plain = lambda: plain_fn(x, wt, with_stats=True)  # noqa: E731

            def lib():
                y = F.conv2d(x_nchw, w_oihw, stride=2, padding=1)
                return torch.var_mean(y, dim=(0, 2, 3), correction=0)
            flops += 3 * m * co
            nbytes += 8 * co
            stats_tol = 1e-4
        else:
            kern = lambda: fn(x, wt, scale=s, offset=o, act=act)  # noqa: E731
            plain = lambda: plain_fn(x, wt, scale=s, offset=o, act=act)  # noqa: E731
            lib = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)  # noqa: E731
    elif kernel in ("conv_k4s2p1_dw", "halo_conv_k4s2p1_dw"):
        n, h, w, ci, co = args
        x = rand(n, h, w, ci)
        dy = rand(n, h // 2, w // 2, co, scale=0.1)
        fn, plain_fn = ((conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain)
                        if kernel == "conv_k4s2p1_dw" else
                        (halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain))
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        kern = lambda: fn(x, dy)  # noqa: E731
        plain = lambda: plain_fn(x, dy)  # noqa: E731
        lib = lambda: nn_grad.conv2d_weight(x_nchw, (co, ci, 4, 4), dy_nchw,  # noqa: E731
                                            stride=2, padding=1)
        flops = 2 * dy.numel() * 16 * ci
        nbytes = (x.numel() + dy.numel() + 16 * ci * co) * size
    else:
        n, h, w, ci, co = args
        x = rand(n, h, w, ci)
        wt = rand(4, 4, ci, co, scale=(16 * co) ** -0.5)
        if dtype == torch.bfloat16 and ci % 16 == 0:  # the tensor-core path
            assert head_plan(n, h, w, ci, co, dtype) is not None
        x_nchw, w_iohw = x.permute(0, 3, 1, 2), wt.permute(2, 3, 0, 1).contiguous()
        kern = lambda: head_convt(x, wt)  # noqa: E731
        plain = lambda: head_convt_plain(x, wt)  # noqa: E731
        lib = lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2, padding=1)  # noqa: E731
        flops = 2 * n * h * w * 16 * ci * co
        nbytes = (x.numel() + wt.numel() + 4 * n * h * w * co) * size

    counted = KIND_KERNEL.get(kernel, kernel)
    before = _build.launches[counted]
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if counted in ("head_convt", "conv_k4s2p1") and _build.launches[counted] != before + 1:
        raise AssertionError(f"{counted} {args}: {_build.launches[counted] - before} "
                             "launches for one call")
    if kernel.endswith("_dw") and not torch.equal(got, kern()):
        raise AssertionError(f"{kernel} {args} {DTYPE_NAMES[dtype]}: two launches "
                             "gave different bits")
    if kernel == "batch_stats" and not all(torch.equal(a, b) for a, b in zip(got, kern())):
        raise AssertionError(f"batch_stats {args} {DTYPE_NAMES[dtype]}: two launches "
                             "gave different bits")
    if kernel == "conv_stats":
        again = kern()
        if not all(torch.equal(a, b) for a, b in zip((got[0], *got[1]),
                                                     (again[0], *again[1]))):
            raise AssertionError(f"conv_stats {args} {DTYPE_NAMES[dtype]}: two launches "
                                 "gave different bits")
    # (output, tolerance) pairs: y, and the statistics where there are some
    if kernel == "conv_stats":
        pairs = [(got[0], want[0], TOL[dtype]),
                 *[(a, b, stats_tol) for a, b in zip(got[1], want[1])]]
    elif kernel == "batch_stats":
        pairs = [(a, b, stats_tol) for a, b in zip(got, want)]
    else:
        pairs = [(got, want, TOL[dtype])]
    err = 0.0
    for a, b, tol in pairs:
        e = (a.float() - b.float()).abs().max().item()
        limit = tol * max(1.0, b.float().abs().max().item())
        if not (e <= limit) or a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{kernel} {args} {DTYPE_NAMES[dtype]}: max error "
                                 f"{e:.3e} > {limit:.3e}")
        err = max(err, e)
    bound, by = bound_ms(flops, nbytes, math_dtype)
    out = {"err": err, "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": bound, "bound_by": by,
           "flops": flops, "bytes": nbytes}
    if copy is not None:
        out["clone_ms"] = timer.ms(copy)
    return out


def check_kernels(timer):
    from discogan_modernized_torch.core.precision import BF16, F32, configure

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    print(f"{'kernel':18} {'case':12} {'dtype':5} {'max_err':>10} {'ms':>9} "
          f"{'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}  bound_by")
    for policy in (F32, BF16):
        configure(policy)
        dtype = policy.compute_dtype
        for kernel, label, args, path, calls in kernel_cases():
            r = run_case(kernel, args, dtype, timer, g)
            results[(KIND_KERNEL.get(kernel, kernel), label, dtype)] = dict(
                r, path=path, calls=calls)
            print(f"{kernel:18} {label:12} {DTYPE_NAMES[dtype]:5} "
                  f"{r['err']:10.3e} {r['ms']:9.4f} {r['plain_ms']:9.4f} "
                  f"{r['library_ms']:9.4f} {r['bound_ms']:9.4f}  {r['bound_by']}",
                  flush=True)
    return results


def _sums(rows, weight):
    """Time, plain, bound and library sums over bf16 case rows, each row
    counted ``weight(row)`` times; and what bounds the sum."""
    t_ops = sum(weight(v) * v["flops"] / PEAK_FLOPS[torch.bfloat16] for v in rows)
    t_bytes = sum(weight(v) * v["bytes"] / HBM_BYTES_PER_S for v in rows)
    return ({key: sum(weight(v) * v[key] for v in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "operations" if t_ops >= t_bytes else "bytes")


def per_layer_lines(results) -> None:
    """bf16 ms per call, kernel vs library vs bound: K3 at every layer of
    the batch-8 training forward (enc1 on K5f), and K6 at its main-path
    shapes."""
    rows = [("K3 batch 8", [(k[1].split()[0], v) for k, v in results.items()
                            if k[2] == torch.bfloat16 and v["path"] == "train"
                            and k[0] in ("conv_k4s2p1", "halo_conv_k4s2p1")]),
            ("K6", [(k[1], v) for k, v in results.items()
                    if k[2] == torch.bfloat16 and k[0] == "head_convt" and v["path"]])]
    for what, cases in rows:
        print(f"{what} (ms: kernel / library / bound): " + "; ".join(
            f"{label} {v['ms']:.4f} / {v['library_ms']:.4f} / {v['bound_ms']:.4f}"
            for label, v in cases))
    # K1 and K2, with x.clone() of the same tensor as the practical copy rate
    for what, kernel, path in (("K2 batch 8", "bn_act", "train"),
                               ("K2 batch 4", "bn_act", "cli"),
                               ("K2 batch 1", "bn_act", "serve"),
                               ("K1 batch 8", "batch_stats", "train")):
        cases = [(k[1].split()[0], v) for k, v in results.items()
                 if k[2] == torch.bfloat16 and k[0] == kernel and v["path"] == path]
        print(f"{what} (ms: kernel / library / bound / clone): " + "; ".join(
            f"{label} {v['ms']:.4f} / {v['library_ms']:.4f} / {v['bound_ms']:.4f} / "
            f"{v['clone_ms']:.4f}" for label, v in cases))
        weight = (lambda v: v["calls"]) if path == "train" else (lambda v: 1)
        total = {key: sum(weight(v) * v[key] for _, v in cases)
                 for key in ("ms", "library_ms", "bound_ms", "clone_ms")}
        print(f"{what} summed over one {'G step' if path == 'train' else 'forward'} "
              f"(ms): kernel {total['ms']:.4f}, library {total['library_ms']:.4f}, "
              f"bound {total['bound_ms']:.4f}, clone {total['clone_ms']:.4f}")


def kernel_summary(results, launches):
    """Per kernel, in bf16 (the card's default): for the serving kernels,
    the times summed over the calls of one 512px batch-4 forward (and the
    kernel ms of one batch-1 forward); for the training-only kernels (K1,
    K4, K5b), summed over the calls of one 512px batch-8 G step. Every
    kernel also carries its G-step sums (train_step_*). With the largest
    bf16 and f32 errors, and the launches of every path run."""
    out = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = {k: v for k, v in results.items() if k[0] == name}
        bf16 = [v for k, v in rows.items() if k[2] == torch.bfloat16]
        train, by_train = _sums([v for v in bf16 if v["path"] == "train"],
                                lambda v: v["calls"])
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(launches[name].values()),
                 "launches_by_path": launches[name],
                 "max_abs_err": max(v["err"] for v in bf16),
                 "max_abs_err_f32": max(v["err"] for k, v in rows.items()
                                        if k[2] == torch.float32)}
        if name in SERVING_KERNELS:
            cli = [v for v in bf16 if v["path"] == "cli"]
            serve, by = _sums(cli, lambda v: 1)
            entry.update(serve, bound_by=by, calls_per_forward=len(cli),
                         ms_batch1=sum(v["ms"] for v in bf16 if v["path"] == "serve"))
        else:
            entry.update(train, bound_by=by_train)
        entry.update({f"train_step_{k}": v for k, v in train.items()},
                     train_step_bound_by=by_train,
                     calls_per_g_step=PER_STEP["gen"][name])
        out.append(entry)
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
    counts = {k: v for k, v in counts.items() if v}
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
        src.mkdir(parents=True)
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
    "batch_stats_kernel": "K1 batch_stats",
    "conv_k4s2p1_kernel": "K3 conv_k4s2p1", "conv_wgmma_kernel": "K3 conv_k4s2p1",
    "conv_stem_wgmma_kernel": "K3 conv_k4s2p1",
    "splitk_epilogue_kernel": "K3 conv_k4s2p1",
    "splitk_stats_epilogue_kernel": "K3 conv_k4s2p1",
    "conv_stats_finalize_kernel": "K3 conv_k4s2p1",
    "conv_dw_kernel": "K4 conv_k4s2p1_dw", "conv_dw_wgmma_kernel": "K4 conv_k4s2p1_dw",
    "conv_dw_stem_kernel": "K4 conv_k4s2p1_dw", "conv_dw_reduce_kernel": "K4 conv_k4s2p1_dw",
    "halo_conv_kernel": "K5f halo_conv_k4s2p1", "halo_wgmma_kernel": "K5f halo_conv_k4s2p1",
    "halo_dw_kernel": "K5b halo_conv_k4s2p1_dw",
    "halo_dw_wgmma_kernel": "K5b halo_conv_k4s2p1_dw",
    "halo_dw_reduce_kernel": "K5b halo_conv_k4s2p1_dw",
    "bn_act_vec_kernel": "K2 bn_act", "bn_act_any_kernel": "K2 bn_act",
    "head_convt_kernel": "K6 head_convt",
    "head_convt_mma_kernel": "K6 head_convt"}
# Library kernels (cuDNN convolutions and their gradients, cuBLAS products)
LIBRARY_MARKERS = ("cudnn", "xmma", "gemm", "cutlass", "sm90_", "sm80_",
                   "convolve", "dgrad", "wgrad", "implicit_convolve")


def kernel_label(name: str) -> str:
    label = next((v for k, v in KERNEL_SYMBOLS.items() if k in name), None)
    if label is not None:
        return label
    if any(m in name.lower() for m in LIBRARY_MARKERS):
        return "library: " + name[:60]
    return "other: " + name[:60]


def profile_forward(fwd, x, policy) -> dict:
    """Device time of one forward by kernel (torch.profiler), and the share
    of the window in which no kernel ran; returns us by kernel name."""
    return profile_call(lambda: fwd(x, policy=policy), "one forward")


K5F_TC_KERNEL = "halo_wgmma_kernel"


def check_k5f_route(by_kernel: dict, what: str) -> None:
    """The profile shows K5f's time under its tensor-core kernel and none
    under the FMA one: the bf16 main path takes the tensor cores."""
    tc = sum(us for name, us in by_kernel.items() if K5F_TC_KERNEL in name)
    fma = sum(us for name, us in by_kernel.items() if "halo_conv_kernel" in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K5f {tc:.1f} us under {K5F_TC_KERNEL}, "
                             f"{fma:.1f} us under halo_conv_kernel")
    print(f"{what}: K5f {tc / 1e3:.4f} ms under {K5F_TC_KERNEL}, none under "
          "halo_conv_kernel")


K3_TC_KERNELS = ("conv_wgmma_kernel", "conv_stem_wgmma_kernel")
K3_SPLIT_KERNELS = ("splitk_epilogue_kernel", "splitk_stats_epilogue_kernel",
                    "conv_stats_finalize_kernel")
# K3's FMA kernel, and the WMMA kernel its bf16 path ran before the wgmma one
K3_OFF_ROUTE = ("conv_k4s2p1_kernel", "conv_tc_kernel")


def check_k3_route(by_kernel: dict, what: str) -> None:
    """The profile shows K3's time under its wgmma kernels (the deep layers'
    and the stem's) and their split sums, and none under the FMA kernel or a
    WMMA one: every bf16 K3 call of the path takes the tensor cores."""
    tc = {k: sum(us for name, us in by_kernel.items() if k in name) for k in K3_TC_KERNELS}
    sums = sum(us for name, us in by_kernel.items()
               if any(k in name for k in K3_SPLIT_KERNELS))
    off = {k: sum(us for name, us in by_kernel.items() if k in name) for k in K3_OFF_ROUTE}
    if not all(us > 0 for us in tc.values()) or any(us > 0 for us in off.values()):
        raise AssertionError(f"{what}: K3 {tc} us under its wgmma kernels, {off} us off "
                             "their route")
    print(f"{what}: K3 " + ", ".join(f"{us / 1e3:.4f} ms under {k}" for k, us in tc.items())
          + f" and {sums / 1e3:.4f} ms under its split sums and statistics, none under "
          + " or ".join(K3_OFF_ROUTE))


K4_TC_KERNELS = ("conv_dw_wgmma_kernel", "conv_dw_stem_kernel")

# K2's kernels: channels kept per thread (C a multiple of the 16-byte
# vector: every main-path call but bf16's latent), and the general one (the
# latent's C of 100); K1's one-launch kernel; the kernels they replaced.
K2_KERNELS = ("bn_act_vec_kernel", "bn_act_any_kernel")
K1_KERNEL = "batch_stats_kernel"
FUSED_OFF_ROUTE = ("bn_act_kernel", "batch_stats_partial_kernel",
                   "batch_stats_finalize_kernel")


def check_fused_route(by_kernel: dict, what: str, stats: bool) -> None:
    """The profile shows K2's time under its kernels (the vector kernel's
    and, for bf16's latent, the general one's), with ``stats`` K1's under
    its one-launch kernel, and none under the kernels they replaced."""
    got = {k: sum(us for name, us in by_kernel.items() if k in name)
           for k in K2_KERNELS + ((K1_KERNEL,) if stats else ())}
    off = {k: sum(us for name, us in by_kernel.items() if k in name) for k in FUSED_OFF_ROUTE}
    if not all(us > 0 for us in got.values()) or any(us > 0 for us in off.values()):
        raise AssertionError(f"{what}: K1/K2 {got} us under their kernels, {off} us under "
                             "the ones they replaced")
    print(f"{what}: " + ", ".join(f"{us / 1e3:.4f} ms under {k}" for k, us in got.items())
          + ", none under " + " or ".join(FUSED_OFF_ROUTE))


K6_TC_KERNEL = "head_convt_mma_kernel"


def check_k6_route(by_kernel: dict, what: str) -> None:
    """The profile shows K6's time under its tensor-core kernel and none
    under the FMA one: every bf16 K6 call of the path (the head, and in a G
    step the stems' input gradient) takes the tensor cores."""
    tc = sum(us for name, us in by_kernel.items() if K6_TC_KERNEL in name)
    fma = sum(us for name, us in by_kernel.items() if "head_convt_kernel" in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K6 {tc:.1f} us under {K6_TC_KERNEL}, "
                             f"{fma:.1f} us under head_convt_kernel")
    print(f"{what}: K6 {tc / 1e3:.4f} ms under {K6_TC_KERNEL}, none under "
          "head_convt_kernel")


def check_k4_route(by_kernel: dict, what: str) -> None:
    """The profile shows K4's time under its wgmma kernels (and its split
    sums) and none under the FMA one: every bf16 K4 call of the training
    step takes the tensor cores."""
    tc = {k: sum(us for name, us in by_kernel.items() if k in name) for k in K4_TC_KERNELS}
    fma = sum(us for name, us in by_kernel.items() if "conv_dw_kernel" in name)
    if not all(us > 0 for us in tc.values()) or fma > 0:
        raise AssertionError(f"{what}: K4 {tc} us under its wgmma kernels, "
                             f"{fma:.1f} us under conv_dw_kernel")
    print(f"{what}: K4 " + ", ".join(f"{us / 1e3:.4f} ms under {k}" for k, us in tc.items())
          + ", none under conv_dw_kernel")


K5B_TC_KERNEL = "halo_dw_wgmma_kernel"


def check_k5b_route(by_kernel: dict, what: str) -> None:
    """The profile shows K5b's time under its wgmma kernel (and its split
    sums) and none under the FMA one: every bf16 K5b call of the training
    step takes the tensor cores."""
    tc = sum(us for name, us in by_kernel.items() if K5B_TC_KERNEL in name)
    sums = sum(us for name, us in by_kernel.items() if "halo_dw_reduce_kernel" in name)
    fma = sum(us for name, us in by_kernel.items() if "halo_dw_kernel" in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K5b {tc:.1f} us under {K5B_TC_KERNEL}, "
                             f"{fma:.1f} us under halo_dw_kernel")
    print(f"{what}: K5b {tc / 1e3:.4f} ms under {K5B_TC_KERNEL} and {sums / 1e3:.4f} ms "
          "under its split sums, none under halo_dw_kernel")


def profile_call(fn, what: str, top: int = 12, ops: int = 0) -> dict:
    """Device time of ``fn()`` by kernel (torch.profiler), the share of the
    window in which no kernel ran, and the split into the port's kernels,
    library kernels and the rest; with ``ops``, also the PyTorch operators
    that launched the most device time. Returns us by kernel name (empty
    where the profiler recorded no device kernels)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profiler: no device kernels recorded; breakdown not measured")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = spans[-1][1] - spans[0][0]
    by_name, by_kernel = defaultdict(float), defaultdict(float)
    for e in kernels:
        by_name[kernel_label(e.name)] += e.time_range.elapsed_us()
        by_kernel[e.name] += e.time_range.elapsed_us()
    print(f"profile of {what}: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window (idle share {1 - busy / window:.3f}), "
          f"{len(kernels)} kernels")
    groups = defaultdict(float)
    for label, us in by_name.items():
        groups["port kernels" if label[0] == "K" else label.split(":")[0]] += us
    print("  split: " + ", ".join(f"{g} {us / 1e3:.3f} ms ({us / busy:.1%})"
                                  for g, us in sorted(groups.items())))
    for label, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.4f} ms  {us / busy:6.1%}  {label}")
    if ops:
        rows = [e for e in prof.key_averages()
                if e.key.startswith("aten::") and e.self_device_time_total > 0]
        rows.sort(key=lambda e: -e.self_device_time_total)
        print("  PyTorch operators by the device time of the kernels they launched:")
        for e in rows[:ops]:
            print(f"  {e.self_device_time_total / 1e3:9.4f} ms  "
                  f"{e.self_device_time_total / busy:6.1%}  {e.key} x{e.count}")
    return dict(by_kernel)


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
    # The profiler now and then keeps only the tail of a short window (a
    # batch-1 forward's trace once held 18 of its 39 kernels): profile
    # again, up to three times, until the trace holds a K5f and a K6 kernel.
    for _ in range(3):
        by_kernel = profile_forward(fwd, x, BF16)
        if all(any(k in name for name in by_kernel) for k in ("halo_", "head_convt")):
            break
        print("the profile holds no K5f or no K6 kernel; profiling again")
    check_k3_route(by_kernel, f"forward batch {batch}")
    check_k5f_route(by_kernel, f"forward batch {batch}")
    check_k6_route(by_kernel, f"forward batch {batch}")
    check_fused_route(by_kernel, f"forward batch {batch}", stats=False)
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


# -- phase 6: one f32 training step, kernels against plain versions ---------

def check_equivalence() -> None:
    """One D step's and one G step's losses and gradients at 512px, batch 2,
    f32, from the same seeded weights, through the kernels and through the
    plain versions, on each of EQUIV_SEEDS' batches, under deterministic
    algorithms (the kernels are deterministic on their own; this makes
    cuDNN's and cuBLAS's calls so on both sides). The plain path runs twice
    on the first batch and must give the same bits. It also runs on the
    batch's images moved by one ulp: how far that moves its gradients is the
    step's own sensitivity to rounding-level changes, and the kernels may
    differ from the plain path by EQUIV_FLOOR_FACTOR times it, or by
    EQUIV_GRAD_REL where that is larger."""
    from discogan_modernized_torch.core.precision import F32, configure
    from discogan_modernized_torch.train.graph import trainable_subsets
    from discogan_modernized_torch.train.step import (TrainConfig,
                                                      init_train_state,
                                                      loss_and_grads)

    configure(F32)
    cfg = TrainConfig(image_size=SIZE, precision="f32")
    ts = init_train_state(0, cfg, "cuda")

    def worst(names, grads, ref, metric):
        return max((metric(g - r) / max(metric(r), 1e-30), name)
                   for name, g, r in zip(names, grads, ref))

    def norm(t):
        return t.norm().item()

    def amax(t):
        return t.abs().max().item()

    torch.use_deterministic_algorithms(True)
    try:
        for seed in EQUIV_SEEDS:
            rng = torch.Generator(device="cuda").manual_seed(seed)
            A, B = (torch.rand(EQUIV_BATCH, SIZE, SIZE, 3, device="cuda", generator=rng)
                    for _ in range(2))
            A1, B1 = (torch.nextafter(t, torch.full_like(t, 2.0)) for t in (A, B))
            for which in ("dis", "gen"):
                losses, grads = loss_and_grads(ts, A, B, 0.01, cfg, F32, which)
                plain_losses, plain_grads = loss_and_grads(ts, A, B, 0.01, cfg, F32,
                                                           which, plain=True)
                _, nudged = loss_and_grads(ts, A1, B1, 0.01, cfg, F32, which, plain=True)
                loss_rel = max(abs(float(losses[k]) - float(v)) / max(abs(float(v)), 1e-30)
                               for k, v in plain_losses.items())
                keys = trainable_subsets(cfg.model_arch)[0 if which == "gen" else 1]
                names = [f"{k}.{n}" for k in keys
                         for n, _ in ts.models[k].named_parameters()]
                grad_rel, grad_name = worst(names, grads, plain_grads, norm)
                floor, floor_name = worst(names, nudged, plain_grads, norm)
                limit = max(EQUIV_GRAD_REL, EQUIV_FLOOR_FACTOR * floor)
                print(f"{which} step, f32 batch {EQUIV_BATCH}, data seed {seed}: losses "
                      + ", ".join(f"{k} {float(v):.6f}" for k, v in losses.items()))
                print(f"  kernels vs plain: max relative loss difference {loss_rel:.3e} "
                      f"(limit {EQUIV_LOSS_REL:.0e}); worst gradient ||diff||/||g|| "
                      f"{grad_rel:.3e} ({grad_name}, limit {limit:.3e}) over "
                      f"{len(grads)} tensors; worst max|diff|/max|g| "
                      "{:.3e} ({})".format(*worst(names, grads, plain_grads, amax)))
                print(f"  plain vs plain on the images moved by one ulp: worst "
                      f"||diff||/||g|| {floor:.3e} ({floor_name})")
                if seed == EQUIV_SEEDS[0]:
                    _, again = loss_and_grads(ts, A, B, 0.01, cfg, F32, which, plain=True)
                    differ = [n for n, g, r in zip(names, again, plain_grads)
                              if not torch.equal(g, r)]
                    print(f"  plain vs plain, run twice: {len(differ)} of {len(names)} "
                          "tensors differ")
                    if differ:
                        raise AssertionError(f"{which} step: the deterministic plain path "
                                             f"gave other bits when run twice: {differ[:4]}")
                if not (loss_rel <= EQUIV_LOSS_REL and grad_rel <= limit):
                    raise AssertionError(f"{which} step, data seed {seed}: kernels and plain "
                                         "versions disagree")
    finally:
        torch.use_deterministic_algorithms(False)
    del ts
    torch.cuda.empty_cache()


# -- phase 7: the trainer ----------------------------------------------------

class StepObserver:
    """Around each trainer step: CUDA events, and the launches the step made."""

    def __init__(self):
        from discogan_modernized_torch.ops import _build

        self.launches = _build.launches
        self.steps = []  # (iters, kind, start event, end event, launches, losses)

    def begin(self, iters, kind):
        self._before = dict(self.launches)
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def end(self, iters, kind, losses):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        delta = {k: v - self._before[k] for k, v in self.launches.items() if v != self._before[k]}
        self.steps.append((iters, kind, self._start, end, delta, losses))

    def report(self) -> dict:
        """Check every step's launches and losses; print and return times."""
        torch.cuda.synchronize()
        times = {"dis": [], "gen": []}
        for iters, kind, start, end, delta, losses in self.steps:
            if delta != PER_STEP[kind]:
                raise AssertionError(f"iteration {iters} ({kind}): launches {delta}, "
                                     f"want {PER_STEP[kind]}")
            bad = [k for k, v in losses.items() if not torch.isfinite(v).item()]
            if bad:
                raise AssertionError(f"iteration {iters}: non-finite losses {bad}")
            if iters >= 2:
                times[kind].append(start.elapsed_time(end))
        counts = {k: sum(1 for s in self.steps if s[1] == k) for k in times}
        print(f"launches checked for {counts['dis']} D and {counts['gen']} G steps: "
              f"D {PER_STEP['dis']}, G {PER_STEP['gen']}; all losses finite")
        out = {k: statistics.median(v) for k, v in times.items()}
        for k, v in times.items():
            print(f"{k} step: median {out[k]:.3f} ms over {len(v)} steps after the "
                  f"first two (min {min(v):.3f}, max {max(v):.3f}; CUDA events)")
        return out


def drive_trainer(work: Path):
    """The trainer CLI at 512px, batch 8, bf16, slim_state=mv, one epoch of
    the synthetic task; returns (model_path, launches, step ms)."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train.loop import run_training

    args = parse_with_config(translation_parser(), [
        "--task_name=synthetic", f"--image_size={SIZE}",
        f"--batch_size={TRAIN_BATCH}", "--epochs=1", "--precision=bf16",
        "--slim_state=mv", "--model_save_interval=1000",
        f"--results_dir={work / 'results'}", f"--models_dir={work / 'models'}"])
    observer = StepObserver()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    _, model_path = run_training(args, observer=observer)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    step_ms = observer.report()
    n_dis = sum(1 for s in observer.steps if s[1] == "dis")
    n_gen = len(observer.steps) - n_dis
    steady = TRAIN_BATCH * (n_dis + n_gen) / (n_dis * step_ms["dis"] + n_gen * step_ms["gen"]) * 1e3
    print(f"trainer: {len(observer.steps)} iterations in {wall:.1f} s (host clock, "
          f"data, sample forwards and saves included); {steady:.1f} img/s at the "
          f"median step times; peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return model_path, launches, step_ms


def profile_g_step() -> None:
    """torch.profiler over one 512px batch-8 bf16 G step (after a D step and
    a G step that warm it)."""
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.train.step import (TrainConfig,
                                                      init_train_state,
                                                      make_train_steps)

    configure(BF16)
    cfg = TrainConfig(image_size=SIZE, precision="bf16", slim_state="mv")
    ts = init_train_state(1, cfg, "cuda")
    gen_step, dis_step = make_train_steps(cfg, BF16)
    rng = torch.Generator(device="cuda").manual_seed(8)
    A, B = (torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=rng)
            for _ in range(2))
    dis_step(ts, A, B, 0.01)
    gen_step(ts, A, B, 0.01)
    what = "one G step (512px, batch 8, bf16)"
    by_kernel = profile_call(lambda: gen_step(ts, A, B, 0.01), what, top=16, ops=12)
    if by_kernel:
        check_k3_route(by_kernel, what)
        check_k4_route(by_kernel, what)
        check_k5b_route(by_kernel, what)
        check_k6_route(by_kernel, what)
        check_fused_route(by_kernel, what, stats=True)
    del ts
    torch.cuda.empty_cache()


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

    (ROOT / "build").mkdir(exist_ok=True)
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

        phase("equivalence: one f32 D and G step at 512px, kernels vs plain")
        check_equivalence()

        phase("train: the trainer CLI at 512px, batch 8, bf16")
        train_model_path, train_counts, step_ms = drive_trainer(work)
        print("inference CLI on the trained generators:")
        _build.reset_launches()
        forwards = drive_cli(train_model_path, work / "trained", images)
        per_forward_check(dict(_build.launches), forwards, "CLI on trained weights")
        profile_g_step()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase("report")
    launches = {k: {"cli": counts.get(k, 0), "serve": serve_counts.get(k, 0),
                    "train": train_counts[k]} for k in train_counts}
    per_layer_lines(results)
    summary = kernel_summary(results, launches)
    serving = [k for k in summary if k["name"] in SERVING_KERNELS]
    print(f"forward {forward_ms:.3f} ms; the four serving kernels' phase-3 medians "
          f"(each with L2 evicted) sum to {sum(k['ms'] for k in serving):.3f} ms")
    print(f"G step {step_ms['gen']:.3f} ms, D step {step_ms['dis']:.3f} ms; the seven "
          f"kernels' phase-3 medians over one G step's calls sum to "
          f"{sum(k['train_step_ms'] for k in summary):.3f} ms")
    print(json.dumps({"kernels": summary}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
