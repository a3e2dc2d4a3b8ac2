#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: builds the CUDA kernels from
``discogan_modernized_torch/csrc``, holds each against its plain PyTorch
version, drives the 512px serving path through the inference CLI and the
serving daemon, from checkpoints and from exported artifacts, trains the
512px DiscoGAN through the trainer CLI on the synthetic task (and through
the data-parallel CLI at a world of one on NCCL), under the train step's
graph variants (--paired, --lean_dis, --remat, concat_dis) and on an
edges2shoes tree (stopped by SIGTERM and resumed), one step a call and in
chunks of steps replayed as CUDA graphs from the dataset on the card, and
trains the 64px angle-pairing model through its CLI both ways. Before the
paths it runs the port's tools, the read probe P among them.

    python3 chip_smoke.py            # one NVIDIA GPU (H100), no arguments
    python3 chip_smoke.py --planted-fault   # the mesh's f32 gate, faults planted

Phases, each fatal on failure (the run then exits non-zero), each timed, with
the disk in use and the bytes the run has written so far after each (the
card machine ends a call after 45 GiB of writes):
  1. device   CUDA present; the card's name and power limit.
  2. build    nvcc of csrc/*.cu into one library, timed; then the A/B
              tools' variant builds (tools/variants.py) start, to build
              while phase 3 runs on the card.
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
              K5b call launched twice for the same bits, and in f32 (its
              CUDA-core kernel, halo_dw_fma_kernel) also on the mesh's
              bands (mesh_cases' "enc1 dw band" cases); K6 (the head and
              the stems' input gradient) at dec7 at batch 1, 4 and 8 and
              the stem dx at batch 8 on its tensor-core path, and at its
              edge shapes (K6_EDGE: W off a multiple of 16, three strips,
              bands that do not divide H, H 1 and 2, CO 1/3/8, CI
              16/32/48/64/128, a ring of 4 rows), each bf16 call on the
              tensor-core path (head_plan) and counted once, each f32 call
              (and bf16 "odd 40x24", CI 8) on the CUDA-core path
              (head_fma_plan, its plan printed) and counted once; K1 and K2
              at their edge shapes (FUSED_EDGE: C 3 and 24, C 100 at 75
              rows, one row, rows fewer than K1's splits, C 2048 at batch
              1, a ragged last split), every K1 call launched twice for
              the same bits, each K1 and K2 call timed beside x.clone() of
              its input (the practical copy rate); K1, K2, K3 (with and
              without its statistics), K4 and K6 at every shape of one 64px
              training step at the angle trainer's batch of 64 (K3 takes
              enc1 there; K5f and K5b are off that path). In
              f32 (TF32 off; tolerance 1e-4 of max(1, max|ref|)) and bf16
              (2e-2: the kernel and the plain version round to bf16 at
              different places; statistics 1e-4 in both, from f32 sums of
              exact products on both sides). Kernel, plain and library times
              are CUDA-event medians of 20 warm runs, each after a write
              that evicts L2 and a device sleep that keeps the host's
              launches out of the window; the bound is the larger of bytes over 3.35
              TB/s and flops over the peak of the math's type (989 TFLOP/s
              for bf16 on the tensor cores, 67 for f32). Then the pair axis
              (P = 2 problems in one launch, ops/pairs.py): every kernel at
              each of its bf16 shapes of one 512px batch-8 training step and
              at one edge shape (PAIR_EDGE), with operands per pair, and K3
              and K5f also with one weight both pairs share (stride 0): each
              pair launch counted once, each pair's outputs bit for bit a
              single launch's, within the tolerances above of the plain pair
              version, and timed beside the two single launches; K5b's
              F32_PAIR_CASES the same in f32.
  3b. tools   the port's tools (M11), each through its main() with its
              launches counted and its kernels phase 3's: the read probe P
              (tools/pipe_probe.py, csrc/pipe_probe.cu) at its six block
              geometries of a seeded (32, 256, 256, 64) bf16 tensor, each
              case's block maxima equal to the plain version's and its value
              the last block's, timed beside x.clone(), torch.amax and the
              80.1 us bound; the tools' plumbing at small shapes (phase
              3's 512px times are the kernels' record): kernel_bench;
              conv_kernel_bench --dw --fused, fwd_profile and layer_ab
              (enc1, fwd/dx/dw, kernel against library) at TOOL_SIZE batch
              TOOL_BATCH; step_itemize (its parts replayed as CUDA graphs, forward <
              forward and backward < step) and roofline --measure at 64px
              batch 64 (every time positive, every roofline or peak share at
              most SHARE_LIMIT); the A/B tools conv_ab (K3's AB_VARIANTS at
              AB_CONV_SHAPE), head_ab (K6's at batch 1, the tensor-core
              kernel's AB_VARIANTS and head_fma_kernel's F32_AB_VARIANTS in
              f32) and dw_ab (K4's f32 DW_AB_VARIANTS at DW_AB_LAYER
              batch 1, and K5b's at enc1 batch 1), one round each, each
              kernel held against its plain version; memory_report at
              TOOL_SIZE batch 8, its model beside the measured peak;
              batch_size_optimization --image_size 512 --train_step in its
              own process, bracketed two steps either side of BATCH_ANSWER,
              its answer within one step of it; the monitor, confined to
              this run's jobs, on a live 64px trainer it launched
              (nvidia-smi, the trainer's memory sidecar, a SIGTERM, the
              restart with --resume, the finished run's log from the saved
              iteration); hyperparameter_search with one 64px trial on the
              card.
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
              FMA ones (K5f's halo_fma_kernel and halo_conv_kernel; nor
              under a WMMA one for K3), and K2's under
              bn_act_vec_kernel and bn_act_any_kernel (the latent's C of
              100) and none under the kernel they replaced; then the f32
              forward at batch 4 (TF32 off) through the kernels, the plain
              versions and cuDNN (LIBRARY_OPS), timed, held together and
              profiled: K3's time under conv_fma_kernel and its split sums,
              K5f's under halo_fma_kernel and none under halo_wgmma_kernel
              or the kernel halo_fma_kernel replaced (halo_conv_kernel),
              K6's under head_fma_kernel and none under head_convt_mma_kernel
              or the kernel head_fma_kernel replaced (head_convt_kernel).
  5. serve    the daemon at 512px: 3 /translate and 1 /reconstruct over
              HTTP (through Translator when PIL is missing), p50/p99 and
              each request's round trip; the daemon's Translator held
              against the plain forward at batch 1 in f32 and bf16; its
              latency on the main thread and from fresh threads.
  5b. export  the serving artifact (tools/export_model.py): gen_B at batch 4
              and symbolic and gen_A at batch 4 exported on the card, and
              gen_B at batch 1 exported on the CPU, through the export CLI
              in bf16, each timed with its size and its graph holding
              OP_NODES (the discogan:: ops of K3, K5f, K2 and K6, one a
              kernel launch of the eval forward); the inference CLI from
              --exported/--exported_rev over phase 4's PNGs, its launches a
              forward as PER_FORWARD; every artifact's forward on the card
              (the symbolic one at batch 1 and 4, the CPU-exported one at
              batch 1) launching PER_FORWARD and equal to the eager forward
              bit for bit, or else its difference and the operands that
              cause it printed and held to PATH_TOL; the daemon from the
              CPU-exported artifact (3 requests, /stats saying so); the
              forward at batch 1 and 4 through the registered ops, the
              wrappers called directly and the artifact, in turns: the
              host's issue time, the window, the device busy time; one K2
              call's host cost through its op and its wrapper.
  6. equivalence  one D step and one G step at 512px batch 2 in f32 from
              the same seeded weights, through the kernels and through the
              plain versions, on three seeded batches, under
              torch.use_deterministic_algorithms (cuDNN's and cuBLAS's
              deterministic algorithms): losses within EQUIV_LOSS_REL
              relative, each gradient tensor within EQUIV_GRAD_REL in norm
              or EQUIV_FLOOR_FACTOR times the plain path's own change when
              its images move by one ulp; the readings are printed, with
              the plain path run twice, which must agree bit for bit. Then
              one f32 G step through the kernels under torch.profiler,
              held to F32_ROUTES (check_f32_route): K4's time under its
              CUDA-core kernel (conv_dw_fma_kernel) and its split sums
              (conv_dw_reduce_kernel), K5b's under halo_dw_fma_kernel and
              its split sums (halo_dw_reduce_kernel), K6's (the heads and
              the stems' input gradient) under head_fma_kernel, K3's under
              conv_fma_kernel and K5f's under halo_fma_kernel; none under
              a tensor-core kernel or a kernel a CUDA-core one replaced
              (conv_dw_kernel, halo_dw_kernel, head_convt_kernel, ...).
  7. train    the trainer CLI at 512px, batch 8, bf16, slim_state=mv, one
              epoch of the synthetic task cut to its first 128 image pairs
              (SYNTHETIC_IMAGES: 16 iterations, 6 D, 10 G; a line every 8;
              7b, 7c (a), the variant CLI and phase 9's chunked CLI take
              the same cut), one step a call (--steps_per_call 1,
              the batches gathered from the dataset on the card; its save
              at iteration 0 not written, first_save_skipped), with the
              launch counts of every D and G step checked
              against PER_STEP, every loss finite, ms per D and per G step
              (CUDA events, median after the first two iterations), img/s
              and peak memory; gen_B_final.pth through the inference CLI;
              a torch.profiler split of one G step, which shows K3's bf16
              time under its wgmma kernels and split sums, K4's under its
              wgmma kernels (conv_dw_wgmma_kernel,
              conv_dw_stem_kernel), K5b's under halo_dw_wgmma_kernel and
              K6's under head_convt_mma_kernel, and none under their FMA
              kernels (K4's conv_dw_fma_kernel and conv_dw_kernel before
              it, K5b's halo_dw_fma_kernel and halo_dw_kernel before it,
              K6's head_fma_kernel and head_convt_kernel before it); K2's
              as in phase 4 and K1's under its one-launch
              batch_stats_kernel, none under the two kernels it replaced.
              Then the step's graph variants (VARIANTS: remat under the
              "full", "latent" and "conv" policies, the lean D step,
              concat_dis, paired) from one seeded 512px bf16 state at batch
              8, under deterministic algorithms: after one D (lean D) and
              one G step every parameter, moment and running statistic
              equal to the plain graph's bit for bit (lean: but the
              generators' statistics); every step's launches against
              variant_per_step's table (paired: half of PER_STEP); median D
              and G ms over 2 rounds of D, G, G; one G step's device busy,
              window and kernels under torch.profiler; peak memory; the
              auto-remat decision at batch 8 and 64 and one D and G step at
              batch 64 as it decides. Then the trainer CLI as above with
              --paired --lean_dis --remat=on --remat_policy=conv
              --log_interval=4 --steps_per_call=1, its saves kept in memory:
              launches per step, finite losses, every logged line with
              nonzero RECON, iteration 0's line and the final parameters and
              moments equal to the plain run's.
  7b. distributed  the data-parallel CLI (--distributed --world_size 1, a
              world of one on NCCL in this process), run between phase 7's
              CLI run and its variants, with phase 7's flags: one step a call
              with and without --bn_sync, one step a call under --bn_sync
              --remat=on, and on the chunked default with BatchNorm per rank
              (7c (a)'s gspmd chunked run captures global BatchNorm's
              all-reduces); every run's log lines and final train state equal
              to phase 7's CLI run's bit for bit; its all-reduces counted, 2 a
              step under per-rank BatchNorm (the gradients, the losses), more
              under --bn_sync (the statistics), more again under remat on the
              steps whose backward rebuilds a region, and on the chunked path
              inside each captured graph as many as the same kind's eager
              step; launches as PER_STEP; ms a step beside phase 7's. The
              runs keep their saves in memory (state_in_memory).
  7c. mesh   tensor and spatial sharding (parallel/gspmd.py), after 7b.
              (a) the distributed CLI at a world of one on NCCL with phase
              7's flags under --parallel_mode gspmd --tp 1 one step a call
              and on the chunked default, and --parallel_mode spatial --tp 1
              one step a call: each run's path line naming its mesh, its log
              lines and final train state equal to phase 7's bit for bit,
              its all-reduces a step and in each captured graph counted, no
              all-gather, saves in memory; the gspmd run one step a call
              under --ckpt_backend orbax sent SIGTERM at the end of
              iteration 7 (its save written as train_state_orbax/, timed)
              and resumed from it: its final train state equal to phase 7's
              bit for bit; then ops/sharding.py's
              collectives over a one-rank NCCL group captured into a CUDA
              graph and replayed, against their eager run, bit for bit
              (check_nccl_capture). (b) two ranks sharing the card over
              gloo (spawned), --tp 2, tensor parallelism then spatial
              sharding, from a seeded 512px batch-8 state: in bf16, each
              rank's launches by kernel and its kernel calls' shapes (K3
              and K4 at the split layers' CO/2; K3's stem, K5f, K5b and K6
              on the bands' rows), its state bytes and peak memory beside
              the one process's and (a)'s, its D and G ms (gloo through host
              memory on one card, not a multi-card speed); after the tensor
              parallel bf16 steps both ranks write one --ckpt_backend orbax
              save of the state, each its own slices, and rank 0 an npz save
              of it gathered (bytes, seconds on the host clock, each rank's
              part); the orbax save loaded whole (tp 1) equals the
              gathered state bit for bit, and so does it placed at tp 2 and
              gathered; the saves deleted with the ranks' directory; in f32
              under
              deterministic algorithms, one D and one G step's losses within
              EQUIV_LOSS_REL of the one process's and each gradient within
              max(EQUIV_GRAD_REL, MESH_FLOOR_FACTOR x its own change on the
              images moved by one ulp), printed beside it. Phase 3 holds
              K1-K6 at these shapes (MESH_PATHS, bf16).
              `python3 chip_smoke.py --planted-fault` runs (b)'s f32 step
              alone with MESH_FAULTS planted, and exits 0 only where the
              gate refuses each.
  8. real data  an edges2shoes tree under the work directory (64 train
              and 8 test side-by-side 512x256 JPEGs from a numpy seed): one
              epoch of the host loader cold (decoding into the cache) and
              warm, timed; the trainer CLI at 512px, batch 8, bf16,
              slim_state=all, 2 epochs (16 iterations), one step a call from
              the host loader (--steps_per_call 1 --no_device_cache), sent
              SIGTERM at the
              end of iteration 7 (it saves and returns, and gives the
              SIGTERM handler back), resumed with --resume to the end, and
              run again uninterrupted: every step's launches checked
              against PER_STEP, every loss finite, and the two final
              train_state.pt equal tensor for tensor, bit for bit (else the
              differing tensors are printed with a probe of which gradients
              differ between two runs of a step, and the phase fails);
              img/s and peak memory against phase 7's, the loader's wait
              per step (the trainer's own line); the uninterrupted run
              goes first, the stopped and the resumed run after it (the
              stopped run saves its SIGTERM's save to the disk, the other
              two in memory); then
              the steps from one slim_state=all state fed an epoch at a
              time from the real tree's loader, the synthetic task's
              loader, the real batches in pinned memory (copied at each
              step) and on the card, in the order AB_ORDER, with each
              source's median D and G step, host issue time and per-block
              G medians; a G
              step under mv and all split into its gradients and its Adam
              update (CUDA events).
  9. chunks   the multi-step driver. Phase 7's CLI run on the trainer's
              defaults with --profile: its path line (the dataset on the
              card, CHUNK_K = 6 iterations a call, CUDA graphs on, remat
              off); every chunk's launches (ChunkObserver: an eager chunk
              launches PER_STEP of each step, the capture each kind's
              PER_STEP once, replays none) and a graph replay count above
              0; its log lines and final train state equal to phase 7's,
              bit for bit; peak memory allocated and reserved beside phase
              7's; the trace (iterations 3-14, all replayed) holding a
              cudaGraphLaunch and kernels of all seven of K1-K6; its saves
              kept in memory. Phase 8's edges2shoes run under slim_state=all
              on the defaults: equal to phase 8's per-step run from the host
              loader; phase 8's run stopped by SIGTERM (saved at the
              misaligned iteration 8) resumed on the defaults: a first chunk
              of 1 back to the period's start, and equal to the
              uninterrupted chunked run; both keep their saves in memory.
              The variants under capture: --paired --lean_dis --remat=on
              --remat_policy=conv, two chunks of 4 (the second replayed)
              against the same chunks run eagerly, bit for bit.
              Then the chunked and the per-step path in one process from one
              seeded state, in turns: ms an iteration over whole periods,
              img/s, each block's device busy, window and idle share under
              the profiler, peak memory; the dataset's build time.
 10. angle    a car sweep (car_<id>_<azimuth>.png, 32 cars x 18 views,
              64px) and the angle CLI's trainer at the angle parser's
              defaults (10 epochs, 40 iterations at batch 64), one step a
              call: launches of every step against PER_STEP64, losses
              finite, log lines without the FM field, median D and G step;
              then on the trainer's defaults (chunks of ANGLE_K = 24
              replayed as CUDA graphs): its path line, launches, log lines
              and final state equal to the per-step run's.
 11. report   per-layer lines of K3 (with K5f at enc1) and K6 at their
              main-path shapes against the library call and the bound, and
              of K2 (batch 8, 4 and 1) and K1 (batch 8) with x.clone() of
              the same tensor beside them, with their sums per G step or
              forward, and each kernel's sums over one 64px G step;
              one JSON line of kernels, the nvidia-smi line, and the last
              line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import signal
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
from discogan_modernized_torch.tools.timing import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_FLOPS, Timer, bound_ms, smi_line)

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
# The angle trainer's 64px model at its batch of 64: K3 takes enc1 there
# (K5f's route starts at 256px inputs), and K5b is not on the path. Per
# step: 8 forwards of 4 halving convs (K3 8 stems + 24 with statistics), K1
# on the latent and the 4 decoder BNs of the 4 generator forwards (20), K2
# 44, K6 4 heads and on a G step 4 stems' input gradients, K4 16.
SIZE64, BATCH64 = 64, 64
CHANS64 = [64, 128, 256, 512]
DEC_CHANS64 = [512, 256, 128, 64]
PER_STEP64 = {
    "dis": {"conv_k4s2p1": 32, "batch_stats": 20, "bn_act": 44, "head_convt": 4,
            "conv_k4s2p1_dw": 16},
    "gen": {"conv_k4s2p1": 32, "batch_stats": 20, "bn_act": 44, "head_convt": 8,
            "conv_k4s2p1_dw": 16},
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
MESH_PATHS = ("mesh_tp", "mesh_band")  # phase 3's cases at the mesh's shapes (bf16)


_phase_start = [None, None]


class DiskWrites:
    """The bytes this run has written to the checkout's file system,
    reckoned from its usage: a thread samples ``shutil.disk_usage`` every
    PERIOD seconds and adds up each rise. A file written and deleted
    between two samples is missed (the large files here live for seconds),
    and the machine's other writes to that file system are counted: in a
    sealed machine, few. The card machine ends a call after 45 GiB of
    writes, whatever is deleted."""

    PERIOD = 0.2

    def __init__(self):
        self.total = 0
        self._last = shutil.disk_usage(ROOT).used
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.PERIOD):
            self.sample()

    def sample(self) -> int:
        with self._lock:
            now = shutil.disk_usage(ROOT).used
            self.total += max(0, now - self._last)
            self._last = now
            return self.total

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


_disk: list = [None]  # main()'s DiskWrites
_started_builds: list = []  # (directory, nvcc process) of the A/B tools' variant builds


def written_line() -> str:
    if _disk[0] is None:
        return "disk writes not counted"
    return (f"{_disk[0].sample() / 2**30:.1f} GiB written since the start (its usage's "
            "rises, sampled every 0.2 s)")


def phase(name):
    """Print the previous phase's duration, the disk the checkout's
    filesystem has in use and what this run has written (the card machine
    takes 45 GiB of writes a call in all), then this phase's header."""
    now = time.perf_counter()
    if _phase_start[0] is not None:
        used = shutil.disk_usage(ROOT).used / 2**30
        print(f"-- {_phase_start[0]}: {now - _phase_start[1]:.1f} s; {used:.1f} GiB of "
              f"disk in use; {written_line()}", flush=True)
    _phase_start[:] = [name, now]
    print(f"\n== {name}", flush=True)


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
    cases += train64_cases()
    cases += mesh_cases()

    # K3 at every layer with and without its statistics at batch 1, 4 and 8
    # (the paths above hold the other halves), and its edge shapes
    for batch in (1, 4, 8):
        cases.append(("conv_stats", f"enc0 b{batch} st", (batch, SIZE, SIZE, 3, 64), None, 0))
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


def mesh_cases():
    """Phase 3 at the mesh's shapes of a 512px batch-8 step at tp 2 (bf16),
    as ``kernel_cases``' (kind, label, args, path, calls per rank's G
    step). Path "mesh_tp": a rank's slices under tensor parallelism: K3
    with its statistics and K4 at enc2-enc6's CO/2, K2 after them and after
    dec0-dec4 on their halves, K1 on dec0-dec4's. Path "mesh_band": the
    bands under spatial sharding: K3 (the stem, enc2-enc6) and K5f (enc1)
    on a band of h/2 rows with two a side, K4/K5b on the same with dy's two
    dropped rows zero, K1 and K2 on the kept rows, K6 (the head, and the
    stem's input gradient) on a band with one row a side. A label ending
    in "first" zeroes the rows above the first band (the image's edge),
    "last" those below the last (``case_band``); the last band's cases are
    held but not counted in the sums."""
    b, t, cases = TRAIN_BATCH, MESH_TP, []
    h, ci = 128, 128
    for i, co in enumerate(CHANS[2:], start=2):
        cases += [("conv_stats", f"enc{i} tp", (b, h, h, ci, co // t), "mesh_tp", 8),
                  ("bn_act", f"enc{i} tp", (b, h // 2, h // 2, co // t, "leaky"), "mesh_tp", 8),
                  ("conv_k4s2p1_dw", f"enc{i} dw tp", (b, h, h, ci, co // t), "mesh_tp", 4)]
        h, ci = h // 2, co
    h = 4
    for j, c in enumerate(DEC_CHANS[:5]):  # dec0-dec4: out channels >= 256
        cases += [("batch_stats", f"dec{j} tp", (b, h, h, c // t), "mesh_tp", 4),
                  ("bn_act", f"dec{j} tp", (b, h, h, c // t, "relu"), "mesh_tp", 4)]
        h *= 2
    for band, calls in (("first", 8), ("last", 0)):
        cases += [("conv_k4s2p1", f"enc0 band {band}",
                   (b, SIZE // t + 4, SIZE, 3, 64, False, "leaky"), "mesh_band", calls),
                  ("halo_conv_k4s2p1", f"enc1 band {band}",
                   (b, SIZE // 2 // t + 4, SIZE // 2, 64, 128, False, None), "mesh_band",
                   calls),
                  ("conv_k4s2p1_dw", f"enc0 dw band {band}", (b, SIZE // t + 4, SIZE, 3, 64),
                   "mesh_band", calls // 2),
                  ("halo_conv_k4s2p1_dw", f"enc1 dw band {band}",
                   (b, SIZE // 2 // t + 4, SIZE // 2, 64, 128), "mesh_band", calls // 2),
                  ("head_convt", f"dec7 band {band}", (b, SIZE // 2 // t + 2, SIZE // 2, 64, 3),
                   "mesh_band", calls)]  # the heads and the stems' dx: 4 + 4
    h, ci = 128, 128
    for i, co in enumerate(CHANS[2:], start=2):
        cases += [("conv_k4s2p1", f"enc{i} band first", (b, h // t + 4, h, ci, co, False, None),
                   "mesh_band", 8),
                  ("conv_k4s2p1_dw", f"enc{i} dw band first", (b, h // t + 4, h, ci, co),
                   "mesh_band", 4)]
        h, ci = h // 2, co
    h = SIZE // 2
    for i, c in enumerate(CHANS[1:3], start=1):  # the kept rows of enc1 and enc2
        cases += [("batch_stats", f"enc{i} band rows", (b, h // 2 // t, h // 2, c), "mesh_band",
                   8),
                  ("bn_act", f"enc{i} band rows", (b, h // 2 // t, h // 2, c, "leaky"),
                   "mesh_band", 8)]
        h //= 2
    return cases


def case_band(label: str):
    """The band a mesh case's label names ("first" or "last"), or None."""
    word = label.split()[-1]
    return word if word in ("first", "last") else None


def train64_cases():
    """The kernels' calls in one 64px G step at the angle trainer's batch
    (path "train64"), each with its calls per step."""
    b, tr = BATCH64, "train64"
    cases = [("conv_k4s2p1", "enc0 t64", (b, SIZE64, SIZE64, 3, 64, False, "leaky"), tr, 8)]
    h, ci = SIZE64 // 2, 64
    for i, co in enumerate(CHANS64[1:], start=1):
        cases.append(("conv_stats", f"enc{i} t64", (b, h, h, ci, co), tr, 8))
        cases.append(("bn_act", f"enc{i} t64", (b, h // 2, h // 2, co, "leaky"), tr, 8))
        h, ci = h // 2, co
    cases.append(("bn_act", "latent t64", (b, 1, 1, 100, "leaky"), tr, 4))
    cases.append(("batch_stats", "latent t64", (b, 1, 1, 100), tr, 4))
    h = 4
    for j, c in enumerate(DEC_CHANS64):
        cases.append(("bn_act", f"dec{j} t64", (b, h, h, c, "relu"), tr, 4))
        cases.append(("batch_stats", f"dec{j} t64", (b, h, h, c), tr, 4))
        h *= 2
    cases.append(("head_convt", "dec4 t64", (b, 32, 32, 64, 3), tr, 4))
    cases.append(("head_convt", "stem dx t64", (b, 32, 32, 64, 3), tr, 4))
    h, ci = SIZE64, 3
    for i, co in enumerate(CHANS64):
        cases.append(("conv_k4s2p1_dw", f"enc{i} dw t64", (b, h, h, ci, co), tr, 4))
        h, ci = h // 2, co
    return cases


def run_case(kernel, args, dtype, timer, g, band=None):
    from torch.nn import grad as nn_grad

    from discogan_modernized_torch.ops.conv_k4s2p1 import (
        conv2d_k4s2p1, conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain,
        conv2d_k4s2p1_plain, conv_plan, dw_plan)
    from discogan_modernized_torch.ops.fused import (
        batch_stats, batch_stats_plain, bn_act, bn_act_plain)
    from discogan_modernized_torch.ops.halo_conv import (
        halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain,
        halo_conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.head import (head_convt, head_convt_plain,
                                                    head_fma_plan, head_plan)

    dev = "cuda"
    size = torch.finfo(dtype).bits // 8

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    math_dtype = dtype
    stats_tol = None  # tolerance of the statistics outputs, where there are some
    copy = None  # x.clone(), the practical copy rate, beside K1 and K2
    plan = None  # K3's or K4's plan, where the call is theirs
    head_text = None  # K6's CUDA-core plan, where the call takes it
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
        x = band_rows(rand(n, h, w, ci), band, 2)
        wt = rand(4, 4, ci, co, scale=(16 * ci) ** -0.5)
        s = torch.rand(co, device=dev, generator=g) + 0.5 if affine else None
        o = torch.randn(co, device=dev, generator=g) * 0.1 if affine else None
        fn, plain_fn = ((halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain)
                        if kernel == "halo_conv_k4s2p1" else
                        (conv2d_k4s2p1, conv2d_k4s2p1_plain))
        if kernel != "halo_conv_k4s2p1":  # K3's route: f32 on the CUDA cores
            plan = conv_plan(n, h, w, ci, co, dtype)
            want = ("fma" if dtype == torch.float32 else "wgmma_stem" if ci <= 4
                    else "wgmma" if ci % 64 == 0 else "fma")
            assert plan.path == want, (args, plan)
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
        x = band_rows(rand(n, h, w, ci), band, 2)
        dy = rand(n, h // 2, w // 2, co, scale=0.1)
        if band is not None:  # the band's two dropped output rows take no cotangent
            dy[:, 0] = 0
            dy[:, -1] = 0
        fn, plain_fn = ((conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain)
                        if kernel == "conv_k4s2p1_dw" else
                        (halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain))
        if kernel == "conv_k4s2p1_dw":  # K4's route: f32 on the CUDA cores
            plan = dw_plan(n, h, w, ci, co, dtype)
            fma = dtype == torch.float32 or co % 8 != 0 or (ci % 8 != 0 and ci > 4)
            assert (plan.path == "fma") == fma, (args, plan)
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        kern = lambda: fn(x, dy)  # noqa: E731
        plain = lambda: plain_fn(x, dy)  # noqa: E731
        lib = lambda: nn_grad.conv2d_weight(x_nchw, (co, ci, 4, 4), dy_nchw,  # noqa: E731
                                            stride=2, padding=1)
        flops = 2 * dy.numel() * 16 * ci
        nbytes = (x.numel() + dy.numel() + 16 * ci * co) * size
    else:
        n, h, w, ci, co = args
        x = band_rows(rand(n, h, w, ci), band, 1)
        wt = rand(4, 4, ci, co, scale=(16 * co) ** -0.5)
        if dtype == torch.bfloat16 and ci % 16 == 0:  # the tensor-core path
            assert head_plan(n, h, w, ci, co, dtype) is not None
        else:  # the CUDA-core path: f32, and bf16 CI 8
            assert head_plan(n, h, w, ci, co, dtype) is None
            fp = head_fma_plan(n, h, w, ci, co, dtype)
            head_text = (f"fma {fp.rows}x{fp.cols} {fp.stages} stages "
                         f"{'vec' if fp.vec else 'scalar'} {fp.blocks} blocks")
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
    if kernel == "conv_k4s2p1" and plan.splits > 1 and not torch.equal(got, kern()):
        raise AssertionError(f"conv_k4s2p1 {args} {DTYPE_NAMES[dtype]}: two launches of a "
                             f"split in {plan.splits} gave different bits")
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
    if plan is not None:
        out["plan"] = f"{plan.path} {plan.tile[0]}x{plan.tile[1]} x{plan.splits}"
    if head_text is not None:
        out["plan"] = head_text
    if copy is not None:
        out["clone_ms"] = timer.ms(copy)
    return out


def band_rows(x: torch.Tensor, band, rows: int) -> torch.Tensor:
    """x with its first (``band`` "first": the rows above the image's first
    band) or last (``"last"``) ``rows`` rows zero."""
    if band == "first":
        x[:, :rows] = 0
    elif band == "last":
        x[:, -rows:] = 0
    return x


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
            # the mesh's shapes in bf16, and K5b's bands in f32 too
            if (path in MESH_PATHS and dtype != torch.bfloat16
                    and (kernel, path) != ("halo_conv_k4s2p1_dw", "mesh_band")):
                continue
            r = run_case(kernel, args, dtype, timer, g, case_band(label))
            results[(KIND_KERNEL.get(kernel, kernel), label, dtype)] = dict(
                r, path=path, calls=calls)
            print(f"{kernel:18} {label:12} {DTYPE_NAMES[dtype]:5} "
                  f"{r['err']:10.3e} {r['ms']:9.4f} {r['plain_ms']:9.4f} "
                  f"{r['library_ms']:9.4f} {r['bound_ms']:9.4f}  {r['bound_by']}"
                  + (f"  {r['plan']}" if "plan" in r else ""), flush=True)
    return results


# -- phase 3, the pair axis: P = 2 problems in one launch (ops/pairs.py) ------

# One edge shape a kernel for its pair launches (every pair's operands start
# on a 16-byte boundary, as the kernels require).
PAIR_EDGE = [("batch_stats", "ragged", (3, 37, 41, 128)),
             ("bn_act", "c24", (2, 5, 7, 24, "leaky")),
             ("conv_k4s2p1", "ragged M", (3, 14, 10, 64, 128, True, "leaky")),
             ("conv_stats", "split 13", (5, 32, 32, 256, 128)),
             ("halo_conv_k4s2p1", "odd 58x40", (4, 58, 40, 32, 72, True, "leaky")),
             ("head_convt", "w300", (1, 8, 300, 32, 3)),
             ("conv_k4s2p1_dw", "ci48 co72", (3, 16, 16, 48, 72)),
             ("halo_conv_k4s2p1_dw", "w/2 20", (3, 30, 40, 16, 72))]


def pair_cases():
    """(kind, label, shape args, shared weight, calls per G step): every
    kernel's calls of one 512px batch-8 training step (phase 3's "train"
    cases) and its PAIR_EDGE shape, with operands per pair; K3's and K5f's
    also with one weight that both pairs read (pair stride 0)."""
    cases = [(k, label, args, calls) for k, label, args, path, calls in kernel_cases()
             if path == "train"]
    cases += [(k, label, args, 0) for k, label, args in PAIR_EDGE]
    out = []
    for kind, label, args, calls in cases:
        out.append((kind, label, args, False, calls))
        if kind in ("conv_k4s2p1", "conv_stats", "halo_conv_k4s2p1"):
            out.append((kind, label, args, True, calls))
    return out


def _flat(out) -> list:
    """A call's output tensors in order (y; y and its statistics; mean, var)."""
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


def run_pair_case(kernel, args, shared, timer, g, dtype=torch.bfloat16):
    """One pair launch in ``dtype``: counted once; each pair's outputs
    equal, bit for bit, a single launch's on that pair's operands; within
    TOL (the statistics 1e-4) of the plain pair version; timed beside the
    two single launches it replaces."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops.conv_k4s2p1 import (
        conv2d_k4s2p1, conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain, conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops.fused import (batch_stats, batch_stats_plain,
                                                     bn_act, bn_act_plain)
    from discogan_modernized_torch.ops.halo_conv import (
        halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain,
        halo_conv2d_k4s2p1_plain)
    from discogan_modernized_torch.ops.head import head_convt, head_convt_plain

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * scale).to(dtype)

    def per_channel(c, shift):
        return torch.rand(2, c, device="cuda", generator=g) * 0.5 + shift

    if kernel == "bn_act":
        n, h, w, c, act = args
        operands, nds = [rand(2, n, h, w, c), per_channel(c, 0.5), per_channel(c, -0.25)], (4, 1, 1)
        fn = lambda x, s, o: bn_act(x, s, o, act)  # noqa: E731
        plain = lambda x, s, o: bn_act_plain(x, s, o, act)  # noqa: E731
    elif kernel == "batch_stats":
        operands, nds = [(rand(2, *args) + 0.5).to(dtype)], (4,)
        fn, plain = batch_stats, batch_stats_plain
    elif kernel in ("conv_k4s2p1", "halo_conv_k4s2p1", "conv_stats"):
        if kernel == "conv_stats":
            (n, h, w, ci, co), affine, act = args, False, None
        else:
            n, h, w, ci, co, affine, act = args
        wt = rand(*(() if shared else (2,)), 4, 4, ci, co, scale=(16 * ci) ** -0.5)
        operands, nds = [rand(2, n, h, w, ci), wt], [4, 4]
        if affine:
            operands += [per_channel(co, 0.5), per_channel(co, -0.25)]
            nds += [1, 1]
        conv_fn, conv_plain = ((halo_conv2d_k4s2p1, halo_conv2d_k4s2p1_plain)
                               if kernel == "halo_conv_k4s2p1" else
                               (conv2d_k4s2p1, conv2d_k4s2p1_plain))
        kw = {"with_stats": True} if kernel == "conv_stats" else {"act": act}
        fn = lambda x, wt, s=None, o=None: conv_fn(x, wt, scale=s, offset=o, **kw)  # noqa: E731
        plain = lambda x, wt, s=None, o=None: conv_plain(  # noqa: E731
            x, wt, scale=s, offset=o, **kw)
    elif kernel in ("conv_k4s2p1_dw", "halo_conv_k4s2p1_dw"):
        n, h, w, ci, co = args
        operands, nds = [rand(2, n, h, w, ci), rand(2, n, h // 2, w // 2, co, scale=0.1)], (4, 4)
        fn, plain = ((conv2d_k4s2p1_dw, conv2d_k4s2p1_dw_plain) if kernel == "conv_k4s2p1_dw"
                     else (halo_conv2d_k4s2p1_dw, halo_conv2d_k4s2p1_dw_plain))
    else:
        n, h, w, ci, co = args
        wt = rand(2, 4, 4, ci, co, scale=(16 * co) ** -0.5)
        operands, nds = [rand(2, n, h, w, ci), wt], (4, 4)
        fn, plain = head_convt, head_convt_plain

    def single(p):
        return fn(*(t if t.dim() == nd else t[p] for t, nd in zip(operands, nds)))

    counted = KIND_KERNEL.get(kernel, kernel)
    before = _build.launches[counted]
    got = fn(*operands)
    torch.cuda.synchronize()
    if _build.launches[counted] != before + 1:
        raise AssertionError(f"{counted} pair {args}: {_build.launches[counted] - before} "
                             "launches for one pair call")
    for p in range(2):
        for a, b in zip(_flat(got), _flat(single(p))):
            if not torch.equal(a[p], b):
                raise AssertionError(f"{kernel} pair {args} shared={shared}: pair {p} differs "
                                     "from a single launch")
    err = 0.0
    for i, (a, b) in enumerate(zip(_flat(got), _flat(plain(*operands)))):
        stats = kernel == "batch_stats" or (kernel == "conv_stats" and i > 0)
        tol = 1e-4 if stats else TOL[dtype]
        e = (a.float() - b.float()).abs().max().item()
        limit = tol * max(1.0, b.float().abs().max().item())
        if not (e <= limit) or a.shape != b.shape:
            raise AssertionError(f"{kernel} pair {args}: max error {e:.3e} > {limit:.3e}")
        err = max(err, e)
    return {"err": err, "ms": timer.ms(lambda: fn(*operands)),
            "singles_ms": timer.ms(lambda: (single(0), single(1)))}


# K5b's f32 pair launches (its CUDA-core kernel): the training step's shape
# and its PAIR_EDGE shape
F32_PAIR_CASES = [("halo_conv_k4s2p1_dw", "enc1 dw", (TRAIN_BATCH, 256, 256, 64, 128)),
                  ("halo_conv_k4s2p1_dw", "w/2 20", (3, 30, 40, 16, 72))]


def check_pair_launches(timer) -> dict:
    """Every case of ``pair_cases`` in bf16, and F32_PAIR_CASES in f32;
    returns kernel -> (pair ms, two singles' ms) summed over its batch-8
    training shapes in bf16, each counted once."""
    from discogan_modernized_torch.core.precision import BF16, F32, configure

    configure(BF16)
    g = torch.Generator(device="cuda").manual_seed(1)
    sums = {}
    print(f"{'pair launch':18} {'case':12} {'weight':6} {'max_err':>10} {'pair ms':>9} "
          f"{'2 singles':>9}  ratio")
    for kind, label, args, shared, calls in pair_cases():
        r = run_pair_case(kind, args, shared, timer, g)
        name = KIND_KERNEL.get(kind, kind)
        print(f"{kind:18} {label:12} {'shared' if shared else 'pair':6} {r['err']:10.3e} "
              f"{r['ms']:9.4f} {r['singles_ms']:9.4f}  {r['ms'] / r['singles_ms']:.3f}",
              flush=True)
        if calls and not shared:
            s = sums.setdefault(name, [0.0, 0.0])
            s[0] += r["ms"]
            s[1] += r["singles_ms"]
    for name, (ms, singles) in sums.items():
        print(f"{name}: pair launches {ms:.4f} ms against two single launches "
              f"{singles:.4f} ms, summed over its batch-8 training shapes (bf16)")
    configure(F32)
    for kind, label, args in F32_PAIR_CASES:
        r = run_pair_case(kind, args, False, timer, g, torch.float32)
        print(f"{kind:18} {label:12} {'f32':6} {r['err']:10.3e} {r['ms']:9.4f} "
              f"{r['singles_ms']:9.4f}  {r['ms'] / r['singles_ms']:.3f}", flush=True)
    configure(BF16)
    return sums


def _sums(rows, weight, dtype=torch.bfloat16):
    """Time, plain, bound and library sums over case rows of ``dtype``, each
    row counted ``weight(row)`` times; and what bounds the sum."""
    t_ops = sum(weight(v) * v["flops"] / PEAK_FLOPS[dtype] for v in rows)
    t_bytes = sum(weight(v) * v["bytes"] / HBM_BYTES_PER_S for v in rows)
    return ({key: sum(weight(v) * v[key] for v in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "operations" if t_ops >= t_bytes else "bytes")


BATCHES = {"serve": 1, "cli": BATCH, "train": TRAIN_BATCH}  # a case path's batch


def per_layer_lines(results) -> None:
    """bf16 ms per call, kernel vs library vs bound: K3 at every layer of
    the batch-8 training forward (enc1 on K5f), and K6 at its main-path
    shapes; in f32 K3 at every layer and K5f at enc1's three batches."""
    rows = [("K3 batch 8", [(k[1].split()[0], v) for k, v in results.items()
                            if k[2] == torch.bfloat16 and v["path"] == "train"
                            and k[0] in ("conv_k4s2p1", "halo_conv_k4s2p1")]),
            ("K6", [(k[1], v) for k, v in results.items()
                    if k[2] == torch.bfloat16 and k[0] == "head_convt" and v["path"]])]
    # K3 in f32 (TF32 off) at every layer: the batch-8 training forward's
    # calls (with the statistics) and the batch-4 forward's (the epilogue)
    for what, path in (("K3 f32 batch 8", "train"), ("K3 f32 batch 4", "cli")):
        rows.append((what, [(k[1].split()[0], v) for k, v in results.items()
                            if k[2] == torch.float32 and v["path"] == path
                            and k[0] == "conv_k4s2p1"]))
    # K5f in f32 at enc1: the daemon's batch 1, the CLI's 4, a training step's 8
    rows.append(("K5f f32 enc1", [(f"b{BATCHES[v['path']]}", v) for k, v in results.items()
                                  if k[2] == torch.float32 and k[0] == "halo_conv_k4s2p1"
                                  and v["path"] in BATCHES]))
    # K6 in f32 (TF32 off for cuDNN's convT) at the head and the stems' dx:
    # the daemon's batch 1, the CLI's 4, a training step's 8, with the plans
    rows.append(("K6 f32 head", [(f"{k[1]} b{BATCHES[v['path']]}", v)
                                 for k, v in results.items()
                                 if k[2] == torch.float32 and k[0] == "head_convt"
                                 and v["path"] in BATCHES]))
    for what, cases in rows:
        print(f"{what} (ms: kernel / library / bound): " + "; ".join(
            f"{label} {v['ms']:.4f} / {v['library_ms']:.4f} / {v['bound_ms']:.4f}"
            + (f" [{v['plan']}]" if what.startswith("K6") and "plan" in v else "")
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
    # each kernel at the mesh's shapes, summed over a rank's G step at tp 2
    for path in MESH_PATHS:
        for kernel in KERNEL_INFO:
            rows = [v for k, v in results.items() if k[2] == torch.bfloat16
                    and k[0] == kernel and v["path"] == path]
            if rows:
                total, by = _sums(rows, lambda v: v["calls"])
                print(f"{kernel} at the {path} shapes, summed over a rank's G step at tp "
                      f"{MESH_TP} ({sum(v['calls'] for v in rows)} calls; ms): kernel "
                      f"{total['ms']:.4f}, plain {total['plain_ms']:.4f}, library "
                      f"{total['library_ms']:.4f}, bound {total['bound_ms']:.4f} ({by})")
    # each kernel over one 64px G step at the angle trainer's batch
    for kernel in ("conv_k4s2p1", "batch_stats", "bn_act", "head_convt", "conv_k4s2p1_dw"):
        rows = [v for k, v in results.items() if k[2] == torch.bfloat16 and k[0] == kernel
                and v["path"] == "train64"]
        total, by = _sums(rows, lambda v: v["calls"])
        print(f"{kernel} summed over one 64px batch-{BATCH64} G step ({sum(v['calls'] for v in rows)} "
              f"calls; ms): kernel {total['ms']:.4f}, plain {total['plain_ms']:.4f}, library "
              f"{total['library_ms']:.4f}, bound {total['bound_ms']:.4f} ({by})")


def kernel_summary(results, launches, pair_ms):
    """Per kernel, in bf16 (the card's default): for the serving kernels,
    the times summed over the calls of one 512px batch-4 forward (and the
    kernel ms of one batch-1 forward); for the training-only kernels (K1,
    K4, K5b), summed over the calls of one 512px batch-8 G step. Every
    kernel also carries its G-step sums (train_step_*), and the same sums in
    f32 with TF32 off (f32_train_step_*; the serving kernels' batch-4
    forward, f32_*), each against the f32 bound (67 TFLOP/s). With the
    largest bf16 and f32 errors, the launches of every path run, and its
    pair launches' ms beside two single launches' over its training shapes
    (pair_ms, two_singles_ms)."""
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
        for path in MESH_PATHS:
            rows_ = [v for v in bf16 if v["path"] == path]
            if rows_:
                sums, by = _sums(rows_, lambda v: v["calls"])
                entry.update({f"{path}_{k}": v for k, v in sums.items()},
                             **{f"{path}_bound_by": by, f"{path}_cases": len(rows_)})
        f32 = [v for k, v in rows.items() if k[2] == torch.float32]
        f32_train, f32_by = _sums([v for v in f32 if v["path"] == "train"],
                                  lambda v: v["calls"], torch.float32)
        entry.update({f"f32_train_step_{k}": v for k, v in f32_train.items()},
                     f32_train_step_bound_by=f32_by)
        if name in SERVING_KERNELS:
            f32_cli, by = _sums([v for v in f32 if v["path"] == "cli"], lambda v: 1,
                                torch.float32)
            entry.update({f"f32_{k}": v for k, v in f32_cli.items()}, f32_bound_by=by,
                         f32_ms_batch1=sum(v["ms"] for v in f32 if v["path"] == "serve"))
        f32_plans = sorted({v["plan"] for v in f32 if v["path"] == "train" and "plan" in v})
        if f32_plans:
            entry["f32_train_step_plans"] = f32_plans
        entry.update({f"train_step_{k}": v for k, v in train.items()},
                     train_step_bound_by=by_train,
                     calls_per_g_step=PER_STEP["gen"][name],
                     pair_ms=pair_ms[name][0], two_singles_ms=pair_ms[name][1])
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


# -- the export phase: serving from a torch.export artifact ------------------

# The artifacts of the phase: (file, direction, batch (0: symbolic), the
# device that traces it, the platforms it may serve on).
ARTIFACTS = (("gen_B_b4.pt2", "AtoB", BATCH, "cuda", "cuda"),
             ("gen_A_b4.pt2", "BtoA", BATCH, "cuda", "cuda"),
             ("gen_B_sym.pt2", "AtoB", 0, "cuda", "cuda,cpu"),
             ("gen_B_b1_cpu.pt2", "AtoB", 1, "cpu", "cuda,cpu"))
# Each eval forward's discogan:: nodes, by op: PER_FORWARD's kernels.
OP_NODES = {"conv2d_k4s2p1": 6, "halo_conv2d_k4s2p1": 1, "fused_batchnorm_act": 8,
            "head_convt_fwd": 1}


def export_artifacts(model_dir: Path, out_dir: Path) -> dict:
    """ARTIFACTS through the export CLI (bf16): each one's export time (the
    checkpoint's load included), size and graph, which must hold OP_NODES.
    Returns name -> path."""
    from discogan_modernized_torch.tools import export_model

    paths = {}
    for name, direction, batch, device, platforms in ARTIFACTS:
        path = out_dir / name
        t0 = time.perf_counter()
        rc = export_model.main([f"--model_path={model_dir}", f"--direction={direction}",
                                f"--image_size={SIZE}", f"--batch={batch}",
                                "--precision=bf16", f"--device={device}",
                                f"--platforms={platforms}", f"--output={path}"])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"export of {name} returned {rc}")
        nodes = export_model.discogan_nodes(torch.export.load(str(path)))
        if nodes != OP_NODES:
            raise AssertionError(f"{name}: discogan:: nodes {nodes}, want {OP_NODES}")
        print(f"artifact {name}: exported on {device} in {seconds:.2f} s (host clock, the "
              f"checkpoint's load included), {path.stat().st_size / 2**20:.1f} MiB; "
              f"graph nodes {nodes}")
        paths[name] = path
    return paths


def artifact_forwards(paths: dict, model_dir: Path, images: np.ndarray) -> int:
    """Each artifact's forward on the card against the eager forward of the
    same checkpoint (bf16): its launches (PER_FORWARD a forward) and its
    outputs bit for bit, or, where they differ, the difference and its
    place, held to PATH_TOL against the plain forward. Returns the
    forwards run."""
    from discogan_modernized_torch.cli.inference import load_artifact, load_generators
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.ops import _build

    configure(BF16)
    gens = dict(zip(("AtoB", "BtoA"), load_generators(model_dir, "AtoB", SIZE, "cuda")))
    forwards = 0
    cases = [("gen_B_b4.pt2", "AtoB", BATCH), ("gen_A_b4.pt2", "BtoA", BATCH),
             ("gen_B_sym.pt2", "AtoB", 1), ("gen_B_sym.pt2", "AtoB", BATCH),
             ("gen_B_b1_cpu.pt2", "AtoB", 1)]
    for name, direction, batch in cases:
        module, _ = load_artifact(paths[name], SIZE, "cuda")
        x = torch.from_numpy(images[:batch]).cuda()
        with torch.no_grad():
            module(x)  # warm: the first call builds what it needs
            torch.cuda.synchronize()
            _build.reset_launches()
            got = module(x)
            torch.cuda.synchronize()
            per_forward_check(dict(_build.launches), 1, f"artifact {name} batch {batch}")
            forwards += 2
            want = gens[direction](x, policy=BF16)
        if torch.equal(got, want):
            print(f"artifact {name} batch {batch}: equal to the eager forward bit for bit")
            continue
        diff = (got - want).abs()
        where = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        print(f"artifact {name} batch {batch}: differs from the eager forward, max "
              f"{float(diff.max()):.3e} at {where}, mean {float(diff.mean()):.3e}")
        operand_differences(paths[name], gens[direction])
        hold_against_plain(f"artifact {name} batch {batch}", "generated", BF16,
                           got.cpu().numpy(), gens[direction](x, policy=BF16, plain=True))
    return forwards


def operand_differences(path: Path, gen) -> None:
    """Where an artifact's forward differs from the eager one: its buffers
    (the eval operands it was exported with) against the ones the eager
    forward derives on the card, by name."""
    from discogan_modernized_torch.core.precision import BF16
    from discogan_modernized_torch.tools.export_model import ServingGenerator

    mine = ServingGenerator(gen, BF16).state_dict()
    theirs = torch.export.load(str(path)).state_dict
    differ = [k for k in mine if not torch.equal(mine[k].cpu(), theirs[k].cpu())]
    worst = {k: float((mine[k].cpu().float() - theirs[k].cpu().float()).abs().max())
             for k in differ}
    print(f"  its operands against the card-derived ones: {len(differ)} of {len(mine)} "
          f"buffers differ ({', '.join(f'{k} {v:.2e}' for k, v in list(worst.items())[:6])}"
          f"{', ...' if len(differ) > 6 else ''})")


def drive_exported_cli(paths: dict, work: Path, images: np.ndarray) -> int:
    """The inference CLI from --exported/--exported_rev (the batch-4
    artifacts) over the same PNGs as phase 4's run, with its launches per
    forward; returns its forwards."""
    from discogan_modernized_torch.cli import inference
    from discogan_modernized_torch.ops import _build

    src = work / "inputs"
    _build.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inference.main([f"--exported={paths['gen_B_b4.pt2']}",
                             f"--exported_rev={paths['gen_A_b4.pt2']}",
                             f"--input_path={src}", f"--output_dir={work / 'exported_out'}",
                             f"--image_size={SIZE}", f"--batch_size={BATCH}"])
    text = out.getvalue()
    print("\n".join(line for line in text.splitlines() if "p50" in line or "로드" in line))
    if rc != 0 or "p50 per-image latency" not in text:
        raise AssertionError(f"inference CLI from artifacts failed (rc {rc}):\n{text}")
    forwards = 2 * (len(images) // BATCH)
    per_forward_check(dict(_build.launches), forwards, "CLI from artifacts")
    return forwards


def serve_exported(paths: dict, images: np.ndarray) -> int:
    """The daemon from the CPU-exported batch-1 artifact: 3 /translate
    requests, /stats saying it serves an artifact, launches per forward.
    Returns its forwards."""
    from PIL import Image

    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.tools.serve import parse_args, serve

    srv, tr = serve(parse_args([f"--exported={paths['gen_B_b1_cpu.pt2']}",
                                f"--image_size={SIZE}", "--port=0"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        _build.reset_launches()
        for im in images[:3]:
            buf = io.BytesIO()
            Image.fromarray((im * 255).astype(np.uint8)).save(buf, "PNG")
            req = urllib.request.Request(url + "/translate", data=buf.getvalue(),
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = np.array(Image.open(io.BytesIO(r.read())))
            if out.shape != (SIZE, SIZE, 3):
                raise AssertionError(f"exported daemon: response of shape {out.shape}")
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        tr.close()
    if not stats["exported"] or stats["requests"] != 3:
        raise AssertionError(f"exported daemon: /stats {stats}")
    per_forward_check(dict(_build.launches), 3, "daemon from an artifact")
    print(f"daemon from the CPU-exported batch-1 artifact: {stats}")
    return 3


def dispatch_cost(paths: dict, model_dir: Path, images: np.ndarray) -> None:
    """The 512px bf16 eval forward at batch 1 and 4 through the registered
    ops (the eval forward's default), through the kernels' wrappers called
    directly, and through the artifact's module, in turns in this process:
    the host's issue time (the call returns), the window to the device's
    end (host clock, after a synchronize), medians of ROUNDS x REPS; then
    each one's device busy time and window under the profiler."""
    from discogan_modernized_torch.cli.inference import load_artifact, load_generators
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.ops.autograd import KERNEL_OPS

    configure(BF16)
    gen, _ = load_generators(model_dir, "AtoB", SIZE, "cuda")
    arts = {1: load_artifact(paths["gen_B_sym.pt2"], SIZE, "cuda")[0]}
    arts[BATCH] = arts[1]
    for batch in (1, BATCH):
        x = torch.from_numpy(images[:batch]).cuda()
        paths_ = {"ops": lambda: gen(x, policy=BF16),
                  "wrappers": lambda: gen._eval_forward(x, BF16, KERNEL_OPS),
                  "artifact": lambda: arts[batch](x)}
        issue = {k: [] for k in paths_}
        window = {k: [] for k in paths_}
        with torch.no_grad():
            for fn in paths_.values():
                fn()
            for _ in range(3):
                for k, fn in paths_.items():
                    for _ in range(10):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        t2 = time.perf_counter()
                        issue[k].append((t1 - t0) * 1e3)
                        window[k].append((t2 - t0) * 1e3)
            busy = {}
            for k, fn in paths_.items():
                busy[k] = {}
                profile_call(fn, f"the batch-{batch} forward through the {k}", top=0,
                             out=busy[k])
        if batch == 1:
            op_call_cost(x)
        print(f"forward 512px batch {batch} bf16, in turns (host clock, medians of 30): "
              + "; ".join(f"{k}: issue {statistics.median(issue[k]):.3f} ms, window "
                          f"{statistics.median(window[k]):.3f} ms, device busy "
                          f"{busy[k].get('busy_ms', float('nan')):.3f} ms"
                          for k in paths_))


def op_call_cost(like: torch.Tensor, calls: int = 2000) -> None:
    """The host's cost of one call of K2 on a latent-sized (1, 1, 1, 100)
    bf16 tensor, through its registered op and through its wrapper, in
    turns: us a call (host clock, the median of 5 blocks of ``calls``)."""
    from discogan_modernized_torch.ops.fused import bn_act
    from discogan_modernized_torch.ops.library import bn_act_op

    x = torch.rand(1, 1, 1, 100, device=like.device).to(torch.bfloat16)
    scale, offset = torch.rand(100, device=like.device), torch.rand(100, device=like.device)
    per = {"op": [], "wrapper": []}
    fns = {"op": lambda: bn_act_op(x, scale, offset, "relu"),
           "wrapper": lambda: bn_act(x, scale, offset, "relu")}
    for _ in range(5):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per[k].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    print("K2 on (1, 1, 1, 100) bf16, host us a call (median of 5 x "
          f"{calls}, in turns): " + ", ".join(f"{k} {statistics.median(v):.2f}"
                                             for k, v in per.items()))


def drive_export(model_dir: Path, work: Path, images: np.ndarray) -> dict:
    """The export phase; returns its launches."""
    from discogan_modernized_torch.ops import _build

    out_dir = work / "artifacts"
    out_dir.mkdir()
    paths = export_artifacts(model_dir, out_dir)
    drive_exported_cli(paths, work, images)
    counts = dict(_build.launches)
    artifact_forwards(paths, model_dir, images)
    serve_exported(paths, images)
    counts = _add([counts, _build.launches])
    dispatch_cost(paths, model_dir, images)
    shutil.rmtree(out_dir)
    return counts


KERNEL_SYMBOLS = {  # device function name -> the kernel it belongs to
    "batch_stats_kernel": "K1 batch_stats",
    "conv_fma_kernel": "K3 conv_k4s2p1", "conv_wgmma_kernel": "K3 conv_k4s2p1",
    "conv_stem_wgmma_kernel": "K3 conv_k4s2p1",
    "splitk_epilogue_kernel": "K3 conv_k4s2p1",
    "splitk_stats_epilogue_kernel": "K3 conv_k4s2p1",
    "conv_stats_finalize_kernel": "K3 conv_k4s2p1",
    "conv_dw_fma_kernel": "K4 conv_k4s2p1_dw", "conv_dw_wgmma_kernel": "K4 conv_k4s2p1_dw",
    "conv_dw_stem_kernel": "K4 conv_k4s2p1_dw", "conv_dw_reduce_kernel": "K4 conv_k4s2p1_dw",
    "halo_fma_kernel": "K5f halo_conv_k4s2p1", "halo_wgmma_kernel": "K5f halo_conv_k4s2p1",
    "halo_dw_fma_kernel": "K5b halo_conv_k4s2p1_dw",
    "halo_dw_wgmma_kernel": "K5b halo_conv_k4s2p1_dw",
    "halo_dw_reduce_kernel": "K5b halo_conv_k4s2p1_dw",
    "bn_act_vec_kernel": "K2 bn_act", "bn_act_any_kernel": "K2 bn_act",
    "head_fma_kernel": "K6 head_convt",
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
# K5f's f32 kernel on the CUDA cores, and the one it replaced
K5F_F32_KERNEL = "halo_fma_kernel"
K5F_OFF_ROUTE = "halo_conv_kernel"


def check_k5f_route(by_kernel: dict, what: str) -> None:
    """The profile shows K5f's time under its tensor-core kernel and none
    under the CUDA-core ones (the f32 kernel and the one it replaced): the
    bf16 main path takes the tensor cores."""
    tc = sum(us for name, us in by_kernel.items() if K5F_TC_KERNEL in name)
    fma = sum(us for name, us in by_kernel.items()
              if K5F_F32_KERNEL in name or K5F_OFF_ROUTE in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K5f {tc:.1f} us under {K5F_TC_KERNEL}, "
                             f"{fma:.1f} us under {K5F_F32_KERNEL} or {K5F_OFF_ROUTE}")
    print(f"{what}: K5f {tc / 1e3:.4f} ms under {K5F_TC_KERNEL}, none under "
          f"{K5F_F32_KERNEL} or {K5F_OFF_ROUTE}")


K3_TC_KERNELS = ("conv_wgmma_kernel", "conv_stem_wgmma_kernel")
K3_SPLIT_KERNELS = ("splitk_epilogue_kernel", "splitk_stats_epilogue_kernel",
                    "conv_stats_finalize_kernel")
# K3's FMA kernel on the CUDA cores, the one it replaced, and the WMMA kernel
# its bf16 path ran before the wgmma one
K3_OFF_ROUTE = ("conv_fma_kernel", "conv_k4s2p1_kernel", "conv_tc_kernel")


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


# K3's f32 kernel on the CUDA cores, and its split sums (a split call's
# second pass; the statistics' last pass runs on every call that takes them)
K3_F32_KERNEL = "conv_fma_kernel"
K3_F32_SPLIT_SUMS = ("splitk_epilogue_kernel", "splitk_stats_epilogue_kernel")


def _library_conv(x, w, *, scale=None, offset=None, act=None):
    """K3's and K5f's function through cuDNN (NHWC data, channels-last views)."""
    from discogan_modernized_torch.ops.activations import apply_act

    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                 padding=1).permute(0, 2, 3, 1)
    return apply_act(y if scale is None else y * scale + offset, act)


def _library_bn_act(x, scale, offset, act):
    from discogan_modernized_torch.ops.activations import apply_act

    return apply_act(x * scale + offset, act)


def _library_head(x, w):
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=2,
                              padding=1).permute(0, 2, 3, 1)


# The eval forward's ops table (ops/autograd.py's keys) on PyTorch's own
# calls: each kernel's function through cuDNN or elementwise ops.
LIBRARY_OPS = {"conv": _library_conv, "halo": _library_conv, "bn_act": _library_bn_act,
               "head": _library_head}


def time_forward_f32(model_dir: Path, images: np.ndarray, timer, batch: int) -> None:
    """One 512px f32 forward (TF32 off) at ``batch``: CUDA-event ms through
    the kernels, through the plain versions and through cuDNN
    (``LIBRARY_OPS``), the three outputs held together (1e-4), and its
    profile, with K3's time under its CUDA-core kernel and split sums and
    K5f's and K6's under their CUDA-core kernels."""
    from discogan_modernized_torch.cli.inference import load_generators
    from discogan_modernized_torch.core.precision import F32, configure
    from discogan_modernized_torch.models.generator import eval_forward
    from discogan_modernized_torch.models.geometry import encoder_channels
    from discogan_modernized_torch.ops.conv_k4s2p1 import conv_plan
    from discogan_modernized_torch.ops.halo_conv import takes_halo

    configure(F32)
    fwd, _ = load_generators(model_dir, "AtoB", SIZE, "cuda")
    x = torch.from_numpy(images[:batch]).cuda()
    operands = fwd._operands(torch.float32)

    def library():
        return eval_forward(operands, x, torch.float32, LIBRARY_OPS)

    with torch.no_grad():
        got, plain, lib = fwd(x, policy=F32), fwd(x, policy=F32, plain=True), library()
    err = max((got - plain).abs().max().item(), (got - lib).abs().max().item())
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"f32 forward batch {batch}: kernels, plain and cuDNN differ by "
                             f"{err:.3e}")
    ms = timer.ms(lambda: fwd(x, policy=F32))
    plain_ms = timer.ms(lambda: fwd(x, policy=F32, plain=True))
    lib_ms = timer.ms(lambda: library())
    print(f"forward 512px batch {batch} f32 (TF32 off): {ms:.3f} ms through the kernels, "
          f"{plain_ms:.3f} ms through the plain versions, {lib_ms:.3f} ms through cuDNN "
          f"(outputs within {err:.1e})")
    splits, h, ci = False, SIZE, 3
    for co in encoder_channels(SIZE):
        xs, ws = torch.empty(batch, h, h, ci, device="meta"), torch.empty(4, 4, ci, co,
                                                                          device="meta")
        if not takes_halo(xs, ws):
            splits |= conv_plan(batch, h, h, ci, co, torch.float32).splits > 1
        h, ci = h // 2, co
    for _ in range(3):  # the profiler now and then keeps only a window's tail
        by_kernel = profile_forward(fwd, x, F32)
        wanted = (K3_F32_KERNEL, K5F_F32_KERNEL, K6_F32_KERNEL)
        if all(any(k in name for name in by_kernel) for k in wanted):
            break
        print(f"the profile holds no {' or no '.join(wanted)}; profiling again")
    check_f32_route(by_kernel, f"f32 forward batch {batch}", "K3", splits)
    check_f32_route(by_kernel, f"f32 forward batch {batch}", "K5f")
    check_f32_route(by_kernel, f"f32 forward batch {batch}", "K6")


K4_TC_KERNELS = ("conv_dw_wgmma_kernel", "conv_dw_stem_kernel")
# K4's f32 kernel on the CUDA cores, the one it replaced, and the split sums
# of a call whose plan splits M
K4_F32_KERNEL = "conv_dw_fma_kernel"
K4_OFF_ROUTE = "conv_dw_kernel"
K4_SPLIT_SUMS = "conv_dw_reduce_kernel"

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
# K6's f32 kernel on the CUDA cores, and the one it replaced
K6_F32_KERNEL = "head_fma_kernel"
K6_OFF_ROUTE = "head_convt_kernel"


def check_k6_route(by_kernel: dict, what: str) -> None:
    """The profile shows K6's time under its tensor-core kernel and none
    under the CUDA-core ones (the f32 kernel and the one it replaced): every
    bf16 K6 call of the path (the head, and in a G step the stems' input
    gradient) takes the tensor cores."""
    tc = sum(us for name, us in by_kernel.items() if K6_TC_KERNEL in name)
    fma = sum(us for name, us in by_kernel.items()
              if K6_F32_KERNEL in name or K6_OFF_ROUTE in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K6 {tc:.1f} us under {K6_TC_KERNEL}, "
                             f"{fma:.1f} us under {K6_F32_KERNEL} or {K6_OFF_ROUTE}")
    print(f"{what}: K6 {tc / 1e3:.4f} ms under {K6_TC_KERNEL}, none under "
          f"{K6_F32_KERNEL} or {K6_OFF_ROUTE}")


def check_k4_route(by_kernel: dict, what: str) -> None:
    """The profile shows K4's time under its wgmma kernels (and its split
    sums) and none under the CUDA-core ones (the f32 kernel and the one it
    replaced): every bf16 K4 call of the training step takes the tensor
    cores."""
    tc = {k: sum(us for name, us in by_kernel.items() if k in name) for k in K4_TC_KERNELS}
    fma = sum(us for name, us in by_kernel.items()
              if K4_F32_KERNEL in name or K4_OFF_ROUTE in name)
    if not all(us > 0 for us in tc.values()) or fma > 0:
        raise AssertionError(f"{what}: K4 {tc} us under its wgmma kernels, "
                             f"{fma:.1f} us under {K4_F32_KERNEL} or {K4_OFF_ROUTE}")
    print(f"{what}: K4 " + ", ".join(f"{us / 1e3:.4f} ms under {k}" for k, us in tc.items())
          + f", none under {K4_F32_KERNEL} or {K4_OFF_ROUTE}")


K5B_TC_KERNEL = "halo_dw_wgmma_kernel"
# K5b's f32 kernel on the CUDA cores, the one it replaced, and the split sums
# of a call whose plan splits (both dtypes)
K5B_F32_KERNEL = "halo_dw_fma_kernel"
K5B_OFF_ROUTE = "halo_dw_kernel"
K5B_SPLIT_SUMS = "halo_dw_reduce_kernel"


def check_k5b_route(by_kernel: dict, what: str) -> None:
    """The profile shows K5b's time under its wgmma kernel (and its split
    sums) and none under the CUDA-core ones (the f32 kernel and the one it
    replaced): every bf16 K5b call of the training step takes the tensor
    cores."""
    tc = sum(us for name, us in by_kernel.items() if K5B_TC_KERNEL in name)
    sums = sum(us for name, us in by_kernel.items() if K5B_SPLIT_SUMS in name)
    fma = sum(us for name, us in by_kernel.items()
              if K5B_F32_KERNEL in name or K5B_OFF_ROUTE in name)
    if not tc > 0 or fma > 0:
        raise AssertionError(f"{what}: K5b {tc:.1f} us under {K5B_TC_KERNEL}, "
                             f"{fma:.1f} us under {K5B_F32_KERNEL} or {K5B_OFF_ROUTE}")
    print(f"{what}: K5b {tc / 1e3:.4f} ms under {K5B_TC_KERNEL} and {sums / 1e3:.4f} ms "
          f"under its split sums, none under {K5B_F32_KERNEL} or {K5B_OFF_ROUTE}")


# Each kernel's f32 route: its CUDA-core kernel, the split sums that a call
# whose plan splits runs, and the kernels off the route (the tensor cores'
# and the FMA kernel the CUDA-core one replaced).
F32_ROUTES = {
    "K3": (K3_F32_KERNEL, K3_F32_SPLIT_SUMS, (*K3_TC_KERNELS, "conv_k4s2p1_kernel")),
    "K5f": (K5F_F32_KERNEL, (), (K5F_TC_KERNEL, K5F_OFF_ROUTE)),
    "K4": (K4_F32_KERNEL, (K4_SPLIT_SUMS,), (*K4_TC_KERNELS, K4_OFF_ROUTE)),
    "K6": (K6_F32_KERNEL, (), (K6_TC_KERNEL, K6_OFF_ROUTE)),
    "K5b": (K5B_F32_KERNEL, (K5B_SPLIT_SUMS,), (K5B_TC_KERNEL, K5B_OFF_ROUTE)),
}


def check_f32_route(by_kernel: dict, what: str, kernel: str, splits: bool = False) -> None:
    """The profile of an f32 path shows ``kernel``'s time (an F32_ROUTES
    key) under its CUDA-core kernel and, where a call's plan splits
    (``splits``), under its split sums; none under the kernels off its
    route."""
    main, split_sums, off_route = F32_ROUTES[kernel]

    def us(symbol):
        return sum(v for name, v in by_kernel.items() if symbol in name)

    fma, sums = us(main), sum(us(k) for k in split_sums)
    off = {k: us(k) for k in off_route}
    if not fma > 0 or (splits and not sums > 0) or any(v > 0 for v in off.values()):
        raise AssertionError(f"{what}: {kernel} {fma:.1f} us under {main}, {sums:.1f} us "
                             f"under its split sums, {off} us off its route")
    print(f"{what}: {kernel} {fma / 1e3:.4f} ms under {main}"
          + (f" and {sums / 1e3:.4f} ms under its split sums" if split_sums else "")
          + ", none under " + " or ".join(off))


def profile_call(fn, what: str, top: int = 12, ops: int = 0, out: dict | None = None) -> dict:
    """Device time of ``fn()`` by kernel (torch.profiler), the share of the
    window in which no kernel ran, and the split into the port's kernels,
    library kernels and the rest; with ``ops``, also the PyTorch operators
    that launched the most device time. Returns us by kernel name (empty
    where the profiler recorded no device kernels); ``out`` receives the
    device busy and window ms and the count of device kernels."""
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
    if out is not None:
        out.update(busy_ms=busy / 1e3, window_ms=window / 1e3, device_kernels=len(kernels))
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
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses, grads = loss_and_grads(ts, A, B, 0.01, cfg, F32, which)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plain_losses, plain_grads = loss_and_grads(ts, A, B, 0.01, cfg, F32,
                                                           which, plain=True)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
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
                      + ", ".join(f"{k} {float(v):.6f}" for k, v in losses.items())
                      + f"; {t1 - t0:.3f} s through the kernels, {t2 - t1:.3f} s through "
                      "the plain versions (host clock)")
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
        profile_f32_g_step(ts, A, B, cfg)
    finally:
        torch.use_deterministic_algorithms(False)
    del ts
    torch.cuda.empty_cache()


def profile_f32_g_step(ts, A, B, cfg) -> None:
    """torch.profiler over one of phase 6's f32 G steps through the kernels
    (512px, batch EQUIV_BATCH): K4's and K5b's time under their CUDA-core
    kernels and, where a layer's plan splits, their split sums; K6's (the
    heads and the stems' input gradients), K3's and K5f's under their
    CUDA-core kernels; none under a tensor-core kernel or a replaced one."""
    from discogan_modernized_torch.core.precision import F32
    from discogan_modernized_torch.models.geometry import encoder_channels
    from discogan_modernized_torch.ops.conv_k4s2p1 import dw_plan
    from discogan_modernized_torch.ops.halo_conv import halo_dw_plan, takes_halo
    from discogan_modernized_torch.train.step import loss_and_grads

    splits = {"K4": False, "K5b": False}
    h, ci = SIZE, 3
    for co in encoder_channels(SIZE):
        xs, ws = torch.empty(EQUIV_BATCH, h, h, ci, device="meta"), torch.empty(
            4, 4, ci, co, device="meta")
        kernel, plan = (("K5b", halo_dw_plan) if takes_halo(xs, ws) else ("K4", dw_plan))
        splits[kernel] |= plan(EQUIV_BATCH, h, h, ci, co, torch.float32).splits > 1
        h, ci = h // 2, co
    what = f"one f32 G step (512px, batch {EQUIV_BATCH}, through the kernels)"
    wanted = [F32_ROUTES[k][0] for k in ("K4", "K5b", "K6", "K3", "K5f")]
    for _ in range(3):  # the profiler now and then keeps only a window's tail
        by_kernel = profile_call(lambda: loss_and_grads(ts, A, B, 0.01, cfg, F32, "gen"), what)
        if all(any(k in name for name in by_kernel) for k in wanted):
            break
        print(f"the profile holds no {' or no '.join(wanted)}; profiling again")
    for kernel in ("K4", "K5b", "K6", "K3", "K5f"):
        check_f32_route(by_kernel, what, kernel, splits.get(kernel, False))


# -- phase 7: the trainer ----------------------------------------------------

STEP_NAMES = {"dis": "D", "lean": "lean D", "gen": "G"}


class StepObserver:
    """Around each trainer step: CUDA events, and the launches the step made,
    which ``report`` holds against ``per_step``."""

    def __init__(self, per_step=None, batch: int = TRAIN_BATCH):
        from discogan_modernized_torch.ops import _build

        self.launches = _build.launches
        self.per_step, self.batch = per_step or PER_STEP, batch
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
        times = {k: [] for k in self.per_step}
        for iters, kind, start, end, delta, losses in self.steps:
            if delta != self.per_step[kind]:
                raise AssertionError(f"iteration {iters} ({kind}): launches {delta}, "
                                     f"want {self.per_step[kind]}")
            bad = [k for k, v in losses.items() if not torch.isfinite(v).item()]
            if bad:
                raise AssertionError(f"iteration {iters}: non-finite losses {bad}")
            if iters >= 2:
                times[kind].append(start.elapsed_time(end))
        counts = {k: sum(1 for s in self.steps if s[1] == k) for k in times}
        print("launches checked for " + ", ".join(
            f"{n} {STEP_NAMES[k]} steps ({self.per_step[k]})" for k, n in counts.items() if n)
            + "; all losses finite")
        out = {k: statistics.median(v) for k, v in times.items() if v}
        for k, v in times.items():
            if v:
                print(f"{k} step: median {out[k]:.3f} ms over {len(v)} steps after the "
                      f"first two (min {min(v):.3f}, max {max(v):.3f}; CUDA events)")
        return out


# Phase 7's CLI run and the runs held against it (7b, 7c (a), the variant
# CLI, phase 9's chunked CLI): one epoch of the synthetic task, its training
# pairs cut to their first SYNTHETIC_IMAGES (``synthetic_once``): the runs'
# depth, SYNTHETIC_ITERS iterations at batch 8, a line every 8.
SYNTHETIC_IMAGES = 128
SYNTHETIC_ITERS = SYNTHETIC_IMAGES // TRAIN_BATCH
SYNTHETIC_FLAGS = ("--task_name=synthetic", f"--image_size={SIZE}",
                   f"--batch_size={TRAIN_BATCH}", "--epochs=1", "--precision=bf16",
                   "--slim_state=mv", "--model_save_interval=1000", "--log_interval=8")


def drive_trainer(work: Path):
    """The trainer CLI at 512px, batch 8, bf16, slim_state=mv, one epoch of
    the synthetic task; returns (model_path, launches, step ms)."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train.loop import run_training

    args = parse_with_config(translation_parser(), [
        *SYNTHETIC_FLAGS, "--steps_per_call=1",
        f"--results_dir={work / 'results'}", f"--models_dir={work / 'models'}"])
    observer = StepObserver()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    with first_save_skipped() as skipped:
        result, model_path = run_training(args, observer=observer)
    wall = time.perf_counter() - t0
    if skipped != [("train state", 1), ("layout", 0)]:
        raise AssertionError(f"trainer: its save at iteration 0 made {skipped}")
    launches = dict(_build.launches)
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    step_ms = observer.report()
    steady = steady_img_s(observer, step_ms)
    print(f"trainer: {len(observer.steps)} iterations in {wall:.1f} s (host clock, "
          f"data, sample forwards and the final save included; the save at iteration 0 "
          f"not written); {steady:.1f} img/s at the "
          f"median step times; peak memory {peak / 2**30:.2f} GiB allocated, "
          f"{reserved / 2**30:.2f} GiB reserved (torch.cuda.max_memory_allocated, "
          f"max_memory_reserved)")
    return model_path, launches, {"step_ms": step_ms, "img_s": steady, "peak": peak,
                                  "reserved": reserved, "result": result,
                                  "model_path": model_path}


# -- the distributed phase: the data-parallel CLI at a world of one ----------

class DistStepObserver(StepObserver):
    """StepObserver that also keeps each step's all-reduces, by kind."""

    def begin(self, iters, kind):
        from discogan_modernized_torch.parallel import collectives

        self._reduces = collectives["all_reduce"]
        super().begin(iters, kind)

    def end(self, iters, kind, losses):
        from discogan_modernized_torch.parallel import collectives

        super().end(iters, kind, losses)
        self.__dict__.setdefault("reduces", {}).setdefault(kind, set()).add(
            collectives["all_reduce"] - self._reduces)


@contextlib.contextmanager
def state_in_memory(total: int, device=None, disk=None):
    """The trainer's saves kept in memory instead of on disk for the block:
    the final train state (iteration ``total``) as ``save_train_state``
    would write it, copied on the card (or to ``device``: "cpu" leaves the
    run's peak memory as it was), and the tags of the reference-layout
    saves. A 512px run writes several GiB a save, and the card machine's
    disk takes 45 GiB of writes a call in all. ``disk(iters, meta)``: the
    train-state saves that go to the disk all the same (their seconds on
    the host clock in ``kept["disk_s"]``)."""
    from discogan_modernized_torch.train import loop

    kept = {"layouts": [], "states": [], "disk_s": []}
    real = loop.save_train_state

    def copy(t):
        return t.detach().clone() if device is None else t.detach().to(device, copy=True)

    def save_train_state(model_path, ts, iters, meta=None, **kw):
        kept["states"].append(iters)
        if disk is not None and disk(iters, meta or {}):
            t0 = time.perf_counter()
            real(model_path, ts, iters, meta, **kw)
            kept["disk_s"].append(time.perf_counter() - t0)
            return
        if iters == total:
            kept["state"] = {
                "models": {n: {k: copy(v) for k, v in m.state_dict().items()}
                           for n, m in ts.models.items()},
                **{key: {"m": [copy(t) for t in opt.m], "v": [copy(t) for t in opt.v],
                         "step": opt.step}
                   for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis))}}

    def save_reference_layout(model_path, models, tag):
        kept["layouts"].append(tag)

    saved = loop.save_train_state, loop.save_reference_layout
    loop.save_train_state, loop.save_reference_layout = save_train_state, save_reference_layout
    try:
        yield kept
    finally:
        loop.save_train_state, loop.save_reference_layout = saved


@contextlib.contextmanager
def first_save_skipped():
    """The trainer's save at iteration 0 (the train state that holds one
    iteration, the reference layout tagged 0) recorded and not written:
    nothing here reads it, the run's later saves write the same files
    through the same functions, and a 512px save is 7-8 GB of the card
    machine's 45 GiB of disk writes a call. Every other save is written."""
    from discogan_modernized_torch.train import loop

    skipped = []
    real = loop.save_train_state, loop.save_reference_layout

    def save_train_state(model_path, ts, iters, meta=None, **kw):
        if iters == 1 and not (meta or {}).get("preempted"):
            skipped.append(("train state", iters))
        else:
            real[0](model_path, ts, iters, meta, **kw)

    def save_reference_layout(model_path, models, tag):
        if tag == 0:
            skipped.append(("layout", tag))
        else:
            real[1](model_path, models, tag)

    loop.save_train_state, loop.save_reference_layout = save_train_state, save_reference_layout
    try:
        yield skipped
    finally:
        loop.save_train_state, loop.save_reference_layout = real


# One step a call first: its steps' all-reduces are what each capture must hold,
# and what a remat run's steps add to.
# The chunked run under --bn_sync is 7c (a)'s gspmd chunked run: global
# BatchNorm's all-reduces captured at a world of one.
DIST_RUNS = (("per-step", True), ("per-step", False), ("remat", True), ("chunked", False))


@contextlib.contextmanager
def synthetic_once():
    """The synthetic task's arrays (data/pipeline.py::synthetic_pair) drawn
    once a process and copied out at each call: a 512px task is 1.6 GB of
    seeded numpy draws, several seconds of host time, and a dozen runs here
    draw the same ones. The values are the same either way. The training
    pairs (seed 0) are cut to their first SYNTHETIC_IMAGES: the 512px runs
    that repeat phase 7's run (7b, 7c (a)) train half the task's epoch, and
    every run held against another takes the same cut."""
    from discogan_modernized_torch.data import pipeline

    made: dict = {}
    draw = pipeline.synthetic_pair

    def synthetic_pair(n: int, image_size: int, seed: int = 0):
        if (n, image_size, seed) not in made:
            made[n, image_size, seed] = draw(n, image_size, seed)
        keep = min(n, SYNTHETIC_IMAGES) if seed == 0 else n
        return tuple(a[:keep].copy() for a in made[n, image_size, seed])

    pipeline.synthetic_pair = synthetic_pair
    try:
        yield
    finally:
        pipeline.synthetic_pair = draw


def drive_distributed(work: Path, synthetic: dict) -> dict:
    """The distributed CLI at a world of one on NCCL (--distributed
    --world_size 1, in this process) with phase 7's flags, one step a call
    with and without --bn_sync, one step a call under --bn_sync --remat=on,
    and on the chunked default with BatchNorm per rank (7c (a)'s gspmd
    chunked run captures global BatchNorm's all-reduces): each run's log
    lines and final train state equal to phase 7's bit for bit (an
    all-reduce over one rank is the identity); its all-reduces counted, 2 a step (the gradients, the
    losses) under per-rank BatchNorm and more under bn_sync (the
    statistics), under remat more again on the steps whose backward
    rebuilds a region (the rebuild takes the statistics over the ranks
    too), and on the chunked path inside each captured graph, as many as
    the same kind's eager step; its launches as PER_STEP (under remat,
    ``variant_per_step``'s); ms a step beside phase 7's. The runs keep
    their saves in memory (``state_in_memory``). Returns the launches."""
    from discogan_modernized_torch.cli import distributed_image_translation as dcli
    from discogan_modernized_torch.cli.common import distributed_parser, parse_with_config
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.parallel import reset_collectives
    from discogan_modernized_torch.train import chunk
    from discogan_modernized_torch.train.loop import config_from_args
    from discogan_modernized_torch.train.step import resolve_remat

    reference = torch.load(synthetic["model_path"] / "train_state.pt", map_location="cuda",
                           weights_only=True)
    theirs = TRAIN_LINE.findall((synthetic["result"] / "training_log.txt").read_text())
    eager_reduces: dict = {}
    counts: dict = {}
    for path, sync in DIST_RUNS:
        tag = f"dist_{path}_{'sync' if sync else 'local'}"
        argv = [*SYNTHETIC_FLAGS, "--distributed", "--world_size=1",
                f"--results_dir={work / tag / 'results'}",
                f"--models_dir={work / tag / 'models'}",
                *(["--bn_sync"] if sync else []),
                *(["--steps_per_call=1"] if path != "chunked" else []),
                *(["--remat=on"] if path == "remat" else [])]
        if path == "chunked":
            observer = ChunkObserver()
        elif path == "remat":
            # the trainer decides remat_dis as this does (far from the card's
            # free memory at batch 8)
            cfg, _ = resolve_remat(config_from_args(parse_with_config(distributed_parser(),
                                                                      argv)),
                                   TRAIN_BATCH, "cuda")
            observer = DistStepObserver(variant_per_step(remat="full",
                                                         remat_dis=cfg.remat_dis))
        else:
            observer = DistStepObserver()
        _build.reset_launches()
        chunk.reset_replays()
        reset_collectives()
        t0 = time.perf_counter()
        tee = Tee(sys.stdout)
        with state_in_memory(SYNTHETIC_ITERS) as kept, contextlib.redirect_stdout(tee):
            result, _ = dcli.main(argv, observer=observer)
        wall = time.perf_counter() - t0
        counts = _add([counts, _build.launches])
        text = tee.text.getvalue()
        if "data parallel: rank 0 of 1 (nccl" not in text:
            raise AssertionError(f"{tag}: no NCCL rank line in its output")
        if kept["layouts"] != [0, "final"] or kept["states"] != [1, SYNTHETIC_ITERS]:
            raise AssertionError(f"{tag}: saves {kept['layouts']} / {kept['states']}")
        ms = observer.report()
        if path == "chunked":
            check_path_line(text, tag, CHUNK_K)
            program = observer.program
            for kind, n in program.collectives.items():
                if n != eager_reduces.get((sync, kind), n) or n < 2 or (n == 2) == sync:
                    raise AssertionError(f"{tag}: the {kind} capture holds {n} all-reduces "
                                         f"(per step: {eager_reduces})")
            print(f"{tag}: all-reduces captured in the graphs: {program.collectives}; "
                  f"{sum(chunk.replays.values())} replays; {ms.get('replayed', 0):.3f} ms "
                  f"an iteration replayed; {wall:.1f} s (host clock)")
        elif path == "remat":
            rebuilds = {"gen": True, "dis": cfg.remat_dis}
            for kind, ns in observer.reduces.items():
                (n,) = ns
                base = eager_reduces[(sync, kind)]
                if (n <= base) if rebuilds[kind] else (n != base):
                    raise AssertionError(f"{tag}: {kind} steps ran {ns} all-reduces, "
                                         f"{base} without remat")
            print(f"{tag}: all-reduces a step {{{', '.join(f'{k}: {n}' for k, (n,) in observer.reduces.items())}}} "
                  f"(without remat {{{', '.join(f'{k}: {v}' for (s2, k), v in eager_reduces.items() if s2 == sync)}}}); "
                  f"D {ms['dis']:.3f} ms, G {ms['gen']:.3f} ms a step; "
                  f"{wall:.1f} s (host clock)")
        else:
            for kind, ns in observer.reduces.items():
                (n,) = ns
                if n < 2 or (n == 2) == sync:
                    raise AssertionError(f"{tag}: {kind} steps ran {ns} all-reduces")
                eager_reduces[(sync, kind)] = n
            print(f"{tag}: all-reduces a step {{{', '.join(f'{k}: {v}' for (s2, k), v in eager_reduces.items() if s2 == sync)}}}; "
                  f"D {ms['dis']:.3f} ms, G {ms['gen']:.3f} ms a step (phase 7: D "
                  f"{synthetic['step_ms']['dis']:.3f}, G {synthetic['step_ms']['gen']:.3f}); "
                  f"{wall:.1f} s (host clock)")
        mine = TRAIN_LINE.findall((result / "training_log.txt").read_text())
        if mine != theirs:
            raise AssertionError(f"{tag}: log lines differ from phase 7's")
        compare_states(kept["state"], reference, f"{tag} vs phase 7's run")
        del kept["state"]
        shutil.rmtree(work / tag)
    del reference
    torch.cuda.empty_cache()
    return counts


# -- the mesh phase: tensor and spatial sharding (parallel/gspmd.py) ---------

# (a): the distributed CLI at a world of one on NCCL, phase 7's flags, on
# the (data 1, model 1) mesh: tensor parallelism one step a call and
# chunked, spatial sharding one step a call.
MESH_RUNS = (("gspmd", "per-step"), ("gspmd", "chunked"), ("spatial", "per-step"))
# (b): two ranks sharing the card over gloo, --tp 2, from the seeded state
# MESH_SEED on the seeded batch MESH_DATA_SEED. In bf16 (phase 7's policy),
# one D and one G step: each rank's launches, kernel shapes, collectives,
# state and peak bytes, and ms. In f32 under deterministic algorithms, one D
# and one G step's losses and gradients against the one process's on the
# same batch, which rank 0 also takes on its images moved by one f32 ulp:
# how far that moves each gradient is that gradient's own sensitivity, and
# the mesh's may differ from the one process's by MESH_FLOOR_FACTOR times
# it, or by EQUIV_GRAD_REL (F5's fixed floor) where that is larger, each
# tensor against its own; the losses by EQUIV_LOSS_REL. (In bf16 one ulp
# moves a gradient by ~0.4-0.5 of its norm, which no gate can see through.)
# MESH_FAULTS plants a fault a mode (``--planted-fault``): the model ranks'
# input gradients left unsummed (TP), the banded layers' gradients summed
# over the data axis alone (spatial); the f32 gate must refuse both.
MESH_SEED, MESH_DATA_SEED = 5, 6
MESH_FLOOR_FACTOR = 3
MESH_TP = 2
MESH_MODES = ("gspmd", "spatial")
MESH_FAULTS = {"gspmd": "_SumGrads's backward without its all-reduce",
               "spatial": "the banded layers' gradients summed over the data axis only"}


def mesh_config():
    from discogan_modernized_torch.train.step import TrainConfig

    return TrainConfig(image_size=SIZE, precision="bf16", slim_state="mv", remat=False)


def mesh_batch():
    rng = np.random.RandomState(MESH_DATA_SEED)
    return tuple(torch.from_numpy(rng.rand(TRAIN_BATCH, SIZE, SIZE, 3).astype(np.float32))
                 .cuda() for _ in range(2))


def drive_mesh(work: Path, synthetic: dict) -> dict:
    """(a) The distributed CLI at a world of one on NCCL (--distributed
    --world_size 1 --tp 1) with phase 7's flags under --parallel_mode gspmd
    one step a call and on the chunked default, and --parallel_mode spatial
    one step a call (its chunks are declined): each run's path line naming
    its mesh, its log lines and final train state equal to phase 7's bit for
    bit, its all-reduces a step as phase 7b's under --bn_sync (BatchNorm is
    global on a mesh) and inside each captured graph as many as the same
    kind's eager step, no all-gather (nothing is split over one rank); its
    launches as PER_STEP, saves kept in memory. (b) ``mesh_ranks``. Returns
    the launches of (a)."""
    from discogan_modernized_torch.cli import distributed_image_translation as dcli
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.parallel import collectives, reset_collectives
    from discogan_modernized_torch.train import chunk

    reference = torch.load(synthetic["model_path"] / "train_state.pt", map_location="cuda",
                           weights_only=True)
    theirs = TRAIN_LINE.findall((synthetic["result"] / "training_log.txt").read_text())
    eager: dict = {}
    counts: dict = {}
    peaks = {}
    for mode, path in MESH_RUNS:
        tag = f"mesh_{mode}_{path}"
        argv = [*SYNTHETIC_FLAGS, "--distributed", "--world_size=1", f"--parallel_mode={mode}",
                "--tp=1", f"--results_dir={work / tag / 'results'}",
                f"--models_dir={work / tag / 'models'}",
                *(["--steps_per_call=1"] if path == "per-step" else [])]
        observer = ChunkObserver() if path == "chunked" else DistStepObserver()
        _build.reset_launches()
        chunk.reset_replays()
        reset_collectives()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tee = Tee(sys.stdout)
        with state_in_memory(SYNTHETIC_ITERS) as kept, contextlib.redirect_stdout(tee):
            result, _ = dcli.main(argv, observer=observer)
        wall = time.perf_counter() - t0
        peaks[tag] = torch.cuda.max_memory_allocated()
        counts = _add([counts, _build.launches])
        text = tee.text.getvalue()
        if f"; mesh {mode} (data=1, model=1) over nccl" not in text:
            raise AssertionError(f"{tag}: no mesh on NCCL in its path line")
        if kept["layouts"] != [0, "final"] or kept["states"] != [1, SYNTHETIC_ITERS]:
            raise AssertionError(f"{tag}: saves {kept['layouts']} / {kept['states']}")
        if collectives["all_gather"]:
            raise AssertionError(f"{tag}: {collectives['all_gather']} all-gathers over a "
                                 "model axis of one rank")
        ms = observer.report()
        if path == "chunked":
            check_path_line(text.replace("; mesh gspmd (data=1, model=1) over nccl", ""),
                            tag, CHUNK_K)
            program = observer.program
            for kind, n in program.collectives.items():
                if n != eager[kind] or program.gathers[kind]:
                    raise AssertionError(f"{tag}: the {kind} capture holds {n} all-reduces "
                                         f"and {program.gathers[kind]} all-gathers (per "
                                         f"step: {eager})")
            print(f"{tag}: all-reduces captured in the graphs: {program.collectives}, "
                  f"all-gathers {program.gathers}; {sum(chunk.replays.values())} replays; "
                  f"{ms.get('replayed', 0):.3f} ms an iteration replayed; {wall:.1f} s "
                  "(host clock)")
        else:
            for kind, ns in observer.reduces.items():
                (n,) = ns
                if n <= 2 or n != eager.setdefault(kind, n):
                    raise AssertionError(f"{tag}: {kind} steps ran {ns} all-reduces")
            print(f"{tag}: all-reduces a step {{{', '.join(f'{k}: {n}' for k, (n,) in observer.reduces.items())}}}, "
                  f"no all-gather; D {ms['dis']:.3f} ms, G {ms['gen']:.3f} ms a step "
                  f"(phase 7: D {synthetic['step_ms']['dis']:.3f}, G "
                  f"{synthetic['step_ms']['gen']:.3f}); peak {peaks[tag] / 2**30:.2f} GiB "
                  f"allocated; {wall:.1f} s (host clock)")
        mine = TRAIN_LINE.findall((result / "training_log.txt").read_text())
        if mine != theirs:
            raise AssertionError(f"{tag}: log lines differ from phase 7's")
        compare_states(kept["state"], reference, f"{tag} vs phase 7's run")
        del kept["state"]
        shutil.rmtree(work / tag)
    counts = _add([counts, mesh_orbax_resume(work, reference)])
    del reference
    torch.cuda.empty_cache()
    check_nccl_capture()
    mesh_ranks(work, peaks["mesh_gspmd_per-step"])
    return counts


def mesh_orbax_resume(work: Path, reference: dict) -> dict:
    """(a) under --ckpt_backend orbax: the gspmd run one step a call, world
    1 on NCCL, sent SIGTERM at the end of iteration SIGTERM_AT (its save at
    iteration 0 kept in memory; the SIGTERM's written, train_state_orbax/
    with rank 0's one part and the index, timed), then --resume'd from that
    directory to the end (its saves in memory): the resumed run trains the
    rest, and its final train state equals phase 7's bit for bit. Returns
    the launches of both runs."""
    from discogan_modernized_torch.cli import distributed_image_translation as dcli
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train.checkpoint import ORBAX_DIR

    tag = "mesh_orbax"
    base = [*SYNTHETIC_FLAGS, "--distributed", "--world_size=1", "--parallel_mode=gspmd",
            "--tp=1", "--steps_per_call=1", "--ckpt_backend=orbax"]

    def dirs(run):
        return [f"--results_dir={work / tag / run / 'results'}",
                f"--models_dir={work / tag / run / 'models'}"]

    _build.reset_launches()
    handler = signal.getsignal(signal.SIGTERM)
    stop = SigtermObserver(SIGTERM_AT)
    t0 = time.perf_counter()
    with state_in_memory(SYNTHETIC_ITERS, disk=lambda iters, meta: meta.get("preempted")) \
            as kept:
        _, stopped = dcli.main([*base, *dirs("stopped")], observer=stop)
    wall = time.perf_counter() - t0
    meta = json.loads((stopped / "train_state_meta.json").read_text())
    if not (meta.get("preempted") and meta["iters"] == SIGTERM_AT + 1
            and meta.get("backend") == "orbax" and signal.getsignal(signal.SIGTERM) is handler
            and kept["states"] == [1, SIGTERM_AT + 1] and len(kept["disk_s"]) == 1):
        raise AssertionError(f"{tag}: SIGTERM at iteration {SIGTERM_AT}: meta {meta}, "
                             f"saves {kept['states']}")
    files = {f.name: f.stat().st_size for f in sorted((stopped / ORBAX_DIR).iterdir())}
    if sorted(files) != ["index.json", "part_m0.pt"]:
        raise AssertionError(f"{tag}: the save holds {sorted(files)}")
    stop.report()
    sizes = ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in files.items())
    print(f"{tag}: SIGTERM at the end of iteration {SIGTERM_AT}: saved iteration "
          f"{meta['iters']} as {ORBAX_DIR}/ ({sizes}) in {kept['disk_s'][0]:.2f} s (host clock, one rank: rank 0 writes the whole "
          f"state); the run {wall:.1f} s", flush=True)
    resume = DistStepObserver()
    t0 = time.perf_counter()
    with state_in_memory(SYNTHETIC_ITERS) as kept:
        dcli.main([*base, *dirs("resumed"), f"--resume={stopped}"], observer=resume)
    done = [s_[0] for s_ in resume.steps]
    if done != list(range(SIGTERM_AT + 1, SYNTHETIC_ITERS)):
        raise AssertionError(f"{tag}: the resumed run trained iterations {done}")
    resume.report()
    print(f"{tag}: resumed from {ORBAX_DIR}/ and trained iterations {done[0]}-{done[-1]} in "
          f"{time.perf_counter() - t0:.1f} s (host clock, the load included)", flush=True)
    compare_states(kept.pop("state"), reference,
                   f"{tag}: SIGTERM'd and resumed under orbax vs phase 7's run")
    shutil.rmtree(work / tag)
    return dict(_build.launches)


def mesh_ranks(work: Path, world1_peak: int | None, faults: bool = False) -> dict:
    """(b) Two ranks sharing the card over gloo (spawned; ``mesh_rank``),
    --tp 2, under tensor parallelism and then spatial sharding. In bf16: each
    rank's launches by kernel, with K3 at the split layers' CO/2 and K4 on
    their slices under tensor parallelism, and K3's stem, K5f and K6 on the
    bands' rows under spatial sharding; each rank's state bytes and peak
    memory beside the one process's and (a)'s; each rank's step ms (gloo
    through host memory on one card: not a multi-card speed). In f32: one D
    and one G step's losses and gradients held against the one process's,
    each gradient within its own gate (``mesh_gate``). With ``faults``, the
    f32 run alone, with MESH_FAULTS planted: each mode's gate must refuse
    it. Returns the f32 readings, by mode and step."""
    import torch.multiprocessing as mp

    from discogan_modernized_torch.core.distributed import free_port

    out_dir = work / ("mesh_faults" if faults else "mesh_ranks")
    out_dir.mkdir()
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(MESH_TP, free_port(), str(out_dir), faults),
                       nprocs=MESH_TP, start_method="spawn")
    print(f"mesh ranks{' (faults planted)' if faults else ''}: "
          f"{time.perf_counter() - t0:.1f} s (host clock, the two processes' start and "
          "the state's making on the CPU included)")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(MESH_TP)]
    shutil.rmtree(out_dir)
    if not faults:
        mesh_saves_report(ranks)
        mesh_bf16_report(ranks, world1_peak)
    print(f"mesh f32 steps (rank 0's host seconds, the card synchronized): " + ", ".join(
        f"{k} {s:.3f}" for k, s in ranks[0]["f32"]["seconds"].items()))
    readings = {}
    for mode in MESH_MODES:
        for which in ("dis", "gen"):
            c = ranks[0]["f32"][mode][which]
            readings[f"{mode}.{which}"] = c
            name, rel, floor, limit = c["worst"]
            print(f"{mode} tp {MESH_TP}, f32 {which} step{' (fault: ' + MESH_FAULTS[mode] + ')' if faults else ''}: "
                  f"relative loss difference {c['loss_rel']:.3e} (limit {EQUIV_LOSS_REL:.0e}; "
                  f"one-ulp sensitivity {c['loss_floor']:.3e}); nearest its gate: {name} "
                  f"||diff||/||g|| {rel:.3e} (limit {limit:.3e}, one-ulp sensitivity "
                  f"{floor:.3e}); largest ||diff||/||g|| {c['largest'][1]:.3e} "
                  f"({c['largest'][0]}); largest sensitivity {c['floor_max'][1]:.3e} "
                  f"({c['floor_max'][0]}); {len(c['outside'])} of {c['tensors']} tensors "
                  "outside their gates")
        outside = [ranks[0]["f32"][mode][w]["outside"] or
                   ranks[0]["f32"][mode][w]["loss_rel"] > EQUIV_LOSS_REL for w in ("dis", "gen")]
        if faults and not any(outside):
            raise AssertionError(f"{mode} tp {MESH_TP}: the gate let the planted fault "
                                 f"({MESH_FAULTS[mode]}) through")
        if not faults and any(outside):
            raise AssertionError(f"{mode} tp {MESH_TP}: the f32 step is outside its gate: "
                                 + "; ".join(str(ranks[0]["f32"][mode][w]["outside"][:4])
                                             for w in ("dis", "gen")))
    return readings


def mesh_bf16_report(ranks: list, world1_peak: int) -> None:
    """Print and check (b)'s bf16 readings."""
    ref = ranks[0]["reference"]
    ref_peak = ref["peak"] - ref["held"]
    print(f"one process (the world of one's bits): state {ref['state_bytes'] / 2**30:.2f} GiB, "
          f"peak {ref_peak / 2**30:.2f} GiB over one D and one G step's gradients (above the "
          f"batch it held before); (a)'s CLI run peaked at {world1_peak / 2**30:.2f} GiB (the "
          f"dataset on the card included); {smi_line()}")
    for mode in MESH_MODES:
        for r, res in enumerate(ranks):
            m = res[mode]
            print(f"{mode} rank {r}: launches D {m['launches']['dis']}, G "
                  f"{m['launches']['gen']}; collectives D {m['collectives']['dis']}, G "
                  f"{m['collectives']['gen']}")
            peak = m["peak"] - m["held"]
            print(f"{mode} rank {r}: state {m['state_bytes'] / 2**30:.2f} GiB "
                  f"({m['state_bytes'] / ref['state_bytes']:.3f} of the one process's), peak "
                  f"{peak / 2**30:.2f} GiB ({peak / ref_peak:.3f} of the one process's; "
                  "torch.cuda.max_memory_allocated above what the rank held before "
                  f"placing its state); its first D and G step in bf16: D "
                  f"{m['ms']['dis']:.1f} ms, G {m['ms']['gen']:.1f} ms a step (CUDA events; "
                  "gloo through host memory, two ranks on one card: not a multi-card speed)")
            check_mesh_shapes(mode, m["shapes"])


def check_mesh_shapes(mode: str, shapes: dict) -> None:
    """The kernels ran at the mesh's shapes: under tensor parallelism K3 with
    each split encoder layer's CO/2 and K4 with its slice of dy; under
    spatial sharding K3's stem on the 512px input's band of 256 rows with
    two a side (260), K5f on enc1's band (128 + 4 rows) and K6 on the head's
    band (128 + 2 rows)."""
    calls = shapes["gen"]
    if mode == "gspmd":
        want = {co // MESH_TP for co in CHANS[2:]}
        k3 = {w[-1] for kernel, x, w in calls if kernel == "conv"}
        k4 = {dy[-1] for kernel, x, dy in calls if kernel == "conv_dw"}
        if not (want <= k3 and want <= k4):
            raise AssertionError(f"gspmd: K3's output channels {sorted(k3)}, K4's "
                                 f"{sorted(k4)}; want CO/{MESH_TP} of enc2-enc6 {sorted(want)}")
    else:
        rows = {(kernel, x[1]) for kernel, x, _ in calls}
        want = {("conv", SIZE // MESH_TP + 4), ("halo", SIZE // 2 // MESH_TP + 4),
                ("halo_dw", SIZE // 2 // MESH_TP + 4), ("head", SIZE // 2 // MESH_TP + 2)}
        if not want <= rows:
            raise AssertionError(f"spatial: band rows {sorted(rows)}; want {sorted(want)}")
    print(f"{mode}: the kernels ran at the mesh's shapes ({len(calls)} kernel calls in a G "
          "step checked)")


def plant_faults() -> None:
    """MESH_FAULTS, in this process: ops/sharding.py's ``_SumGrads`` passes
    each rank's own input gradient back, and parallel/gspmd.py's
    ``banded_layers`` names no layer, so that the banded layers' gradients
    are summed over the data axis only."""
    from discogan_modernized_torch.ops import sharding
    from discogan_modernized_torch.parallel import gspmd

    sharding._SumGrads.backward = staticmethod(lambda ctx, g: (g, None))
    gspmd.banded_layers = lambda image_size, tp: {"gen": set(), "dis": set()}


def mesh_rank(rank: int, world: int, port: int, out_dir: str, faults: bool) -> None:
    """A rank of ``mesh_ranks`` (spawned): on card 0, in a gloo group of
    ``world``."""
    import torch.distributed as dist

    from discogan_modernized_torch.train.step import init_train_state

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        if faults:
            plant_faults()
        whole = init_train_state(MESH_SEED, mesh_config(), "cpu")
        A, B = mesh_batch()
        out = {"f32": mesh_rank_f32(rank, world, whole, A, B)}
        torch.use_deterministic_algorithms(False)
        if not faults:
            out.update(mesh_rank_bf16(rank, world, whole, A, B, Path(out_dir)))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def _step_names(ts, cfg, which) -> list:
    from discogan_modernized_torch.train.graph import trainable_subsets

    keys = trainable_subsets(cfg.model_arch)[0 if which == "gen" else 1]
    return [(k, n) for k in keys for n, _ in ts.models[k].named_parameters()]


def _one_process(whole, cfg):
    """``whole`` (a CPU state) copied onto the card as one process holds it."""
    import copy

    from discogan_modernized_torch.train.step import TrainState, make_optimizers

    models = {k: m.to("cuda") for k, m in copy.deepcopy(whole.models).items()}
    return TrainState(models, *make_optimizers(models, cfg))


def mesh_rank_bf16(rank: int, world: int, whole, A, B, out_dir: Path) -> dict:
    """(b)'s bf16 run on this rank, after the f32 one: rank 0 first takes
    one D and one G step's gradients as one process (its state and peak
    bytes); then per mode, the state placed, one D and one G train step,
    each timed and its launches, collectives and kernel calls' shapes
    counted; under tensor parallelism then ``mesh_rank_saves``."""
    import copy

    from discogan_modernized_torch.core.mesh import make_mesh
    from discogan_modernized_torch.core.precision import configure, default_policy
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.ops import autograd as ag
    from discogan_modernized_torch.parallel import collectives, reset_collectives
    from discogan_modernized_torch.parallel.gspmd import (MeshParallel,
                                                          make_gspmd_train_steps,
                                                          place_train_state)
    from discogan_modernized_torch.train.step import loss_and_grads

    cfg = mesh_config()
    policy = default_policy("bf16", torch.device("cuda"))
    configure(policy)
    calls = []
    kernels = dict(ag.KERNEL_OPS)
    for key, fn in kernels.items():
        def recorded(x, *args, _key=key, _fn=fn, **kwargs):
            w = args[0] if args and isinstance(args[0], torch.Tensor) else None
            calls.append((_key, tuple(x.shape), None if w is None else tuple(w.shape)))
            return _fn(x, *args, **kwargs)
        ag.KERNEL_OPS[key] = recorded
    out = {}
    try:
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            one = _one_process(whole, cfg)
            state_bytes = torch.cuda.memory_allocated() - base
            for which in ("dis", "gen"):
                loss_and_grads(one, A, B, 0.01, cfg, policy, which)
            torch.cuda.synchronize()
            out["reference"] = {"state_bytes": state_bytes, "held": base,
                                "peak": torch.cuda.max_memory_allocated()}
            del one
        for mode in MESH_MODES:
            mp = MeshParallel(make_mesh(1, world), spatial=mode == "spatial")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ts = place_train_state(copy.deepcopy(whole), mp, cfg, "cuda")
            res = {"state_bytes": torch.cuda.memory_allocated() - base, "launches": {},
                   "collectives": {}, "shapes": {}, "held": base, "ms": {}}
            gen_step, dis_step = make_gspmd_train_steps(cfg, mp, policy)
            for which, step in (("dis", dis_step), ("gen", gen_step)):  # one reading each
                reset_collectives()
                before = dict(_build.launches)
                calls.clear()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                step(ts, A, B, 0.01)
                end.record()
                end.synchronize()
                res["ms"][which] = start.elapsed_time(end)
                res["launches"][which] = {k: v - before[k] for k, v in _build.launches.items()
                                          if v != before[k]}
                res["collectives"][which] = dict(collectives)
                res["shapes"][which] = sorted(set(calls))
            res["peak"] = torch.cuda.max_memory_allocated()
            if mode == "gspmd":
                res["saves"] = mesh_rank_saves(rank, world, ts, mp, whole, cfg, out_dir)
            out[mode] = res
            del ts
    finally:
        ag.KERNEL_OPS.update(kernels)
    return out


def _state_dict(ts, device="cpu") -> dict:
    """A TrainState as ``save_train_state``'s npz dict, on ``device``
    (``compare_states`` reads it)."""
    def on(t):
        return t.detach().to(device)

    return {"models": {n: {k: on(v) for k, v in m.state_dict().items()}
                       for n, m in ts.models.items()},
            **{key: {"m": [on(t) for t in opt.m], "v": [on(t) for t in opt.v],
                     "step": opt.step}
               for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis))}}


def _tree_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def mesh_rank_saves(rank: int, world: int, ts, mp, whole, cfg, out_dir: Path) -> dict:
    """(b)'s saves on this rank, of the tp 2 state after its bf16 steps,
    as the trainer saves it without the reference layout
    (train/loop.py ``save_checkpoint``): under --ckpt_backend orbax, every
    rank its own slices (its part's bytes; the save's seconds on rank 0's
    host clock, fence to fence); under npz, the state gathered onto rank 0's
    CPU (``gather_train_state``, kept) and written there (the gather and
    the write timed). Then the orbax save loaded into a fresh whole state
    (a copy of the seeded one): rank 0 holds it, as one process (tp 1)
    loads it, against the gathered state, tensor by tensor, bit for bit;
    then that state placed on a new tp 2 mesh and gathered, held against
    it the same way."""
    import copy

    import torch.distributed as dist

    from discogan_modernized_torch.core.mesh import make_mesh
    from discogan_modernized_torch.parallel.gspmd import (MeshParallel, gather_train_state,
                                                          place_train_state)
    from discogan_modernized_torch.train.checkpoint import (ORBAX_DIR, load_train_state,
                                                            save_train_state,
                                                            train_state_meta)
    from discogan_modernized_torch.train.loop import save_checkpoint

    d = out_dir / "saves"
    meta = train_state_meta(cfg)
    out = {}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    save_checkpoint(d / "orbax", ts, mp, 2, meta, backend="orbax", every_rank=True,
                    main=rank == 0)
    out["orbax_s"] = time.perf_counter() - t0
    out["part_bytes"] = (d / "orbax" / ORBAX_DIR / f"part_m{mp.mesh.m}.pt").stat().st_size
    dist.barrier()
    t0 = time.perf_counter()
    gathered = gather_train_state(ts, mp)
    if rank == 0:
        save_train_state(d / "npz", gathered, 2, meta)
    out["npz_s"] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        out["orbax_bytes"] = _tree_bytes(d / "orbax" / ORBAX_DIR)
        out["npz_bytes"] = (d / "npz" / "train_state.pt").stat().st_size
    t0 = time.perf_counter()
    fresh = copy.deepcopy(whole)
    if load_train_state(d / "orbax", fresh, cfg) != 2:
        raise AssertionError("the orbax save's iteration count")
    out["load_s"] = time.perf_counter() - t0
    if rank == 0:
        compare_states(_state_dict(fresh), _state_dict(gathered),
                       "the orbax save of the tp 2 state, loaded at tp 1 (whole), vs the "
                       "state gathered")
    t0 = time.perf_counter()
    second = MeshParallel(make_mesh(1, world))
    loaded = gather_train_state(place_train_state(fresh, second, cfg, "cuda"), second)
    out["place_s"] = time.perf_counter() - t0
    if rank == 0:
        compare_states(_state_dict(loaded), _state_dict(gathered),
                       "the orbax save of the tp 2 state, loaded and placed at tp 2, "
                       "gathered, vs the state gathered")
    del loaded, fresh, gathered
    dist.barrier()
    return out


def mesh_saves_report(ranks: list) -> None:
    """(b)'s saves: their bytes and seconds, each rank's part."""
    s0 = ranks[0]["gspmd"]["saves"]
    parts = ", ".join(f"rank {r} {res['gspmd']['saves']['part_bytes'] / 2**30:.3f} GiB"
                      for r, res in enumerate(ranks))
    print(f"tp {MESH_TP} saves of the {SIZE}px state (slim state mv, no reference layout): "
          f"orbax {s0['orbax_bytes'] / 2**30:.3f} GiB in {s0['orbax_s']:.2f} s, the ranks' "
          f"parts {parts} written at once; npz {s0['npz_bytes'] / 2**30:.3f} GiB in "
          f"{s0['npz_s']:.2f} s (gathered onto rank 0's CPU and written there); the orbax "
          f"save loaded whole in {s0['load_s']:.2f} s, placed at tp {MESH_TP} and gathered in "
          f"{s0['place_s']:.2f} s; host clock on rank 0, two ranks sharing one card over "
          f"gloo; {smi_line()}", flush=True)


def mesh_rank_f32(rank: int, world: int, whole, A, B) -> dict:
    """(b)'s f32 run on this rank, under deterministic algorithms: rank 0
    takes one D and one G step as one process on (A, B) and on their images
    moved by one ulp; then per mode, the state placed and one D and one G
    step, the split gradients gathered onto rank 0, which holds them
    against its own (``mesh_gate``). Rank 0's readings by mode and step."""
    import copy

    from discogan_modernized_torch.core.mesh import make_mesh
    from discogan_modernized_torch.core.precision import F32, configure
    from discogan_modernized_torch.parallel.dp import gather
    from discogan_modernized_torch.parallel.gspmd import MeshParallel, place_train_state
    from discogan_modernized_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(mesh_config(), precision="f32")
    configure(F32)
    torch.use_deterministic_algorithms(True)
    seconds = {}  # each step's host seconds, the card synchronized around it

    def timed(key, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = loss_and_grads(*args, **kw)
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return r

    ref = {}
    if rank == 0:
        one = _one_process(whole, cfg)
        nudged = [torch.nextafter(t, torch.full_like(t, 2.0)) for t in (A, B)]
        for which in ("dis", "gen"):
            ref[which] = [timed(f"one process {which}", one, A, B, 0.01, cfg, F32, which),
                          loss_and_grads(one, *nudged, 0.01, cfg, F32, which)]
        names = {which: _step_names(one, cfg, which) for which in ("dis", "gen")}
        del one
    out = {}
    for mode in MESH_MODES:
        mp = MeshParallel(make_mesh(1, world), spatial=mode == "spatial")
        torch.cuda.empty_cache()
        ts = place_train_state(copy.deepcopy(whole), mp, cfg, "cuda")
        out[mode] = {}
        for which in ("dis", "gen"):
            losses, grads = timed(f"{mode} {which}", ts, A, B, 0.01, cfg, F32, which, dp=mp)
            whole_grads = []
            for (k, n), g in zip(_step_names(ts, cfg, which), grads):
                dim = mp.shards[k].get(n)
                if dim is not None:
                    parts = gather(g, mp.mesh.model_group)
                    g = torch.cat(parts, dim).cuda() if parts is not None else None
                whole_grads.append(g)
            del grads
            if rank == 0:
                (want_l, want_g), (nudged_l, nudged_g) = ref[which]
                out[mode][which] = mesh_gate(names[which], losses, whole_grads, want_l,
                                             want_g, nudged_l, nudged_g)
            del whole_grads
        del ts
    out["seconds"] = seconds
    return out


def mesh_gate(names, losses, grads, want_l, want_g, nudged_l, nudged_g) -> dict:
    """Each gradient's ||diff||/||g|| against the one process's beside its
    own one-ulp sensitivity and its limit, max(EQUIV_GRAD_REL,
    MESH_FLOOR_FACTOR x that sensitivity); the worst relative loss
    difference, and the one process's own on its nudged images."""
    def rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    def loss_rel(a):
        return max(abs(float(a[k]) - float(v)) / max(abs(float(v)), 1e-30)
                   for k, v in want_l.items())

    rows = []
    for (k, n), g, r, nu in zip(names, grads, want_g, nudged_g):
        got, floor = rel(g, r), rel(nu, r)
        rows.append((f"{k}.{n}", got, floor, max(EQUIV_GRAD_REL, MESH_FLOOR_FACTOR * floor)))
    return {"loss_rel": loss_rel(losses), "loss_floor": loss_rel(nudged_l),
            "worst": max(rows, key=lambda row: row[1] / row[3]),
            "largest": max(((r[0], r[1]) for r in rows), key=lambda r: r[1]),
            "floor_max": max(((r[0], r[2]) for r in rows), key=lambda r: r[1]),
            "outside": [r[0] for r in rows if r[1] > r[3]], "tensors": len(rows)}


def check_nccl_capture() -> None:
    """The mesh's collectives on NCCL under CUDA graph capture, which (a)
    does not issue (nothing splits over one rank) and (b) cannot (gloo):
    ops/sharding.py's ``_SumGrads``, ``_Gather`` and ``_Halo`` forward and
    backward over the model group of a one-rank NCCL mesh, captured into
    one CUDA graph, replayed on new inputs and held against the same calls
    run eagerly and against what they compute, bit for bit; the collectives
    counted at the capture. Then parallel/dp.py's ``gather`` (the saves';
    it lands on the CPU, so it is not captured) on NCCL."""
    import torch.distributed as dist

    from discogan_modernized_torch.core.distributed import free_port
    from discogan_modernized_torch.core.mesh import make_mesh
    from discogan_modernized_torch.ops.sharding import _Gather, _Halo, _SumGrads
    from discogan_modernized_torch.parallel import collectives
    from discogan_modernized_torch.parallel.dp import gather

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1)
        group = mesh.model_group

        def f(x, g):
            x = x.detach().requires_grad_()
            y = _Gather.apply(_SumGrads.apply(x * 2, group), group, 0, -1)
            h = _Halo.apply(y, mesh, 1)
            (dx,) = torch.autograd.grad(h, x, g)
            return h.detach(), dx

        gen = torch.Generator(device="cuda").manual_seed(12)
        shape, halo_shape = (2, 8, 16, 32), (2, 12, 16, 32)

        def inputs():
            return (torch.randn(shape, device="cuda", generator=gen, dtype=torch.bfloat16),
                    torch.randn(halo_shape, device="cuda", generator=gen, dtype=torch.bfloat16))

        static = inputs()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            f(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(collectives)
        with torch.cuda.graph(graph):
            h, dx = f(*static)
        captured = {k: v - before[k] for k, v in collectives.items()}
        x, g = inputs()
        for t, new in zip(static, (x, g)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        eager = f(x, g)
        zero = torch.zeros_like(x[:, :1])
        plain = (torch.cat([zero, zero, 2 * x, zero, zero], 1), 2 * g[:, 2:10])
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip((h, dx), eager, plain)):
            raise AssertionError("NCCL collectives replayed from a CUDA graph differ from "
                                 "their eager run or from what they compute")
        if captured != {"all_reduce": 1, "all_gather": 3, "gather": 0}:
            raise AssertionError(f"the capture counted {captured}")
        before = collectives["gather"]
        (part,) = gather(x, group)
        if not torch.equal(part, x.cpu()) or collectives["gather"] != before + 1:
            raise AssertionError("parallel.dp.gather on NCCL")
        print(f"NCCL under capture: _SumGrads, _Gather and _Halo over a one-rank model "
              f"group, captured ({captured}) and replayed = eager = their plain values "
              "bit for bit; dp.gather on NCCL ✓")
    finally:
        dist.destroy_process_group()


def steady_img_s(observer, step_ms) -> float:
    """img/s of the run's steps at the median D and G step times."""
    n_dis = sum(1 for s in observer.steps if s[1] == "dis")
    n_gen = len(observer.steps) - n_dis
    return observer.batch * (n_dis + n_gen) / (n_dis * step_ms["dis"] + n_gen * step_ms["gen"]) * 1e3


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



# -- phase 7, the train step's graph variants -----------------------------------

# Launches of one pass of each network at 512px (a pair's pass launches
# once), of the weight gradients of a pass that trains, and of a stem's
# input gradient (K6).
GEN_PASS = {"conv_k4s2p1": 6, "halo_conv_k4s2p1": 1, "batch_stats": 9, "bn_act": 14,
            "head_convt": 1}
DIS_PASS = {"conv_k4s2p1": 6, "halo_conv_k4s2p1": 1, "batch_stats": 1, "bn_act": 6}
TRAINED_PASS = {"conv_k4s2p1_dw": 6, "halo_conv_k4s2p1_dw": 1}
STEM_DX = {"head_convt": 1}
# The variants phase: one seeded state, each variant's TrainConfig fields.
VARIANTS = {
    "plain": {},
    "remat full": {"remat": True, "remat_policy": "full", "remat_dis": True},
    "remat latent": {"remat": True, "remat_policy": "latent", "remat_dis": True},
    "remat conv": {"remat": True, "remat_policy": "conv", "remat_dis": True},
    "lean_dis": {"lean_dis": True},
    "concat_dis": {"concat_dis": True},
    "paired": {"paired": True},
}
VARIANT_ROUNDS = 2  # timed rounds of D, G, G after the first D and G steps
TRAIN_LINE = re.compile(r"Iter \[(\d+)/\d+\] GEN: \d+\.\d{4}/\d+\.\d{4}, "
                        r"FM: \d+\.\d{4}/\d+\.\d{4}, RECON: (\d+\.\d{4})/(\d+\.\d{4}), "
                        r"DIS: \d+\.\d{4}/\d+\.\d{4}")


def variant_per_step(paired: bool = False, concat_dis: bool = False,
                     remat: str | None = None, remat_dis: bool = True) -> dict:
    """Launches of a D, a lean D and a G step, from the passes the graph
    makes: 4 generator passes (2 as pairs; a lean D step makes half of
    them), 4 discriminator passes (2 as pairs or under concat_dis); every
    pass of the networks a step trains takes its weight gradients, and on
    a G step the passes whose input takes a gradient (the generators'
    second passes, the discriminators' fake ones) take their stems' input
    gradients: 2 + 2 singly, 1 + 1 as pairs, 2 + 2 under concat_dis (each
    discriminator's pass holds its fake half). Under ``remat`` the backward
    rebuilds every pass whose graph it walks: on a D step the
    discriminators', on a G step the generators' and the fake
    discriminator passes (the discriminators' only with ``remat_dis``);
    "full" and "latent" rebuild a whole pass, "conv" its BatchNorm chains
    alone (K1 and K2)."""
    g = 2 if paired else 4
    d = 2 if paired or concat_dis else 4
    dx = 2 if paired else 4
    d_fake = 1 if paired else 2

    def rebuilt(counts, dis=False):
        if remat is None or (dis and not remat_dis):
            return {}
        if remat == "conv":
            return {k: v for k, v in counts.items() if k in ("batch_stats", "bn_act")}
        return counts

    def total(*terms):
        out = {}
        for times, counts in terms:
            for k, v in counts.items():
                out[k] = out.get(k, 0) + times * v
        return out

    d_step = ((d, DIS_PASS), (d, TRAINED_PASS), (d, rebuilt(DIS_PASS, True)))
    return {"dis": total((g, GEN_PASS), *d_step),
            "lean": total((g // 2, GEN_PASS), *d_step),
            "gen": total((g, GEN_PASS), (d, DIS_PASS), (g, TRAINED_PASS), (dx, STEM_DX),
                         (g, rebuilt(GEN_PASS)), (d_fake, rebuilt(DIS_PASS, True)))}


def _snapshot(ts) -> dict:
    """Every parameter, running statistic and Adam moment, on the host."""
    out = {f"{k}.{n}": t.detach().cpu()
           for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        for which in ("m", "v"):
            out.update({f"{key}.{which}{i}": t.cpu()
                        for i, t in enumerate(getattr(opt, which))})
    return out


def drive_variants() -> dict:
    """Each variant of VARIANTS from one seeded 512px bf16 state at batch 8,
    slim_state=mv, under deterministic algorithms: the first D (lean D) and
    G step's parameters, moments and running statistics against the plain
    graph's, bit for bit (lean: parameters, moments and the discriminators'
    statistics); every step's launches against ``variant_per_step``; then
    VARIANT_ROUNDS rounds of D, G, G timed (CUDA events), one G step under
    the profiler, and the peak memory. Then the auto-remat decision at batch
    8 and 64, and two steps at batch 64 as it decides."""
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                      make_lean_dis_step, make_optimizers,
                                                      make_train_steps, resolve_remat)

    plain_table = variant_per_step()
    if {k: plain_table[k] for k in ("dis", "gen")} != PER_STEP:
        raise AssertionError(f"the derived launch table {plain_table} is not PER_STEP")
    half = {k: {n: v // 2 for n, v in PER_STEP[k].items()} for k in PER_STEP}
    if {k: variant_per_step(paired=True)[k] for k in ("dis", "gen")} != half:
        raise AssertionError("the paired launch table is not half of PER_STEP")

    configure(BF16)
    base = TrainConfig(image_size=SIZE, precision="bf16", slim_state="mv")
    ts = init_train_state(3, base, "cuda")
    init = {k: {n: t.detach().cpu() for n, t in m.state_dict().items()}
            for k, m in ts.models.items()}
    rng = torch.Generator(device="cuda").manual_seed(11)
    A, B = (torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=rng)
            for _ in range(2))
    out, ref = {}, None
    torch.use_deterministic_algorithms(True)
    try:
        for name, fields in VARIANTS.items():
            cfg = dataclasses.replace(base, **fields)
            for k, m in ts.models.items():
                m.load_state_dict(init[k])
            ts.opt_gen, ts.opt_dis = make_optimizers(ts.models, cfg)
            gen_step, dis_step = make_train_steps(cfg, BF16)
            steps = {"gen": gen_step, "dis": dis_step,
                     "lean": make_lean_dis_step(cfg, BF16) if cfg.lean_dis else None}
            table = variant_per_step(cfg.paired, cfg.concat_dis and not cfg.paired,
                                     cfg.remat_policy if cfg.use_remat else None)
            d_kind = "lean" if cfg.lean_dis else "dis"
            times = {"dis": [], "gen": []}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i, kind in enumerate([d_kind, "gen"] + [d_kind, "gen", "gen"] * VARIANT_ROUNDS):
                before = dict(_build.launches)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                losses = steps[kind](ts, A, B, 0.01)
                end.record()
                delta = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
                if delta != table[kind]:
                    raise AssertionError(f"{name}, step {i} ({kind}): launches {delta}, "
                                         f"want {table[kind]}")
                bad = [k for k, v in losses.items() if not torch.isfinite(v).item()]
                if bad:
                    raise AssertionError(f"{name}: non-finite losses {bad}")
                if i >= 2:
                    end.synchronize()
                    times["gen" if kind == "gen" else "dis"].append(start.elapsed_time(end))
                if i == 1:
                    snap = _snapshot(ts)
                    if ref is None:
                        ref = snap
                    else:
                        # under lean the generators' running statistics take
                        # 2 updates a D step instead of 4
                        stat = lambda k: "running" in k or "num_batches" in k  # noqa: E731
                        skip = ("gen_A.", "gen_B.") if cfg.lean_dis else ()
                        differ = [k for k in ref if not (k.startswith(skip) and stat(k))
                                  and not torch.equal(ref[k], snap[k])]
                        print(f"{name}: after one D and one G step, {len(differ)} of "
                              f"{len(ref)} tensors differ from the plain graph's"
                              + (" (the generators' running statistics not compared)"
                                 if cfg.lean_dis else ""))
                        if differ:
                            raise AssertionError(f"{name} differs from the plain graph: "
                                                 f"{differ[:6]}")
                    del snap
            peak = torch.cuda.max_memory_allocated()
            profile = {}
            profile_call(lambda: gen_step(ts, A, B, 0.01), f"one G step, {name}", top=0,
                         out=profile)
            med = {k: statistics.median(v) for k, v in times.items()}
            out[name] = dict(med, peak=peak, launches=sum(table["gen"].values()),
                             **profile)
            print(f"{name}: D {med['dis']:.3f} ms, G {med['gen']:.3f} ms (medians of "
                  f"{len(times['dis'])} / {len(times['gen'])}, CUDA events); port kernel "
                  f"launches a G step {out[name]['launches']}; peak memory "
                  f"{peak / 2**30:.2f} GiB", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    del ref
    for batch in (TRAIN_BATCH, 64):
        cfg, line = resolve_remat(base, batch, "cuda")
        print(f"auto-remat at batch {batch} (this state resident): {line}")
    A64, B64 = (torch.rand(64, SIZE, SIZE, 3, device="cuda", generator=rng) for _ in range(2))
    gen_step, dis_step = make_train_steps(cfg, BF16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in (dis_step, gen_step):
        losses = step(ts, A64, B64, 0.01)
        if not all(torch.isfinite(v).item() for v in losses.values()):
            raise AssertionError("batch 64: non-finite losses")
    torch.cuda.synchronize()
    print(f"batch 64 under auto (remat {'on' if cfg.use_remat else 'off'}): one D and one G "
          f"step, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ts, A64, B64
    torch.cuda.empty_cache()
    return out


def drive_variant_cli(work: Path, plain_model_path: Path, plain_result: Path) -> None:
    """The trainer CLI as phase 7 runs it, with --paired --lean_dis
    --remat=on --remat_policy=conv and --log_interval=4: every step's
    launches against ``variant_per_step(paired=True)``, every loss finite;
    each logged line in the log's format with nonzero RECON (the logged D
    iterations take the full graph), iteration 0's line the same as phase
    7's; the final parameters and moments the same, bit for bit, as phase
    7's run's (the generators' running statistics differ under lean). Its
    saves are kept in memory (``state_in_memory``)."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.train.loop import config_from_args, run_training
    from discogan_modernized_torch.train.step import resolve_remat

    args = parse_with_config(translation_parser(), [
        "--task_name=synthetic", f"--image_size={SIZE}",
        f"--batch_size={TRAIN_BATCH}", "--epochs=1", "--precision=bf16",
        "--slim_state=mv", "--model_save_interval=1000", "--log_interval=4",
        "--paired", "--lean_dis", "--remat=on", "--remat_policy=conv", "--steps_per_call=1",
        f"--results_dir={work / 'variant_results'}", f"--models_dir={work / 'variant_models'}"])
    # the trainer decides remat_dis as this does (the estimate is far from
    # the card's free memory at batch 8)
    cfg, _ = resolve_remat(config_from_args(args), TRAIN_BATCH, "cuda")
    observer = StepObserver(variant_per_step(paired=True, remat="conv",
                                             remat_dis=cfg.remat_dis))
    torch.cuda.reset_peak_memory_stats()
    with state_in_memory(SYNTHETIC_ITERS, "cpu") as kept:
        result, model_path = run_training(args, observer=observer)
    if "state" not in kept:
        raise AssertionError(f"variant CLI: saves at {kept['states']}, none at iteration "
                             f"{SYNTHETIC_ITERS}")
    step_ms = observer.report()
    log = (result / "training_log.txt").read_text()
    lines = TRAIN_LINE.findall(log)
    want = [i for i in range(len(observer.steps)) if i % 4 == 0]
    if [int(i) for i, _, _ in lines] != want or any(
            float(a) == 0 or float(b) == 0 for _, a, b in lines):
        raise AssertionError(f"variant CLI log: logged iterations {lines}, want {want} "
                             "with nonzero RECON")
    first = next(l for l in (plain_result / "training_log.txt").read_text().splitlines()
                 if l.startswith("Iter [0/"))
    if first not in log.splitlines():
        raise AssertionError(f"variant CLI: iteration 0's line differs from phase 7's: {first}")
    a = torch.load(plain_model_path / "train_state.pt", map_location="cpu", weights_only=True)
    b = kept.pop("state")
    differ = []
    for name in a["models"]:
        for k, t in a["models"][name].items():
            lean_stat = name.startswith("gen") and ("running" in k or "num_batches" in k)
            if not lean_stat and not torch.equal(t, b["models"][name][k]):
                differ.append(f"{name}.{k}")
    for key in ("opt_gen", "opt_dis"):
        for which in ("m", "v"):
            differ += [f"{key}.{which}{i}" for i, (x, y) in
                       enumerate(zip(a[key][which], b[key][which])) if not torch.equal(x, y)]
    print(f"variant CLI: {len(observer.steps)} iterations, {len(lines)} logged lines with "
          f"nonzero RECON, iteration 0's line as phase 7's; final parameters and moments: "
          f"{len(differ)} tensors differ from phase 7's; D {step_ms.get('dis', 0):.3f} / lean "
          f"D {step_ms.get('lean', 0):.3f} / G {step_ms['gen']:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if differ:
        raise AssertionError(f"variant CLI's final state differs from phase 7's: {differ[:6]}")
    shutil.rmtree(model_path, ignore_errors=True)


# -- phase 8: a real-data task at 512px, slim_state=all, SIGTERM and resume --

REAL_TRAIN, REAL_TEST = 64, 8  # edges2shoes pairs written for the run
REAL_EPOCHS = 2  # 16 iterations at batch 8
SIGTERM_AT = 7  # the iteration at whose end the trainer gets SIGTERM


class SigtermObserver(StepObserver):
    """A StepObserver that sends this process SIGTERM at the end of one
    iteration, as a preemption would."""

    def __init__(self, at: int):
        super().__init__()
        self.at = at

    def end(self, iters, kind, losses):
        super().end(iters, kind, losses)
        if iters == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def write_edges2shoes(root: Path) -> None:
    """The dataset's geometry: side-by-side 512x256 JPEGs (edges left, photo
    right), made from a numpy seed."""
    from PIL import Image

    rng = np.random.RandomState(3)
    for split, n in (("train", REAL_TRAIN), ("test", REAL_TEST)):
        d = root / "edges2shoes" / split
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.rand(256, 512, 3) * 255).astype(np.uint8)).save(
                d / f"{i}_AB.jpg", quality=95)


def time_decode() -> None:
    """One epoch of the loader over the tree, cold (decoding into the cache)
    and warm (reading it), copies to the card included."""
    from discogan_modernized_torch.data.pipeline import HostLoader
    from discogan_modernized_torch.data.resolvers import get_edge2photo_files

    files, _ = get_edge2photo_files("edges2shoes")
    times = {}
    for what in ("cold", "warm"):
        loader = HostLoader(files, files, TRAIN_BATCH, SIZE, "cuda",
                            domain_A="A", domain_B="B")
        t0 = time.perf_counter()
        n = sum(1 for _ in loader.epoch(0))
        torch.cuda.synchronize()
        times[what] = time.perf_counter() - t0
        loader.close()
    print(f"decode of {len(files)} edges2shoes pairs to {SIZE}px, both domains, "
          f"{n} batches: cold (decode into the cache) {times['cold']:.3f} s, warm "
          f"(from the cache) {times['warm']:.3f} s (host clock)")


def real_args(work: Path, tag: str, *extra, per_step: bool = True):
    """The edges2shoes run's flags; ``per_step``: one step a call from the
    host loader (phase 8), else the trainer's defaults (the dataset on the
    card, chunks of CUDA graphs)."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser

    return parse_with_config(translation_parser(), [
        "--task_name=edges2shoes", f"--image_size={SIZE}", f"--batch_size={TRAIN_BATCH}",
        f"--epochs={REAL_EPOCHS}", "--precision=bf16", "--slim_state=all",
        "--model_save_interval=1000", f"--results_dir={work / tag / 'results'}",
        f"--models_dir={work / tag / 'models'}",
        *(("--steps_per_call=1", "--no_device_cache") if per_step else ()), *extra])


def keep_train_state(model_path: Path) -> None:
    """Delete a finished run's reference-layout .pth files, keeping its
    train_state.pt and meta for later comparisons: a 512px run writes ~7 GB
    at iteration 0 and at its end, and the card machine's disk takes 45 GiB
    of writes in all, so a run's files live no longer than they are
    needed."""
    for f in model_path.glob("*.pth"):
        f.unlink()


def compare_states(a, b, what: str = "resumed vs uninterrupted") -> None:
    """The two runs' final train_state.pt (a model dir, or the state's dict
    as ``save_train_state`` writes it), tensor by tensor: bit-identical,
    or the differing tensors and what differs, then a probe of which op
    gives other bits on the same inputs."""
    sa, sb = (x if isinstance(x, dict) else torch.load(
        x / "train_state.pt", map_location="cpu", weights_only=True) for x in (a, b))
    pairs = [(f"{name}.{k}", v, sb["models"][name][k])
             for name in sa["models"] for k, v in sa["models"][name].items()]
    for key in ("opt_gen", "opt_dis"):
        if sa[key]["step"] != sb[key]["step"]:
            raise AssertionError(f"{key} step {sa[key]['step']} vs {sb[key]['step']}")
        for part in ("m", "v"):
            pairs += [(f"{key}.{part}[{i}]", x, y)
                      for i, (x, y) in enumerate(zip(sa[key][part], sb[key][part], strict=True))]
    differ = [(n, (x.float() - y.float()).abs().max().item()) for n, x, y in pairs
              if x.dtype != y.dtype or not torch.equal(x, y)]
    nbytes = sum(x.numel() * x.element_size() for _, x, _ in pairs)
    print(f"final train_state.pt, {what}: {len(pairs)} tensors "
          f"({nbytes / 2**30:.2f} GiB), {len(differ)} differ")
    if differ:
        for n, d in sorted(differ, key=lambda t: -t[1])[:12]:
            print(f"  {n}: max |diff| {d:.3e}")
        determinism_probe()
        raise AssertionError(f"train states differ: {what}")


def determinism_probe() -> None:
    """One 512px bf16 G step's and D step's gradients twice from the same
    state and batch: the tensors whose gradients differ, with cuDNN's
    default algorithms and with its deterministic ones."""
    from discogan_modernized_torch.core.precision import BF16
    from discogan_modernized_torch.train.graph import trainable_subsets
    from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                      loss_and_grads)

    cfg = TrainConfig(image_size=SIZE, precision="bf16", slim_state="all")
    ts = init_train_state(2, cfg, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(5)
    A, B = (torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=rng)
            for _ in range(2))
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        for which in ("dis", "gen"):
            keys = trainable_subsets(cfg.model_arch)[0 if which == "gen" else 1]
            names = [f"{k}.{n}" for k in keys for n, _ in ts.models[k].named_parameters()]
            _, g1 = loss_and_grads(ts, A, B, 0.01, cfg, BF16, which)
            _, g2 = loss_and_grads(ts, A, B, 0.01, cfg, BF16, which)
            differ = [n for n, x, y in zip(names, g1, g2) if not torch.equal(x, y)]
            print(f"determinism probe, {which} step, cudnn.deterministic={deterministic}: "
                  f"{len(differ)} of {len(names)} gradients differ between two runs "
                  f"{differ[:8]}")
    torch.backends.cudnn.deterministic = False
    del ts
    torch.cuda.empty_cache()


def drive_real_data(work: Path, synthetic: dict) -> dict:
    """The trainer on an edges2shoes tree at 512px, batch 8, bf16,
    slim_state=all, 2 epochs (16 iterations): uninterrupted, then stopped
    by SIGTERM at the end of iteration SIGTERM_AT and resumed to the end;
    every step's launches checked, the two final train states compared.
    The uninterrupted and the resumed run keep their saves in memory
    (``state_in_memory``); the stopped run saves to the disk. Returns the
    uninterrupted run's launches and final state and the stopped run's
    model directory."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train.loop import run_training

    os.environ["DISCOGAN_DATASETS_ROOT"] = str(work / "datasets")
    os.environ["DISCOGAN_TORCH_CACHE_DIR"] = str(work / "data_cache")
    write_edges2shoes(work / "datasets")
    time_decode()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    full = StepObserver()
    total = REAL_EPOCHS * REAL_TRAIN // TRAIN_BATCH
    t0 = time.perf_counter()
    with state_in_memory(total, "cpu") as kept:
        run_training(real_args(work, "uninterrupted"), observer=full)
    wall = time.perf_counter() - t0
    uninterrupted = kept.pop("state")
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    step_ms = full.report()
    img_s = steady_img_s(full, step_ms)
    print(f"real data, slim_state=all: {len(full.steps)} iterations in {wall:.1f} s "
          f"(host clock, decode from the cache and sample forwards included, saves kept "
          f"in memory); {img_s:.1f} img/s at the median step times against "
          f"{synthetic['img_s']:.1f} for phase 7's synthetic run under mv (D "
          f"{step_ms['dis']:.3f} / G "
          f"{step_ms['gen']:.3f} ms against {synthetic['step_ms']['dis']:.3f} / "
          f"{synthetic['step_ms']['gen']:.3f})")
    print(f"peak memory: slim_state=all {peak / 2**30:.2f} GiB, phase 7's mv "
          f"{synthetic['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    handler = signal.getsignal(signal.SIGTERM)
    stop = SigtermObserver(SIGTERM_AT)
    with first_save_skipped():
        _, stopped = run_training(real_args(work, "stopped"), observer=stop)
    keep_train_state(stopped)
    meta = json.loads((stopped / "train_state_meta.json").read_text())
    if not (meta.get("preempted") and meta["iters"] == SIGTERM_AT + 1
            and signal.getsignal(signal.SIGTERM) is handler):
        raise AssertionError(f"SIGTERM at iteration {SIGTERM_AT}: meta {meta}")
    print(f"SIGTERM at the end of iteration {SIGTERM_AT}: the trainer saved at "
          f"iteration {meta['iters']} and returned; the caller's handler is back")
    stop.report()
    resume = StepObserver()
    with state_in_memory(total, "cpu") as kept:
        run_training(real_args(work, "resumed", f"--resume={stopped}"), observer=resume)
    done = [s[0] for s in resume.steps]
    if done != list(range(SIGTERM_AT + 1, REAL_EPOCHS * REAL_TRAIN // TRAIN_BATCH)):
        raise AssertionError(f"the resumed run trained iterations {done}")
    resume.report()
    compare_states(kept.pop("state"), uninterrupted)
    shutil.rmtree(work / "resumed")
    return launches, uninterrupted, stopped


AB_ORDER = ("real", "synthetic", "pinned", "resident",
            "resident", "pinned", "synthetic", "real")


def data_source_ab(work: Path) -> None:
    """The trainer's steps at 512px, batch 8, bf16, slim_state=all, from one
    state, fed an epoch at a time in the order AB_ORDER from four sources:
    the host loader over the edges2shoes tree (cache reads, np.stack and
    pin_memory on its thread), the host loader over synthetic arrays of the
    same count (the synthetic task's path: an index copy and pin_memory),
    the real batches held in pinned memory and copied to the card at each
    step (no loader thread), and the same batches already on the card. Per
    source, the median D and G step (CUDA events), the median host time to
    issue a step, and each block's median G step: the steps are host-bound,
    so what the loader's thread takes from the launch loop shows as the
    difference between sources, apart from run order."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.data.pipeline import HostLoader, synthetic_pair
    from discogan_modernized_torch.data.resolvers import get_edge2photo_files
    from discogan_modernized_torch.train.loop import config_from_args
    from discogan_modernized_torch.train.step import init_train_state, make_train_steps

    cfg = config_from_args(parse_with_config(translation_parser(), [
        "--task_name=edges2shoes", f"--image_size={SIZE}", "--precision=bf16",
        "--slim_state=all"]))
    configure(BF16)
    files, _ = get_edge2photo_files("edges2shoes")
    loaders = {"real": HostLoader(files, files, TRAIN_BATCH, SIZE, "cuda",
                                  domain_A="A", domain_B="B"),
               "synthetic": HostLoader(*synthetic_pair(len(files), SIZE),
                                       TRAIN_BATCH, SIZE, "cuda")}
    resident = list(loaders["real"].epoch(0))
    pinned = [tuple(x.cpu().pin_memory() for x in batch) for batch in resident]
    ts = init_train_state(6, cfg, "cuda")
    gen_step, dis_step = make_train_steps(cfg, BF16)
    for step in (dis_step, gen_step):  # warm
        step(ts, *resident[0], 0.01)
    times = {src: {"dis": [], "gen": [], "host": [], "blocks": []}
             for src in ("real", "synthetic", "pinned", "resident")}
    iters = 0
    for block, src in enumerate(AB_ORDER):
        if src == "resident":
            batches = resident
        elif src == "pinned":
            batches = (tuple(x.to("cuda", non_blocking=True) for x in b) for b in pinned)
        else:
            batches = loaders[src].epoch(block)
        events = []
        for A, B in batches:
            kind = "dis" if cfg.is_dis_iter(iters) else "gen"
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            h0 = time.perf_counter()
            (dis_step if kind == "dis" else gen_step)(ts, A, B, 0.01)
            times[src]["host"].append((time.perf_counter() - h0) * 1e3)
            e[1].record()
            events.append((kind, e))
            iters += 1
        torch.cuda.synchronize()
        gen_ms = []
        for kind, (e0, e1) in events:
            times[src][kind].append(e0.elapsed_time(e1))
            if kind == "gen":
                gen_ms.append(e0.elapsed_time(e1))
        times[src]["blocks"].append(statistics.median(gen_ms))
    for loader in loaders.values():
        loader.close()
    for src, t in times.items():
        med = {k: statistics.median(t[k]) for k in ("dis", "gen", "host")}
        print(f"data source {src}, slim_state=all, order {'/'.join(AB_ORDER)}: D "
              f"{med['dis']:.3f} ms over {len(t['dis'])}, G {med['gen']:.3f} ms over "
              f"{len(t['gen'])} steps (medians, CUDA events); host time to issue a "
              f"step {med['host']:.3f} ms (median, host clock); G median per block "
              + ", ".join(f"{v:.3f}" for v in t["blocks"]))
    del ts, resident, pinned
    torch.cuda.empty_cache()


def optimizer_share() -> None:
    """A 512px batch-8 bf16 G step split into its loss-and-gradients part
    and its Adam update, under slim_state mv and all (CUDA events, median of
    3 steps after a D and a G step that warm it)."""
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.train.step import (TrainConfig, TrainState,
                                                      cast_parameters, init_train_state,
                                                      loss_and_grads, make_optimizers,
                                                      make_train_steps)

    configure(BF16)
    rng = torch.Generator(device="cuda").manual_seed(8)
    A, B = (torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=rng)
            for _ in range(2))
    ts = init_train_state(1, TrainConfig(image_size=SIZE, precision="bf16",
                                         slim_state="mv"), "cuda")
    for slim in ("mv", "all"):
        cfg = TrainConfig(image_size=SIZE, precision="bf16", slim_state=slim)
        if slim == "all":  # the same networks, their parameters cast to bf16
            for m in ts.models.values():
                cast_parameters(m, torch.bfloat16)
            ts = TrainState(ts.models, *make_optimizers(ts.models, cfg))
        gen_step, dis_step = make_train_steps(cfg, BF16)
        dis_step(ts, A, B, 0.01)
        gen_step(ts, A, B, 0.01)
        grads_ms, update_ms = [], []
        for _ in range(3):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            _, grads = loss_and_grads(ts, A, B, 0.01, cfg, BF16, "gen")
            e[1].record()
            ts.opt_gen.update(grads)
            e[2].record()
            e[2].synchronize()
            grads_ms.append(e[0].elapsed_time(e[1]))
            update_ms.append(e[1].elapsed_time(e[2]))
        g, u = statistics.median(grads_ms), statistics.median(update_ms)
        n = sum(p.numel() for p in ts.opt_gen.params)
        print(f"G step, slim_state={slim}: loss and gradients {g:.3f} ms, Adam update "
              f"{u:.3f} ms over {n / 1e6:.1f} M parameters (optimizer share "
              f"{u / (g + u):.3f}; CUDA events, median of 3)")
        del grads
    del ts
    torch.cuda.empty_cache()


# -- phase 9: the multi-step driver: chunks replayed as CUDA graphs --------------

CHUNK_K = 6  # auto_steps_per_call at 512px without remat: two [D, G, G] periods
ANGLE_K = 24  # auto_steps_per_call at 64px
CHUNK_ROUNDS = 2  # timed blocks of CHUNK_K iterations a path, in turns
TIMING_IMAGES = 64  # a domain, for the timed blocks (8 batches an epoch)
VARIANT_CHUNK = 4  # the variants under capture: [D, G, G, lean D] warms all three kinds
PATH_LINE = re.compile(r"^train path: dataset (.*); steps_per_call (\d+) \((\w+)\); "
                       r"CUDA graphs (on|off); remat (on|off)$", re.M)
K_IDS = ("K1", "K2", "K3", "K4", "K5f", "K5b", "K6")


class Tee(io.TextIOBase):
    """A stream that writes to ``out`` and keeps what it was given."""

    def __init__(self, out):
        self.out, self.text = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.text.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_captured(args, **kw):
    """run_training with its standard output kept: (result, model_path, text)."""
    from discogan_modernized_torch.train.loop import run_training

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result, model_path = run_training(args, **kw)
    return result, model_path, tee.text.getvalue()


def check_path_line(text: str, what: str, k: int) -> None:
    """The trainer's path line: the dataset on the card, ``k`` iterations a
    call, CUDA graphs on, remat off."""
    m = PATH_LINE.search(text)
    if m is None or not (m.group(1).startswith("on the card") and int(m.group(2)) == k
                         and m.group(4) == "on" and m.group(5) == "off"):
        raise AssertionError(f"{what}: path line {m and m.group(0)!r}, want the dataset on "
                             f"the card, steps_per_call {k}, CUDA graphs on, remat off")
    print(f"{what}: {m.group(0)}")


def _add(tables) -> dict:
    out: dict = {}
    for t in tables:
        for k, v in t.items():
            out[k] = out.get(k, 0) + v
    return out


class ChunkObserver:
    """Around each chunk of the chunked path: CUDA events, the chunk's
    kernel launches and graph replays, a copy of its losses. ``report``
    checks the launches: an eager chunk (the
    warm-up) launches ``per_step`` of each of its steps; the chunk that
    captures launches each captured kind's ``per_step`` once, at its
    capture, and replays every step; a later chunk replays every step and
    launches nothing."""

    def __init__(self, per_step=None, batch: int = TRAIN_BATCH):
        from discogan_modernized_torch.ops import _build
        from discogan_modernized_torch.train import chunk

        self.launches, self.replays = _build.launches, chunk.replays
        self.per_step, self.batch = per_step or PER_STEP, batch
        self.chunks = []  # (iters0, kinds, start, end, launches, replays, captured, losses)
        self.seen, self.program = set(), None

    def begin_chunk(self, iters0, kinds):
        self._before = (dict(self.launches), sum(self.replays.values()))
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def end_chunk(self, iters0, kinds, losses, program):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        before, replays = self._before
        delta = {k: v - before[k] for k, v in self.launches.items() if v != before[k]}
        captured = sorted(set(program.graphs) - self.seen)
        self.seen = set(program.graphs)
        self.program = program
        self.chunks.append((iters0, kinds, self._start, end, delta,
                            sum(self.replays.values()) - replays, captured, losses.clone()))

    def report(self) -> dict:
        """Check every chunk's launches, replays and losses, and that some
        chunk replayed; return the ms an iteration
        (CUDA events) over the chunks of whole periods: those that only
        replayed, the one that captured (its host time inside), the eager
        ones."""
        torch.cuda.synchronize()
        times = {"replayed": [], "capture": [], "eager": []}
        for iters0, kinds, start, end, delta, replays, captured, losses in self.chunks:
            if replays == 0:
                want = _add(self.per_step[k] for k in kinds)
            elif replays == len(kinds):
                want = _add(self.per_step[k] for k in captured)
                for k in captured:
                    if self.program.launches[k] != self.per_step[k]:
                        raise AssertionError(f"the {k} capture launched "
                                             f"{self.program.launches[k]}, want "
                                             f"{self.per_step[k]}")
            else:
                raise AssertionError(f"chunk at {iters0}: {replays} replays for "
                                     f"{len(kinds)} steps")
            if delta != want:
                raise AssertionError(f"chunk at {iters0} ({kinds}, {replays} replays, "
                                     f"captured {captured}): launches {delta}, want {want}")
            if not torch.isfinite(losses).all().item():
                raise AssertionError(f"chunk at {iters0}: non-finite losses")
            if replays == 0 or len(kinds) % 3 == 0:
                kind = "eager" if replays == 0 else "capture" if captured else "replayed"
                times[kind].append(start.elapsed_time(end) / len(kinds))
        n_replayed = sum(c[5] for c in self.chunks)
        if not n_replayed:
            raise AssertionError("no chunk replayed a CUDA graph")
        kinds = sorted(self.seen)
        print(f"chunks checked: {len(self.chunks)} chunks, {n_replayed} graph replays, "
              f"captured {kinds} with launches " + "; ".join(
                  f"{k} {sum(self.program.launches[k].values())}" for k in kinds)
              + " (each its kind's per-step table); eager chunks launched their steps' "
              "tables, replays nothing; all losses finite")
        out = {k: statistics.median(v) for k, v in times.items() if v}
        for k, v in times.items():
            if v:
                print(f"{k} chunks: median {out[k]:.3f} ms an iteration over {len(v)} "
                      f"chunks (min {min(v):.3f}, max {max(v):.3f}; CUDA events)")
        return out


def check_trace(trace_dir: Path, observer: ChunkObserver) -> None:
    """The --profile run's trace: one Chrome trace in ``trace_dir`` whose
    iterations are all in replayed chunks, holding a cudaGraphLaunch and
    device kernels of all seven of K1-K6."""
    from collections import Counter

    files = sorted(trace_dir.glob("trace_iters_*.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile wrote {files}")
    first, last = map(int, re.match(r"trace_iters_(\d+)-(\d+)\.json", files[0].name).groups())
    inside = [c for c in observer.chunks if first <= c[0] <= last]
    if not inside or any(c[5] != len(c[1]) for c in inside):
        raise AssertionError(f"trace of iterations {first}-{last}: chunks "
                             f"{[(c[0], c[5]) for c in inside]} not all replayed")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_id = Counter(kernel_label(e["name"]).split()[0] for e in kernels)
    graph_launches = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
    in_graphs = sum(1 for e in kernels if any("graph" in k for k in e.get("args", {})))
    missing = [k for k in K_IDS if not by_id[k]]
    print(f"--profile trace {files[0].name} ({files[0].stat().st_size / 2**20:.1f} MiB): "
          f"{len(kernels)} device kernels, {graph_launches} cudaGraphLaunch calls, "
          f"{in_graphs} kernels with a graph id; port kernels "
          + ", ".join(f"{k} {by_id[k]}" for k in K_IDS))
    if missing or not graph_launches:
        raise AssertionError(f"the trace lacks {missing or 'cudaGraphLaunch'}")


def drive_chunked_cli(work: Path, synthetic: dict) -> dict:
    """Phase 7's CLI run on the trainer's defaults (the dataset on the
    card, chunks of CHUNK_K replayed as CUDA graphs) with --profile: its
    path line; its launches and replays (``ChunkObserver``); its log lines
    and final train state equal to phase 7's per-step run's, bit for bit;
    its peak memory beside phase 7's; the trace's kernels. Its saves are
    kept in memory (``state_in_memory``; phase 10's chunked angle run saves
    from the chunked path to disk). Returns its launches."""
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train import chunk

    args = parse_with_config(translation_parser(), [
        *SYNTHETIC_FLAGS, f"--profile={work / 'trace'}",
        f"--results_dir={work / 'chunk_results'}", f"--models_dir={work / 'chunk_models'}"])
    observer = ChunkObserver()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    chunk.reset_replays()
    t0 = time.perf_counter()
    with state_in_memory(SYNTHETIC_ITERS, "cpu") as kept:
        result, model_path, text = run_captured(args, observer=observer)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    check_path_line(text, "chunked CLI", CHUNK_K)
    ms = observer.report()
    iters = sum(len(c[1]) for c in observer.chunks)
    print(f"chunked CLI: {iters} iterations in {wall:.1f} s (host clock; the dataset, "
          f"warm-up, captures, the trace, sample forwards and saves included); "
          f"{TRAIN_BATCH * 1e3 / ms['replayed']:.1f} img/s over its replayed chunks "
          f"against phase 7's {synthetic['img_s']:.1f}; peak memory "
          f"{peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB reserved "
          f"(phase 7: {synthetic['peak'] / 2**30:.2f}, {synthetic['reserved'] / 2**30:.2f})")
    mine = TRAIN_LINE.findall((result / "training_log.txt").read_text())
    theirs = TRAIN_LINE.findall((synthetic["result"] / "training_log.txt").read_text())
    if mine != theirs or not mine:
        raise AssertionError(f"log lines differ from phase 7's: {mine} vs {theirs}")
    print(f"chunked CLI: the same {len(mine)} log lines as phase 7's")
    compare_states(kept.pop("state"), synthetic["model_path"],
                   "chunked vs phase 7's per-step run")
    check_trace(work / "trace", observer)
    shutil.rmtree(work / "trace")
    shutil.rmtree(model_path, ignore_errors=True)
    return launches


def drive_real_chunks(work: Path, per_step_run: dict, stopped: Path) -> dict:
    """The edges2shoes run under slim_state=all on the trainer's defaults:
    uninterrupted (its final state equal to phase 8's per-step run from
    the host loader), then --resume of phase 8's run stopped by SIGTERM
    (saved at the misaligned iteration SIGTERM_AT + 1): its chunks start
    with one that restores the period's alignment, and it ends equal to the
    uninterrupted chunked run, bit for bit. Both keep their saves in memory
    (``state_in_memory``). Returns the uninterrupted run's launches."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train import chunk

    total = REAL_EPOCHS * REAL_TRAIN // TRAIN_BATCH
    _build.reset_launches()
    chunk.reset_replays()
    full = ChunkObserver()
    with state_in_memory(total, "cpu") as kept:
        _, _, text = run_captured(real_args(work, "chunked", per_step=False), observer=full)
    uninterrupted = kept.pop("state")
    launches = dict(_build.launches)
    check_path_line(text, "chunked edges2shoes", CHUNK_K)
    full.report()
    compare_states(uninterrupted, per_step_run,
                   "chunked from the card's dataset vs phase 8's per-step run from the loader")
    at = json.loads((stopped / "train_state_meta.json").read_text())["iters"]
    resume = ChunkObserver()
    with state_in_memory(total, "cpu") as kept:
        run_captured(real_args(work, "chunk_resumed", f"--resume={stopped}", per_step=False),
                     observer=resume)
    starts = [(c[0], len(c[1])) for c in resume.chunks]
    if not at % 3 or starts[0] != (at, 3 - at % 3):
        raise AssertionError(f"resumed from iteration {at}: chunks {starts}")
    resume.report()
    print(f"chunked resume of phase 8's SIGTERM-stopped run (saved at the misaligned "
          f"iteration {at}): chunks (start, size) {starts}")
    compare_states(kept.pop("state"), uninterrupted, "chunked: resumed vs uninterrupted")
    for tag in ("chunked", "chunk_resumed"):
        shutil.rmtree(work / tag)
    return launches


def check_graph_variants() -> None:
    """The step's graph variants under capture: from one seeded 512px bf16
    state at batch 8 under --paired --lean_dis --remat=on
    --remat_policy=conv, two chunks of VARIANT_CHUNK (a logged D, G and
    lean D steps) eager and then replayed from CUDA graphs, against the
    same chunks run eagerly from a copy of the state: every parameter,
    moment and running statistic equal, bit for bit."""
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.data.pipeline import DeviceDataset, HostLoader, synthetic_pair
    from discogan_modernized_torch.train.chunk import ChunkProgram
    from discogan_modernized_torch.train.step import TrainConfig, init_train_state, kinds_in_range

    configure(BF16)
    cfg = TrainConfig(image_size=SIZE, precision="bf16", slim_state="mv", paired=True,
                      lean_dis=True, remat=True, remat_policy="conv", remat_dis=False)
    data = DeviceDataset(HostLoader(*synthetic_pair(4 * TRAIN_BATCH, SIZE, seed=5),
                                    TRAIN_BATCH, SIZE, "cuda", seed=5))
    k = VARIANT_CHUNK
    rows = [np.concatenate(r)[:2 * k] for r in zip(*(data.epoch_rows(e) for e in range(2)))]
    snaps = []
    for graphs in (False, True):
        ts = init_train_state(4, cfg, "cuda")
        program = ChunkProgram(ts, cfg, BF16, *data.data, TRAIN_BATCH, k,
                               kinds_in_range(cfg, 0, 2 * k), graphs=graphs)
        for i0 in (0, k):
            program(rows[0][i0:i0 + k], rows[1][i0:i0 + k], i0)
        if graphs and sorted(program.graphs) != ["dis", "gen", "lean"]:
            raise AssertionError(f"captured {sorted(program.graphs)}")
        snaps.append(_snapshot(ts))
        del ts, program
        torch.cuda.empty_cache()
    differ = [k for k in snaps[0] if not torch.equal(snaps[0][k], snaps[1][k])]
    print(f"graph variants under capture (--paired --lean_dis --remat=on "
          f"--remat_policy=conv): {2 * VARIANT_CHUNK} iterations, the second chunk replayed; "
          f"{len(differ)} of {len(snaps[0])} tensors differ from the eager run's")
    if differ:
        raise AssertionError(f"replayed variant steps differ from eager ones: {differ[:6]}")


def chunk_timing() -> None:
    """The chunked and the per-step path in one process from one seeded
    512px bf16 state at batch 8 (slim_state=mv, the dataset on the card):
    after both are warm, CHUNK_ROUNDS blocks of CHUNK_K iterations (whole
    [D, G, G] periods) a path in turns (chunked, per-step, per-step,
    chunked, ...), host clock around each block with a synchronize at both
    ends; ms an iteration and img/s; one block of each under the profiler
    (device busy, window, idle share); peak memory of each. The dataset's
    build time on its own line."""
    from discogan_modernized_torch.core.precision import BF16, configure
    from discogan_modernized_torch.data.pipeline import DeviceDataset, HostLoader, synthetic_pair
    from discogan_modernized_torch.train.chunk import ChunkProgram
    from discogan_modernized_torch.train.step import (TrainConfig, auto_steps_per_call,
                                                      init_train_state, make_train_steps)

    configure(BF16)
    cfg = TrainConfig(image_size=SIZE, precision="bf16", slim_state="mv", remat=False)
    if auto_steps_per_call(cfg, SIZE) != CHUNK_K:
        raise AssertionError("auto_steps_per_call moved")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = DeviceDataset(HostLoader(*synthetic_pair(TIMING_IMAGES, SIZE), TRAIN_BATCH, SIZE,
                                    "cuda"))
    torch.cuda.synchronize()
    print(f"dataset on the card: 2 x {TIMING_IMAGES} images at {SIZE}px, "
          f"{data.nbytes / 2**30:.2f} GiB f32, built in {time.perf_counter() - t0:.3f} s "
          "(host clock, the synthetic arrays' generation included)")
    ts = init_train_state(3, cfg, "cuda")
    program = ChunkProgram(ts, cfg, BF16, *data.data, TRAIN_BATCH, CHUNK_K, {"dis", "gen"})
    gen_step, dis_step = make_train_steps(cfg, BF16)
    rows = [r for e in range(12) for r in zip(*data.epoch_rows(e))]
    at = [0]

    def chunked():
        i0 = at[0]
        block = rows[i0:i0 + CHUNK_K]
        program(np.stack([a for a, _ in block]), np.stack([b for _, b in block]), i0)
        at[0] += CHUNK_K

    def per_step():
        for i in range(at[0], at[0] + CHUNK_K):
            A, B = data.gather(*rows[i])
            (dis_step if cfg.is_dis_iter(i) else gen_step)(ts, A, B, cfg.rate_for(i))
        at[0] += CHUNK_K

    paths = {"chunked": chunked, "per-step": per_step}
    chunked()  # the warm-up: eager
    chunked()  # captures, then replays
    per_step()
    times = {k: [] for k in paths}
    for r in range(CHUNK_ROUNDS):
        for name in ("chunked", "per-step") if r % 2 == 0 else ("per-step", "chunked"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / CHUNK_K)
    for name, fn in paths.items():
        med = statistics.median(times[name])
        prof = {}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        profile_call(fn, f"{CHUNK_K} iterations {name} (512px, batch 8, bf16)", top=0,
                     out=prof)
        print(f"{name}: {med:.3f} ms an iteration (median of {CHUNK_ROUNDS} blocks of "
              f"{CHUNK_K}: " + ", ".join(f"{t:.3f}" for t in times[name])
              + f"; host clock), {TRAIN_BATCH * 1e3 / med:.1f} img/s; device busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms of a "
              f"{prof.get('window_ms', float('nan')):.3f} ms window for the block; memory "
              f"allocated {before / 2**30:.2f} GiB before the block, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB in it, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    del ts, program, data
    torch.cuda.empty_cache()


# -- phase 10: the angle-pairing trainer at 64px ---------------------------------

ANGLE_CARS, ANGLE_STEP = 32, 10  # cars, degrees between views (18 views a car)
ANGLE_LINE = re.compile(r"^Iter \[\d+/\d+\] GEN: \d+\.\d{4}/\d+\.\d{4}, "
                        r"RECON: \d+\.\d{4}/\d+\.\d{4}, DIS: \d+\.\d{4}/\d+\.\d{4}$",
                        re.M)


def write_cars(root: Path) -> None:
    """A rendered-car sweep, car_<id>_<azimuth>.png, made from a numpy seed:
    each half of the rotation holds 288 views, 260 of them for training (4
    batches of 64)."""
    from PIL import Image

    rng = np.random.RandomState(4)
    d = root / "data" / "cars"
    d.mkdir(parents=True)
    for car in range(ANGLE_CARS):
        for az in range(0, 180, ANGLE_STEP):
            Image.fromarray((rng.rand(SIZE64, SIZE64, 3) * 255).astype(np.uint8)).save(
                d / f"car_{car:02d}_{az:03d}.png")


def drive_angle(work: Path) -> dict:
    """The angle CLI's trainer at the angle parser's defaults (car2car,
    64px, batch 64, bf16 on the card, rates 0.9, 10 epochs: 40 iterations),
    one step a call: every step's launches checked against PER_STEP64,
    every loss finite, the log's lines without the FM field. Then the same
    run on the trainer's defaults (the dataset on the card, chunks of
    ANGLE_K iterations replayed as CUDA graphs): its path line, its
    launches, its log lines and its final train state equal to the
    per-step run's. Returns the two runs' launches."""
    from discogan_modernized_torch.cli.common import angle_parser, parse_with_config
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.train import chunk
    from discogan_modernized_torch.train.loop import run_training

    os.environ["DISCOGAN_DATASETS_ROOT"] = str(work / "angle_data")
    write_cars(work / "angle_data")

    def args(tag, *extra):
        return parse_with_config(angle_parser(), [
            f"--results_dir={work / tag / 'results'}",
            f"--models_dir={work / tag / 'models'}", *extra])

    per_step = args("angle", "--steps_per_call=1")
    if (per_step.image_size, per_step.batch_size) != (SIZE64, BATCH64):
        raise AssertionError("the angle parser's defaults moved")
    observer = StepObserver(PER_STEP64, batch=BATCH64)
    _build.reset_launches()
    t0 = time.perf_counter()
    result, model_path = run_training(per_step, observer=observer, angle_variant=True)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    step_ms = observer.report()
    log = (result / "training_log.txt").read_text()
    lines = ANGLE_LINE.findall(log)
    if not lines or "FM:" in log:
        raise AssertionError(f"angle log without its lines or with FM:\n{log}")
    print(f"angle CLI: {len(observer.steps)} iterations at {SIZE64}px batch {BATCH64} "
          f"in {wall:.1f} s (host clock); {steady_img_s(observer, step_ms):.1f} img/s "
          f"at the median step times; log lines without FM, e.g. {lines[0]!r}")

    chunked = ChunkObserver(PER_STEP64, batch=BATCH64)
    _build.reset_launches()
    chunk.reset_replays()
    t0 = time.perf_counter()
    c_result, c_model_path, text = run_captured(args("angle_chunks"), observer=chunked,
                                                angle_variant=True)
    wall = time.perf_counter() - t0
    chunk_launches = dict(_build.launches)
    check_path_line(text, "angle CLI on its defaults", ANGLE_K)
    c_ms = chunked.report()
    if ANGLE_LINE.findall((c_result / "training_log.txt").read_text()) != lines:
        raise AssertionError("the chunked angle run's log lines differ from the per-step run's")
    print(f"angle CLI chunked: {sum(len(c[1]) for c in chunked.chunks)} iterations in "
          f"{wall:.1f} s (host clock); {c_ms['replayed']:.3f} ms an iteration over its "
          f"replayed chunks; the same {len(lines)} log lines as the per-step run")
    compare_states(c_model_path, model_path, "angle, chunked vs per-step")
    return launches, chunk_launches


# -- the tools phase (M11): the port's tools and the read probe P -------------

P_SOURCE = "discogan_modernized_torch/csrc/pipe_probe.cu"
P_REPLACES = "benchmarks/pipe_probe.py:38"
P_CASE = "4d_th32_lane64"  # the kernels line's case: 128-byte rows, 32 a block
BATCH_ANSWER, BATCH_STEP = 192, 16  # PR 11's largest 512px batch without remat
# 512 iterations, about 6 s on the card: the SIGTERM lands a poll or two
# (about 100 iterations) after the monitor has read MONITOR_SEEN
MONITOR_FLAGS = ("--image_size=64", "--batch_size=8", "--epochs=16", "--log_interval=10",
                 "--model_save_interval=200", "--image_save_interval=100000")
MONITOR_SEEN = 20  # the iteration the monitor must have read before the SIGTERM
# the kernels each tool's run must launch (phase 3's routes at its shapes)
TOOL_KERNELS = {
    "pipe_probe": {"pipe_probe"},
    "kernel_bench": {"batch_stats", "bn_act"},
    "conv_kernel_bench": {"conv_k4s2p1", "conv_k4s2p1_dw", "halo_conv_k4s2p1",
                          "halo_conv_k4s2p1_dw", "bn_act"},
    "fwd_profile": {"conv_k4s2p1", "halo_conv_k4s2p1", "batch_stats", "bn_act"},
    "layer_ab": {"halo_conv_k4s2p1", "halo_conv_k4s2p1_dw"},
    "step_itemize": set(PER_STEP64["gen"]),
    "roofline": set(PER_STEP64["gen"]),
}
SHARE_LIMIT = 1.05  # a roofline or peak share above this is a timing fault
# the layer tools' image size and batch: plumbing, not the record (batch 2:
# train-mode BatchNorm needs two values a channel at the 1x1 latent)
TOOL_SIZE, TOOL_BATCH = 256, 2
AB_CONV_SHAPE = "enc6 b1"  # conv_ab's shape: the wgmma path
# the variants of conv_ab and head_ab built here: the kernel and its two
# halves (13 nvcc runs of the two sources for all of them cost the next
# phase ~25 s of the host's cores)
AB_VARIANTS = ("kernel", "copies only", "no copies")
# head_ab's f32 variants built here (head_fma_kernel at batch 1; the
# kernel's own library and one build)
F32_AB_VARIANTS = ("kernel", "no copies")
# dw_ab's variants built here and its layer (K4's f32 kernel at batch 1; K5b's
# at enc1, batch 1)
DW_AB_VARIANTS, DW_AB_LAYER = ("kernel", "no copies"), "enc5"
TRAIN_ITER = re.compile(r"Iter \[(\d+)/\d+\]")


def _tool(name: str, argv: list, want=None):
    """Run a tool's main() with its launches counted: (result, launches).
    It must launch ``want``'s kernels (default: TOOL_KERNELS[name])."""
    import importlib

    from discogan_modernized_torch.ops import _build

    module = importlib.import_module(f"discogan_modernized_torch.tools.{name}")
    _build.reset_launches()
    t0 = time.perf_counter()
    out = module.main(argv)
    torch.cuda.synchronize()
    launched = {k for k, v in _build.launches.items() if v}
    want = TOOL_KERNELS.get(name) if want is None else want
    if want is not None and launched != want:
        raise AssertionError(f"{name}: launched {sorted(launched)}, want {sorted(want)}")
    print(f"-- tool {name}: {time.perf_counter() - t0:.1f} s; kernels {sorted(launched)}",
          flush=True)
    return out, dict(_build.launches)


def _positive(what: str, values) -> None:
    bad = [v for v in values if not v > 0]
    if bad:
        raise AssertionError(f"{what}: times not positive: {bad}")


def _share(what: str, share: float) -> None:
    if not 0 < share <= SHARE_LIMIT:
        raise AssertionError(f"{what}: share {share:.3f} of a roofline or peak")


def drive_pipe_probe() -> dict:
    """P: the six cases at full size through tools/pipe_probe.py (each
    case's block maxima equal to the plain version's, its value the last
    block's, timed beside x.clone(), torch.amax and the bound); returns
    P's entry of the kernels line."""
    (out, launches) = _tool("pipe_probe", [])
    n = launches["pipe_probe"]
    if n < len(out):
        raise AssertionError(f"pipe_probe: {n} launches for {len(out)} cases")
    for name, r in out.items():
        _positive(f"pipe_probe {name}", [r["us"], r["plain_us"], r["clone_us"], r["amax_us"]])
        _share(f"pipe_probe {name}", r["bound_us"] / r["us"])
    r = out[P_CASE]
    return {"name": "pipe_probe", "route": "cuda", "source": P_SOURCE, "replaces": P_REPLACES,
            "launches": n, "max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
            "library_ms": r["amax_us"] / 1e3, "clone_ms": r["clone_us"] / 1e3,
            "case": P_CASE, "cases": out}


def drive_timing_tools() -> dict:
    """kernel_bench, conv_kernel_bench --dw --fused, fwd_profile, layer_ab
    (enc1, fwd/dx/dw, kernel and library; enc2's forward in f32), step_itemize
    and roofline, each
    once through its main(), at small shapes: the tools' plumbing is what
    this checks, and phase 3's 512px times are the kernels' record.
    TOOL_SIZE batch TOOL_BATCH for the layers and calls (K5f's route holds
    enc1 there, as at 512px), 64px batch 64 for the whole steps. Every time
    positive, every roofline or peak share at most SHARE_LIMIT, each
    tool's kernels phase 3's."""
    from discogan_modernized_torch.tools.timing import PEAK_FLOPS

    launches = {}
    rows, launches["kernel_bench"] = _tool("kernel_bench", [])
    for r in rows:
        _positive(f"kernel_bench {r['shape']}", [r["kernel_us"], r["library_us"],
                                                 r["stats_kernel_us"], r["stats_var_mean_us"]])
        _share(f"kernel_bench {r['shape']}", r["bound_us"] / r["kernel_us"])
    rows, launches["conv_kernel_bench"] = _tool(
        "conv_kernel_bench", ["--size", str(TOOL_SIZE), "--batch", str(TOOL_BATCH), "--dw",
                              "--fused"])
    for r in rows:
        _positive(f"conv_kernel_bench {r['layer']}",
                  [v for k, v in r.items() if k.endswith("_us")])
        for key in ("kernel_tf", "halo_tf"):  # K3's row, and K5f's where the route takes it
            if key in r:
                _share(f"conv_kernel_bench {r['layer']} {key}",
                       r[key] * 1e12 / PEAK_FLOPS[torch.bfloat16])
    rows, launches["fwd_profile"] = _tool(
        "fwd_profile", ["--image_size", str(TOOL_SIZE), "--batch", str(TOOL_BATCH)])
    for r in rows:
        _positive(f"fwd_profile {r['layer']}", [r["ms"]])
        _share(f"fwd_profile {r['layer']}", r["efficiency"])
    rows, launches["layer_ab"] = _tool(
        "layer_ab", ["--size", str(TOOL_SIZE), "--batch", str(TOOL_BATCH), "--layer", "enc1",
                     "--modes", "fwd,dx,dw", "--impls", "kernel,library", "--rounds", "2"])
    if len(rows) != 3:
        raise AssertionError(f"layer_ab: {len(rows)} rows for enc1's three modes")
    for r in rows:
        _positive(f"layer_ab {r['layer']} {r['mode']}", r["us"].values())
    # K3's f32 route (the CUDA cores) against cuDNN in f32 with TF32 off
    rows, launches["layer_ab f32"] = _tool(
        "layer_ab", ["--size", str(TOOL_SIZE), "--batch", str(TOOL_BATCH), "--layer", "enc2",
                     "--modes", "fwd", "--impls", "kernel,library", "--rounds", "2",
                     "--dtype", "f32"], want={"conv_k4s2p1"})
    if len(rows) != 1:  # the generator's enc2 (the discriminator's is "dis2")
        raise AssertionError(f"layer_ab f32: {len(rows)} rows for enc2's forward")
    for r in rows:
        _positive(f"layer_ab f32 {r['layer']} {r['mode']}", r["us"].values())
    out, launches["step_itemize"] = _tool(
        "step_itemize", ["--image_size", str(SIZE64), "--batch", str(BATCH64), "--reps", "5"])
    _positive("step_itemize", [v for k, v in out.items() if k.startswith("t_")])
    for which, fwd in (("gen", "t_fwd_ms"), ("dis", "t_fwd_lean_ms")):
        parts = [out[fwd], out[f"t_grad_{which}_ms"], out[f"t_step_{which}_ms"]]
        if not parts[0] < parts[1] < parts[2]:  # replayed graphs: each part holds the last
            raise AssertionError(f"step_itemize {which}: forward, forward and backward, step "
                                 f"{parts} ms are not increasing")
    _positive("step_itemize layers", [v for vs in out["per_layer"].values() for v in vs[:3]])
    out, launches["roofline"] = _tool(
        "roofline", ["--image_size", str(SIZE64), "--batch", str(BATCH64), "--lean",
                     "--measure", "--json"])
    for name, rep in out["programs"].items():
        _positive(f"roofline {name}", [rep["measured_ms"], rep["roofline_lo_ms"]])
        _share(f"roofline {name}", rep["light_speed"])
    return launches


def drive_memory_report() -> None:
    """memory_report at TOOL_SIZE batch 8 under slim state mv: its model of
    a one-process G step beside the step's measured peak."""
    rep, _ = _tool("memory_report", ["--image_size", str(TOOL_SIZE), "--batch",
                                     str(TRAIN_BATCH), "--slim_state", "mv"])
    m = rep["single_measured"]
    _positive("memory_report", [m["measured_peak_bytes"], m["model_bytes"]])
    print(f"memory_report: single-mode G step at {TOOL_SIZE}px batch {TRAIN_BATCH}: model "
          f"{m['model_bytes'] / 2**30:.2f} GiB, measured peak "
          f"{m['measured_peak_bytes'] / 2**30:.2f} GiB; per rank of {rep['n_devices']}: "
          + ", ".join(f"{k} {v['live_bytes'] / 2**30:.2f} GiB" for k, v in rep["modes"].items()))


def drive_batch_size(work: Path) -> None:
    """batch_size_optimization --image_size 512 --train_step in a process of
    its own (the whole card), its bisection bracketed two steps either side
    of BATCH_ANSWER (its first probe is BATCH_ANSWER; an answer at either
    end of the bracket fails): its answer within one bisection step of
    BATCH_ANSWER, under the trainer's default slim state."""
    gc_collect()
    out = work / "batch_size_results.json"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "discogan_modernized_torch.tools.batch_size_optimization",
                        f"--image_size={SIZE}", "--train_step", f"--output={out}",
                        f"--min_batch={BATCH_ANSWER - 2 * BATCH_STEP}",
                        f"--max_batch={BATCH_ANSWER + 2 * BATCH_STEP}"],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=600)
    print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
    if r.returncode:
        raise AssertionError(f"batch_size_optimization exited {r.returncode}")
    res = json.loads(out.read_text())
    got = res["max_working_batch_size"]
    print(f"batch_size_optimization: {got} at {SIZE}px with --train_step, slim state "
          f"{res['slim_state']} "
          f"(history {[(h['batch_size'], h['ok']) for h in res['history']]}); "
          f"{BATCH_ANSWER} measured in PR 11; {time.perf_counter() - t0:.1f} s", flush=True)
    if abs(got - BATCH_ANSWER) > BATCH_STEP:
        raise AssertionError(f"batch_size_optimization found {got}, not within "
                             f"{BATCH_STEP} of {BATCH_ANSWER}")


def gc_collect() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _wait_for(what: str, cond, timeout: float, every: float = 0.5):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"monitor: no {what} within {timeout:.0f} s")


def drive_monitor(work: Path) -> None:
    """A 64px port trainer started from the monitor's launch path; the
    monitor finds it, reads nvidia-smi and the trainer's memory sidecar;
    the job gets SIGTERM (it saves and returns); the monitor restarts it
    with --resume within its cap; the restarted run finishes, its log
    continuing from the saved iteration. The monitor sees only this
    run's jobs (those writing to its --results_dir): it tracks and
    restarts every trainer on the host, and others may share it."""
    from discogan_modernized_torch.tools import monitor as mon_mod

    mdir = work / "monitor"
    results = f"--results_dir={mdir / 'results'}"
    cmd = [*mon_mod.launch_command("synthetic", "discogan"), *MONITOR_FLAGS, results,
           f"--models_dir={mdir / 'models'}"]
    every_job = mon_mod.find_training_jobs

    def ours():
        return [j for j in every_job() if results in (j.get("argv") or j["cmdline"].split())]

    mon = mon_mod.Monitor(mon_mod.parse_args([f"--log_dir={mdir / 'logs'}", "--no-interactive",
                                              "--auto-restart"]))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(mdir.parent / "monitor_job.log", "w") as log:
        job = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    mon_mod.find_training_jobs = ours
    try:
        def found():
            snap = mon.poll_once()
            mine = [j for j in snap["jobs"] if j["pid"] == job.pid]
            ok = mine and mine[0].get("hbm") and (mine[0].get("iters") or 0) >= MONITOR_SEEN
            return (snap, mine[0]) if ok else None

        snap, seen = _wait_for("job with its sidecar and a log line", found, 240)
        dev = snap["devices"][0]
        if "error" in dev or not dev.get("bytes_limit"):
            raise AssertionError(f"monitor: nvidia-smi gave {dev}")
        rec = seen["hbm"]["devices"][0]
        print(f"monitor: job {job.pid} at iteration {seen['iters']}; nvidia-smi {dev['kind']}, "
              f"{dev['bytes_in_use'] / 2**30:.2f} of {dev['bytes_limit'] / 2**30:.2f} GiB, "
              f"{dev['gpu_utilization']}% busy, {dev['power_w']} W; the trainer's sidecar at "
              f"iteration {seen['hbm']['iter']}: {rec['bytes_in_use'] / 2**30:.3f} of "
              f"{rec['bytes_limit'] / 2**30:.2f} GiB", flush=True)
        job.send_signal(signal.SIGTERM)
        if job.wait(timeout=120):
            raise AssertionError(f"monitor: the job exited {job.returncode} after SIGTERM")
        saved = json.loads(next((mdir / "models").rglob("train_state_meta.json")).read_text())
        mon.poll_once()  # the job is gone: the monitor restarts it
        if list(mon.restart_counts.values()) != [1]:
            raise AssertionError(f"monitor: restart counts {mon.restart_counts}")

        def restarted():
            return [j for j in ours() if j["pid"] != job.pid]

        (new,) = _wait_for("restarted job", restarted, 60, every=0.2)
        _, status = os.waitpid(new["pid"], 0)
        if os.waitstatus_to_exitcode(status):
            raise AssertionError(f"monitor: the restarted job exited {status}")
    finally:
        mon_mod.find_training_jobs = every_job
        if job.poll() is None:
            job.kill()
            job.wait()
    (restart_log,) = (mdir / "logs").glob("restart_pid*_1.log")
    text = restart_log.read_text()
    if f"(iter {saved['iters']})" not in text or "Training completed" not in text:
        raise AssertionError(f"monitor: the restarted run's output:\n{text[-2000:]}")
    runs = sorted((mdir / "results").rglob("training_log.txt"), key=lambda p: p.stat().st_mtime)
    first = TRAIN_ITER.findall(runs[-1].read_text())
    if not first or int(first[0]) < saved["iters"]:
        raise AssertionError(f"monitor: the restarted log starts at {first[:1]}, the save "
                             f"holds iteration {saved['iters']}")
    print(f"monitor: SIGTERM saved iteration {saved['iters']}; restarted with --resume "
          f"({max(mon.restart_counts.values())} of {mon_mod.MAX_RESTARTS}); the restarted "
          f"run's log starts at iteration {first[0]} and it finished", flush=True)
    shutil.rmtree(mdir)


def drive_hp_search(work: Path) -> None:
    """hyperparameter_search: one 64px synthetic trial on the card, which
    completes with an avg_recon_loss."""
    from discogan_modernized_torch.tools import hyperparameter_search as hps

    t0 = time.perf_counter()
    analysis = hps.main(["--task_name=synthetic", "--trials=1", "--base_epochs=1",
                         f"--image_size={SIZE64}", f"--output_dir={work / 'hp'}", "--seed=0",
                         "--poll_interval=1"])
    (trial,) = analysis["all_trials"]
    info = json.loads((Path(trial["result_dir"]) / "trial_info.json").read_text())
    if (trial["status"] != "completed" or info["device"] != "cuda:0"
            or trial["metrics"].get("avg_recon_loss") is None):
        raise AssertionError(f"hyperparameter_search: trial {trial} ({info})")
    print(f"hyperparameter_search: trial 0 {trial['status']} on {info['device']}, "
          f"avg_recon_loss {trial['metrics']['avg_recon_loss']:.4f}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(work / "hp")


def start_ab_builds() -> dict:
    """The A/B tools' variant builds (tools/variants.py), started after the
    main build, to build while phase 3 runs: tool -> what its ``run``
    takes."""
    from discogan_modernized_torch.tools import conv_ab, dw_ab, head_ab

    started = {"conv_ab": conv_ab.start_variants(AB_VARIANTS),
               "head_ab": head_ab.start_variants(AB_VARIANTS),
               "head_ab f32": head_ab.start_variants(F32_AB_VARIANTS, "f32"),
               "dw_ab": dw_ab.start_variants(DW_AB_VARIANTS),
               "dw_ab k5b": dw_ab.start_variants(DW_AB_VARIANTS, "k5b")}
    _started_builds.extend(b for builds in started.values() for b in builds.values())
    return started


def drive_ab_tools(started: dict) -> None:
    """conv_ab (K3's AB_VARIANTS at AB_CONV_SHAPE), head_ab (K6's, batch 1:
    the tensor-core kernel's AB_VARIANTS, then head_fma_kernel's
    F32_AB_VARIANTS in f32) and dw_ab (K4's f32 DW_AB_VARIANTS at
    DW_AB_LAYER, batch 1), one round each through their ``run``, from the
    builds started after the build phase: each variant builds and launches,
    the kernel holds its plain version (the tools check it)."""
    from discogan_modernized_torch.tools import conv_ab, dw_ab, head_ab

    for name, call in (("conv_ab", lambda: conv_ab.run(
            1, [s_ for s_ in conv_ab.SHAPES if s_[0] == AB_CONV_SHAPE], started["conv_ab"])),
                       ("head_ab", lambda: head_ab.run([1], 1, started["head_ab"])),
                       ("head_ab f32", lambda: head_ab.run([1], 1, started["head_ab f32"], "f32",
                                                           F32_AB_VARIANTS)),
                       ("dw_ab", lambda: dw_ab.run([DW_AB_LAYER], [1], 1, started["dw_ab"],
                                                   DW_AB_VARIANTS)),
                       ("dw_ab k5b", lambda: dw_ab.run(["enc1"], [1], 1, started["dw_ab k5b"],
                                                       DW_AB_VARIANTS, "k5b"))):
        t0 = time.perf_counter()
        if call():
            raise AssertionError(f"{name} exited non-zero")
        torch.cuda.synchronize()
        print(f"-- tool {name}: {time.perf_counter() - t0:.1f} s (the wait for its builds "
              "included)", flush=True)


def drive_tools(work: Path, ab_builds: dict) -> dict:
    """The tools phase; returns P's entry of the kernels line and the
    tools' launches."""
    p_entry = drive_pipe_probe()
    launches = drive_timing_tools()
    drive_ab_tools(ab_builds)
    drive_memory_report()
    gc_collect()
    drive_batch_size(work)
    drive_monitor(work)
    drive_hp_search(work)
    return {"pipe_probe": p_entry, "launches": launches}


def planted_fault() -> int:
    """``--planted-fault``: (b)'s f32 gate with MESH_FAULTS planted; 0 where
    it refuses the fault of each mode."""
    phase("mesh: the f32 gate against planted faults")
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        readings = mesh_ranks(work, None, faults=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"planted_fault": MESH_FAULTS, "refused": True, "readings": {
        k: {"loss_rel": v["loss_rel"], "worst": v["worst"], "outside": len(v["outside"]),
            "tensors": v["tensors"]} for k, v in readings.items()}}))
    print(smi_line())
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--planted-fault"]):
        print("usage: python3 chip_smoke.py [--planted-fault]", file=sys.stderr)
        return 2
    _disk[0] = DiskWrites()
    try:
        return run_phases(argv)
    finally:
        _disk[0].stop()
        for _, proc in _started_builds:  # a phase failed before the tools waited for them
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(argv: list) -> int:
    started = time.perf_counter()
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
    if argv:
        return planted_fault()
    ab_builds = start_ab_builds()  # they build while phase 3 runs on the card

    phase("kernels against their plain versions")
    timer = Timer()
    results = check_kernels(timer)
    pair_ms = check_pair_launches(timer)

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    patches = contextlib.ExitStack()
    try:
        patches.enter_context(synthetic_once())
        phase("tools: the port's tools (M11) and the read probe P")
        tools = drive_tools(work, ab_builds)

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
        time_forward_f32(model_dir, images, timer, BATCH)

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

        phase("export: the 512px artifact")
        export_counts = drive_export(model_dir, work, images)
        shutil.rmtree(model_dir)

        phase("equivalence: one f32 D and G step at 512px, kernels vs plain")
        check_equivalence()

        phase("train: the trainer CLI at 512px, batch 8, bf16")
        train_model_path, train_counts, synthetic = drive_trainer(work)
        step_ms = synthetic["step_ms"]
        print("inference CLI on the trained generators:")
        _build.reset_launches()
        forwards = drive_cli(train_model_path, work / "trained", images)
        per_forward_check(dict(_build.launches), forwards, "CLI on trained weights")
        keep_train_state(train_model_path)
        profile_g_step()

        phase("distributed: world 1 on NCCL")
        dist_counts = drive_distributed(work, synthetic)

        phase("mesh: tensor and spatial sharding, world 1 on NCCL and 2 ranks over gloo")
        mesh_counts = drive_mesh(work, synthetic)

        phase("train: the step's graph variants at 512px, batch 8, bf16")
        _build.reset_launches()
        variants = drive_variants()
        variant_counts = dict(_build.launches)
        _build.reset_launches()
        drive_variant_cli(work, train_model_path, synthetic["result"])
        variant_cli_counts = dict(_build.launches)

        phase("train: a real-data task at 512px, slim_state=all, SIGTERM and resume")
        real_counts, *real_run = drive_real_data(work, synthetic)
        data_source_ab(work)
        optimizer_share()

        phase("train: chunks of the step replayed as CUDA graphs, the dataset on the card")
        chunk_counts = drive_chunked_cli(work, synthetic)
        shutil.rmtree(train_model_path)
        real_chunk_counts = drive_real_chunks(work, *real_run)
        shutil.rmtree(work / "uninterrupted")
        shutil.rmtree(work / "stopped")
        check_graph_variants()
        chunk_timing()

        phase("train: the angle-pairing CLI at 64px")
        angle_counts, angle_chunk_counts = drive_angle(work)
    finally:
        patches.close()
        shutil.rmtree(work, ignore_errors=True)

    phase("report")
    print(f"phases: {time.perf_counter() - started:.1f} s", flush=True)
    launches = {k: {"cli": counts.get(k, 0), "serve": serve_counts.get(k, 0),
                    "export": export_counts.get(k, 0), "train": train_counts[k],
                    "distributed": dist_counts.get(k, 0), "mesh": mesh_counts.get(k, 0),
                    "variants": variant_counts[k],
                    "variant_cli": variant_cli_counts[k], "real_data": real_counts[k],
                    "chunks": chunk_counts[k], "real_data_chunks": real_chunk_counts[k],
                    "angle": angle_counts[k], "angle_chunks": angle_chunk_counts.get(k, 0),
                    "tools": sum(t.get(k, 0) for t in tools["launches"].values())}
                for k in train_counts}
    per_layer_lines(results)
    summary = kernel_summary(results, launches, pair_ms)
    for name, v in variants.items():
        print(f"variant {name}: D {v['dis']:.3f} ms, G {v['gen']:.3f} ms, G step device busy "
              f"{v.get('busy_ms', float('nan')):.3f} ms of {v.get('window_ms', float('nan')):.3f} "
              f"({v.get('device_kernels', 0)} device kernels, {v['launches']} port launches), "
              f"peak {v['peak'] / 2**30:.2f} GiB")
    serving = [k for k in summary if k["name"] in SERVING_KERNELS]
    print(f"forward {forward_ms:.3f} ms; the four serving kernels' phase-3 medians "
          f"(each with L2 evicted) sum to {sum(k['ms'] for k in serving):.3f} ms")
    print(f"G step {step_ms['gen']:.3f} ms, D step {step_ms['dis']:.3f} ms; the seven "
          f"kernels' phase-3 medians over one G step's calls sum to "
          f"{sum(k['train_step_ms'] for k in summary):.3f} ms")
    print(json.dumps({"kernels": summary + [tools["pipe_probe"]]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
