"""The trainer behind ``cli/image_translation.py`` (the reference's
image_translation.py:211-436 skeleton, the JAX package's ``train/loop.py``
per-step path): a timestamped result/model directory pair, the epoch loop
with independent A/B shuffles, D on ``iters % update_interval == 0`` and G
otherwise with the curriculum rate, the training_log.txt contract, sample
grids and reference-layout ``.pth`` checkpoints, one host iteration per
step.

``run_training`` takes an optional ``observer`` with ``begin(iters, kind)``
and ``end(iters, kind, losses)`` (kind "dis" or "gen", losses the step's
device tensors), called around each step and nothing else: a caller can
time the steps, count their kernel launches or check their losses.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import configure, default_policy
from ..data.pipeline import epoch_batches, n_batches, synthetic_pair
from .checkpoint import save_reference_layout, save_train_state
from .graph import ARCH_MODES
from .logging_ import TrainingLogger
from .samples import save_sample_grid
from .step import (TrainConfig, init_train_state, make_sample_fn,
                   make_train_steps, resolve_slim_state)


def build_paths(args, timestamp: str):
    """results/<task>/<arch>/<timestamp> and models/<task>/<arch>/<timestamp>
    (ref :226-235)."""
    tail = Path(args.task_name) / args.model_arch / timestamp
    return Path(args.results_dir) / tail, Path(args.models_dir) / tail


def config_from_args(args) -> TrainConfig:
    if args.model_arch not in ARCH_MODES:
        raise SystemExit(
            f"model_arch must be one of {ARCH_MODES}, got {args.model_arch!r}")
    cfg = TrainConfig(
        image_size=args.image_size, model_arch=args.model_arch,
        learning_rate=args.learning_rate, beta1=args.beta1, beta2=args.beta2,
        gan_curriculum=args.gan_curriculum, starting_rate=args.starting_rate,
        default_rate=args.default_rate, update_interval=args.update_interval,
        precision=args.precision, slim_state=args.slim_state)
    resolve_slim_state(cfg)  # fail before any data or weights
    return cfg


def task_data(args):
    """(data_A, data_B, test_A, test_B) as NHWC f32 arrays."""
    if args.task_name != "synthetic":
        raise SystemExit(
            f"task {args.task_name!r}: only --task_name=synthetic is ported; "
            "the real-data resolvers come in a later slice of the port")
    data_A, data_B = synthetic_pair(256, args.image_size, seed=0)
    test_A, test_B = synthetic_pair(8, args.image_size, seed=1)
    return data_A, data_B, test_A, test_B


def run_training(args, *, observer=None):
    """Train as the flags say; returns (result_path, model_path)."""
    device = resolve_device(args.device)
    policy = default_policy(args.precision, device)
    configure(policy)
    cfg = config_from_args(args)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    result_path, model_path = build_paths(args, timestamp)
    data_A, data_B, test_A, test_B = task_data(args)
    nb = n_batches(data_A, data_B, args.batch_size)
    if nb == 0:
        raise SystemExit(
            f"batch_size={args.batch_size} exceeds the usable dataset size "
            f"({min(len(data_A), len(data_B))} pairs): no batches to train on")
    total_iterations = args.epochs * nb
    result_path.mkdir(parents=True, exist_ok=True)
    model_path.mkdir(parents=True, exist_ok=True)

    ts = init_train_state(args.seed, cfg, device)
    gen_step, dis_step = make_train_steps(cfg, policy)
    sample_fn = make_sample_fn(cfg, policy)
    test_A_t = torch.from_numpy(test_A).to(device)
    test_B_t = torch.from_numpy(test_B).to(device)
    n_samples = min(5, len(test_A), len(test_B))
    logger = TrainingLogger(result_path / "training_log.txt", timestamp,
                            args.task_name, args.model_arch, args.batch_size,
                            args.learning_rate)
    print(f"Total iterations: {total_iterations}")
    print(f"Saving results to: {result_path}")
    print(f"Saving models to: {model_path}")
    meta = {"task": args.task_name, "arch": args.model_arch}

    rng = np.random.RandomState(args.seed)
    iters = 0
    t_start = time.time()
    with torch.autograd.set_detect_anomaly(args.debug):
        for _ in range(args.epochs):
            for A, B in epoch_batches(data_A, data_B, args.batch_size, device, rng):
                kind = "dis" if cfg.is_dis_iter(iters) else "gen"
                if observer is not None:
                    observer.begin(iters, kind)
                step = dis_step if kind == "dis" else gen_step
                losses = step(ts, A, B, cfg.rate_for(iters))
                if observer is not None:
                    observer.end(iters, kind, losses)

                if iters % args.log_interval == 0:
                    vals = {k: float(v) for k, v in losses.items()}
                    if not all(np.isfinite(v) for v in vals.values()):
                        print("경고: 손실에 NaN/Inf 감지 — --debug 로 첫 발생 "
                              "지점을 추적할 수 있습니다")
                    logger.log(iters, total_iterations, vals)
                if iters % args.image_save_interval == 0:
                    # Train-mode forwards: the running statistics advance,
                    # as in the reference.
                    out = sample_fn(ts.models, test_A_t, test_B_t)
                    save_sample_grid(test_A, test_B,
                                     *(o.cpu().numpy() for o in out),
                                     result_path / "samples", iters,
                                     n_samples=n_samples)
                if iters % args.model_save_interval == 0:
                    save_reference_layout(model_path, ts.models, iters)
                    save_train_state(model_path, ts, iters, meta)
                iters += 1

    save_reference_layout(model_path, ts.models, "final")
    save_train_state(model_path, ts, iters, meta)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    if dt > 0 and iters > 0:
        print(f"Throughput: {iters * args.batch_size / dt:.1f} images/sec")
    print(f"Training completed. Final models saved to {model_path}")
    print(f"Results and logs saved to {result_path}")
    return result_path, model_path
