"""The trainer behind ``cli/image_translation.py`` and
``cli/angle_pairing.py`` (the reference's image_translation.py:211-436 and
angle_pairing.py:181-451 skeletons, the JAX package's ``train/loop.py``
per-step path): a timestamped result/model directory pair, the task's data
through the resolvers and the host loader, the test set preprocessed once,
the epoch loop with independent A/B shuffles, D on
``iters % update_interval == 0`` and G otherwise with the curriculum rate,
the training_log.txt contract, sample dumps and reference-layout ``.pth``
checkpoints beside the full train state.

``--resume <model dir>`` restores the full train state and continues to
the run's original total (epochs x batches an epoch): finished epochs are
skipped, and a partly trained epoch restarts at the next batch, with the
batches the uninterrupted run would have drawn. On SIGTERM the trainer
finishes its step, saves the full train state and the reference layout,
and returns; the caller's SIGTERM handler is restored on every way out.

The angle variant (``angle_variant=True``) has no style level in its
paths, leaves the first discriminator feature out of the feature-matching
loss, logs without the FM field and dumps each test image's views.

The train step's graph variants come from the flags: ``--paired``,
``--lean_dis`` (D iterations that are not logged take the lean D step; a
logged one the full graph), ``--remat {on,off}`` and ``--remat_policy``;
with ``--remat`` unset, ``resolve_remat`` decides from the card's free
memory and prints its line.

``run_training`` takes an optional ``observer`` with ``begin(iters, kind)``
and ``end(iters, kind, losses)`` (kind "dis", "lean" (a lean D step) or
"gen", losses the step's device tensors), called around each step and
nothing else: a caller can time the steps, count their kernel launches or
check their losses.
"""

from __future__ import annotations

import contextlib
import signal
import statistics
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import configure, default_policy
from ..data.pipeline import HostLoader, is_paths
from ..data.preprocess import read_images
from ..data.resolvers import get_task_data, task_domains
from .checkpoint import (load_train_state, save_reference_layout,
                         save_train_state, train_state_meta)
from .graph import ARCH_MODES
from .logging_ import TrainingLogger
from .samples import save_individual_images, save_sample_grid
from .step import (TrainConfig, init_train_state, make_lean_dis_step,
                   make_sample_fn, make_train_steps, resolve_remat,
                   resolve_slim_state)


def build_paths(args, timestamp: str, angle_variant: bool = False):
    """results/<task>[/<style_A>]/<arch>/<timestamp>, and the same under
    models/ (ref :226-235; the angle trainer has no style level, ref
    angle_pairing.py:190-191)."""
    result_path = Path(args.results_dir) / args.task_name
    model_path = Path(args.models_dir) / args.task_name
    if not angle_variant and getattr(args, "style_A", None):
        result_path, model_path = result_path / args.style_A, model_path / args.style_A
    tail = Path(args.model_arch) / timestamp
    return result_path / tail, model_path / tail


def preprocess_test_set(args, test_A, test_B, angle_variant: bool = False):
    """The test images as NHWC f32 arrays (ref image_translation.py:241-249,
    angle_pairing.py:196-205)."""
    dom_A, dom_B = (None, None) if angle_variant else task_domains(args.task_name)

    def prep(data, domain):
        data = np.asarray(data)
        if is_paths(data):
            return read_images(list(data), domain, args.image_size)
        return np.asarray(data, np.float32)

    return prep(test_A, dom_A), prep(test_B, dom_B)


def config_from_args(args, angle_variant: bool = False) -> TrainConfig:
    if args.model_arch not in ARCH_MODES:
        raise SystemExit(
            f"model_arch must be one of {ARCH_MODES}, got {args.model_arch!r}")
    cfg = TrainConfig(
        image_size=args.image_size, model_arch=args.model_arch,
        learning_rate=args.learning_rate, beta1=args.beta1, beta2=args.beta2,
        gan_curriculum=args.gan_curriculum, starting_rate=args.starting_rate,
        default_rate=args.default_rate, update_interval=args.update_interval,
        skip_first_fm=angle_variant, precision=args.precision,
        slim_state=args.slim_state, paired=args.paired, lean_dis=args.lean_dis,
        remat={"on": True, "off": False, None: None}[args.remat],
        remat_policy=args.remat_policy, log_interval=args.log_interval)
    resolve_slim_state(cfg)  # fail before any data or weights
    return cfg


@contextlib.contextmanager
def sigterm_flag():
    """A flag that SIGTERM sets while the block runs (in the main thread;
    elsewhere it stays unset), and the caller's handler restored after."""
    flag = {"set": False}

    def on_sigterm(signum, frame):
        flag["set"] = True

    try:
        old = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        old = None
    try:
        yield flag
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)


def run_training(args, *, observer=None, angle_variant: bool = False):
    """Train as the flags say; returns (result_path, model_path)."""
    device = resolve_device(args.device)
    policy = default_policy(args.precision, device)
    configure(policy)
    cfg = config_from_args(args, angle_variant)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    result_path, model_path = build_paths(args, timestamp, angle_variant)
    data_A, data_B, test_A, test_B = get_task_data(args)
    test_A, test_B = preprocess_test_set(args, test_A, test_B, angle_variant)
    n_samples = min(5, len(test_A), len(test_B))
    dom_A, dom_B = (None, None) if angle_variant else task_domains(args.task_name)
    loader = HostLoader(data_A, data_B, args.batch_size, args.image_size, device,
                        domain_A=dom_A, domain_B=dom_B, seed=args.seed)
    nb = loader.n_batches
    if nb == 0:
        raise SystemExit(
            f"batch_size={args.batch_size} exceeds the usable dataset size "
            f"({min(len(data_A), len(data_B))} pairs): no batches to train on")
    total_iterations = args.epochs * nb
    cfg, remat_line = resolve_remat(cfg, args.batch_size, device,
                                    compute_itemsize=policy.compute_dtype.itemsize)
    print(remat_line)

    ts = init_train_state(args.seed, cfg, device)
    start_iters = 0
    if args.resume:
        start_iters = load_train_state(args.resume, ts, cfg)
        print(f"전체 학습 상태 복원: {args.resume} (iter {start_iters})")
    result_path.mkdir(parents=True, exist_ok=True)
    model_path.mkdir(parents=True, exist_ok=True)

    gen_step, dis_step = make_train_steps(cfg, policy)
    lean_step = make_lean_dis_step(cfg, policy) if cfg.lean_dis else None
    sample_fn = make_sample_fn(cfg, policy)
    test_A_t = torch.from_numpy(test_A).to(device)
    test_B_t = torch.from_numpy(test_B).to(device)
    logger = TrainingLogger(result_path / "training_log.txt", timestamp,
                            args.task_name, args.model_arch, args.batch_size,
                            args.learning_rate)
    print(f"Total iterations: {total_iterations}")
    print(f"Saving results to: {result_path}")
    print(f"Saving models to: {model_path}")
    meta = train_state_meta(cfg, task=args.task_name)

    def dump_samples(iters):
        # Train-mode forwards: the running statistics advance, as in the
        # reference.
        out = [o.cpu().numpy() for o in sample_fn(ts.models, test_A_t, test_B_t)]
        if angle_variant:
            save_individual_images(test_A, test_B, *out,
                                   result_path / str(iters // args.image_save_interval),
                                   args.n_test)
            save_sample_grid(test_A[:5], test_B[:5], *out,
                             result_path / "sample_grids", iters, n_samples=n_samples)
        else:
            save_sample_grid(test_A, test_B, *out, result_path / "samples", iters,
                             n_samples=n_samples)

    iters = start_iters
    start_epoch = min(start_iters // nb, args.epochs)
    skip = start_iters - start_epoch * nb
    t_start = time.time()
    with sigterm_flag() as preempted, contextlib.closing(loader), \
            torch.autograd.set_detect_anomaly(args.debug):
        for epoch in range(start_epoch, args.epochs):
            with contextlib.closing(loader.epoch(epoch, skip=skip)) as batches:
                for A, B in batches:
                    kind = ("lean" if cfg.use_lean_dis(iters) else
                            "dis" if cfg.is_dis_iter(iters) else "gen")
                    if observer is not None:
                        observer.begin(iters, kind)
                    step = {"dis": dis_step, "lean": lean_step, "gen": gen_step}[kind]
                    losses = step(ts, A, B, cfg.rate_for(iters))
                    if observer is not None:
                        observer.end(iters, kind, losses)

                    if iters % args.log_interval == 0:
                        vals = {k: float(v) for k, v in losses.items()}
                        if not all(np.isfinite(v) for v in vals.values()):
                            print("경고: 손실에 NaN/Inf 감지 — --debug 로 첫 발생 "
                                  "지점을 추적할 수 있습니다")
                        logger.log(iters, total_iterations, vals, fm=not angle_variant)
                    if iters % args.image_save_interval == 0:
                        dump_samples(iters)
                    if iters % args.model_save_interval == 0:
                        save_reference_layout(model_path, ts.models, iters)
                        # The state holds iteration ``iters``: a resume
                        # from it trains ``iters + 1`` next.
                        save_train_state(model_path, ts, iters + 1, meta)
                    iters += 1
                    if preempted["set"]:
                        save_train_state(model_path, ts, iters,
                                         dict(meta, preempted=True))
                        save_reference_layout(model_path, ts.models, iters)
                        print(f"SIGTERM: 학습 상태 저장 후 종료 (iter {iters}) — "
                              f"--resume {model_path} 로 재개")
                        return result_path, model_path
            skip = 0

    save_reference_layout(model_path, ts.models, "final")
    save_train_state(model_path, ts, iters, meta)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    if dt > 0 and iters > start_iters:
        print(f"Throughput: {(iters - start_iters) * args.batch_size / dt:.1f} "
              "images/sec")
    if loader.waits:
        ms = [w * 1e3 for w in loader.waits]
        print(f"Loader wait per step: median {statistics.median(ms):.3f} ms, "
              f"max {max(ms):.3f} ms over {len(ms)} steps")
    print(f"Training completed. Final models saved to {model_path}")
    print(f"Results and logs saved to {result_path}")
    return result_path, model_path
