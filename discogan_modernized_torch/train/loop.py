"""The trainer behind ``cli/image_translation.py`` and
``cli/angle_pairing.py`` (the reference's image_translation.py:211-436 and
angle_pairing.py:181-451 skeletons, the JAX package's ``train/loop.py``
per-step path): a timestamped result/model directory pair, the task's data
through the resolvers and the host loader, the test set preprocessed once,
the epoch loop with independent A/B shuffles, D on
``iters % update_interval == 0`` and G otherwise with the curriculum rate,
the training_log.txt contract, sample dumps and reference-layout ``.pth``
checkpoints beside the full train state. At each save the trainer appends
its memory on the card to ``hbm_telemetry.jsonl`` beside the log
(``hbm_sample``, the JAX trainer's sidecar), which ``tools/monitor.py``
reads; on the chunked path that falls at a chunk's end, outside its graphs.

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

The multi-step driver (the JAX package's train/loop.py:498-921, one
process): where both decoded domains fit the card's budget
(``data/pipeline.py::fits_device_budget``; ``--no_device_cache`` turns it
off) the dataset is built on the card before ``resolve_remat`` reads the
free memory, and batches are gathered there. ``--steps_per_call`` k > 1
(the default on the card: ``auto_steps_per_call`` of the resolved config)
then runs chunks of up to k iterations through ``train/chunk.py``'s
``ChunkProgram``: CUDA graphs of the step kinds on the card, the same
steps eagerly on the CPU. Chunks end at sample and save iterations and at
whole [D, G, ..., G] periods (``step.chunk_steps``), so logs, samples and
saves fall on the per-step path's iterations and give its results; the
losses are read once a chunk that holds a logged iteration; SIGTERM is
honoured between chunks. Unlike the JAX package, nothing falls back to
the per-step loop: the path is decided up front, printed in one line
(dataset, k, graphs, remat), and a capture or replay that fails raises.
k = 1 is the per-step loop, from the dataset where it is on, else from
the host loader. ``--profile DIR`` traces iterations 2-9
(``train/profiling.py``).

Data parallelism (``ranks``, from core/distributed.py; the JAX package's
train/loop.py:164-375 on a mesh): every rank runs this loop on its own
device with a ``parallel.DataParallel``, whose all-reduces run inside the
steps (and, on the chunked path, inside their CUDA graphs).
``--batch_size`` is one host's batch, as in the JAX package
(loop.py:241-260, :352-375, where a host's mesh splits it over its
devices): each host trains on its shard of both domains,
``d[host::hosts]`` truncated to the shortest shard's length (a host with
one batch more would wait forever in a collective), draws the batches one
process would draw from that shard, and each of its ranks takes its rows
of every batch (``data/pipeline.py::host_rows``). So W ranks on one host
train on exactly the batches of the one-process run with the same flags;
a rank's dataset on the device holds its host's shard. Every rank takes
the same seed, so the models start equal, and rank 0's run timestamp
names every rank's directories. The ranks decide remat and the dataset's
place from the smallest free memory and the least fit among them, so that
all run the same collectives. Rank 0 alone
writes the log, the sample images and the checkpoints (its running
statistics under per-rank BatchNorm, JAX ``dp.py:55-69``), and handles a
SIGTERM save; the ranks agree after each step (chunk) whether any was
sent SIGTERM, and all stop there. Every rank runs the sample forwards, so
their running statistics take the same updates as a single process's.
``--resume`` and the weights-only ``--load_gen_A`` ... ``--load_dis_B``
(the distributed CLI's; JAX loop.py:278-290) load on every rank.

A (data, model) mesh (``--parallel_mode gspmd|spatial``, the JAX package's
train/loop.py:292-341 and :515-559): ``--tp`` ranks on the model axis (by
default 2 on an even world larger than one, else 1; it must divide the
world, and the ranks of a host), the rest on the data axis, whose ranks
split a host's batch as above while a data row's model ranks take the same
rows. The whole state is made and loaded on the CPU, then each rank takes
its part onto its device (parallel/gspmd.py ``place_train_state``); the
steps take a ``MeshParallel``, BatchNorm global whatever ``--bn_sync``
says. Under ``--ckpt_backend npz`` saves gather the whole state onto rank
0's CPU (its data row's ranks send their slices; no rank holds a whole
copy on its card), which writes it in the layout a one-process run
writes; under ``orbax`` with more than one rank (the JAX trainer's
``ckpt_all_procs``, loop.py:379-384) every rank enters the save and writes
its own slices from its device, nothing gathering the Adam moments (rank 0
still gathers the networks for the reference layout, which it alone
writes). Either way a resume reads the whole state on the CPU and places
it, so a save moves between meshes of any shape and a one-process run.
Tensor parallelism runs
chunks where every rank is on one host; spatial sharding one step a call
(``chunks_declined``). The path line names the mode, the mesh and the
backend.

``run_training`` takes an optional ``observer``. On the per-step path it
is called with ``begin(iters, kind)`` and ``end(iters, kind, losses)``
(kind "dis", "lean" (a lean D step) or "gen", losses the step's device
tensors) around each step; on the chunked path with
``begin_chunk(iters0, kinds)`` and ``end_chunk(iters0, kinds, losses,
program)`` around each chunk (losses (k, len(chunk.LOSS_KEYS)) on the
device; ``program`` the ``ChunkProgram``, with each captured kind's
launches). Nothing else calls it: a caller can time the steps, count
their kernel launches or check their losses.
"""

from __future__ import annotations

import contextlib
import json
import signal
import statistics
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.distributed import any_rank, broadcast_text, min_over_ranks
from ..core.precision import configure, default_policy
from ..data.pipeline import (DEVICE_BUDGET_SHARE, DeviceDataset, HostLoader,
                             dataset_bytes, fits_device_budget, host_rows, is_paths,
                             rank_shard)
from ..data.preprocess import read_images
from ..data.resolvers import get_task_data, task_domains
from ..core.mesh import make_mesh
from ..parallel import DataParallel
from ..parallel.gspmd import (MeshParallel, gather_train_state, local_train_state,
                              place_train_state, resolve_tp)
from .checkpoint import (load_train_state, save_reference_layout,
                         save_train_state, state_slices, train_state_meta)
from .chunk import LOSS_KEYS, ChunkProgram
from .graph import ARCH_MODES
from .logging_ import TrainingLogger
from .profiling import ProfileWindow
from .samples import save_individual_images, save_sample_grid
from .step import (TrainConfig, auto_steps_per_call, chunk_steps, init_train_state,
                   kinds_in_range, make_lean_dis_step, make_sample_fn,
                   make_train_steps, resolve_remat, resolve_slim_state)


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
        remat_policy=args.remat_policy, log_interval=args.log_interval,
        bn_sync=args.bn_sync)
    resolve_slim_state(cfg)  # fail before any data or weights
    return cfg


def use_device_dataset(args, device, n_a: int, n_b: int) -> tuple[bool, str]:
    """(whether the decoded dataset goes on the device, why): off under
    --no_device_cache; on the card where it fits DEVICE_BUDGET_SHARE of the
    card's memory; on the CPU only for chunks (--steps_per_call > 1)."""
    gib = dataset_bytes(n_a, n_b, args.image_size) / 2**30
    if args.no_device_cache:
        return False, "off (--no_device_cache)"
    if device.type == "cuda":
        if fits_device_budget(n_a, n_b, args.image_size, device):
            return True, f"on the card ({gib:.2f} GiB)"
        return False, (f"off ({gib:.2f} GiB passes {DEVICE_BUDGET_SHARE:.0%} of the "
                       "card's memory)")
    if (args.steps_per_call or 1) > 1:
        return True, f"on the CPU for --steps_per_call ({gib:.2f} GiB)"
    return False, "off (the CPU)"


def chunks_declined(args, ranks) -> str | None:
    """Why a run takes one step a call whatever --steps_per_call says, or
    None. Spatial sharding is not routed to chunks (JAX train/loop.py:538-550:
    under its scan the latent and enc0 gradients drift 0.013-0.033 in Adam's
    first moment, JAX parallel/gspmd.py:221-229); tensor parallelism is,
    where every rank is on one host; a card that ranks share over gloo takes
    none, since gloo's collectives do not capture into CUDA graphs."""
    mode = getattr(args, "parallel_mode", "dp") or "dp"
    if ranks is None:
        return None
    if mode == "spatial":
        return ("spatial sharding is not routed to chunks: JAX measured its scan's latent "
                "and enc0 gradients 0.013-0.033 off the per-step path's in Adam's first "
                "moment, and declines it")
    if mode == "gspmd" and ranks.hosts > 1:
        return "tensor parallelism runs chunks only where every rank is on one host"
    if ranks.backend == "gloo" and ranks.device.type == "cuda":
        return "the ranks share a card over gloo, whose collectives CUDA graphs cannot capture"
    return None


def resolve_steps_per_call(args, cfg: TrainConfig, device, dataset,
                           declined: str | None = None) -> tuple[int, str]:
    """(iterations a call, how it was decided): --steps_per_call as set, else
    ``auto_steps_per_call`` of the resolved config with the dataset on the
    card (not under --debug, whose anomaly checks read the device inside a
    step), else 1. Above 1 it needs the dataset on the device; where chunks
    are ``declined`` (``chunks_declined``), the default is 1 and more is
    refused."""
    k, how = args.steps_per_call, "set"
    if k is None:
        auto = (dataset is not None and device.type == "cuda" and not args.debug
                and declined is None)
        k, how = (auto_steps_per_call(cfg, args.image_size) if auto else 1), "auto"
    if k < 1:
        raise SystemExit(f"--steps_per_call must be at least 1, got {k}")
    if k > 1 and declined is not None:
        raise SystemExit(f"--steps_per_call {k}: {declined}")
    if k > 1 and dataset is None:
        raise SystemExit("--steps_per_call above 1 gathers its batches from the dataset "
                         "on the device, which is off for this run")
    if k > 1 and args.debug and device.type == "cuda":
        raise SystemExit("--debug reads the device inside a step, which a CUDA graph "
                         "cannot capture: use --steps_per_call 1")
    return k, how


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


def device_memory(device) -> list | None:
    """This process's memory on ``device`` as the JAX trainer's sidecar
    records a device's: the bytes its tensors hold
    (``torch.cuda.memory_allocated``) and the card's total
    (``torch.cuda.mem_get_info``); None on the CPU, which keeps no such
    count (as JAX's backends without ``memory_stats``)."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return [{"id": index, "bytes_in_use": torch.cuda.memory_allocated(index),
             "bytes_limit": torch.cuda.mem_get_info(index)[1]}]


def hbm_sample(result_path: Path, iters: int, device) -> None:
    """Append ``{"t", "iter", "devices"}`` to ``hbm_telemetry.jsonl`` beside
    the training log (the JAX trainer's sidecar, train/loop.py:386-408):
    a monitor cannot see another process's allocator, so the trainer
    reports its own. Nothing on the CPU; a failure never stops training."""
    try:
        devices = device_memory(device)
        if devices:
            with open(Path(result_path) / "hbm_telemetry.jsonl", "a") as f:
                f.write(json.dumps({"t": time.time(), "iter": iters,
                                    "devices": devices}) + "\n")
    except Exception:  # noqa: BLE001 -- telemetry must never stop training
        pass


def load_weights(args, models: dict) -> None:
    """The weights-only ``--load_<name>`` flags: a reference-layout .pth
    into that network (strict), cast to its parameters' dtype."""
    for name, m in models.items():
        path = getattr(args, f"load_{name}", None)
        if path:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            m.load_state_dict(sd, strict=True)
            print(f"모델 로드 성공: {path}")


def save_checkpoint(model_path, ts, mp, iters: int, meta: dict, tag=None, *,
                    backend: str = "npz", every_rank: bool = False,
                    main: bool = True) -> None:
    """One save of the trainer: the train state (holding ``iters``
    iterations) and, where ``tag`` is set, the reference layout
    ``{name}_{tag}.pth``. ``mp``: the rank's mesh (None: a one-process or
    data-parallel state, whole on every rank). ``every_rank`` (the orbax
    backend over several ranks, a collective): each rank writes its own
    slices, and rank 0 the reference layout from the networks gathered
    alone; else the whole state, gathered under a mesh, written by the main
    rank."""
    if every_rank:
        save_train_state(model_path, local_train_state(ts, mp) if mp is not None
                         else state_slices(ts, writes=main), iters, meta, backend=backend)
        if tag is not None:
            models = ts if mp is None else gather_train_state(ts, mp, moments=False)
            if main:
                save_reference_layout(model_path, models.models, tag)
        return
    state = ts if mp is None else gather_train_state(ts, mp)
    if main:
        save_train_state(model_path, state, iters, meta, backend=backend)
        if tag is not None:
            save_reference_layout(model_path, state.models, tag)


def run_training(args, *, observer=None, angle_variant: bool = False, ranks=None):
    """Train as the flags say; returns (result_path, model_path). ``ranks``:
    this process's place in a data-parallel group (core/distributed.py)."""
    device = ranks.device if ranks is not None else resolve_device(args.device)
    main_rank = ranks is None or ranks.is_main
    policy = default_policy(args.precision, device)
    configure(policy)
    cfg = config_from_args(args, angle_variant)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    if ranks is not None:
        timestamp = broadcast_text(timestamp, ranks, len(timestamp))
    result_path, model_path = build_paths(args, timestamp, angle_variant)
    data_A, data_B, test_A, test_B = get_task_data(args)
    rows, batch, global_batch = None, args.batch_size, args.batch_size
    mode = getattr(args, "parallel_mode", "dp") or "dp"
    tp = 1
    if ranks is not None:
        if mode != "dp":
            tp = resolve_tp(args.tp, ranks.world)
            if ranks.local_world % tp:
                raise SystemExit(f"--tp {tp}: the model axis lies within a host, and "
                                 f"{tp} does not divide the {ranks.local_world} ranks of one")
        if ranks.hosts > 1:
            data_A, data_B = (rank_shard(d, ranks.host, ranks.hosts) for d in (data_A, data_B))
        # the data axis splits a host's batch; a data row's model ranks share its rows
        rows = host_rows(args.batch_size, ranks.part // tp, ranks.local_world // tp)
        batch, global_batch = rows.stop - rows.start, ranks.hosts * args.batch_size
    test_A, test_B = preprocess_test_set(args, test_A, test_B, angle_variant)
    n_samples = min(5, len(test_A), len(test_B))
    dom_A, dom_B = (None, None) if angle_variant else task_domains(args.task_name)
    loader = HostLoader(data_A, data_B, args.batch_size, args.image_size, device,
                        domain_A=dom_A, domain_B=dom_B, seed=args.seed, rows=rows)
    nb = loader.n_batches
    if nb == 0:
        raise SystemExit(
            f"batch_size={args.batch_size} exceeds the usable dataset size "
            f"({min(len(data_A), len(data_B))} pairs): no batches to train on")
    total_iterations = args.epochs * nb
    on, dataset_line = use_device_dataset(args, device, len(data_A), len(data_B))
    if ranks is not None and not min_over_ranks([on], ranks)[0] and on:
        on, dataset_line = False, "off (it does not fit on every rank's card)"
    dataset = None
    if on:
        t0 = time.perf_counter()
        dataset = DeviceDataset(loader)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dataset_line += f", built in {time.perf_counter() - t0:.3f} s"
    # After the dataset: the remat rule reads the free memory without it.
    free_bytes = None
    if device.type == "cuda":
        free_bytes = torch.cuda.mem_get_info(device)[0]
        if ranks is not None:
            (free_bytes,) = min_over_ranks([free_bytes], ranks)
    cfg, remat_line = resolve_remat(cfg, batch, device, free_bytes,
                                    compute_itemsize=policy.compute_dtype.itemsize)
    print(remat_line)
    declined = chunks_declined(args, ranks)
    steps_per_call, how = resolve_steps_per_call(args, cfg, device, dataset, declined)
    graphs = steps_per_call > 1 and device.type == "cuda"
    dp = mp = None
    mesh_line = ""
    if ranks is not None and mode != "dp":
        mp = dp = MeshParallel(make_mesh(ranks.world // tp, tp), spatial=mode == "spatial")
        mesh_line = (f"; mesh {mode} ("
                     + ", ".join(f"{axis}={n}" for axis, n in mp.mesh.shape.items())
                     + f") over {ranks.backend}")
    print(f"train path: dataset {dataset_line}; steps_per_call {steps_per_call} ({how}); "
          f"CUDA graphs {'on' if graphs else 'off'}; remat "
          f"{'on' if cfg.use_remat else 'off'}{mesh_line}")
    if declined is not None and args.steps_per_call is None and dataset is not None:
        print(f"one step a call: {declined}")
    if mp is not None:
        print(f"mesh: rank {ranks.rank} of {ranks.world} at (data {mp.mesh.d}, model "
              f"{mp.mesh.m}) ({ranks.backend}, {device}); BatchNorm global"
              + (" (--bn_sync changes nothing on a mesh)" if cfg.bn_sync else "")
              + f"; global batch {global_batch}, {batch} on this rank's data row")
    elif ranks is not None:
        dp = DataParallel(bn_sync=cfg.bn_sync)
        print(f"data parallel: rank {ranks.rank} of {ranks.world} ({ranks.backend}, "
              f"{device}); BatchNorm {'synced' if cfg.bn_sync else 'per rank'}; "
              f"global batch {global_batch}, {batch} on this rank")

    # On a mesh the whole state is made (and loaded) on the CPU, then each
    # rank takes its part of it onto its device.
    ts = init_train_state(args.seed, cfg, "cpu" if mp is not None else device)
    start_iters = 0
    if args.resume:
        start_iters = load_train_state(args.resume, ts, cfg)
        print(f"전체 학습 상태 복원: {args.resume} (iter {start_iters})")
    load_weights(args, ts.models)
    if mp is not None:
        ts = place_train_state(ts, mp, cfg, device)
    if main_rank:
        result_path.mkdir(parents=True, exist_ok=True)
        model_path.mkdir(parents=True, exist_ok=True)

    gen_step, dis_step = make_train_steps(cfg, policy, dp)
    lean_step = make_lean_dis_step(cfg, policy, dp) if cfg.lean_dis else None
    program = None
    if steps_per_call > 1:
        program = ChunkProgram(ts, cfg, policy, *dataset.data, batch,
                               steps_per_call,
                               kinds_in_range(cfg, start_iters, total_iterations - start_iters),
                               graphs=graphs, dp=dp)
    sample_fn = make_sample_fn(cfg, policy, None if mp is None else mp.for_samples())
    test_A_t = torch.from_numpy(test_A).to(device)
    test_B_t = torch.from_numpy(test_B).to(device)
    logger = TrainingLogger(result_path / "training_log.txt", timestamp,
                            args.task_name, args.model_arch, args.batch_size,
                            args.learning_rate) if main_rank else None
    if main_rank:
        print(f"Total iterations: {total_iterations}")
        print(f"Saving results to: {result_path}")
        print(f"Saving models to: {model_path}")
    meta = train_state_meta(cfg, task=args.task_name)
    backend = getattr(args, "ckpt_backend", "npz")
    every_rank = backend == "orbax" and ranks is not None and ranks.world > 1

    def save(iters: int, tag, meta: dict) -> None:
        save_checkpoint(model_path, ts, mp, iters, meta, tag, backend=backend,
                        every_rank=every_rank, main=main_rank)

    def dump_samples(iters):
        # Train-mode forwards: the running statistics advance, as in the
        # reference.
        out = [o.cpu().numpy() for o in sample_fn(ts.models, test_A_t, test_B_t)]
        if not main_rank:
            return
        if angle_variant:
            save_individual_images(test_A, test_B, *out,
                                   result_path / str(iters // args.image_save_interval),
                                   args.n_test)
            save_sample_grid(test_A[:5], test_B[:5], *out,
                             result_path / "sample_grids", iters, n_samples=n_samples)
        else:
            save_sample_grid(test_A, test_B, *out, result_path / "samples", iters,
                             n_samples=n_samples)

    def finish(i: int, vals: dict | None) -> None:
        """What follows iteration i: its log line (``vals``, its losses on
        the host), its samples and its saves."""
        if i % args.log_interval == 0 and main_rank:
            if not all(np.isfinite(v) for v in vals.values()):
                print("경고: 손실에 NaN/Inf 감지 — --debug 로 첫 발생 "
                      "지점을 추적할 수 있습니다")
            logger.log(i, total_iterations, vals, fm=not angle_variant)
        if i % args.image_save_interval == 0:
            dump_samples(i)
        if i % args.model_save_interval == 0:
            if main_rank:
                hbm_sample(result_path, i, device)
            # The state holds iteration i: a resume from it trains i + 1 next.
            save(i + 1, i, meta)

    def preempt(iters: int):
        save(iters, iters, dict(meta, preempted=True))
        if main_rank:
            print(f"SIGTERM: 학습 상태 저장 후 종료 (iter {iters}) — "
                  f"--resume {model_path} 로 재개")
        return result_path, model_path

    def stop_now(flag: bool) -> bool:
        """Whether to stop for a SIGTERM: on any rank, where there are
        several (they must stop at the same step)."""
        if ranks is None or ranks.world == 1:
            return flag
        return any_rank(flag, ranks)

    def batches():
        """(iters, A, B) from start_iters on, from the dataset or the loader."""
        i, skip = start_iters, start_iters - start_epoch * nb
        for epoch in range(start_epoch, args.epochs):
            source = (dataset or loader).epoch(epoch, skip=skip)
            with contextlib.closing(source):
                for A, B in source:
                    yield i, A, B
                    i += 1
            skip = 0

    def index_rows():
        """The dataset's (idx_A, idx_B) rows from start_iters on."""
        skip = start_iters - start_epoch * nb
        for epoch in range(start_epoch, args.epochs):
            ia, ib = dataset.epoch_rows(epoch)
            yield from zip(ia[skip:], ib[skip:])
            skip = 0

    iters = start_iters
    start_epoch = min(start_iters // nb, args.epochs)
    profiler = ProfileWindow(args.profile if main_rank else None, device)
    steps = {"dis": dis_step, "lean": lean_step, "gen": gen_step}
    t_start = time.time()
    with sigterm_flag() as preempted, contextlib.closing(loader), \
            torch.autograd.set_detect_anomaly(args.debug):
        if program is None:
            for i, A, B in batches():
                profiler.tick(i)
                kind = cfg.step_kind(i)
                if observer is not None:
                    observer.begin(i, kind)
                losses = steps[kind](ts, A, B, cfg.rate_for(i))
                if observer is not None:
                    observer.end(i, kind, losses)
                finish(i, {k: float(v) for k, v in losses.items()}
                       if i % args.log_interval == 0 else None)
                iters = i + 1
                if stop_now(preempted["set"]):
                    profiler.stop()
                    return preempt(iters)
        else:
            rows = index_rows()
            intervals = (args.image_save_interval, args.model_save_interval)
            while iters < total_iterations:
                profiler.tick(iters)
                k = chunk_steps(cfg, iters, total_iterations, steps_per_call, intervals)
                idx = [next(rows) for _ in range(k)]
                kinds = [cfg.step_kind(i) for i in range(iters, iters + k)]
                if observer is not None:
                    observer.begin_chunk(iters, kinds)
                losses = program(np.stack([a for a, _ in idx]),
                                 np.stack([b for _, b in idx]), iters)
                if observer is not None:
                    observer.end_chunk(iters, kinds, losses, program)
                logged = [j for j in range(k) if (iters + j) % args.log_interval == 0]
                host = losses.cpu().numpy() if logged else None
                for j in range(k):
                    finish(iters + j, dict(zip(LOSS_KEYS, map(float, host[j])))
                           if j in logged else None)
                iters += k
                if stop_now(preempted["set"]):
                    profiler.stop()
                    return preempt(iters)
        profiler.stop()

    save(iters, "final", meta)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    if dt > 0 and iters > start_iters:
        print(f"Throughput: {(iters - start_iters) * global_batch / dt:.1f} "
              "images/sec")
    if loader.waits:
        ms = [w * 1e3 for w in loader.waits]
        print(f"Loader wait per step: median {statistics.median(ms):.3f} ms, "
              f"max {max(ms):.3f} ms over {len(ms)} steps")
    print(f"Training completed. Final models saved to {model_path}")
    print(f"Results and logs saved to {result_path}")
    return result_path, model_path
