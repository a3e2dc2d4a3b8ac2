"""The multi-step driver's chunk program: k train iterations a call, from
the dataset on the device (the port of the JAX package's
``make_scan_train_step`` and ``make_scan_program_getter``,
train/step.py:350-498).

JAX runs a chunk as one ``lax.scan`` program, (ts, data_A, data_B, idx_A,
idx_B, iters0) -> (ts, losses). Here ``ChunkProgram`` binds the train
state and the dataset when it is made (a CUDA graph holds their
addresses) and is called with (idx_A, idx_B, iters0); it returns the
chunk's per-iteration losses as a (k, len(LOSS_KEYS)) tensor on the
device, which the trainer reads once a chunk, where a logged iteration
falls inside.

Each iteration's kind (D, lean D, G: ``TrainConfig.step_kind``) is routed
on the host. Everything a step reads that changes from one iteration to
the next comes from one int64 table on the device, which one pinned
host-to-device copy fills a chunk: a slot counter (element 0, zeroed by
that copy), and a row a slot with the batch's gather indices into both
domains, the curriculum rate, the optimizer's bias corrections and its
rounding seed words (the f32 and int32 values in the low 32 bits of their
words). A step reads its slot's row, gathers its batch, runs the step of
its kind, applies Adam from the row (``Adam.apply``), writes its losses
into its slot's row of the output and advances the counter. Nothing in
it reads a host value, so:

- on the card, once every kind the run will take has run eagerly once (a
  real iteration each, on the program's side stream: every kernel, plan
  and library handle is made and every kernel's attributes are set), each
  kind is captured as a CUDA graph, the captures sharing one memory pool,
  and every later iteration replays its kind's graph; no eager step
  follows a capture, so the pool and the allocator's cache never both hold
  a step's activations;
- on the CPU, the same steps run eagerly: the plain version the tests use.

Eager and replayed steps launch the same kernels on the same inputs, so
they give the same bits, and both give the bits of the per-step path
(``make_train_steps``), whose Adam and curriculum rate are tensors on the
device too. The host's ``Adam.step`` is the mirror that checkpoints save:
it advances by the chunk's steps of each optimizer. A capture or a replay
that fails raises; there is no fallback to the per-step loop.

``replays`` counts the graph replays of each kind in this process, as
``ops/_build.launches`` counts the kernels' launches; a kernel launched in
a captured step is counted once, at its capture (``ChunkProgram.launches``
keeps each kind's), and not at its replays. ``host_ns`` counts the host's
nanoseconds (``time.perf_counter_ns``) in this process inside the graphs'
replays (``replay``), the eager step bodies (``eager``) and the captures,
instantiation included (``capture``); it is always on, two clock reads a
call. On the card the kernel library is built or loaded when the program
is made, so no build falls in ``eager``. ``reset_replays`` zeroes both
counters. A step body runs in the span ``step.<kind>`` (core/trace.py),
which a profiler records; a replay has no span of its own (a span would
add a device-side range around the graph's kernels to the trace), and its
kernels share the correlation of their ``cudaGraphLaunch``.

Under data parallelism (``dp``, a parallel.DataParallel) each rank runs
its own program over its shard of the dataset, and the steps' all-reduces
(the gradients, the losses, and under bn_sync the statistics) run inside
the steps: on the card NCCL's collectives are captured into the graphs
with the kernels, after the eager warm-up has made the communicator, and
each capture's all-reduces are counted (``ChunkProgram.collectives``); on
the CPU gloo's run eagerly. Under tensor parallelism on a mesh (``dp`` a
parallel.gspmd.MeshParallel, every rank on one host) the same holds, with
the model axis's all-gathers and all-reduces inside the steps too (each
capture's all-gathers: ``ChunkProgram.gathers``); a data row's model ranks
gather the same batch rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import trace
from ..core.precision import Policy
from ..ops import _build
from ..parallel import dp as dp_counts
from .step import TrainConfig, TrainState, loss_and_grads

LOSS_KEYS = ("gen_A", "gen_B", "fm_A", "fm_B", "recon_A", "recon_B", "dis_A", "dis_B",
             "gen_total", "dis_total")
KINDS = ("dis", "lean", "gen")

replays = dict.fromkeys(KINDS, 0)
host_ns = dict.fromkeys(("replay", "eager", "capture"), 0)


def reset_replays() -> None:
    for counts in (replays, host_ns):
        for k in counts:
            counts[k] = 0


def _low_words(values, dtype) -> np.ndarray:
    """``values`` in ``dtype`` (4 bytes), each in the low 32 bits of an
    int64 word (the table's little-endian layout)."""
    return np.asarray(values, dtype).view(np.uint32).astype(np.int64)


class ChunkProgram:
    """Chunks of up to ``steps`` iterations of ``cfg``'s train step on
    ``ts``, gathering batches of ``batch`` from ``data_A``/``data_B`` (the
    decoded dataset, (N, H, W, 3) f32 on the models' device). ``kinds``:
    the step kinds the run will take (``step.kinds_in_range``), all of
    which run eagerly once before any is captured. ``graphs``: capture and
    replay (the default on the card; never on the CPU). ``dp``: this rank's
    parallel.DataParallel under data parallelism."""

    def __init__(self, ts: TrainState, cfg: TrainConfig, policy: Policy,
                 data_A: torch.Tensor, data_B: torch.Tensor, batch: int, steps: int,
                 kinds, graphs: bool | None = None, dp=None):
        device = data_A.device
        self.ts, self.cfg, self.steps, self.batch, self.dp = ts, cfg, steps, batch, dp
        self.kinds = set(kinds)
        graphs = device.type == "cuda" if graphs is None else graphs
        if graphs and device.type != "cuda":
            raise ValueError("CUDA graphs need the dataset on the card")
        if device.type == "cuda":
            _build.library()  # built here, not inside the first timed eager body
        n_seeds = max(len(ts.opt_gen.params), len(ts.opt_dis.params))
        self.width = 2 * batch + 3 + n_seeds
        words = 1 + steps * self.width
        self.table = torch.zeros(words, dtype=torch.int64, device=device)
        self.host = torch.zeros(words, dtype=torch.int64,
                                pin_memory=device.type == "cuda")
        self.losses = torch.zeros(steps, len(LOSS_KEYS), dtype=torch.float32, device=device)
        self.bodies = {kind: self._body(kind, policy, data_A, data_B, n_seeds)
                       for kind in KINDS}
        self.warm: set = set()
        self.graphs: dict = {}    # kind -> torch.cuda.CUDAGraph
        self.launches: dict = {}  # kind -> the kernel launches of its capture
        self.collectives: dict = {}  # kind -> the all-reduces of its capture
        self.gathers: dict = {}  # kind -> the all-gathers of its capture (a mesh's)
        self.stream = torch.cuda.Stream(device) if graphs else None
        self._copied = None  # the event after the last table copy

    def _body(self, kind: str, policy: Policy, data_A, data_B, n_seeds: int):
        ts, cfg, b = self.ts, self.cfg, self.batch
        which = "gen" if kind == "gen" else "dis"
        opt = ts.opt_gen if which == "gen" else ts.opt_dis
        slot = self.table[:1]
        rows = self.table[1:].view(self.steps, self.width)

        def body():
            with trace.span("step." + kind):
                r = rows.index_select(0, slot)[0]
                A = data_A.index_select(0, r[:b])
                B = data_B.index_select(0, r[b:2 * b])
                f32 = r[2 * b:2 * b + 3].view(torch.float32)[0::2]  # rate, bc1, bc2
                seeds = r[2 * b + 3:2 * b + 3 + n_seeds].view(torch.int32)[0::2]
                losses, grads = loss_and_grads(ts, A, B, f32[0], cfg, policy, which,
                                               lean=kind == "lean", dp=self.dp)
                opt.apply(grads, f32[1:], seeds)
                self.losses.index_copy_(0, slot,
                                        torch.stack([losses[k] for k in LOSS_KEYS])[None])
                slot.add_(1)
        return body

    def _fill(self, iters0: int, kinds: list, idx_A, idx_B) -> None:
        """The chunk's table: the counter at 0 and each slot's row, in the
        host buffer, then one copy to the device."""
        b, n = self.batch, len(kinds)
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has read the host buffer
        rows = np.zeros((n, self.width), np.int64)
        rows[:, :b] = idx_A
        rows[:, b:2 * b] = idx_B
        counts = {"gen": 0, "dis": 0}
        for j, kind in enumerate(kinds):
            which = "gen" if kind == "gen" else "dis"
            opt = self.ts.opt_gen if which == "gen" else self.ts.opt_dis
            counts[which] += 1
            bc1, bc2, seeds = opt.step_scalars(opt.step + counts[which])
            rows[j, 2 * b:2 * b + 3] = _low_words([self.cfg.rate_for(iters0 + j), bc1, bc2],
                                                  np.float32)
            rows[j, 2 * b + 3:2 * b + 3 + len(seeds)] = _low_words(seeds, np.int32)
        host = self.host.numpy()
        host[0] = 0
        host[1:1 + rows.size] = rows.ravel()
        if self.stream is None:
            self.table.copy_(self.host)
            return
        with torch.cuda.stream(self.stream):
            self.table.copy_(self.host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _capture(self) -> None:
        """Each kind of ``kinds`` as a CUDA graph on the side stream, all in
        one memory pool; the kernel launches and all-reduces of each capture
        counted."""
        t0 = time.perf_counter_ns()
        pool = torch.cuda.graph_pool_handle()
        for kind in sorted(self.kinds):
            graph = torch.cuda.CUDAGraph()
            before = dict(_build.launches)
            issued = dict(dp_counts.collectives)
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                self.bodies[kind]()
            self.launches[kind] = {k: v - before[k] for k, v in _build.launches.items()
                                   if v != before[k]}
            self.collectives[kind] = dp_counts.collectives["all_reduce"] - issued["all_reduce"]
            self.gathers[kind] = dp_counts.collectives["all_gather"] - issued["all_gather"]
            self.graphs[kind] = graph
        host_ns["capture"] += time.perf_counter_ns() - t0

    def __call__(self, idx_A, idx_B, iters0: int) -> torch.Tensor:
        """Iterations iters0 .. iters0 + k - 1 on the batches of the index
        rows ``idx_A``/``idx_B`` ((k, batch) each, into the dataset);
        returns their losses, (k, len(LOSS_KEYS)) on the device."""
        k = len(idx_A)
        if not 1 <= k <= self.steps or len(idx_B) != k:
            raise ValueError(f"a chunk of {k} iterations (at most {self.steps}) with "
                             f"{len(idx_B)} B rows")
        kinds = [self.cfg.step_kind(i) for i in range(iters0, iters0 + k)]
        if not set(kinds) <= self.kinds:
            raise ValueError(f"kinds {sorted(set(kinds))} outside the program's "
                             f"{sorted(self.kinds)}")
        if self.stream is None:
            self._fill(iters0, kinds, idx_A, idx_B)
            self._run(kinds)
        else:
            current = torch.cuda.current_stream(self.table.device)
            self.stream.wait_stream(current)
            self._fill(iters0, kinds, idx_A, idx_B)
            if not self.graphs and self.warm >= self.kinds:
                self._capture()
            with torch.cuda.stream(self.stream):
                self._run(kinds)
            current.wait_stream(self.stream)
        for which, opt in (("gen", self.ts.opt_gen), ("dis", self.ts.opt_dis)):
            opt.step += sum(1 for kind in kinds if (kind == "gen") == (which == "gen"))
        return self.losses[:k]

    def _run(self, kinds: list) -> None:
        for kind in kinds:
            graph = self.graphs.get(kind)
            if graph is None:
                t0 = time.perf_counter_ns()
                self.bodies[kind]()
                host_ns["eager"] += time.perf_counter_ns() - t0
                self.warm.add(kind)
            else:
                t0 = time.perf_counter_ns()
                graph.replay()
                host_ns["replay"] += time.perf_counter_ns() - t0
                replays[kind] += 1

