"""The trainer's chunked path, as users get it by default on the card: the
decoded dataset on the device, iterations run in chunks of CUDA graphs
replayed from a per-chunk table (``train/chunk.py::ChunkProgram``), at
the trainer's 1 D : 2 G mix from iteration 0.

Set-up, all counted in ``setup_s``: the dataset of both domains and the
weights, drawn on the device from the seed; the train state made by the
program's ``init_train_state`` and loaded with those weights; the first
iterations, up to one of each step kind, run eagerly (every kernel, plan
and handle made); the state put back to its start in place; the checked
steps: iterations 0-1 and 2 through the program's own call and feed, now
captured and replayed, whose readings (each step's trained total, each
optimizer's first gradient read off its first moment, each leaf's change
after the three) are kept; then the traffic's ``warm_chunks`` whole chunks
from iteration 3. The window then runs whole chunks from there for
``seconds``, ended by a ``torch.cuda.synchronize()``.

With ``trace`` the run then profiles a fixed count of further chunks, with
spans around each chunk's fill, replay and sync, and keeps a summary of it.
After the window and the peak memory are read, the program's state is
freed and the reference follows the three checked iterations from the same
weights and batches (``reference/discogan.py``); the gaps between the two
readings decide ``correct`` against the cell's limits (``check.py``).
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import check, harness
from portbench.reference import discogan as ref

NETS = ref.NETS
BIG = 1 << 62


def derived_seed(seed: int, tag: int) -> int:
    """An independent stream's seed from the run's seed (any size)."""
    return (int(seed) % (1 << 64) * 0x9E3779B97F4A7C15 + tag) % (1 << 63)


class Feed:
    """The batches' index rows: each epoch a permutation of each domain,
    drawn from the seed, cut into batches (the last partial one dropped),
    as the trainer's dataset orders them."""

    def __init__(self, seed: int, n_a: int, n_b: int, batch: int):
        self.seed, self.n, self.batch = int(seed) % (1 << 64), (n_a, n_b), batch
        self.per_epoch = min(n_a, n_b) // batch
        self._cache: dict = {}

    def _perms(self, epoch: int):
        if epoch not in self._cache:
            rng = np.random.default_rng([self.seed, 7, epoch])
            self._cache = {epoch: (rng.permutation(self.n[0]), rng.permutation(self.n[1]))}
        return self._cache[epoch]

    def rows(self, it0: int, k: int):
        ia, ib = [], []
        for i in range(it0, it0 + k):
            epoch, j = divmod(i, self.per_epoch)
            pa, pb = self._perms(epoch)
            sl = slice(j * self.batch, (j + 1) * self.batch)
            ia.append(pa[sl])
            ib.append(pb[sl])
        return np.stack(ia).astype(np.int64), np.stack(ib).astype(np.int64)


def images_per_domain(traffic: dict, image_size: int, device) -> int:
    ds = traffic["dataset"]
    if "images_per_domain" in ds:
        return int(ds["images_per_domain"])
    total = torch.cuda.get_device_properties(device).total_memory
    return int(ds["device_share"] * total) // (2 * image_size * image_size * 3 * 4)


def train_config(config: dict):
    from discogan_modernized_torch.train.step import TrainConfig

    t = config["train"]
    return TrainConfig(image_size=config["image_size"], model_arch="discogan",
                       learning_rate=t["learning_rate"], beta1=t["beta1"], beta2=t["beta2"],
                       weight_decay=t["weight_decay"], gan_curriculum=t["gan_curriculum"],
                       starting_rate=t["starting_rate"], default_rate=t["default_rate"],
                       update_interval=t["update_interval"], precision=t["precision"],
                       slim_state=t["slim_state"], remat=t["remat"], lean_dis=t["lean_dis"],
                       log_interval=t["log_interval"])


def weights_of(image_size: int, seed: int, device, nets=NETS) -> dict:
    """The benchmark's weights of ``nets``: one call a network."""
    out = {}
    for k, net in enumerate(NETS):
        if net in nets:
            out[net] = ref.make_weights(image_size, derived_seed(seed, 10 + k), device,
                                        nets=(net,))[net]
    return out


def build_state(cfg, weights: dict, device):
    """The program's train state as ``train/step.py::init_train_state``
    makes it, loaded with the benchmark's weights (under slim state "all"
    the port's masters are bf16, and the load rounds them to nearest). Its
    own draw is overwritten, so it takes one fixed seed."""
    from discogan_modernized_torch.train.step import init_train_state

    ts = init_train_state(0, cfg, device)
    load_weights(ts.models, weights)
    return ts


@torch.no_grad()
def load_weights(models: dict, weights: dict) -> None:
    for net, ws in weights.items():
        params = list(models[net].parameters())
        if [tuple(p.shape) for p in params] != [tuple(w.shape) for w in ws]:
            raise RuntimeError(f"{net}: the port's parameters do not match the "
                               "reference architecture's leaves")
        for p, w in zip(params, ws):
            p.copy_(w)


@torch.no_grad()
def reset_state(ts, image_size: int, seed: int, device) -> None:
    """The state as built, in place (the graphs hold its addresses)."""
    for net in NETS:
        load_weights(ts.models, weights_of(image_size, seed, device, (net,)))
    for m in ts.models.values():
        for mod in m.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.reset_running_stats()
    for opt in (ts.opt_gen, ts.opt_dis):
        for t in (*opt.m, *opt.v):
            t.zero_()
        opt.step = 0


@torch.no_grad()
def first_grad_norms(opt, beta1: float) -> list:
    """Each leaf's first gradient as the optimizer took it, g + wd * p,
    read off its first moment after one step: m = (1 - beta1) * g."""
    return (torch.stack([m.float().norm() for m in opt.m]) / (1.0 - beta1)).tolist()


@torch.no_grad()
def change_norms(ts, image_size: int, seed: int, device) -> dict:
    out = {"gen": [], "dis": []}
    for net in NETS:
        params = list(ts.models[net].parameters())
        start = weights_of(image_size, seed, device, (net,))[net]
        out["gen" if net.startswith("gen") else "dis"] += torch.stack(
            [(p.float() - w.to(p.dtype).float()).norm() for p, w in zip(params, start)]).tolist()
    return out


def fill_data(data: list, seed: int, device) -> None:
    """Both domains' images, uniform in [0, 1), drawn in place from the seed."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    for d in data:
        torch.rand(d.shape, generator=gen, device=device, out=d)


def gather_batches(data: list, feed: Feed, device, n: int = 3) -> list:
    """The batches of iterations 0 .. n-1, gathered from the dataset."""
    return [tuple(d.index_select(0, torch.from_numpy(r[0]).to(device))
                  for d, r in zip(data, feed.rows(i, 1))) for i in range(n)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Bench:
    """One cell's program, built once from ``seed``: the dataset, the train
    state loaded with the benchmark's weights, the chunk program's first
    iterations run eagerly (every kind made), and the state put back to its
    start. ``images``: images a domain in place of the traffic's."""

    def __init__(self, spec: dict, seed: int, device, images: int | None = None):
        from discogan_modernized_torch.core.precision import configure, default_policy
        from discogan_modernized_torch.ops import _build
        from discogan_modernized_torch.train import chunk as chunk_mod
        from discogan_modernized_torch.train.step import (auto_steps_per_call, chunk_steps,
                                                          kinds_in_range)

        self.chunk_mod, self.chunk_steps, self.device = chunk_mod, chunk_steps, device
        self.spec, self.seed = spec, seed
        config, traffic = spec["config"], spec["traffic"]
        self.size, self.batch = config["image_size"], traffic["batch"]
        self.cfg = cfg = train_config(config)
        self.policy = default_policy(cfg.precision, device)
        configure(self.policy)
        n = images or images_per_domain(traffic, self.size, device)
        shape = (n, self.size, self.size, 3)
        self.data = [torch.empty(shape, device=device) for _ in range(2)]
        self._fill_data(seed)
        self.ts = build_state(cfg, weights_of(self.size, seed, device), device)
        self.steps = auto_steps_per_call(cfg, self.size)
        self.program = chunk_mod.ChunkProgram(self.ts, cfg, self.policy, *self.data,
                                              self.batch, self.steps,
                                              kinds_in_range(cfg, 0, BIG))
        _build.reset_launches()
        chunk_mod.reset_replays()
        # Eager, the first iterations that take every kind once: each kind's
        # kernels, plans and handles made before any capture.
        kinds, first = set(), 0
        while kinds != self.program.kinds:
            kinds.add(cfg.step_kind(first))
            first += 1
        self.program(*self.feed.rows(0, first), 0)
        _sync(device)
        reset_state(self.ts, self.size, seed, device)

    def _fill_data(self, seed: int) -> None:
        fill_data(self.data, seed, self.device)
        self.feed = Feed(seed, len(self.data[0]), len(self.data[1]), self.batch)

    def reseed(self, seed: int) -> None:
        """The state and the dataset of another seed, in place."""
        self.seed = seed
        self._fill_data(seed)
        reset_state(self.ts, self.size, seed, self.device)

    def checked_steps(self) -> dict:
        """Iterations 0-1, then 2, through the program's call and feed
        (captured on the first call, replayed); the readings the reference
        is held to."""
        cfg, p = self.cfg, self.program
        losses = p(*self.feed.rows(0, 2), 0).tolist()
        grads = {"dis": first_grad_norms(self.ts.opt_dis, cfg.beta1),
                 "gen": first_grad_norms(self.ts.opt_gen, cfg.beta1)}
        losses += p(*self.feed.rows(2, 1), 2).tolist()
        key = {k: self.chunk_mod.LOSS_KEYS.index(f"{k}_total") for k in ("gen", "dis")}
        return {"losses": [losses[i][key["dis" if i == 0 else "gen"]] for i in range(3)],
                "grad_norms": grads,
                "change_norms": change_norms(self.ts, self.size, self.seed, self.device)}

    def chunk(self, it: int):
        """One chunk from iteration ``it`` as the trainer runs it, its logged
        iterations' losses read; (iterations, non-finite logged rows)."""
        k = self.chunk_steps(self.cfg, it, BIG, self.steps, ())
        out = self.program(*self.feed.rows(it, k), it)
        logged = [j for j in range(k) if (it + j) % self.cfg.log_interval == 0]
        bad = int((~torch.isfinite(out[logged])).any(dim=1).sum()) if logged else 0
        return k, bad

    def batches(self, n: int = 3) -> list:
        return gather_batches(self.data, self.feed, self.device, n)

    def missing_kernels(self) -> list:
        if self.device.type != "cuda":
            return []
        return [k for k in self.spec["cell"]["kernels"]
                if not any(c.get(k, 0) for c in self.program.launches.values())]

    def free(self) -> None:
        self.program = self.ts = self.data = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(spec: dict, seed: int, batches: list, device,
                       precision: str = "f32", half: bool = False) -> dict:
    """The reference's readings of the three checked iterations, in
    ``precision`` (reference/discogan.py's ``Ops``: "fp8" is the control);
    with ``half``, the fault of half of each batch left out."""
    config = spec["config"]
    cfg = train_config(config)
    if half:
        batches = [tuple(t[: len(t) // 2] for t in b) for b in batches]
    return ref.follow(weights_of(config["image_size"], seed, device), batches,
                      ["dis", "gen", "gen"], [cfg.rate_for(i) for i in range(3)],
                      config["train"], cfg.slim_state, ref.Ops(precision))


def run(spec: dict, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    b = Bench(spec, seed, device)
    prog = b.checked_steps()
    it, bad = 3, 0
    for _ in range(spec["traffic"].get("warm_chunks", 0)):
        k, nbad = b.chunk(it)
        it, bad = it + k, bad + nbad
    _sync(device)
    it0 = it
    t0 = time.perf_counter()
    setup_s = time.time() - started
    while True:
        k, nbad = b.chunk(it)
        it, bad = it + k, bad + nbad
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    timed = {"window_s": window_s, "iterations": it - it0, "kinds": _kinds(b.cfg, it0, it)}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    missing = b.missing_kernels()
    replays = b.chunk_mod.replays
    if missing or (device.type == "cuda" and not sum(replays.values())):
        raise SystemExit(f"portbench: the window's path skipped the kernels {missing} "
                         f"or replayed no graph ({replays})")

    summary = None
    if trace:
        from portbench import tracing

        summary = tracing.profile_chunks(b, it, spec["traffic"]["trace_chunks"])
        summary.update(timed=timed, peak_bytes=peak, image_size=b.size, batch=b.batch,
                       math=b.cfg.precision, itemsize=b.policy.compute_dtype.itemsize)
        print("portbench trace: ms an iteration by class "
              + json.dumps({c: 1e3 * t / max(summary["iterations"], 1)
                            for c, t in sorted(summary["classes"].items())}),
              file=sys.stderr)
    batches = b.batches()
    b.free()
    numbers = check.gaps(prog, reference_readings(spec, seed, batches, device))
    correct, checks = harness.judge(numbers, spec["cell"]["limits"])

    result = {"correct": correct, "attempted": timed["iterations"], "failed": bad}
    if trace:
        result["metrics"] = harness.read_metrics(spec["per_layer"], summary, spec["here"])
    else:
        e2e = {"train_img_per_s": timed["iterations"] * b.batch / window_s,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"]}
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    return result


def _kinds(cfg, it0: int, it1: int) -> dict:
    out: dict = {}
    for i in range(it0, it1):
        kind = cfg.step_kind(i)
        out[kind] = out.get(kind, 0) + 1
    return out


def device_info(device, peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}
