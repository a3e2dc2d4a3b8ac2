"""The port's multi-step driver on the CPU (f32, 16px and 32px), against
the JAX package's (train/step.py:350-498, train/loop.py:786-799) and the
port's own per-step path:

- the chunk planner: ``scan_variant``, ``auto_steps_per_call`` and
  ``scan_variants_for_range`` equal JAX's, and ``chunk_steps`` equals the
  JAX loop's chunk splitting (copied below as ``jax_chunk``), over a grid
  of update, log, sample and save intervals, start iterations, chunk
  sizes, lean_dis and remat; the chunks cover a run once and end at every
  sample and save iteration;
- ``ChunkProgram`` (the CPU runs its steps eagerly: the plain version of
  the card's CUDA graphs) equals the per-step path (``make_train_steps``,
  ``make_lean_dis_step``) bit for bit in every parameter, Adam moment and
  step count and running statistic, and in every loss, under slim states
  off, mv and all, with --lean_dis (a logged D iteration inside a chunk)
  and from a misaligned first iteration;
- ``ChunkProgram`` against JAX ``make_scan_train_step`` from the same
  weights (carried across with tests/test_torch_train_step.py's
  ``port_state``) on the same dataset and index rows: the losses within
  5e-4 and the parameters and running statistics within mean/p99/max
  2e-5/1e-4/1e-3, tests/test_torch_train_step.py's gates;
- ``DeviceDataset``: its batches equal ``HostLoader``'s bit for bit (arrays
  and a decoded edges2shoes tree), an undecodable file takes a seeded
  substitute, and the budget rule keeps 30% of the card's memory;
- the trainer CLI at --steps_per_call 4 writes the same training_log.txt
  lines, checkpoints and final train_state.pt as at --steps_per_call 1; a
  SIGTERM between chunks and a --resume end bit-equal to the uninterrupted
  run; --profile writes a trace.
"""

import json
import os
import re
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.train import step as jax_step
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.data.pipeline import (DEVICE_BUDGET_SHARE, DeviceDataset,
                                                     HostLoader, dataset_bytes,
                                                     fits_device_budget)
from discogan_modernized_torch.train import step as port_step
from discogan_modernized_torch.train.chunk import LOSS_KEYS, ChunkProgram
from discogan_modernized_torch.train.step import (TrainConfig, chunk_steps, init_train_state,
                                                  kinds_in_range, make_lean_dis_step,
                                                  make_train_steps)
from tests.test_torch_train_step import param_stats, port_state
from tests.torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 5e-4
PARAM_GATES = {"mean": 2e-5, "p99": 1e-4, "max": 1e-3}


# ---- the planner -----------------------------------------------------------

def jax_chunk(iters, total, steps_per_call, ui, intervals):
    """The JAX trainer's chunk splitting (train/loop.py:786-799), as it is
    written there."""
    k = min(steps_per_call, total - iters)
    for iv in intervals:
        nxt = ((iters + iv - 1) // iv) * iv  # next snapshot iter
        k = min(k, nxt - iters + 1)
    if iters % ui:
        k = min(k, ui - iters % ui)
    elif k >= ui and k % ui:
        k = (k // ui) * ui
    return k


GRID = [  # (update_interval, log_interval, image_save, model_save, lean_dis, remat)
    (3, 50, 1000, 10000, False, None), (3, 4, 10, 7, True, None),
    (2, 6, 5, 9, True, False), (4, 8, 12, 1000, False, True), (1, 3, 4, 4, True, None),
    (5, 10, 1000, 6, True, True)]


def _configs(ui, log, lean, remat):
    kw = dict(update_interval=ui, log_interval=log, lean_dis=lean, remat=remat)
    return JaxConfig(image_size=16, **kw), TrainConfig(image_size=16, **kw)


@pytest.mark.parametrize("ui,log,img,save,lean,remat", GRID)
def test_planner_equals_jax(ui, log, img, save, lean, remat):
    jcfg, cfg = _configs(ui, log, lean, remat)
    for size in (16, 64, 128, 129, 200, 256, 512):
        assert port_step.auto_steps_per_call(cfg, size) == jax_step.auto_steps_per_call(
            jcfg, size), size
    for it0 in range(0, 31):
        for k in (1, 2, 3, 4, 6, 7, 12, 24):
            assert port_step.scan_variant(cfg, it0, k) == jax_step.scan_variant(jcfg, it0, k)
            assert port_step.scan_variants_for_range(cfg, it0, 40, k) == \
                jax_step.scan_variants_for_range(jcfg, it0, 40, k)


@pytest.mark.parametrize("ui,log,img,save,lean,remat", GRID)
@pytest.mark.parametrize("steps_per_call", [1, 2, 6, 24])
def test_chunk_splitting_equals_jax(ui, log, img, save, lean, remat, steps_per_call):
    """From every start iteration, the chunks equal the JAX loop's; they
    cover the run once, and every sample and save iteration ends one."""
    _, cfg = _configs(ui, log, lean, remat)
    total = 45
    for start in range(0, 12):
        iters, ends = start, []
        while iters < total:
            k = chunk_steps(cfg, iters, total, steps_per_call, (img, save))
            assert k == jax_chunk(iters, total, steps_per_call, ui, (img, save))
            assert 1 <= k <= steps_per_call
            iters += k
            ends.append(iters - 1)
        assert iters == total
        assert all(i in ends for i in range(start, total) if i % img == 0 or i % save == 0)


def test_step_kinds():
    cfg = TrainConfig(lean_dis=True, log_interval=6)
    assert [cfg.step_kind(i) for i in range(8)] == [
        "dis", "gen", "gen", "lean", "gen", "gen", "dis", "gen"]
    assert kinds_in_range(cfg, 1, 2) == {"gen"}
    assert kinds_in_range(cfg, 1, 4) == {"gen", "lean"}
    assert kinds_in_range(cfg, 7, 1000) == {"dis", "gen", "lean"}
    assert kinds_in_range(TrainConfig(), 0, 10**9) == {"dis", "gen"}


# ---- the chunk program against the per-step path ---------------------------

def _dataset(seed, n, size):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(n, size, size, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(n, size, size, 3).astype(np.float32)),
            rng.randint(0, n, size=(40, 4)), rng.randint(0, n, size=(40, 4)))


def _state(ts) -> dict:
    out = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        out[f"{key}.step"] = torch.tensor(opt.step)
        out.update({f"{key}.m{i}": t for i, t in enumerate(opt.m)})
        out.update({f"{key}.v{i}": t for i, t in enumerate(opt.v)})
    return out


@pytest.mark.parametrize("size,slim,lean,start,chunks", [
    (16, "off", False, 0, (1, 2, 6, 3)),
    (16, "mv", True, 1, (2, 6, 3, 1)),    # misaligned; logged D iterations 6 and 12 inside
    (16, "all", False, 2, (1, 3, 3, 4)),  # misaligned, a chunk that is not whole periods
    (32, "all", True, 0, (3, 6, 6))])
def test_chunk_program_equals_the_per_step_path(size, slim, lean, start, chunks):
    cfg = TrainConfig(image_size=size, precision="f32", slim_state=slim, lean_dis=lean,
                      log_interval=6, gan_curriculum=5)
    data_A, data_B, ia, ib = _dataset(1, 24, size)
    n = sum(chunks)
    per_step, chunked = init_train_state(2, cfg), init_train_state(2, cfg)
    gen_step, dis_step = make_train_steps(cfg, F32)
    steps = {"gen": gen_step, "dis": dis_step, "lean": make_lean_dis_step(cfg, F32)}
    want = []
    for i in range(start, start + n):
        losses = steps[cfg.step_kind(i)](per_step, data_A[ia[i]], data_B[ib[i]],
                                         cfg.rate_for(i))
        want.append([float(losses[k]) for k in LOSS_KEYS])
    program = ChunkProgram(chunked, cfg, F32, data_A, data_B, 4, max(chunks),
                           kinds_in_range(cfg, start, n))
    got, i = [], start
    for k in chunks:
        got += program(ia[i:i + k], ib[i:i + k], i).tolist()
        i += k
    assert got == want
    a, b = _state(per_step), _state(chunked)
    assert a.keys() == b.keys()
    assert not [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def test_chunk_program_refuses_what_it_cannot_run():
    cfg = TrainConfig(image_size=16, precision="f32")
    data_A, data_B, ia, ib = _dataset(1, 8, 16)
    program = ChunkProgram(init_train_state(0, cfg), cfg, F32, data_A, data_B, 4, 3, {"gen"})
    with pytest.raises(ValueError, match="kinds"):
        program(ia[:3], ib[:3], 0)  # iteration 0 is a D step
    with pytest.raises(ValueError, match="at most 3"):
        program(ia[:4], ib[:4], 1)
    with pytest.raises(ValueError, match="on the card"):
        ChunkProgram(init_train_state(0, cfg), cfg, F32, data_A, data_B, 4, 3, {"gen"},
                     graphs=True)


# ---- the chunk program against JAX's scan program --------------------------

@pytest.mark.parametrize("start,k", [(0, 6), (1, 2), (3, 3)])
def test_chunk_program_against_jax_scan(start, k):
    """One chunk from the same weights, dataset and index rows as one call
    of JAX make_scan_train_step with the variant JAX's trainer takes for it
    ("phase" for whole periods, "switch" from the misaligned start 1),
    16px (``port_state``'s), f32; the curriculum boundary inside. Longer
    chunks from start 1 run into the f32 chaos of ROADMAP F1: over 5
    iterations JAX's own steps op by op stray from its scan program by up
    to 1.4e-3 in the losses (and the port by 2.4e-3), past the 5e-4 gate,
    so the misaligned case stops at 2."""
    kw = dict(image_size=16, precision="f32", gan_curriculum=start + 2)
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    jts = jax_init(jax.random.PRNGKey(3), jcfg)
    ts = port_state(jts, cfg)
    rng = np.random.RandomState(5)
    data_A = rng.rand(12, 16, 16, 3).astype(np.float32)
    data_B = rng.rand(12, 16, 16, 3).astype(np.float32)
    ia, ib = rng.randint(0, 12, size=(k, 4)), rng.randint(0, 12, size=(k, 4))
    variant = jax_step.scan_variant(jcfg, start, k)
    assert variant == ("switch" if start % 3 else "phase")
    jts, jlosses = jax_step.make_scan_train_step(jcfg, steps=k, variant=variant)(
        jts, jnp.asarray(data_A), jnp.asarray(data_B), jnp.asarray(ia, jnp.int32),
        jnp.asarray(ib, jnp.int32), jnp.int32(start))
    # The port's Adam counts steps from 1 as JAX's does: both states start fresh.
    program = ChunkProgram(ts, cfg, F32, torch.from_numpy(data_A), torch.from_numpy(data_B),
                           4, k, kinds_in_range(cfg, start, k))
    got = program(ia, ib, start).numpy()
    for j in range(k):
        err = max(abs(float(got[j, c]) - float(jlosses[key][j]))
                  for c, key in enumerate(LOSS_KEYS))
        assert err < LOSS_TOL, (j, err)
    stats = param_stats(ts, jts)
    print({key: f"{v:.3e}" for key, v in stats.items()})
    for key, v in stats.items():
        assert v < PARAM_GATES[key], (key, v)


# ---- the dataset on the device ------------------------------------------------

def test_device_dataset_batches_equal_the_loaders():
    rng = np.random.RandomState(4)
    a = rng.rand(20, 8, 8, 3).astype(np.float32)
    b = rng.rand(23, 8, 8, 3).astype(np.float32)
    loader = HostLoader(a, b, 4, 8, "cpu", seed=9)
    dataset = DeviceDataset(loader)
    assert dataset.nbytes == dataset_bytes(20, 23, 8)
    for epoch in (0, 3):
        for skip in (0, 2):
            ref = list(loader.epoch(epoch, skip=skip))
            got = list(dataset.epoch(epoch, skip=skip))
            assert len(got) == len(ref) == 5 - skip
            for (x, y), (u, v) in zip(ref, got):
                assert torch.equal(x, u) and torch.equal(y, v)
        ia, ib = dataset.epoch_rows(epoch)
        assert ia.shape == ib.shape == (5, 4)
    loader.close()


@pytest.fixture()
def edges2shoes(tmp_path, monkeypatch):
    """An edges2shoes tree of side-by-side JPEGs, one of them not an image."""
    from PIL import Image

    rng = np.random.RandomState(0)
    d = tmp_path / "datasets" / "edges2shoes" / "train"
    d.mkdir(parents=True)
    for i in range(8):
        Image.fromarray((rng.rand(256, 512, 3) * 255).astype(np.uint8)).save(d / f"{i}_AB.jpg")
    monkeypatch.setenv("DISCOGAN_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    return sorted(d.glob("*.jpg"))


def test_device_dataset_decodes_as_the_loader(edges2shoes):
    files = np.array([str(f) for f in edges2shoes])
    loader = HostLoader(files, files, 4, 16, "cpu", domain_A="A", domain_B="B", seed=1)
    dataset = DeviceDataset(loader)
    for (x, y), (u, v) in zip(loader.epoch(1), dataset.epoch(1)):
        assert torch.equal(x, u) and torch.equal(y, v)
    loader.close()


def test_an_undecodable_file_takes_a_seeded_substitute(edges2shoes):
    edges2shoes[3].write_bytes(b"not an image")
    files = np.array([str(f) for f in edges2shoes])
    first, second = (DeviceDataset(HostLoader(files, files, 4, 16, "cpu", domain_A="A",
                                              domain_B="B", seed=1)) for _ in range(2))
    assert first.data[0].shape == (8, 16, 16, 3)  # the count stays
    assert torch.equal(first.data[0], second.data[0])
    assert not torch.equal(first.data[0][3], first.data[1][3])  # per domain
    decoded = HostLoader(files, files, 4, 16, "cpu", domain_A="A", domain_B="B")
    assert torch.equal(first.data[0][2], torch.from_numpy(
        decoded._decode_paths([str(edges2shoes[2])], "A", None)[0]))


def test_device_budget(monkeypatch):
    """Both domains in f32 within DEVICE_BUDGET_SHARE of the card's total
    memory (not its free memory)."""
    total = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1, total))
    per = 512 * 512 * 3 * 4
    n = int(DEVICE_BUDGET_SHARE * total // per)
    assert fits_device_budget(n // 2, n - n // 2, 512, "cuda")
    assert not fits_device_budget(n // 2, n - n // 2 + 1, 512, "cuda")
    assert dataset_bytes(256, 256, 512) == 512 * per


# ---- the trainer ------------------------------------------------------------

def run(tmp_path, tag, *extra, observer=None, slim="mv"):
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.train.loop import run_training

    args = parse_with_config(translation_parser(), [
        "--device=cpu", "--task_name=synthetic", "--model_arch=discogan",
        "--image_size=16", "--batch_size=16", "--epochs=2", "--precision=f32",
        f"--slim_state={slim}", "--log_interval=3", "--image_save_interval=7",
        "--model_save_interval=10", f"--results_dir={tmp_path}/{tag}/r",
        f"--models_dir={tmp_path}/{tag}/m", *extra])
    return run_training(args, observer=observer)


def _log(result_path):
    return [line for line in (result_path / "training_log.txt").read_text().splitlines()
            if line.startswith("Iter")]


def _saved(model_path):
    return {p.name: torch.load(p, weights_only=True) for p in sorted(model_path.glob("*.p*"))}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


class ChunkLog:
    """The chunks a run took; SIGTERM after the chunk that starts at ``stop``."""

    def __init__(self, stop=None):
        self.stop, self.chunks = stop, []

    def begin_chunk(self, iters0, kinds):
        pass

    def end_chunk(self, iters0, kinds, losses, program):
        self.chunks.append((iters0, len(kinds)))
        if iters0 == self.stop:
            os.kill(os.getpid(), signal.SIGTERM)


@pytest.fixture(scope="module")
def per_step_runs(tmp_path_factory):
    """The per-step runs (32 iterations), by slim state."""
    runs = {}

    def get(slim):
        if slim not in runs:
            runs[slim] = run(tmp_path_factory.mktemp(f"per_step_{slim}"), "a",
                             "--steps_per_call=1", slim=slim)
        return runs[slim]
    return get


@pytest.mark.parametrize("slim", ["mv", "all"])
def test_chunked_trainer_equals_the_per_step_trainer(slim, tmp_path, per_step_runs):
    """Its log lines, sample iterations, checkpoints (the reference layout
    at 0, 10, 20, 30 and final; train_state.pt) and meta, bit for bit."""
    result_a, model_a = per_step_runs(slim)
    chunks = ChunkLog()
    result_b, model_b = run(tmp_path, "b", "--steps_per_call=4", observer=chunks, slim=slim)
    assert _log(result_a) == _log(result_b) and len(_log(result_b)) == 11
    assert sorted(p.name for p in (result_a / "samples").iterdir()) == \
        sorted(p.name for p in (result_b / "samples").iterdir())
    a, b = _saved(model_a), _saved(model_b)
    assert a.keys() == b.keys() and "gen_A_30.pth" in a
    assert not [k for k in a if not _equal(a[k], b[k])]
    assert json.loads((model_a / "train_state_meta.json").read_text()) == \
        json.loads((model_b / "train_state_meta.json").read_text())
    assert max(k for _, k in chunks.chunks) == 3  # whole periods of 3 in chunks of 4
    ends = [i + k - 1 for i, k in chunks.chunks]
    assert all(i in ends for i in (0, 7, 10, 14, 20, 21, 28, 30))


def test_sigterm_between_chunks_then_resume_is_bit_exact(tmp_path, per_step_runs):
    """SIGTERM after the chunk at 9 (iterations 9-10, clipped at the save
    at 10): the trainer saves at 11 and returns; --resume runs chunks from
    11 on and ends on the uninterrupted run's state, which the per-step
    run's is too."""
    stop = ChunkLog(stop=9)
    _, stopped = run(tmp_path, "stopped", "--steps_per_call=6", observer=stop)
    meta = json.loads((stopped / "train_state_meta.json").read_text())
    assert meta["preempted"] and meta["iters"] == 11
    assert stop.chunks[-1] == (9, 2)
    resumed = ChunkLog()
    _, model = run(tmp_path, "resumed", "--steps_per_call=6", f"--resume={stopped}",
                   observer=resumed)
    assert resumed.chunks[0] == (11, 1)
    _, reference = per_step_runs("mv")
    a = torch.load(reference / "train_state.pt", weights_only=True)
    b = torch.load(model / "train_state.pt", weights_only=True)
    assert _equal(a, b)


def test_resume_from_a_misaligned_iteration(tmp_path, per_step_runs):
    """A per-step run stopped by SIGTERM at the end of iteration 4 (saved
    at 5, inside a period) and resumed in chunks: one short chunk restores
    the alignment, and the run ends on the uninterrupted state."""
    class StopAt:
        def begin(self, iters, kind):
            pass

        def end(self, iters, kind, losses):
            if iters == 4:
                os.kill(os.getpid(), signal.SIGTERM)

    _, stopped = run(tmp_path, "stopped", "--steps_per_call=1", observer=StopAt())
    chunks = ChunkLog()
    _, model = run(tmp_path, "resumed", "--steps_per_call=6", f"--resume={stopped}",
                   observer=chunks)
    assert chunks.chunks[:2] == [(5, 1), (6, 2)]  # to the period's start; to the samples at 7
    _, reference = per_step_runs("mv")
    assert _equal(torch.load(reference / "train_state.pt", weights_only=True),
                  torch.load(model / "train_state.pt", weights_only=True))


def test_profile_traces_the_chunked_path(tmp_path, capsys):
    run(tmp_path, "p", "--steps_per_call=3", f"--profile={tmp_path / 'trace'}")
    traces = list((tmp_path / "trace").iterdir())
    first, last = map(int, re.fullmatch(r"trace_iters_(\d+)-(\d+)\.json",
                                        traces[0].name).groups())
    assert len(traces) == 1 and (first, last) == (3, 10)  # the chunks from 3 to the one at 9
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "steps_per_call 3 (set)" in capsys.readouterr().out


@pytest.mark.parametrize("extra,error", [
    (("--steps_per_call=0",), "at least 1"),
    (("--steps_per_call=4", "--no_device_cache"), "dataset"),
])
def test_steps_per_call_refusals(extra, error, tmp_path, capsys):
    with pytest.raises(SystemExit, match=error):
        run(tmp_path, "x", *extra)
