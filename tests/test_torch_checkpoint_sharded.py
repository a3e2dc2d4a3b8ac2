"""The port's sharded train-state saves (``--ckpt_backend orbax``,
train/checkpoint.py), mirroring the JAX package's orbax backend and its
tests (tests/test_preemption.py, test_review_fixes.py, test_cli.py,
test_multihost.py).

On gloo ranks on the CPU (tests/torch_dp_ranks.py): a save from the tp 2
mesh, every rank writing its own slices, loads bit for bit at tp 2, at tp 1
and in one process, and one from the tp 1 mesh at tp 2, under slim state
off, mv and all; it gathers the split parameters once for the reference
layout and no moment, where an npz save gathers parameters and both
moments; a write that fails on one rank leaves the previous save as it
was. The distributed trainer at tp 2, stopped by SIGTERM and resumed
under orbax, one step a call and in chunks, ends on the uninterrupted
run's state bit for bit, and so does the one-process trainer. JAX's
crash-safety cases (a stale ``.new``, a lone ``.new`` promoted by the
save and by the load, the promotion race's loser) hold. The same state,
carried from a JAX state, goes through JAX's orbax save and load and
through the port's, and both give back exactly what was saved.
"""

import json
import os
import re
import signal

import numpy as np
import pytest
import torch

from discogan_modernized_torch.train import checkpoint
from discogan_modernized_torch.train.checkpoint import (ORBAX_DIR, ORBAX_NEW,
                                                        load_train_state, save_train_state,
                                                        train_state_meta)
from discogan_modernized_torch.train.step import TrainConfig, init_train_state
from tests import torch_dp_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = 32  # the smallest size with a split layer at tp 2 (enc2, dec0, conv3)
KINDS = ["dis", "gen"]


def batches(seed, n, size=SMALL, batch=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, size, size, 3).astype(np.float32),
             rng.rand(batch, size, size, 3).astype(np.float32)) for _ in range(n)]


def tensors(ts) -> dict:
    """Every tensor of a port TrainState by name, and the Adam steps."""
    out = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key in ("opt_gen", "opt_dis"):
        opt = getattr(ts, key)
        out[f"{key}.step"] = opt.step
        out.update((f"{key}.{part}{i}", t) for part in ("m", "v")
                   for i, t in enumerate(getattr(opt, part)))
    return out


def assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def moved(ts, seed: int = 3):
    """``ts`` with every moment and running statistic set to seeded values
    in its dtype, and the steps to 5 and 3: a state whose every tensor a
    save must carry."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in ts.models.values():
            for t in m.state_dict().values():
                if t.is_floating_point():
                    t.copy_(torch.rand(t.shape, generator=g).to(t.dtype))
        for opt, step in ((ts.opt_gen, 5), (ts.opt_dis, 3)):
            for t in opt.m + opt.v:
                t.copy_(torch.rand(t.shape, generator=g).to(t.dtype))
            opt.step = step
    return ts


# ---- saves moved between meshes, on gloo ranks ------------------------------

@pytest.fixture(scope="module")
def orbax_meshes(tmp_path_factory):
    """slim state -> ``torch_dp_ranks.mesh_orbax``'s results, each rank's."""
    cache = {}

    def get(slim):
        if slim not in cache:
            d = tmp_path_factory.mktemp(f"orbax_{slim}")
            cfg = dict(image_size=SMALL, precision="f32", slim_state=slim, gan_curriculum=1)
            p = {"seed": 8, "cfg": cfg, "batches": batches(3, 2), "kinds": KINDS, "n": 2,
                 "dir": str(d / "saves")}
            cache[slim] = torch_dp_ranks.run("mesh_orbax", p, d)
        return cache[slim]
    return get


@pytest.mark.parametrize("slim", ["off", "mv", "all"])
@pytest.mark.parametrize("tp_from, tp_to", [(2, 2), (2, 1), (1, 2)])
def test_orbax_saves_move_between_tp_meshes(tp_from, tp_to, slim, orbax_meshes):
    """An orbax save from a tp_from mesh, each rank writing its slices,
    loads into a fresh state placed on a tp_to mesh bit for bit (the
    gathered states' digests), and as one process; the tp 2 save holds one
    part a model rank, the tp 1 save one part, beside its index."""
    ranks = orbax_meshes(slim)
    r0 = ranks[0]
    saved = r0["saved"][tp_from]
    loaded = r0["loaded"][tp_from, tp_to]
    assert saved.keys() == loaded.keys()
    assert not [k for k in saved if saved[k] != loaded[k]]
    one = r0["one"][tp_from]
    assert not [k for k in saved if saved[k] != one[k]]
    parts = ["part_m0.pt", "part_m1.pt"] if tp_from == 2 else ["part_m0.pt"]
    assert r0["files"][tp_from] == ["index.json", *parts]


@pytest.mark.parametrize("tp", [2, 1])
def test_orbax_save_gathers_no_moment(tp, orbax_meshes):
    """At tp 2 an orbax save gathers each split parameter once (for the
    reference layout, which rank 0 writes) and no Adam moment; an npz save
    of the same state gathers the parameters and both moments. At tp 1
    nothing is split and neither gathers."""
    for rank in orbax_meshes("mv"):
        split = rank["split"][tp]
        assert (split > 0) == (tp == 2)
        assert rank["gathers"]["orbax", tp] == split
        assert rank["gathers"]["npz", tp] == 3 * split


def test_a_failed_rank_write_leaves_the_previous_save(tmp_path):
    """A second save whose write fails on rank 1 alone raises on both ranks
    (rank 1 its own error, rank 0 that another rank failed), and the first
    save still loads, bit for bit, with its iteration count; the next save
    removes the incomplete ``.new`` and succeeds."""
    cfg = dict(image_size=SMALL, precision="f32", slim_state="mv", gan_curriculum=1)
    p = {"seed": 4, "cfg": cfg, "batches": batches(5, 2), "kinds": KINDS,
         "dir": str(tmp_path / "save")}
    ranks = torch_dp_ranks.run("orbax_failed_write", p, tmp_path)
    assert "planted" in ranks[1]["error"] and ranks[1]["error"].startswith("OSError")
    assert ranks[0]["error"].startswith("RuntimeError") and "another rank" in ranks[0]["error"]
    first = ranks[0]["first"]
    for r in ranks:
        assert r["iters"] == 2 and r["stale_new"]
        assert not [k for k in first if first[k] != r["loaded"][k]]
        assert r["after"] == 3 and not r["stale_new_after"]


# ---- SIGTERM and --resume under orbax --------------------------------------

def final_state(model_path, cfg) -> dict:
    ts = init_train_state(99, cfg)
    load_train_state(model_path, ts, cfg)
    return tensors(ts)


MESH_ARGV = ["--distributed", "--device=cpu", "--task_name=synthetic",
             "--model_arch=discogan", f"--image_size={SMALL}", "--batch_size=32",
             "--epochs=1", "--precision=f32", "--log_interval=1",
             "--image_save_interval=1000", "--model_save_interval=1000",
             "--parallel_mode=gspmd", "--tp=2", "--ckpt_backend=orbax"]


@pytest.fixture(scope="module")
def mesh_resumes(tmp_path_factory):
    """The distributed trainer at tp 2 on two gloo ranks under orbax (8
    iterations): uninterrupted; stopped by SIGTERM at the end of iteration 4
    (one step a call) or of the chunk at 3 (chunks of 2: 3-4), and resumed."""
    d = tmp_path_factory.mktemp("mesh_resume")
    p = {"argv": MESH_ARGV, "dir": str(d / "runs"),
         "stopped": [("per_step", ["--steps_per_call=1"], 4),
                     ("chunked", ["--steps_per_call=2"], 3)]}
    return torch_dp_ranks.run("mesh_cli_resume", p, d)[0]


@pytest.mark.parametrize("path", ["per_step", "chunked"])
def test_mesh_sigterm_then_resume_is_bit_exact(path, mesh_resumes):
    """The stopped run saved (every rank its slices) at the iteration after
    the stop, marked preempted; the resume trains the rest and ends on the
    uninterrupted run's state bit for bit."""
    from pathlib import Path

    cfg = TrainConfig(image_size=SMALL, precision="f32", slim_state="mv")
    stopped = Path(mesh_resumes[f"{path}_stopped"])
    meta = json.loads((stopped / "train_state_meta.json").read_text())
    assert meta["preempted"] and meta["iters"] == 5 and meta["backend"] == "orbax"
    assert sorted(p.name for p in (stopped / ORBAX_DIR).iterdir()) == [
        "index.json", "part_m0.pt", "part_m1.pt"]
    result, resumed = map(Path, mesh_resumes[path])
    logged = [int(i) for i in re.findall(r"Iter \[(\d+)/8\]",
                                         (result / "training_log.txt").read_text())]
    assert logged == list(range(5, 8))
    assert_same(final_state(resumed, cfg),
                final_state(Path(mesh_resumes["full"][1]), cfg))


def run(tmp_path, tag, *extra, observer=None):
    from discogan_modernized_torch.cli.common import parse_with_config, translation_parser
    from discogan_modernized_torch.train.loop import run_training

    args = parse_with_config(translation_parser(), [
        "--device=cpu", "--task_name=synthetic", "--model_arch=gan",
        "--image_size=16", "--batch_size=32", "--epochs=2", "--precision=f32",
        "--slim_state=all", "--log_interval=1", "--image_save_interval=1000",
        "--model_save_interval=1000", "--ckpt_backend=orbax",
        f"--results_dir={tmp_path}/{tag}/r", f"--models_dir={tmp_path}/{tag}/m", *extra])
    return run_training(args, observer=observer)


@pytest.mark.parametrize("path", ["per_step", "chunked"])
def test_sigterm_then_resume_is_bit_exact(path, tmp_path):
    """The one-process trainer under orbax (JAX's tests/test_preemption.py
    orbax case): stopped by SIGTERM after iteration 10 (per step) or the
    chunk at 9, it saves the directory and a preempted meta and gives the
    caller's handler back; the resume ends on the uninterrupted run's
    state, bit for bit."""
    cfg = TrainConfig(image_size=16, precision="f32", slim_state="all", model_arch="gan")
    flag = "--steps_per_call=1" if path == "per_step" else "--steps_per_call=4"
    _, full = run(tmp_path, "full", flag)
    before = signal.getsignal(signal.SIGTERM)
    _, stopped = run(tmp_path, "stopped", flag,
                     observer=torch_dp_ranks.StopAt(10 if path == "per_step" else 9))
    assert signal.getsignal(signal.SIGTERM) is before
    meta = json.loads((stopped / "train_state_meta.json").read_text())
    assert meta["preempted"] and meta["backend"] == "orbax"
    assert meta["iters"] == (11 if path == "per_step" else 12)
    assert (stopped / ORBAX_DIR / "index.json").is_file()
    assert not (stopped / "train_state.pt").exists()
    _, resumed = run(tmp_path, "resumed", flag, f"--resume={stopped}")
    assert_same(final_state(resumed, cfg), final_state(full, cfg))


# ---- crash safety (JAX's cases) ---------------------------------------------

CFG16 = TrainConfig(image_size=16, precision="f32", slim_state="mv")


def saved_state(tmp_path, iters=7, seed=3):
    ts = moved(init_train_state(0, CFG16), seed)
    save_train_state(tmp_path, ts, iters, train_state_meta(CFG16), backend="orbax")
    return tensors(ts)


def loads(tmp_path):
    ts = init_train_state(99, CFG16)
    iters = load_train_state(tmp_path, ts, CFG16)
    return tensors(ts), iters


def test_a_stale_new_beside_the_final_directory_is_removed(tmp_path):
    saved_state(tmp_path, 7, seed=1)
    (tmp_path / ORBAX_NEW).mkdir()
    (tmp_path / ORBAX_NEW / "part_m0.pt").write_bytes(b"half a write")
    want = saved_state(tmp_path, 8, seed=2)
    assert not (tmp_path / ORBAX_NEW).exists()
    got, iters = loads(tmp_path)
    assert iters == 8
    assert_same(got, want)


def test_a_lone_new_is_promoted_by_the_save(tmp_path, monkeypatch):
    """A crash inside the swap left only the complete ``.new``: the next
    save promotes it before reusing the name, so a save that then fails
    still leaves it as the checkpoint."""
    want = saved_state(tmp_path, 7)
    os.rename(tmp_path / ORBAX_DIR, tmp_path / ORBAX_NEW)

    def failing(obj, f, *args, **kwargs):
        raise OSError(28, "No space left on device (planted)", str(f))

    monkeypatch.setattr(checkpoint.torch, "save", failing)
    with pytest.raises(OSError, match="planted"):
        save_train_state(tmp_path, moved(init_train_state(0, CFG16), 4), 9,
                         train_state_meta(CFG16), backend="orbax")
    monkeypatch.undo()
    assert (tmp_path / ORBAX_DIR / "index.json").is_file()
    got, iters = loads(tmp_path)
    assert iters == 7
    assert_same(got, want)


def test_an_incomplete_new_is_never_promoted(tmp_path):
    """A ``.new`` without its index (a save that died in its writes) is not
    a checkpoint: the load refuses it, and the next save removes it."""
    (tmp_path / ORBAX_NEW).mkdir()
    (tmp_path / ORBAX_NEW / "part_m0.pt").write_bytes(b"half a write")
    (tmp_path / "train_state_meta.json").write_text(json.dumps(
        {"iters": 3, "backend": "orbax", **train_state_meta(CFG16)}))
    with pytest.raises(FileNotFoundError, match=ORBAX_DIR):
        loads(tmp_path)
    want = saved_state(tmp_path, 4)
    assert not (tmp_path / ORBAX_NEW).exists()
    assert_same(loads(tmp_path)[0], want)


def test_a_lone_new_is_promoted_by_the_load(tmp_path):
    want = saved_state(tmp_path, 7)
    os.rename(tmp_path / ORBAX_DIR, tmp_path / ORBAX_NEW)
    got, iters = loads(tmp_path)
    assert iters == 7
    assert_same(got, want)
    assert (tmp_path / ORBAX_DIR).is_dir() and not (tmp_path / ORBAX_NEW).exists()


def test_orbax_new_promotion_race_loser_uses_winners_dir(tmp_path, monkeypatch):
    """Two processes resume from a lone ``.new``: the loser's rename fails
    after the winner's landed, and it reads the winner's final directory
    (JAX tests/test_review_fixes.py:79-106)."""
    want = saved_state(tmp_path, 7)
    final, new = tmp_path / ORBAX_DIR, tmp_path / ORBAX_NEW
    os.rename(final, new)
    real_rename = os.rename

    def losing_rename(src, dst):
        if str(src) == str(new):
            real_rename(src, dst)  # the winner's rename lands first
            raise OSError(2, "No such file or directory", str(src))
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", losing_rename)
    got, iters = loads(tmp_path)
    assert iters == 7
    assert_same(got, want)


def test_every_read_is_weights_only(tmp_path, monkeypatch):
    """An orbax load reads its parts with ``torch.load(weights_only=True)``
    and nothing else but the JSON index and meta."""
    saved_state(tmp_path, 7)
    calls = []
    real_load = torch.load

    def load(*args, **kwargs):
        calls.append(kwargs.get("weights_only"))
        return real_load(*args, **kwargs)

    monkeypatch.setattr(checkpoint.torch, "load", load)
    loads(tmp_path)
    assert calls == [True]


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_a_save_under_either_backend_resumes(backend, tmp_path):
    """The meta names its backend, and the load reads it from there: an
    npz meta without the key (every save before the second backend) loads
    as npz; the npz file is the same torch.save dict as before."""
    ts = moved(init_train_state(0, CFG16))
    save_train_state(tmp_path, ts, 6, train_state_meta(CFG16), backend=backend)
    meta = json.loads((tmp_path / "train_state_meta.json").read_text())
    assert meta["backend"] == backend and meta["iters"] == 6
    assert (tmp_path / "train_state.pt").exists() == (backend == "npz")
    assert (tmp_path / ORBAX_DIR).exists() == (backend == "orbax")
    if backend == "npz":
        del meta["backend"]
        (tmp_path / "train_state_meta.json").write_text(json.dumps(meta))
        raw = torch.load(tmp_path / "train_state.pt", weights_only=True)
        assert sorted(raw) == ["models", "opt_dis", "opt_gen"]
    got, iters = loads(tmp_path)
    assert iters == 6
    assert_same(got, tensors(ts))


def test_the_monitor_resumes_from_an_orbax_save(tmp_path):
    """tools/monitor.py's restart finds an orbax save's directory as it
    finds an npz one's: by its meta."""
    from discogan_modernized_torch.tools.monitor import Monitor

    d = tmp_path / "models" / "synthetic" / "gan" / "20260101_000000"
    saved_state(d, 5)
    argv = ["python", "-m", "x", "--task_name=synthetic", "--model_arch=gan"]
    assert Monitor._resume_dir_for(None, argv, str(tmp_path)) == d


# ---- held against JAX's orbax backend on the CPU ---------------------------

@pytest.mark.parametrize("slim", ["off", "mv", "all"])
def test_round_trip_against_jax_orbax(slim, tmp_path):
    """One state, made in JAX (moments and running statistics seeded,
    steps 5 and 3) and carried into the port by
    ``models.torch_compat.train_state_from_jax``: JAX's
    ``save_train_state(backend="orbax")`` and ``load_train_state`` give
    back exactly its leaves and dtypes, the port's give back exactly the
    carried state and dtypes (bf16 masters under "all"), and the state
    JAX reads back carries over to the one the port reads back; both metas
    hold the iterations and the backend."""
    pytest.importorskip("orbax.checkpoint")
    import jax

    from discogan_modernized_tpu.train import TrainConfig as JaxConfig
    from discogan_modernized_tpu.train import init_train_state as jax_init
    from discogan_modernized_tpu.train.checkpoint import load_train_state as jax_load
    from discogan_modernized_tpu.train.checkpoint import save_train_state as jax_save
    from discogan_modernized_torch.models.torch_compat import train_state_from_jax

    jcfg = JaxConfig(image_size=16, precision="f32", slim_state=slim)
    cfg = TrainConfig(image_size=16, precision="f32", slim_state=slim)
    jts = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(2)

    def seeded(a):
        if not np.issubdtype(a.dtype, np.floating) and str(a.dtype) != "bfloat16":
            return a
        return np.asarray(rng.rand(*a.shape), np.float32).astype(a.dtype)

    jts = dict(jts, model_states=jax.tree.map(seeded, jts["model_states"]),
               **{key: dict(jts[key], m=jax.tree.map(seeded, jts[key]["m"]),
                            v=jax.tree.map(seeded, jts[key]["v"]),
                            step=np.asarray(step, jts[key]["step"].dtype))
                  for key, step in (("opt_gen", 5), ("opt_dis", 3))})
    jax_save(tmp_path / "jax", jts, 7, {"task": "synthetic"}, backend="orbax")
    template = jax.tree.map(np.zeros_like, jts)
    back, iters = jax_load(tmp_path / "jax", template)
    assert iters == 7
    want_leaves, treedef = jax.tree.flatten(jts)
    got_leaves, got_def = jax.tree.flatten(jax.tree.map(np.asarray, back))
    assert got_def == treedef
    for a, b in zip(got_leaves, want_leaves, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    ts = train_state_from_jax(jts, cfg)
    save_train_state(tmp_path / "port", ts, 7, train_state_meta(cfg, task="synthetic"),
                     backend="orbax")
    fresh = init_train_state(99, cfg)
    assert load_train_state(tmp_path / "port", fresh, cfg) == 7
    got = tensors(fresh)
    assert_same(got, tensors(ts))
    if slim == "all":
        assert got["gen_A.encoder.0.weight"].dtype == torch.bfloat16
        assert got["opt_gen.m0"].dtype == torch.bfloat16
    assert_same(got, tensors(train_state_from_jax(jax.tree.map(np.asarray, back), cfg)))
    for side in ("jax", "port"):
        meta = json.loads((tmp_path / side / "train_state_meta.json").read_text())
        assert meta["iters"] == 7 and meta["backend"] == "orbax", side


def test_no_source_reads_through_torch_distributed_checkpoint():
    """The port's sharded saves are not ``torch.distributed.checkpoint``,
    whose metadata file is read with ``pickle.load``: no source of the port
    (nor chip_smoke.py) imports it."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+torch\.distributed\.checkpoint\b|"
                         r"^\s*from\s+torch\.distributed\s+import\s+[^\n]*\bcheckpoint\b|"
                         r"import_module\([\"']torch\.distributed\.checkpoint", re.M)
    files = [*(root / "discogan_modernized_torch").rglob("*.py"), root / "chip_smoke.py"]
    assert not [str(f.relative_to(root)) for f in files if pattern.search(f.read_text())]
