"""The port's tensor parallelism on a (data, model) mesh of gloo ranks on
the CPU (core/mesh.py, ops/sharding.py, parallel/gspmd.py), f32, against
the JAX package's ``make_gspmd_train_steps`` on the same mesh of the
conftest's virtual CPU devices and against the port itself; mirrors
tests/test_gspmd.py.

Rank r sits at (r // tp, r % tp); each data row trains on its rows of a
global batch, and its model ranks hold the channel slices of every wide
weight. Against JAX at its test's size (64px, global batch 8, enc2/enc3
split), four iterations of the D/G alternation hold tests/test_gspmd.py's
gates (losses 5e-3, parameters mean 2e-5 and max 2e-3), and so does the
port's one process on the whole batch. A world of one at tp 1 is the
one-process step bit for bit (also under slim state "all"). Placing a
state and gathering it back is exact; TP chunks are the per-step TP path
bit for bit, remat on is remat off bit for bit, and saves move between a
tp 2 and a tp 1 mesh exactly. The collectives of each step are counted.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.core.mesh import make_mesh as jax_make_mesh
from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.parallel import (make_gspmd_train_steps, place_train_state,
                                              train_state_shardings)
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.generator import enc_conv_index
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.parallel.gspmd import (banded_layers, shard_spec,
                                                      train_state_shardings as port_shardings)
from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                  make_train_steps)
from tests import torch_dp_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

TP_SIZE = 64         # tests/test_gspmd.py's: enc2 (256) and enc3 (512) split
GLOBAL_BATCH = 8
SMALL = 32           # the smallest size with a split layer (enc2, dec0, conv3)
TP_CFG = dict(gan_curriculum=2, starting_rate=0.01, default_rate=0.5)
KINDS4 = ["dis", "gen", "gen", "dis"]  # the D/G alternation of iterations 0-3
GATES = {"loss": 5e-3, "mean": 2e-5, "max": 2e-3}  # tests/test_gspmd.py:84-94


def batches(seed, n, size=TP_SIZE, batch=GLOBAL_BATCH):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, size, size, 3).astype(np.float32),
             rng.rand(batch, size, size, 3).astype(np.float32)) for _ in range(n)]


def numpy_tree(ts):
    return jax.tree.map(np.asarray, ts)


def param_diffs(a: dict, b: dict) -> np.ndarray:
    """|a - b| over the parameters of two ``state_arrays`` (not the running
    statistics, the moments or the counts)."""
    keys = [k for k in a if not k.startswith("opt_") and "running" not in k
            and "num_batches" not in k]
    return np.concatenate([np.abs(a[k].astype(np.float64) - b[k]).ravel() for k in keys])


def assert_gates(log, state, want_log, want_state, where):
    loss = max(abs(g[k] - w[k]) for g, w in zip(log, want_log) for k in w)
    d = param_diffs(state, want_state)
    print(f"{where}: losses within {loss:.3e}; parameters mean {d.mean():.3e}, "
          f"max {d.max():.3e}")
    assert loss < GATES["loss"], (where, loss)
    assert d.mean() < GATES["mean"] and d.max() < GATES["max"], (where, d.mean(), d.max())


def one_process(state_or_seed, cfg, data, kinds):
    """The port's one-process steps of ``kinds`` on the whole batches."""
    ts = (init_train_state(state_or_seed, cfg) if isinstance(state_or_seed, int)
          else train_state_from_jax(state_or_seed, cfg))
    gen, dis = make_train_steps(cfg, F32)
    log = []
    for it, ((A, B), kind) in enumerate(zip(data, kinds)):
        losses = (dis if kind == "dis" else gen)(ts, torch.from_numpy(A), torch.from_numpy(B),
                                                cfg.rate_for(it))
        log.append({k: float(v) for k, v in losses.items()})
    return log, torch_dp_ranks.state_arrays(ts)


@pytest.mark.parametrize("n_data", [2, 1])
def test_tp_matches_jax_gspmd_and_one_process(n_data, tmp_path):
    """Four iterations at 64px on a (n_data, 2) mesh: the port's ranks hold
    JAX's GSPMD steps on the same mesh and the port's one process on the
    whole batch within tests/test_gspmd.py's gates; every rank's own tensors
    are its pieces of the whole state that rank 0 gathers."""
    jcfg = JaxConfig(image_size=TP_SIZE, precision="f32", **TP_CFG)
    cfg = dict(image_size=TP_SIZE, precision="f32", **TP_CFG)
    jts = jax_init(jax.random.PRNGKey(0), jcfg)
    data = batches(0, 4)
    ranks = torch_dp_ranks.run("mesh_steps", {"jts": numpy_tree(jts), "batches": data,
                                              "kinds": KINDS4, "cfg": cfg, "tp": 2},
                               tmp_path, world=2 * n_data)
    r0 = ranks[0]
    for r in ranks:
        assert r["log"] == r0["log"]
        assert not torch_dp_ranks.not_pieces(r["own"][0], r0["states"][0])
    assert r0["split"]["gen_A"] == ["decoder.0.weight", "decoder.3.weight",
                                    "encoder.5.weight", "encoder.8.weight"]
    assert r0["split"]["dis_A"] == ["conv3.weight", "conv4.weight"]

    mesh = jax_make_mesh(n_data=n_data, n_model=2)
    tsg = place_train_state(jax.tree.map(jnp.copy, jts), mesh)
    gen, dis = make_gspmd_train_steps(jcfg, mesh, JAX_F32)
    jlog = []
    for it, ((A, B), kind) in enumerate(zip(data, KINDS4)):
        tsg, losses = (dis if kind == "dis" else gen)(tsg, jnp.asarray(A), jnp.asarray(B),
                                                      jnp.float32(jcfg.rate_for(it)))
        jlog.append({k: float(v) for k, v in losses.items()})
    jstate = torch_dp_ranks.state_arrays(
        train_state_from_jax(numpy_tree(jax.device_get(tsg)), TrainConfig(**cfg)))
    assert_gates(r0["log"], r0["states"][0], jlog, jstate, f"({n_data}, 2) port vs JAX GSPMD")
    one_log, one = one_process(numpy_tree(jts), TrainConfig(**cfg), data, KINDS4)
    assert_gates(r0["log"], r0["states"][0], one_log, one, f"({n_data}, 2) vs one process")


@pytest.mark.parametrize("mode, slim", [("gspmd", None), ("spatial", None), ("gspmd", "all")])
def test_world_of_one_equals_one_process(mode, slim, tmp_path):
    """A mesh of one rank (tp 1) in either mode: the one-process steps bit
    for bit, losses and whole state (the bf16 masters' rounding bits too)."""
    cfg = dict(image_size=16, precision="f32", gan_curriculum=1, slim_state=slim)
    data = batches(1, 3, size=16, batch=4)
    kinds = ["dis", "gen", "gen"]
    (r,) = torch_dp_ranks.run("mesh_steps", {"seed": 4, "batches": data, "kinds": kinds,
                                             "cfg": cfg, "tp": 1,
                                             "spatial": mode == "spatial"},
                              tmp_path, world=1)
    log, state = one_process(4, TrainConfig(**cfg), data, kinds)
    assert r["log"] == log
    got = r["states"][0]
    assert got.keys() == state.keys()
    assert not [k for k in state if not np.array_equal(got[k], state[k])]


def test_place_then_gather_returns_the_whole_state(tmp_path):
    """At 64px over tp 2 (slim state "all": bf16 parameters): each rank
    holds half of every split weight, its pieces of the state placed, and
    the state rank 0 gathers is the placed one bit for bit."""
    cfg = dict(image_size=TP_SIZE, precision="f32", slim_state="all")
    ranks = torch_dp_ranks.run("mesh_place_gather", {"seed": 6, "cfg": cfg, "tp": 2},
                               tmp_path)
    for r in ranks:
        assert r["local"]["encoder.5.weight"] == (128, 128, 4, 4)   # enc2, 256 -> 128
        assert r["local"]["encoder.8.weight"] == (256, 256, 4, 4)   # enc3, 512 -> 256
        assert r["local"]["decoder.0.weight"] == (100, 256, 4, 4)   # dec0, 512 -> 256
        assert r["local"]["encoder.2.weight"] == (128, 64, 4, 4)    # enc1 whole
        assert not r["not_pieces"]
    assert "gathered_digest" not in ranks[1]  # rank 1 sends its slices and holds no whole
    a, b = ranks[0]["gathered_digest"], ranks[0]["whole_digest"]
    assert a.keys() == b.keys()
    assert not [k for k in b if a[k] != b[k]]


@pytest.mark.parametrize("slim", ["mv", "all"])
def test_tp_chunks_equal_the_per_step_tp_path(slim, tmp_path):
    """--steps_per_call under tensor parallelism (the chunk program, eager
    on the CPU, the gathers and all-reduces inside its steps) against the
    per-step TP path on two ranks: the same losses, the same tensors on
    every rank and the same state gathered, bit for bit."""
    cfg = dict(image_size=SMALL, precision="f32", slim_state=slim, lean_dis=True,
               log_interval=6, gan_curriculum=5)
    ranks = torch_dp_ranks.run("mesh_chunks", {"cfg": cfg, "n": 7, "chunks": (4, 3),
                                               "batch": 2, "seed": 2, "tp": 2}, tmp_path)
    for r in ranks:
        assert r["got"] == r["want"]
        a, b = (own["digest"] for own in r["own"])
        assert not [k for k in a if a[k] != b[k]]
        assert all(np.isfinite(v).all() for v in r["want"])
    a, b = ranks[0]["per_step_digest"], ranks[0]["chunked_digest"]
    assert a.keys() == b.keys()
    assert not [k for k in a if a[k] != b[k]]


@pytest.mark.parametrize("policy", ["full", "conv"])
def test_remat_equals_no_remat_under_tp(policy, tmp_path):
    """Remat regions rebuild with their collectives: D and G steps on two
    tp ranks under remat equal the same steps without it, bit for bit."""
    base = dict(image_size=SMALL, precision="f32", gan_curriculum=1)
    data = batches(2, 2, size=SMALL, batch=4)
    out = {}
    for remat in (True, False):
        cfg = dict(base, remat=remat, remat_policy=policy, remat_dis=True)
        out[remat] = torch_dp_ranks.run("mesh_steps", {"seed": 5, "batches": data,
                                                       "kinds": ["dis", "gen"], "cfg": cfg,
                                                       "tp": 2}, tmp_path)
    for a, b in zip(out[True], out[False]):
        assert a["log"] == b["log"]
        sa, sb = a["digests"][0], b["digests"][0]
        assert not [k for k in sa if sa[k] != sb[k]]


@pytest.mark.parametrize("tp_from, tp_to", [(2, 1), (1, 2)])
def test_saves_move_between_tp_meshes(tp_from, tp_to, tmp_path):
    """A whole state saved from a tp_from mesh (slim state "all") loads into
    a tp_to mesh bit for bit, and trains on there as the same state placed
    on that mesh without the disk does, bit for bit."""
    cfg = dict(image_size=SMALL, precision="f32", slim_state="all", gan_curriculum=1)
    p = {"seed": 8, "cfg": cfg, "batches": batches(3, 2, size=SMALL, batch=4),
         "kinds": ["dis", "gen"], "n": 2, "tp_from": tp_from, "tp_to": tp_to,
         "dir": str(tmp_path / "save")}
    ranks = torch_dp_ranks.run("mesh_resume", p, tmp_path)
    r0 = ranks[0]
    for what, a, b in (("loaded", r0["loaded_digest"], r0["saved_digest"]),
                       ("continued", r0["resumed_digest"], r0["continued_digest"])):
        assert a.keys() == b.keys()
        assert not [k for k in a if a[k] != b[k]], what
    for r in ranks:
        a, b = (own["digest"] for own in r["own"])
        assert not [k for k in a if a[k] != b[k]], "continued, this rank's tensors"


# Per step of the 32px model at tp 2 on a (1, 2) mesh, the collectives that
# parallel/dp.py counts. Split layers: the generators' enc2 and dec0 and the
# discriminators' conv3. Forward, 56 all-reduces and 24 all-gathers: a
# generator forward takes K3's statistics of enc1 and enc2 over the data
# axis (1 all-reduce each) and K1's of the latent, dec0, dec1 and dec2 (2
# each: the mean, then the variance), 10; a discriminator forward those of
# conv2 and conv3, 2; each of the 2 feature-matching losses the batch means
# of the real and the fake of its 2 features, 4; 4 forwards of each network
# (40 + 8 + 8). Each split layer gathers its statistics and its channels:
# 2 all-gathers in each of 8 generator and 4 discriminator layer calls.
# Backward: one all-reduce a mean over the data axis whose output takes a
# gradient, and one a split layer whose input takes one (the model ranks'
# input gradients summed). D step: the 4 discriminator forwards' 8 means
# and 4 sums, 12. G step: the 4 generator forwards' 40 means and 8 sums,
# the 2 fake discriminator forwards' 4 means and 2 sums, the fake features'
# 4 means, 58. Then the gradients, one flat buffer a group (the data axis;
# every rank for the split layers' BatchNorm parameters): 2; the losses: 1.
COUNTS = {"dis": {"all_reduce": 56 + 12 + 3, "all_gather": 24, "gather": 0},
          "gen": {"all_reduce": 56 + 58 + 3, "all_gather": 24, "gather": 0}}


def test_tp_collectives_per_step(tmp_path):
    """Each step's collectives as stated, the same on every rank."""
    cfg = dict(image_size=SMALL, precision="f32", gan_curriculum=1)
    ranks = torch_dp_ranks.run("mesh_steps", {"seed": 5, "batches": batches(4, 2, SMALL, 4),
                                              "kinds": ["dis", "gen"], "cfg": cfg, "tp": 2},
                               tmp_path)
    assert ranks[0]["counts"] == ranks[1]["counts"]
    d, g = ranks[0]["counts"]
    print(f"collectives: D step {d}, G step {g}")
    assert d == COUNTS["dis"] and g == COUNTS["gen"]


def jax_leaf_names(image_size: int):
    """(JAX path of each 4-D conv kernel leaf, network, the port's parameter
    and its output-channel axis there), from the JAX layouts of
    models/torch_compat.py."""
    from discogan_modernized_torch.models.geometry import n_halvings

    n = n_halvings(image_size)
    out = []
    for net in ("gen_A", "gen_B"):
        out += [(("models", net, "encoder", i, "w"), net, f"encoder.{enc_conv_index(i)}.weight",
                 0) for i in range(n)]
        out.append((("models", net, "latent", "w"), net, f"encoder.{enc_conv_index(n)}.weight",
                    0))
        out += [(("models", net, "decoder", j, "w"), net, f"decoder.{3 * j}.weight", 1)
                for j in range(n + 1)]
    for net in ("dis_A", "dis_B"):
        out += [(("models", net, "trunk", i, "w"), net, f"conv{i + 1}.weight", 0)
                for i in range(n)]
        out.append((("models", net, "head", "w"), net, f"conv{n + 1}.weight", 0))
    return out


@pytest.mark.parametrize("image_size", [64, 512])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_spec_matches_jax_train_state_shardings(image_size, tp):
    """``shard_spec`` on every conv weight equals JAX
    ``train_state_shardings`` leaf by leaf (a JAX kernel split on the model
    axis is the port's weight split on its output-channel axis), from the
    shapes alone; nothing else is split."""
    jcfg = JaxConfig(image_size=image_size, precision="f32")
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    mesh = jax_make_mesh(n_data=8 // tp, n_model=tp)
    jspecs = train_state_shardings(shapes, mesh)
    with torch.device("meta"):
        ts = init_train_state(0, TrainConfig(image_size=image_size), "meta")
    port = port_shardings(ts.models, tp)
    seen = set()
    for path, net, name, dim in jax_leaf_names(image_size):
        spec = jspecs
        for key in path:
            spec = spec[key]
        split = spec.spec != jax.sharding.PartitionSpec()
        assert port[net][name] == (dim if split else None), (path, spec.spec)
        assert shard_spec(ts.models[net], name, tp) == port[net][name]
        seen.add((net, name))
    assert not [(k, n) for k, specs in port.items() for n, d in specs.items()
                if d is not None and (k, n) not in seen]


def test_tp_halves_the_512px_state():
    """At 512px tp 2 splits 98.8% of the trained state (the generators'
    enc2-enc6 and dec0-dec4, the discriminators' enc2-enc6), so a rank
    holds 0.506 of its parameters; spatial sharding bands the stated
    layers."""
    with torch.device("meta"):
        ts = init_train_state(0, TrainConfig(image_size=512), "meta")
    split = port_shardings(ts.models, 2)
    total = sum(p.numel() for m in ts.models.values() for p in m.parameters())
    halved = sum(p.numel() for k, m in ts.models.items() for n, p in m.named_parameters()
                 if split[k][n] is not None)
    assert abs(halved / total - 0.988) < 5e-4, halved / total
    assert abs((total - halved / 2) / total - 0.506) < 5e-4
    assert [n for n, d in split["gen_A"].items() if d is not None] == [
        *(f"encoder.{enc_conv_index(i)}.weight" for i in range(2, 7)),
        *(f"decoder.{3 * j}.weight" for j in range(5))]
    assert [n for n, d in split["dis_A"].items() if d is not None] == [
        f"conv{i}.weight" for i in range(3, 8)]
    bands = banded_layers(512, 2)
    assert f"encoder.{enc_conv_index(6)}" in bands["gen"] and "decoder.3" in bands["gen"]
    assert "conv7" in bands["dis"] and "conv8" not in bands["dis"]


def test_gspmd_cli_two_ranks_rank_zero_writes(tmp_path, monkeypatch):
    """The distributed trainer under --parallel_mode gspmd on two gloo ranks
    (--tp taking its default, 2): the path line names the mode, the mesh
    and the backend; one run directory, a log line for each logged
    iteration, rank 0's samples and saves, whole weights in the reference
    layout."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--device=cpu", "--task_name=synthetic", f"--image_size={SMALL}",
            "--batch_size=64", "--epochs=1", "--precision=f32", "--log_interval=2",
            "--image_save_interval=2", "--model_save_interval=3", "--parallel_mode=gspmd",
            f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"]
    outs = torch_dp_ranks.run("mesh_cli", {"argvs": [argv]}, tmp_path)
    for rank, (text,) in enumerate(outs):
        assert "; mesh gspmd (data=1, model=2) over gloo" in text
        assert f"mesh: rank {rank} of 2 at (data 0, model {rank})" in text
    (result,) = (tmp_path / "r" / "synthetic" / "discogan").iterdir()
    (model,) = (tmp_path / "m" / "synthetic" / "discogan").iterdir()
    lines = [ln for ln in (result / "training_log.txt").read_text().splitlines()
             if ln.startswith("Iter")]
    assert [ln.split("]")[0] for ln in lines] == [f"Iter [{i}/4" for i in (0, 2)]
    assert len(list((result / "samples").iterdir())) == 2
    assert sorted(p.name for p in model.glob("gen_A_*.pth")) == [
        "gen_A_0.pth", "gen_A_3.pth", "gen_A_final.pth"]
    sd = torch.load(model / "gen_A_final.pth", weights_only=True)
    assert sd["encoder.5.weight"].shape == (256, 128, 4, 4)
