"""The port's spatial sharding on a (data, model) mesh of gloo ranks on the
CPU (ops/sharding.py's bands and halos, parallel/gspmd.py), f32, against
the JAX package's ``make_gspmd_train_steps(spatial=True)`` on the same
mesh of the conftest's virtual CPU devices and against the port's one
process; mirrors tests/test_gspmd.py's spatial and lean-D cases.

Each data row's model ranks hold bands of every map's rows (the first and
last band with the image's zero edge, the middle ones with two
neighbours at tp 4). One D and one G step from the same state at 32px,
batch 4, hold tests/test_gspmd.py:123-140's gates against JAX's and the
one process's (losses 1e-5, parameters mean 2e-6 and max 2.1 lr, Adam's
first moment 2e-3). The lean D step equals the full D step's weights bit
for bit in both modes (tests/test_gspmd.py:143-175). The distributed CLI
trains under --parallel_mode spatial on two ranks, rank 0 alone writing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.core.mesh import make_mesh as jax_make_mesh
from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.parallel import make_gspmd_train_steps
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.train.step import TrainConfig, make_train_steps
from tests import torch_dp_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 32
BATCH = 4
LR = 2e-4
GATES = {"loss": 1e-5, "mean": 2e-6, "max": 2.1 * LR, "m": 2e-3}


def numpy_tree(ts):
    return jax.tree.map(np.asarray, ts)


def batch(seed, size=SIZE, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.rand(n, size, size, 3).astype(np.float32))


def diffs(a: dict, b: dict, moments: bool) -> np.ndarray:
    """|a - b| over the parameters (or the first moments) of two
    ``state_arrays``."""
    keys = ([k for k in a if ".m" in k and k.startswith("opt_")] if moments else
            [k for k in a if not k.startswith("opt_") and "running" not in k
             and "num_batches" not in k])
    return np.concatenate([np.abs(a[k].astype(np.float64) - b[k]).ravel() for k in keys])


def assert_same_state_gates(got_loss, got, want_loss, want, where):
    loss = max(abs(got_loss[k] - want_loss[k]) for k in want_loss)
    d, m = diffs(got, want, False), diffs(got, want, True)
    print(f"{where}: losses within {loss:.3e}; parameters mean {d.mean():.3e}, max "
          f"{d.max():.3e}; first moments max {m.max():.3e}")
    assert loss < GATES["loss"], (where, loss)
    assert d.mean() < GATES["mean"] and d.max() <= GATES["max"], (where, d.mean(), d.max())
    assert m.max() < GATES["m"], (where, m.max())


@pytest.mark.parametrize("n_data, tp", [(2, 2), (1, 2), (1, 4)])
def test_spatial_matches_jax_and_one_process(n_data, tp, tmp_path):
    """One D step and one G step, each from the same state, on a (n_data,
    tp) mesh: every rank's whole state equal, and within
    tests/test_gspmd.py's same-state gates of JAX's spatial steps on the
    same mesh and of the port's one process."""
    jcfg = JaxConfig(image_size=SIZE, precision="f32")
    cfg = TrainConfig(image_size=SIZE, precision="f32")
    jts = jax_init(jax.random.PRNGKey(0), jcfg)
    host = numpy_tree(jts)
    A, B = batch(3)
    ranks = torch_dp_ranks.run("mesh_steps", {"jts": host, "batches": [(A, B)] * 2,
                                              "kinds": ["dis", "gen"], "same_state": True,
                                              "cfg": dict(image_size=SIZE, precision="f32"),
                                              "tp": tp, "spatial": True},
                               tmp_path, world=n_data * tp)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["log"] == r0["log"]
        assert r["digests"] == r0["digests"]

    mesh = jax_make_mesh(n_data=n_data, n_model=tp)
    gen, dis = make_gspmd_train_steps(jcfg, mesh, JAX_F32, spatial=True)
    one_gen, one_dis = make_train_steps(cfg, F32)
    for i, (jstep, one_step) in enumerate(((dis, one_dis), (gen, one_gen))):
        jnew, jl = jstep(jax.tree.map(jnp.asarray, host), jnp.asarray(A), jnp.asarray(B),
                         jnp.float32(0.01))
        want = torch_dp_ranks.state_arrays(train_state_from_jax(numpy_tree(jnew), cfg))
        assert_same_state_gates(r0["log"][i], r0["states"][i],
                                {k: float(v) for k, v in jl.items()}, want,
                                f"({n_data}, {tp}) step {i} vs JAX spatial")
        one = train_state_from_jax(host, cfg)
        losses = one_step(one, torch.from_numpy(A), torch.from_numpy(B), 0.01)
        assert_same_state_gates(r0["log"][i], r0["states"][i],
                                {k: float(v) for k, v in losses.items()},
                                torch_dp_ranks.state_arrays(one),
                                f"({n_data}, {tp}) step {i} vs one process")


@pytest.mark.parametrize("mode", ["gspmd", "spatial"])
def test_lean_dis_step_equals_the_full_d_step(mode, tmp_path):
    """--lean_dis on the mesh: from one state, the lean D step's weights and
    moments equal the full D step's bit for bit (the generators' running
    statistics take fewer updates); its recon losses report 0."""
    cfg = dict(image_size=SIZE, precision="f32", lean_dis=True)
    A, B = batch(7, n=8)
    ranks = torch_dp_ranks.run("mesh_steps", {"seed": 3, "batches": [(A, B)] * 2,
                                              "kinds": ["dis", "lean"], "same_state": True,
                                              "cfg": cfg, "tp": 2,
                                              "spatial": mode == "spatial"}, tmp_path)
    for r in ranks:
        full, lean = r["digests"]
        assert r["log"][1]["recon_A"] == 0.0
        assert abs(r["log"][0]["dis_total"] - r["log"][1]["dis_total"]) < 1e-6
        keys = [k for k in full if "running" not in k and "num_batches" not in k]
        assert not [k for k in keys if full[k] != lean[k]]


def test_spatial_cli_two_ranks_rank_zero_writes(tmp_path, monkeypatch):
    """The distributed trainer under --parallel_mode spatial --tp 2 on two
    gloo ranks: the path line names the mode, the mesh and the backend;
    --steps_per_call above 1 is refused with the reason; one run directory
    with rank 0's log lines, samples and saves."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--device=cpu", "--task_name=synthetic", "--image_size=16",
            "--batch_size=32", "--epochs=1", "--precision=f32", "--log_interval=2",
            "--image_save_interval=4", "--model_save_interval=6", "--parallel_mode=spatial",
            "--tp=2", f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"]
    outs = torch_dp_ranks.run("mesh_cli", {"argvs": [argv]}, tmp_path)
    for rank, (text,) in enumerate(outs):
        assert "; mesh spatial (data=1, model=2) over gloo" in text
        assert f"mesh: rank {rank} of 2 at (data 0, model {rank})" in text
    (result,) = (tmp_path / "r" / "synthetic" / "discogan").iterdir()
    (model,) = (tmp_path / "m" / "synthetic" / "discogan").iterdir()
    lines = [ln for ln in (result / "training_log.txt").read_text().splitlines()
             if ln.startswith("Iter")]
    assert [ln.split("]")[0] for ln in lines] == [f"Iter [{i}/8" for i in range(0, 8, 2)]
    assert len(list((result / "samples").iterdir())) == 2
    assert sorted(p.name for p in model.glob("gen_A_*.pth")) == [
        "gen_A_0.pth", "gen_A_6.pth", "gen_A_final.pth"]
    from discogan_modernized_torch.cli.distributed_image_translation import main

    with pytest.raises(SystemExit, match="spatial sharding is not routed to chunks"):
        main([*(a for a in argv if a != "--tp=2"), "--distributed", "--world_size=1",
              "--steps_per_call=3",
              f"--results_dir={tmp_path}/r2", f"--models_dir={tmp_path}/m2"])


@pytest.mark.parametrize("variant", ["paired", "concat_dis", "remat_latent", "remat_conv"])
@pytest.mark.parametrize("mode", ["gspmd", "spatial"])
def test_graph_variants_equal_the_plain_graph_on_the_mesh(mode, variant, tmp_path):
    """The train step's graph variants on a tp 2 mesh (the pair axis through
    the halos, gathers and sums; a remat region's rebuild with its
    collectives): one D and one G step equal the plain graph's bit for
    bit, as they do on one process."""
    extra = {"paired": {"paired": True}, "concat_dis": {"concat_dis": True},
             "remat_latent": {"remat": True, "remat_policy": "latent"},
             "remat_conv": {"remat": True, "remat_policy": "conv", "remat_dis": True}}[variant]
    base = dict(image_size=SIZE, precision="f32", gan_curriculum=1)
    p = {"seed": 5, "batches": [batch(2), batch(9)], "kinds": ["dis", "gen"], "tp": 2,
         "spatial": mode == "spatial"}
    plain, varied = (torch_dp_ranks.run("mesh_steps", dict(p, cfg=cfg), tmp_path)
                     for cfg in (base, dict(base, **extra)))
    for a, b in zip(varied, plain):
        assert a["log"] == b["log"]
        sa, sb = a["digests"][0], b["digests"][0]
        assert not [k for k in sa if sa[k] != sb[k]]


# Per step of the 32px model at tp 2 on a (1, 2) mesh under spatial
# sharding (16-row bands of the images), the collectives that parallel/dp.py
# counts. Forward, 72 all-reduces and 50 all-gathers: a generator forward
# exchanges halo rows at enc0, enc1, enc2, dec1, dec2 and the head (6
# all-gathers) and gathers the latent's 4x4 map (1), and takes K1's
# statistics over every rank at enc1, enc2, dec1 and dec2 and over the data
# axis at the latent and dec0 (2 all-reduces each: 12); a discriminator
# forward exchanges halos at conv1-conv3 (3) and gathers its two features
# whole (2), and takes conv2's and conv3's statistics (4); the two
# reconstructions are gathered whole (2); the feature-matching means, 8.
# 4 forwards of each network: 4 x 7 + 4 x 5 + 2 = 50, 4 x 12 + 4 x 4 + 8 =
# 72. Backward: an all-gather a halo whose input takes a gradient (the
# halo cotangents go home) and a dec0 band's (the bands' cotangents
# gathered), an all-reduce a mean whose output takes one. D step: the 4
# discriminator forwards' conv2 and conv3 halos (8) and 16 means. G step:
# the generator forwards' 5 inner halos each and the 2 reconstructions'
# stems (22) and 4 dec0 bands, the 2 fake discriminator forwards' 3 halos
# each (6), 48 + 8 + 4 fake feature means. Then the gradients (2 groups:
# every rank for the banded layers, the data axis for the latent, dec0 and
# the discriminators' heads) and the losses (1).
SPATIAL_COUNTS = {"dis": {"all_reduce": 72 + 16 + 3, "all_gather": 50 + 8, "gather": 0},
                  "gen": {"all_reduce": 72 + 60 + 3, "all_gather": 50 + 32, "gather": 0}}


def test_spatial_collectives_per_step(tmp_path):
    """Each step's collectives as stated, the same on every rank."""
    cfg = dict(image_size=SIZE, precision="f32", gan_curriculum=1)
    ranks = torch_dp_ranks.run("mesh_steps", {"seed": 5, "batches": [batch(4), batch(5)],
                                              "kinds": ["dis", "gen"], "cfg": cfg, "tp": 2,
                                              "spatial": True}, tmp_path)
    assert ranks[0]["counts"] == ranks[1]["counts"]
    d, g = ranks[0]["counts"]
    print(f"collectives: D step {d}, G step {g}")
    assert d == SPATIAL_COUNTS["dis"] and g == SPATIAL_COUNTS["gen"]
