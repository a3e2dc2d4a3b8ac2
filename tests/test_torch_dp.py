"""The port's data parallelism (parallel/dp.py, core/distributed.py, the
distributed CLI) on two gloo ranks on the CPU, f32, 16px, against the JAX
package's ``make_dp_train_steps`` on a 2-device mesh (tests/conftest.py
gives 8 CPU devices) and against one process on the concatenated batch;
mirrors tests/test_dp.py, test_dp_scan.py and test_multihost.py.

Each rank trains on its half of a global batch of 8 (the mesh's shard).
Under ``bn_sync`` one D and one G step equal one process's steps on the
whole batch and JAX's DP steps, within tests/test_torch_train_step.py's
gates, or twice JAX's own DP-vs-one-device spread where that is larger
(the order of the sums differs); so do its steps under remat (the "full"
and "conv" policies), which equal the DP steps without remat bit for bit.
Under per-rank BatchNorm the parameters
stay equal on both ranks bit for bit, and each rank's running statistics
equal its JAX replica's. The chunk program under DP equals the per-step
DP path bit for bit, under slim states mv and all. The distributed CLI
trains both BatchNorm modes with rank 0 alone writing, and its two local
ranks take the halves of the batches the one-process trainer takes with
the same flags (``--batch_size`` is one host's batch, as in JAX); unequal
shards are truncated; the refused flags exit (a --tp that does not divide
the world, as JAX train/loop.py:309-314 refuses it); ``--load_*`` loads the
weights.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.core.mesh import make_mesh
from discogan_modernized_tpu.parallel import make_dp_train_steps, replicate_train_state
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.cli.image_translation import main as one_process_main
from discogan_modernized_torch.data.pipeline import host_rows, rank_shard
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.train.step import TrainConfig, make_train_steps
from tests import torch_dp_ranks
from tests.test_torch_train_step import LOSS_TOL, PARAM_GATES, configs, run_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 16
WORLD = 2
GLOBAL_BATCH = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(WORLD)


def global_batches(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(GLOBAL_BATCH, SIZE, SIZE, 3).astype(np.float32),
             rng.rand(GLOBAL_BATCH, SIZE, SIZE, 3).astype(np.float32)) for _ in range(n)]


def run_jax_dp(jts, jcfg, batches, mesh):
    """JAX's DP steps over ``batches`` from a copy of ``jts`` (the steps
    donate their state): (final state as numpy, loss log)."""
    ts = replicate_train_state(jax.tree.map(jnp.copy, jts), mesh, jcfg)
    gen, dis = make_dp_train_steps(jcfg, mesh)
    log = []
    for it, (A, B) in enumerate(batches):
        step = dis if jcfg.is_dis_iter(it) else gen
        ts, losses = step(ts, jnp.asarray(A), jnp.asarray(B), jnp.float32(jcfg.rate_for(it)))
        log.append({k: float(v) for k, v in losses.items()})
    return jax.tree.map(np.asarray, ts), log


def numpy_tree(ts):
    return jax.tree.map(np.asarray, ts)


def stats(a: dict, b: dict) -> dict:
    """mean/p99/max of |a - b| over the parameters and running statistics
    (not the moments, nor num_batches_tracked) of two ``state_arrays``."""
    keys = [k for k in a if not k.startswith("opt_") and "num_batches" not in k]
    d = np.concatenate([np.abs(a[k].astype(np.float64) - b[k]).ravel() for k in keys])
    return {"mean": d.mean(), "p99": np.quantile(d, 0.99), "max": d.max()}


def assert_close(got: dict, want: dict, where: str, floor: dict | None = None):
    s = stats(got, want)
    print(f"{where}: " + ", ".join(f"{k} {v:.3e}" for k, v in s.items()))
    for k, v in s.items():
        limit = PARAM_GATES[k] if floor is None else max(PARAM_GATES[k], 2 * floor[k])
        assert v < limit, (where, k, v, limit)


def assert_losses(got: list, want: list, where: str, floor: float = 0.0):
    worst = max(abs(g[k] - w[k]) for g, w in zip(got, want) for k in w)
    print(f"{where}: losses within {worst:.3e}")
    assert worst < max(LOSS_TOL, 2 * floor), (where, worst)


def test_sync_bn_equals_one_process_and_jax_dp(mesh, tmp_path):
    """Under bn_sync one D and one G step on two ranks equal the port's
    single-process steps on the global batch and JAX's DP steps; the two
    ranks hold the same state bit for bit."""
    jcfg, cfg = configs(bn_sync=True, gan_curriculum=1)
    jts = jax_init(jax.random.PRNGKey(3), jcfg)
    batches = global_batches(4, 2)
    ranks = torch_dp_ranks.run("steps", {"jts": numpy_tree(jts), "batches": batches,
                                         "cfg": dict(image_size=SIZE, precision="f32",
                                                     bn_sync=True, gan_curriculum=1)},
                               tmp_path)
    r0, r1 = ranks
    assert r0["state"].keys() == r1["state"].keys()
    assert all(np.array_equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    assert r0["log"] == r1["log"]

    one, one_log = one_process_steps(jts, cfg, batches)
    jdp, jdp_log = run_jax_dp(jts, jcfg, batches, mesh)
    jone, jone_log = run_jax(jts, jcfg, batches, jit=True)
    jdp_state = torch_dp_ranks.state_arrays(train_state_from_jax(jdp, cfg))
    jone_state = torch_dp_ranks.state_arrays(train_state_from_jax(numpy_tree(jone), cfg))
    floor = stats(jdp_state, jone_state)
    loss_floor = max(abs(a[k] - b[k]) for a, b in zip(jdp_log, jone_log) for k in a)
    print("JAX DP vs JAX one device: " + ", ".join(f"{k} {v:.3e}" for k, v in floor.items())
          + f"; losses {loss_floor:.3e}")
    assert_close(r0["state"], one, "2 ranks vs one process")
    assert_losses(r0["log"], one_log, "2 ranks vs one process")
    assert_close(r0["state"], jdp_state, "2 ranks vs JAX DP", floor)
    assert_losses(r0["log"], jdp_log, "2 ranks vs JAX DP", loss_floor)


def one_process_steps(jts, cfg, batches):
    """The port's single-process D and G steps over the global ``batches``
    from the JAX state ``jts``: (state arrays, loss log)."""
    one = train_state_from_jax(numpy_tree(jts), cfg)
    gen, dis = make_train_steps(cfg, F32)
    log = []
    for it, (A, B) in enumerate(batches):
        losses = (dis if cfg.is_dis_iter(it) else gen)(
            one, torch.from_numpy(A), torch.from_numpy(B), cfg.rate_for(it))
        log.append({k: float(v) for k, v in losses.items()})
    return torch_dp_ranks.state_arrays(one), log


@pytest.mark.parametrize("policy", ["full", "conv"])
def test_sync_bn_under_remat_equals_one_process(policy, tmp_path):
    """--bn_sync with remat on: a region's rebuild in the backward takes the
    global batch's statistics and all-reduces again, as its first forward
    did. Two ranks' D and G steps equal their steps without remat bit for
    bit, and one process's remat steps on the global batch within the
    gates."""
    jcfg, _ = configs(bn_sync=True, gan_curriculum=1)
    cfg = dict(image_size=SIZE, precision="f32", bn_sync=True, gan_curriculum=1,
               remat=True, remat_policy=policy, remat_dis=True)
    jts = jax_init(jax.random.PRNGKey(7), jcfg)
    batches = global_batches(8, 2)
    ranks = torch_dp_ranks.run("remat_steps", {"jts": numpy_tree(jts), "batches": batches,
                                               "cfg": cfg}, tmp_path)
    for r in ranks:
        a, b = r["remat"]["state"], r["plain"]["state"]
        assert not [k for k in a if not np.array_equal(a[k], b[k])]
        assert r["remat"]["log"] == r["plain"]["log"]
    r0, r1 = (r["remat"] for r in ranks)
    assert all(np.array_equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    one, one_log = one_process_steps(jts, TrainConfig(**cfg), batches)
    assert_close(r0["state"], one, f"2 ranks vs one process, remat {policy}")
    assert_losses(r0["log"], one_log, f"2 ranks vs one process, remat {policy}")


def test_local_bn_keeps_parameters_equal_and_matches_jax_replicas(mesh, tmp_path):
    """Per-rank BatchNorm: the parameters and moments stay equal on both
    ranks, the running statistics differ between them, and each rank's
    whole state equals JAX's DP state with that replica's statistics."""
    jcfg, cfg = configs(bn_sync=False)
    jts = jax_init(jax.random.PRNGKey(5), jcfg)
    batches = global_batches(6, 2)
    ranks = torch_dp_ranks.run("steps", {"jts": numpy_tree(jts), "batches": batches,
                                         "cfg": dict(image_size=SIZE, precision="f32")},
                               tmp_path)
    shared = [k for k in ranks[0]["state"] if "running" not in k]
    assert all(np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in shared)
    assert not np.array_equal(ranks[0]["state"]["gen_B.encoder.3.running_mean"],
                              ranks[1]["state"]["gen_B.encoder.3.running_mean"])
    assert ranks[0]["log"] == ranks[1]["log"]
    jdp, jdp_log = run_jax_dp(jts, jcfg, batches, mesh)
    for r, got in enumerate(ranks):
        want = torch_dp_ranks.state_arrays(train_state_from_jax(jdp, cfg, replica=r))
        assert_close(got["state"], want, f"rank {r} vs JAX replica {r}")
    assert_losses(ranks[0]["log"], jdp_log, "2 ranks vs JAX DP (means)")


@pytest.mark.parametrize("slim, sync", [("mv", True), ("all", False)])
def test_chunks_under_dp_equal_the_per_step_dp_path(slim, sync, tmp_path):
    """--steps_per_call 4 under DP (the chunk program, eager on the CPU,
    with the all-reduces inside its steps) against the per-step DP path:
    the same losses and the same final state, bit for bit, on each rank;
    both ranks' parameters equal."""
    cfg = dict(image_size=SIZE, precision="f32", slim_state=slim, bn_sync=sync,
               lean_dis=True, log_interval=6, gan_curriculum=5)
    ranks = torch_dp_ranks.run("chunks", {"cfg": cfg, "n": 7, "chunks": (4, 3)}, tmp_path)
    for r in ranks:
        assert r["got"] == r["want"]
        a, b = r["per_step"], r["chunked"]
        assert a.keys() == b.keys()
        assert not [k for k in a if not np.array_equal(a[k], b[k])]
        assert all(np.isfinite(v).all() for v in r["want"])
    shared = [k for k in ranks[0]["chunked"] if "running" not in k]
    assert all(np.array_equal(ranks[0]["chunked"][k], ranks[1]["chunked"][k])
               for k in shared)


def cli(tmp_path, tag, *extra):
    from discogan_modernized_torch.cli.distributed_image_translation import main

    return main(["--device=cpu", "--task_name=synthetic", "--image_size=16",
                 "--batch_size=16", "--epochs=1", "--precision=f32", "--log_interval=2",
                 "--image_save_interval=4", "--model_save_interval=6",
                 f"--results_dir={tmp_path}/{tag}/r", f"--models_dir={tmp_path}/{tag}/m",
                 *extra])


@pytest.mark.parametrize("mode", ["--bn_sync", None])
def test_distributed_cli_two_ranks_rank_zero_writes(mode, tmp_path, monkeypatch):
    """Two local ranks (--world_size 2, one process each) train the
    synthetic task, 8 iterations of a global batch of 32; one run
    directory, one log line for each logged iteration, rank 0's samples and
    saves (iterations 0 and 6 and the final state)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cli(tmp_path, "run", "--distributed", "--world_size=2", "--batch_size=32",
        *([mode] if mode else []))
    (result,) = (tmp_path / "run" / "r" / "synthetic" / "discogan").iterdir()
    (model,) = (tmp_path / "run" / "m" / "synthetic" / "discogan").iterdir()
    lines = [ln for ln in (result / "training_log.txt").read_text().splitlines()
             if ln.startswith("Iter")]
    assert [ln.split("]")[0] for ln in lines] == [f"Iter [{i}/8" for i in range(0, 8, 2)]
    assert sorted(p.name for p in (result / "samples").iterdir()) and \
        len(list((result / "samples").iterdir())) == 2
    assert json.loads((model / "train_state_meta.json").read_text())["iters"] == 8
    assert sorted(p.name for p in model.glob("gen_A_*.pth")) == [
        "gen_A_0.pth", "gen_A_6.pth", "gen_A_final.pth"]


BATCH_FLAGS = ["--device=cpu", "--task_name=synthetic", "--image_size=16", "--batch_size=32",
               "--epochs=1", "--precision=f32", "--log_interval=50",
               "--image_save_interval=50", "--model_save_interval=50"]
STEPS_PER_CALL = (1, 4)


@pytest.fixture(scope="module")
def rank_batches(tmp_path_factory):
    """Each rank's (A, B) a step of the distributed trainer's two local
    ranks at BATCH_FLAGS, one run for each of STEPS_PER_CALL."""
    tmp = tmp_path_factory.mktemp("batches")
    argvs = [[*BATCH_FLAGS, f"--steps_per_call={k}", "--distributed",
              f"--results_dir={tmp}/r{k}", f"--models_dir={tmp}/m{k}"] for k in STEPS_PER_CALL]
    return torch_dp_ranks.run("cli_batches", {"argvs": argvs}, tmp)


@pytest.mark.parametrize("steps_per_call", STEPS_PER_CALL)
def test_two_ranks_take_the_one_process_batches(steps_per_call, rank_batches, tmp_path,
                                                monkeypatch):
    """--batch_size is one host's batch (JAX train/loop.py:352-375): the
    two local ranks of the distributed trainer each take their half of every
    batch the one-process trainer takes with the same flags, from the host
    loader (per step) and from the dataset (chunks of 4)."""
    ranks = [r[STEPS_PER_CALL.index(steps_per_call)] for r in rank_batches]
    calls = []
    for module, name, fn in torch_dp_ranks.batch_recorders(calls):
        monkeypatch.setattr(module, name, fn)
    one_process_main([*BATCH_FLAGS, f"--steps_per_call={steps_per_call}",
                      f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"])
    assert len(calls) == 8 and [len(r) for r in ranks] == [8, 8]
    for i, (A, B) in enumerate(calls):
        assert [len(r[i][0]) for r in ranks] == [16, 16]
        assert np.array_equal(np.concatenate([r[i][0] for r in ranks]), A), i
        assert np.array_equal(np.concatenate([r[i][1] for r in ranks]), B), i


def test_host_rows_split_a_host_batch():
    assert [host_rows(8, p, 2) for p in range(2)] == [slice(0, 4), slice(4, 8)]
    assert host_rows(6, 0, 1) == slice(0, 6)
    with pytest.raises(SystemExit, match="split evenly"):
        host_rows(6, 0, 4)


def test_a_sigterm_on_one_rank_stops_every_rank(tmp_path):
    """The ranks agree whether any was sent SIGTERM (the trainer's check
    after each step): set on rank 0 alone, on rank 1 alone, on none."""
    for result in torch_dp_ranks.run("agree", {"set_on": [0, 1]}, tmp_path):
        assert result == [True, True, False]


def test_rank_shards_are_truncated_to_equal_length():
    data = np.arange(11)
    shards = [rank_shard(data, r, 3) for r in range(3)]
    assert [s.tolist() for s in shards] == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    assert [len(rank_shard(np.arange(9), r, 2)) for r in range(2)] == [4, 4]
    with pytest.raises(ValueError, match="every rank"):
        rank_shard(np.arange(1), 0, 2)


@pytest.mark.parametrize("flags, match", [
    (["--multihost"], "requires --distributed"),
    (["--distributed", "--world_size=2", "--parallel_mode=gspmd", "--tp=3"],
     "--tp 3 does not divide the 2-rank mesh"),
    (["--distributed", "--world_size=2", "--parallel_mode=gspmd", "--tp=4"],
     "--tp 4 does not divide the 2-rank mesh"),
    (["--distributed", "--world_size=2", "--parallel_mode=spatial", "--tp=3"],
     "--tp 3 does not divide the 2-rank mesh"),
])
def test_refused_flags_exit(flags, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli(tmp_path, "refused", *flags)


def test_load_flags_load_the_weights_on_a_world_of_one(tmp_path):
    """--load_gen_A and --load_dis_B on the distributed CLI at a world of
    one (a gloo group in this process), with no iteration to train: the
    final checkpoints are the loaded weights."""
    from discogan_modernized_torch.models.discriminator import Discriminator
    from discogan_modernized_torch.models.generator import Generator

    gen = Generator(SIZE, generator=torch.Generator().manual_seed(11))
    dis = Discriminator(SIZE, generator=torch.Generator().manual_seed(12))
    torch.save(gen.state_dict(), tmp_path / "g.pth")
    torch.save(dis.state_dict(), tmp_path / "d.pth")
    cli(tmp_path, "load", "--distributed", "--world_size=1", "--epochs=0",
        f"--load_gen_A={tmp_path / 'g.pth'}", f"--load_dis_B={tmp_path / 'd.pth'}")
    assert not torch.distributed.is_initialized()
    (model,) = (tmp_path / "load" / "m" / "synthetic" / "discogan").iterdir()
    for name, module in (("gen_A", gen), ("dis_B", dis)):
        saved = torch.load(model / f"{name}_final.pth", weights_only=True)
        assert all(torch.equal(saved[k], v) for k, v in module.state_dict().items())
