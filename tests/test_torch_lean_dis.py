"""The port's lean D step (``--lean_dis``, ``make_lean_dis_step``): on D
iterations that are not logged it skips the ABA/BAB forwards. Over the JAX
test's schedule (tests/test_lean_dis.py: 32px, batch 4, 13 iterations,
log_interval 4, f32 on the CPU):

- the parameters and Adam moments of a lean run equal a full run's bit for
  bit, and so do the discriminators' running statistics;
- the lean iterations report recon_A = recon_B = 0, and every logged
  iteration's losses equal the full run's exactly;
- the generators' running statistics (which take 2 updates a lean D step
  instead of 4) match JAX's lean run within 1e-5, from the same weights
  (``train_state_from_jax``) and the same batches;
- ``--lean_dis`` through the trainer CLI: every logged line carries real
  RECON values.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_tpu.train import make_train_steps as jax_steps
from discogan_modernized_tpu.train.step import make_lean_dis_step as jax_lean_step
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.train.step import (TrainConfig, make_lean_dis_step,
                                                  make_train_steps)
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, BATCH, ITERS, LOG = 32, 4, 13, 4


def batches():
    rng = np.random.RandomState(0)
    return (rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32))


def jax_state():
    return jax_init(jax.random.PRNGKey(0), JaxConfig(image_size=SIZE, precision="f32"))


def run_port(lean: bool):
    cfg = TrainConfig(image_size=SIZE, precision="f32", lean_dis=lean, log_interval=LOG)
    ts = train_state_from_jax(jax.tree.map(np.asarray, jax_state()), cfg)
    gen_step, dis_step = make_train_steps(cfg, F32)
    lean_step = make_lean_dis_step(cfg, F32)
    A, B = map(torch.from_numpy, batches())
    logged, lean_losses = {}, []
    for j in range(ITERS):
        step = (lean_step if cfg.use_lean_dis(j) else
                dis_step if cfg.is_dis_iter(j) else gen_step)
        losses = step(ts, A, B, cfg.rate_for(j))
        if cfg.use_lean_dis(j):
            lean_losses.append(losses)
        if j % LOG == 0:
            logged[j] = {k: float(v) for k, v in losses.items()}
    return ts, logged, lean_losses


def tensors(ts) -> dict:
    out = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        out.update({f"{key}.m{i}": t for i, t in enumerate(opt.m)})
        out.update({f"{key}.v{i}": t for i, t in enumerate(opt.v)})
    return out


def test_lean_dis_weights_bit_identical_and_logged_losses_exact():
    full, log_full, _ = run_port(False)
    lean, log_lean, lean_losses = run_port(True)
    a, b = tensors(full), tensors(lean)
    gen_stats = [k for k in a if k.startswith("gen") and ("running" in k or "num_batches" in k)]
    assert [k for k in a if k not in gen_stats and not torch.equal(a[k], b[k])] == []
    assert any(not torch.equal(a[k], b[k]) for k in gen_stats)  # ABA/BAB really skipped
    # gen_A runs once, not twice, on each lean D step (iterations 3, 6 and 9)
    n = lambda ts: int(ts.models["gen_A"].encoder[3].num_batches_tracked)  # noqa: E731
    assert n(full) - n(lean) == 3
    assert log_full.keys() == log_lean.keys() and log_full == log_lean
    assert len(lean_losses) == 3
    for losses in lean_losses:
        assert float(losses["recon_A"]) == 0.0 and float(losses["recon_B"]) == 0.0


def test_lean_generator_statistics_match_jax_lean_run():
    """At each lean iteration of JAX's lean run (3, 6 and 9), the port's
    lean D step from JAX's state of that moment (the same weights, running
    statistics and moments) leaves the generators' running statistics
    within 1e-5 of JAX's lean step's (the runs' weights themselves part at
    the f32 rounding level over the iterations, tests/test_torch_train_step.py)."""
    jcfg = JaxConfig(image_size=SIZE, precision="f32", lean_dis=True, log_interval=LOG)
    cfg = TrainConfig(image_size=SIZE, precision="f32", lean_dis=True, log_interval=LOG)
    port_lean = make_lean_dis_step(cfg, F32)
    jts = jax_state()
    jgen, jdis = jax_steps(jcfg)
    jlean = jax_lean_step(jcfg)
    A, B = batches()
    checked = 0
    for j in range(ITERS):
        rate = jcfg.rate_for(j)
        if jcfg.use_lean_dis(j):
            ts = train_state_from_jax(jax.tree.map(np.asarray, jts), cfg)
            port_lean(ts, torch.from_numpy(A), torch.from_numpy(B), rate)
        step = jlean if jcfg.use_lean_dis(j) else jdis if jcfg.is_dis_iter(j) else jgen
        jts, _ = step(jts, jnp.asarray(A), jnp.asarray(B), jnp.float32(rate))
        if not jcfg.use_lean_dis(j):
            continue
        checked += 1
        for name in ("gen_A", "gen_B"):
            state = jax.tree.map(np.asarray, jts["model_states"][name])
            want = ([s for s in state["encoder"] if "mean" in s] + [state["latent"]]
                    + [s for s in state["decoder"] if "mean" in s])
            bns = [m for m in ts.models[name].modules() if isinstance(m, torch.nn.BatchNorm2d)]
            assert len(bns) == len(want)
            for bn, s in zip(bns, want):
                np.testing.assert_allclose(bn.running_mean.numpy(), s["mean"], atol=1e-5)
                np.testing.assert_allclose(bn.running_var.numpy(), s["var"], atol=1e-5)
                assert int(bn.num_batches_tracked) == int(s["count"])
    assert checked == 3


def test_lean_dis_cli_e2e(tmp_path):
    """--lean_dis end to end at 16px: the log has a line every 4
    iterations, each with nonzero RECON (logged iterations run the full
    graph), and the meta records the variant."""
    from discogan_modernized_torch.cli.image_translation import main

    result_path, model_path = main([
        "--device=cpu", "--task_name=synthetic", "--model_arch=discogan",
        "--image_size=16", "--batch_size=8", "--epochs=2", "--log_interval=4",
        "--image_save_interval=100", "--model_save_interval=100",
        f"--results_dir={tmp_path}/results", f"--models_dir={tmp_path}/models",
        "--precision=f32", "--lean_dis"])
    assert (model_path / "gen_B_final.pth").exists()
    recs = re.findall(r"RECON: ([0-9.]+)/([0-9.]+)",
                      (result_path / "training_log.txt").read_text())
    assert len(recs) == 16  # iterations 0, 4, ..., 60 of 64
    assert all(float(a) > 0 and float(b) > 0 for a, b in recs), recs
    assert '"lean_dis": true' in (model_path / "train_state_meta.json").read_text()
