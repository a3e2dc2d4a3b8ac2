"""The paired graph (``--paired``: each A-side/B-side pair of forwards as
one pass on a pair axis, ``discogan_losses_paired``) and the concat_dis
graph (each discriminator's real and fake forwards as one pass,
``Discriminator.forward_pair``) on the CPU, f32, 16px, batch 4:

- after one D and one G step each equals the plain graph bit for bit in
  every parameter, Adam moment and running statistic, alone and with the
  other variants (remat, the lean D step);
- against the JAX package's paired and concat_dis graphs from the same
  weights and batches, at tests/test_paired.py's gates: every loss within
  1e-5, the 0.999 quantile of the parameters' differences within 1e-5 and
  their maximum within 5e-4;
- paired with skip_first_fm and remat trains to finite losses, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_tpu.train import make_train_steps as jax_steps
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                  make_lean_dis_step, make_train_steps)
from tests.test_torch_train_step import state_dicts
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, BATCH = 16, 4


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32))


def tensors(ts) -> dict:
    out = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        out.update({f"{key}.m{i}": t for i, t in enumerate(opt.m)})
        out.update({f"{key}.v{i}": t for i, t in enumerate(opt.v)})
    return out


def port_steps(ts, cfg, A, B, lean=False):
    """One D (the lean one with ``lean``) and one G step; the G step's losses."""
    gen_step, dis_step = make_train_steps(cfg, F32)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    (make_lean_dis_step(cfg, F32) if lean else dis_step)(ts, A, B, 0.01)
    return gen_step(ts, A, B, 0.01)


@pytest.fixture(scope="module")
def plain():
    ts = init_train_state(0, TrainConfig(image_size=SIZE, precision="f32"))
    losses = port_steps(ts, TrainConfig(image_size=SIZE, precision="f32"), *batch())
    return tensors(ts), losses


@pytest.mark.parametrize("fields", [
    {"paired": True}, {"concat_dis": True},
    {"paired": True, "remat": True, "remat_policy": "conv", "remat_dis": True},
    {"paired": True, "remat": True, "remat_policy": "latent", "remat_dis": False},
    {"concat_dis": True, "remat": True, "remat_policy": "full", "remat_dis": True},
    {"paired": True, "lean_dis": True}, {"concat_dis": True, "lean_dis": True}],
    ids=["paired", "concat_dis", "paired-remat-conv", "paired-remat-latent",
         "concat-remat-full", "paired-lean", "concat-lean"])
def test_variant_equals_plain_graph_bit_for_bit(plain, fields):
    cfg = TrainConfig(image_size=SIZE, precision="f32", **fields)
    ts = init_train_state(0, cfg)
    losses = port_steps(ts, cfg, *batch(), lean=cfg.lean_dis)
    want, want_losses = plain
    got = tensors(ts)
    # the lean D step runs the generators twice, not four times: their
    # running statistics take fewer updates
    skip = ("gen_A.", "gen_B.") if cfg.lean_dis else ()
    stat = lambda k: "running" in k or "num_batches" in k  # noqa: E731
    differ = [k for k in want if not (k.startswith(skip) and stat(k))
              and not torch.equal(got[k], want[k])]
    assert differ == []
    assert all(torch.equal(losses[k], want_losses[k]) for k in want_losses)


def gates(port_ts, port_losses, jts, jlosses):
    """tests/test_paired.py's gates between the port's state and losses and
    JAX's."""
    for k, v in jlosses.items():
        assert abs(float(port_losses[k]) - float(v)) < 1e-5, k
    a, b = state_dicts(port_ts), state_dicts(jts)
    diffs = np.concatenate([np.abs(a[k][n] - b[k][n]).ravel() for k in a for n in a[k]
                            if "num_batches" not in n and "running" not in n])
    assert float(np.quantile(diffs, 0.999)) < 1e-5
    assert float(diffs.max()) < 5e-4


@pytest.mark.parametrize("variant", ["paired", "concat_dis"])
def test_variant_matches_jax_graph(variant, monkeypatch):
    monkeypatch.delenv("DISCOGAN_CONCAT_DIS", raising=False)
    A, B = batch()
    jcfg = JaxConfig(image_size=SIZE, precision="f32", **{variant: True})
    jts = jax_init(jax.random.PRNGKey(0), jcfg)
    cfg = TrainConfig(image_size=SIZE, precision="f32", **{variant: True})
    ts = train_state_from_jax(jax.tree.map(np.asarray, jts), cfg)
    jgen, jdis = jax_steps(jcfg, JAX_F32)
    jts, _ = jdis(jts, jnp.asarray(A), jnp.asarray(B), jnp.float32(0.01))
    jts, jlosses = jgen(jts, jnp.asarray(A), jnp.asarray(B), jnp.float32(0.01))
    gates(ts, port_steps(ts, cfg, A, B), jax.tree.map(np.asarray, jts), jlosses)


def test_paired_with_angle_variant_and_remat():
    """paired composes with skip_first_fm and remat (tests/test_paired.py)."""
    A, B = (a[:2] for a in batch(1))
    cfg = TrainConfig(image_size=SIZE, precision="f32", paired=True, skip_first_fm=True,
                      remat=True)
    ts = init_train_state(2, cfg)
    gen_step, dis_step = make_train_steps(cfg, F32)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    dis_step(ts, A, B, 0.9)
    losses = gen_step(ts, A, B, 0.9)
    assert all(torch.isfinite(v) for v in losses.values())


def test_concat_dis_shares_the_weights_only_without_their_gradient(monkeypatch):
    """forward_pair hands the kernels one copy of the weights (pair stride
    0) where no parameter takes a gradient, and one a half where they do."""
    from discogan_modernized_torch.models import discriminator

    seen = []
    real = discriminator.discriminator_weights

    def spy(dises, dtype, shared=False):
        seen.append(shared)
        return real(dises, dtype, shared)

    monkeypatch.setattr(discriminator, "discriminator_weights", spy)
    d = discriminator.Discriminator(SIZE).train()
    x = torch.rand(2, SIZE, SIZE, 3)
    d.forward_pair(x, x)
    d.requires_grad_(False)
    (prob, _), _ = d.forward_pair(x, x)
    assert seen == [False, True] and prob.shape == (2, 1, 1, 1)
