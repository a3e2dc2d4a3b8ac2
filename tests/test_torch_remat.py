"""Rematerialized forwards (``remat`` / ``remat_policy`` / ``remat_dis``,
train/graph.py's ``_checkpoint_policies``, models/regions.py) on the CPU,
f32, 16px, batch 4:

- for each policy, with the discriminators' regions on and off, one D and
  two G steps under remat equal remat off bit for bit in every gradient,
  parameter, running statistic and ``num_batches_tracked``: the test that
  catches a rebuilt forward advancing the running statistics twice;
- the regions really rebuild: "full" and "latent" run every layer again,
  "conv" only the BatchNorm chains (K1, K2) and no convolution;
- the auto rule (``resolve_remat``) as a plain function of the free memory
  it is given;
- the remat step's gradients against ``jax.grad`` of the JAX package's
  remat graph, at tests/test_torch_train_step.py's gate: per tensor
  max|diff| <= 1e-4 * max(1, max|g|).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import graph as jax_graph
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.ops import autograd
from discogan_modernized_torch.train.step import (REMAT_MARGIN, TrainConfig,
                                                  estimate_step_bytes, init_train_state,
                                                  loss_and_grads, resolve_remat)
from tests.test_torch_train_step import to_sd
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE, BATCH = 16, 4
GIB = 2 ** 30


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32))
            for _ in range(2)]


def run(cfg):
    """One D and two G steps: every gradient, then every tensor of the state."""
    ts = init_train_state(0, cfg)
    A, B = batch()
    grads = []
    for which in ("dis", "gen", "gen"):
        _, g = loss_and_grads(ts, A, B, 0.01, cfg, F32, which)
        grads += list(g)
        (ts.opt_gen if which == "gen" else ts.opt_dis).update(g)
    state = {f"{k}.{n}": t for k, m in ts.models.items() for n, t in m.state_dict().items()}
    for key, opt in (("opt_gen", ts.opt_gen), ("opt_dis", ts.opt_dis)):
        state.update({f"{key}.m{i}": t for i, t in enumerate(opt.m)})
        state.update({f"{key}.v{i}": t for i, t in enumerate(opt.v)})
    return grads, state


@pytest.fixture(scope="module")
def plain_run():
    return run(TrainConfig(image_size=SIZE, precision="f32", remat=False))


@pytest.mark.parametrize("remat_dis", [True, False], ids=["dis_on", "dis_off"])
@pytest.mark.parametrize("policy", ["full", "latent", "conv"])
def test_remat_equals_remat_off_bit_for_bit(plain_run, policy, remat_dis):
    cfg = TrainConfig(image_size=SIZE, precision="f32", remat=True, remat_policy=policy,
                      remat_dis=remat_dis)
    grads, state = run(cfg)
    want_grads, want_state = plain_run
    assert len(grads) == len(want_grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert [k for k in want_state if not torch.equal(state[k], want_state[k])] == []
    assert int(state["gen_A.encoder.3.num_batches_tracked"]) == 3 * 2


@pytest.mark.parametrize("policy,rebuilt", [
    ("full", {"conv", "bn_act", "stats", "head"}),
    ("latent", {"conv", "bn_act", "stats", "head"}),
    ("conv", {"bn_act", "stats"})])
def test_regions_rebuild_what_their_policy_says(monkeypatch, policy, rebuilt):
    """The ops' calls in one G step under remat, less those without it: the
    rebuilt layers' (every one for "full" and "latent"; the BatchNorm
    chains alone for "conv", whose convolutions hand back their outputs)."""
    calls = {}
    for key, fn in list(autograd.PLAIN_OPS.items()):
        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setitem(autograd.PLAIN_OPS, key, counted)
    A, B = batch()
    counts = {}
    for remat in (False, True):
        cfg = TrainConfig(image_size=SIZE, precision="f32", remat=remat,
                          remat_policy=policy, remat_dis=True)
        ts = init_train_state(0, cfg)
        calls.clear()
        loss_and_grads(ts, A, B, 0.01, cfg, F32, "gen", plain=True)
        counts[remat] = dict(calls)
    more = {k for k in counts[True] if counts[True][k] > counts[False].get(k, 0)}
    assert more == rebuilt, (counts[False], counts[True])


def test_auto_rule_is_a_function_of_the_free_memory():
    cfg = TrainConfig(image_size=512, slim_state="mv")
    need = estimate_step_bytes(512, 64, 2, "mv")
    # no card: off, and says so
    off, line = resolve_remat(cfg, 64, "cpu")
    assert off.remat is False and off.remat_dis is False and "no card" in line
    # room to spare: off
    roomy, line = resolve_remat(cfg, 64, "cpu", free_bytes=2 * need)
    assert roomy.remat is False and "remat: off (auto)" in line
    assert f"{need / GIB:.2f} GiB without remat" in line
    # the estimate passes the free memory less the margin: on; the
    # discriminators only where the step does not fit with theirs kept
    free = int(need / (1 - REMAT_MARGIN)) - 1
    on, line = resolve_remat(cfg, 64, "cpu", free_bytes=free)
    assert on.remat is True and "remat: on (auto)" in line
    with_dis_kept = estimate_step_bytes(512, 64, 2, "mv", True, None, False)
    assert on.remat_dis == (with_dis_kept > free * (1 - REMAT_MARGIN))
    tight, _ = resolve_remat(cfg, 64, "cpu", free_bytes=int(with_dis_kept * 0.5))
    assert tight.remat is True and tight.remat_dis is True
    # an explicit setting stands
    for remat in (True, False):
        got, line = resolve_remat(dataclasses.replace(cfg, remat=remat), 64, "cpu",
                                  free_bytes=free)
        assert got.remat is remat and "(set" in line
    with pytest.raises(ValueError):
        resolve_remat(dataclasses.replace(cfg, remat_policy="layer"), 8, "cpu")


def test_estimate_orders_the_policies():
    """More batch, more memory; each policy keeps less than none, "latent"
    (which rebuilds half a generator at a time) least; the estimate at
    512px batch 8 lies within 10% of the card's measured 12.74 GiB under
    slim state mv."""
    for b in (8, 64):
        none = estimate_step_bytes(512, b, 2, "mv")
        full, latent, conv = (estimate_step_bytes(512, b, 2, "mv", True, p)
                              for p in ("full", "latent", "conv"))
        assert latent <= full < conv < none
    assert estimate_step_bytes(512, 64, 2, "mv") > estimate_step_bytes(512, 8, 2, "mv")
    assert abs(estimate_step_bytes(512, 8, 2, "mv") / GIB - 12.74) < 0.1 * 12.74


@pytest.mark.parametrize("policy", ["full", "latent", "conv"])
@pytest.mark.parametrize("which", ["gen", "dis"])
def test_remat_gradients_match_jax_remat_grad(policy, which):
    jcfg = JaxConfig(image_size=SIZE, precision="f32")
    cfg = TrainConfig(image_size=SIZE, precision="f32", remat=True, remat_policy=policy,
                      remat_dis=True)
    jts = jax_init(jax.random.PRNGKey(3), jcfg)
    ts = train_state_from_jax(jax.tree.map(np.asarray, jts), cfg)
    A, B = (t.numpy() for t in batch(3))
    keys = jax_graph.trainable_subsets("discogan")[0 if which == "gen" else 1]
    frozen = {k: v for k, v in jts["models"].items() if k not in keys}

    def loss_fn(trainable):
        losses, _ = jax_graph.discogan_losses(
            {**frozen, **trainable}, jts["model_states"], A, B, policy=JAX_F32, remat=True,
            remat_policy=None if policy == "full" else policy, remat_dis=True)
        gen_total, dis_total = jax_graph.mix_losses(losses, 0.01, "discogan")
        return gen_total if which == "gen" else dis_total

    jgrads = jax.grad(loss_fn)({k: jts["models"][k] for k in keys})
    _, grads = loss_and_grads(ts, torch.from_numpy(A), torch.from_numpy(B), 0.01, cfg, F32,
                              which)
    names = [(k, n) for k in keys for n, _ in ts.models[k].named_parameters()]
    want = {k: to_sd(k, jgrads[k], jts["model_states"][k]) for k in keys}
    assert len(names) == len(grads)
    for (k, n), g in zip(names, grads):
        w = want[k][n]
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(1.0, float(np.abs(w).max()))
