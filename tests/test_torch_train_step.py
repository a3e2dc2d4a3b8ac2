"""The port's train step against the JAX package's, from identical weights
and numpy-seeded data, f32 on the CPU (the kernels' plain versions):

- the gradients of one G step and one D step at 16px, batch 4, against
  ``jax.grad`` of the JAX loss graph (``graph.discogan_losses`` +
  ``mix_losses``) over the same trainable subset: per tensor,
  max|diff| <= 1e-4 * max(1, max|g|);
- the 7-iteration trajectory of tests/test_train_step.py (curriculum
  boundary at 4) against JAX ``make_train_steps``, gated with that test's
  limits: every loss within 5e-4, and the final parameters and running
  statistics of all four networks within mean/p99/max 2e-5/1e-4/1e-3.
  The trajectory is chaotic at the f32 rounding level: a parameter whose
  gradient nearly cancels its weight decay (|g + wd*p| ~ Adam's eps of
  1e-8) takes an update of up to lr whose sign rounding decides. So the
  test also runs the JAX steps op by op and measures how far JAX strays
  from its own jitted run, in the losses and in the final parameters;
  where that exceeds the gate (iterations 5 and 6 on this data: 8.4e-4 and
  9.3e-4), the port must stay within twice it.
  The port against tests/torch_ref.py's loop is printed beside it and not
  gated (ROADMAP F1: JAX and that oracle differ by 5.85e-4 at iteration 5);
- recongan/gan update only their subsets; one slim_state=mv D and G step
  against JAX's; the eval forward after a step uses the new weights.

Run with -s to see the per-iteration differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.models.torch_compat import (
    discriminator_to_state_dict, generator_to_state_dict)
from discogan_modernized_tpu.train import graph as jax_graph
from discogan_modernized_tpu.train import (TrainConfig as JaxConfig,
                                           init_train_state as jax_init,
                                           make_train_steps as jax_steps)
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.discriminator import Discriminator
from discogan_modernized_torch.models.generator import Generator
from discogan_modernized_torch.models.torch_compat import (discriminator_from_jax,
                                                           generator_from_jax)
from discogan_modernized_torch.train.step import (TrainConfig, TrainState,
                                                  loss_and_grads,
                                                  make_optimizers,
                                                  make_train_steps)
from tests.test_train_step import _run_torch_reference, _torch_models_from_state
from tests.torch_threads import one_torch_thread  # noqa: F401

IMAGE_SIZE = 16
BATCH = 4
LOSS_TOL = 5e-4
PARAM_GATES = {"mean": 2e-5, "p99": 1e-4, "max": 1e-3}


def configs(**kw):
    """The same configuration for both packages."""
    return JaxConfig(image_size=IMAGE_SIZE, precision="f32", **kw), \
        TrainConfig(image_size=IMAGE_SIZE, precision="f32", **kw)


def to_sd(name, params, state):
    conv = generator_to_state_dict if name.startswith("gen") else discriminator_to_state_dict
    return {k: np.asarray(v) for k, v in conv(params, state).items()}


def port_state(jts, cfg: TrainConfig) -> TrainState:
    """The JAX train state's networks carried into the port, fresh Adam."""
    models = {}
    for name in ("gen_A", "gen_B", "dis_A", "dis_B"):
        params = jax.tree.map(np.asarray, jts["models"][name])
        state = jax.tree.map(np.asarray, jts["model_states"][name])
        if name.startswith("gen"):
            m, sd = Generator(IMAGE_SIZE), generator_from_jax(params, state)
        else:
            m, sd = Discriminator(IMAGE_SIZE), discriminator_from_jax(params, state)
        m.load_state_dict(sd, strict=True)
        models[name] = m.train()
    return TrainState(models, *make_optimizers(models, cfg))


def data(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32),
             rng.rand(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32))
            for _ in range(n)]


def run_jax(jts, jcfg, batches, *, jit: bool):
    """JAX ``make_train_steps`` over ``batches``: (final state, loss log)."""
    jgen, jdis = jax_steps(jcfg, JAX_F32, jit=jit)
    log = []
    for iters, (A, B) in enumerate(batches):
        step = jdis if jcfg.is_dis_iter(iters) else jgen
        jts, losses = step(jts, jnp.asarray(A), jnp.asarray(B),
                           jnp.float32(jcfg.rate_for(iters)))
        log.append({k: float(v) for k, v in losses.items()})
    return jts, log


def state_dicts(ts) -> dict:
    """name -> reference-layout numpy state dict, of a port or JAX state."""
    if isinstance(ts, TrainState):
        return {k: {n: v.numpy() for n, v in m.state_dict().items()}
                for k, m in ts.models.items()}
    return {k: to_sd(k, ts["models"][k], ts["model_states"][k])
            for k in ts["models"]}


def param_stats(a, b) -> dict:
    """mean/p99/max of |a - b| over every parameter and running statistic."""
    sa, sb = state_dicts(a), state_dicts(b)
    d = np.concatenate([np.abs(sa[k][n] - sb[k][n]).ravel()
                        for k in sa for n in sa[k] if "num_batches" not in n])
    return {"mean": d.mean(), "p99": np.quantile(d, 0.99), "max": d.max()}


def assert_param_gates(stats, where, floor=None):
    """Each stat within its gate, or within twice JAX's own spread."""
    print(f"{where}: final parameters |port - JAX| " + ", ".join(
        f"{k} {v:.3e}" for k, v in stats.items()) + ("" if floor is None else
        "; |JAX op-by-op - JAX| " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in floor.items())))
    for k, v in stats.items():
        limit = PARAM_GATES[k] if floor is None else max(PARAM_GATES[k], 2 * floor[k])
        assert v < limit, (where, k, v, limit)


@pytest.mark.parametrize("which", ["gen", "dis"])
def test_step_gradients_match_jax_grad(which):
    jcfg, cfg = configs(model_arch="discogan")
    jts = jax_init(jax.random.PRNGKey(3), jcfg)
    ts = port_state(jts, cfg)
    (A, B), = data(3, 1)
    rate = 0.01

    keys = jax_graph.trainable_subsets("discogan")[0 if which == "gen" else 1]
    frozen = {k: v for k, v in jts["models"].items() if k not in keys}

    def loss_fn(trainable):
        losses, _ = jax_graph.discogan_losses({**frozen, **trainable},
                                              jts["model_states"], A, B,
                                              policy=JAX_F32)
        gen_total, dis_total = jax_graph.mix_losses(losses, rate, "discogan")
        return (gen_total if which == "gen" else dis_total), losses

    (_, jlosses), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jts["models"][k] for k in keys})
    losses, grads = loss_and_grads(ts, torch.from_numpy(A), torch.from_numpy(B),
                                   rate, cfg, F32, which)
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k

    names = [(k, n) for k in keys for n, _ in ts.models[k].named_parameters()]
    want = {k: to_sd(k, jgrads[k], jts["model_states"][k]) for k in keys}
    assert len(names) == len(grads)
    worst = 0.0
    for (k, n), g in zip(names, grads):
        w = want[k][n]
        err = float(np.abs(g.numpy() - w).max())
        limit = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert err <= limit, (k, n, err, limit)
        worst = max(worst, err / limit)
    print(f"{which} step: {len(names)} gradient tensors, worst max|diff| at "
          f"{worst:.3f} of its limit")


def test_seven_iteration_trajectory():
    """tests/test_train_step.py's run: 16px, batch 4, curriculum boundary
    at 4, D on iterations 0, 3, 6."""
    jcfg, cfg = configs(model_arch="discogan", gan_curriculum=4,
                        starting_rate=0.01, default_rate=0.5)
    jts = jax_init(jax.random.PRNGKey(0), jcfg)
    ts = port_state(jts, cfg)
    ref_models = _torch_models_from_state(jts)
    batches = data(0, 7)

    ref_log = _run_torch_reference(ref_models, batches, jcfg)
    gen_step, dis_step = make_train_steps(cfg, F32)
    port_log = []
    for iters, (A, B) in enumerate(batches):
        step = dis_step if cfg.is_dis_iter(iters) else gen_step
        losses = step(ts, torch.from_numpy(A), torch.from_numpy(B),
                      cfg.rate_for(iters))
        port_log.append({k: float(v) for k, v in losses.items()})
    jts, jax_log = run_jax(jts, jcfg, batches, jit=True)
    jts_eager, jax_eager_log = run_jax(jax_init(jax.random.PRNGKey(0), jcfg),
                                       jcfg, batches, jit=False)

    def spread(a, b):
        return max(abs(a[k] - b[k]) for k in b)

    print("\niter  |port - JAX|  |JAX op-by-op - JAX|  |port - torch_ref|"
          "  (max over the 8 losses)")
    for i, (p, j, e, r) in enumerate(zip(port_log, jax_log, jax_eager_log,
                                         ref_log)):
        print(f"{i:4d}  {spread(p, j):.3e}     {spread(e, j):.3e}"
              f"            {spread(p, r):.3e}")
    for i, (p, j, e) in enumerate(zip(port_log, jax_log, jax_eager_log)):
        limit = max(LOSS_TOL, 2 * spread(e, j))
        for k in j:
            assert abs(p[k] - j[k]) < limit, f"iter {i} {k}: {p[k]} vs {j[k]}"
    assert_param_gates(param_stats(ts, jts), "7 iterations",
                       floor=param_stats(jts_eager, jts))
    ref_sd = ref_models["gen_B"].state_dict()
    d = np.concatenate([np.abs(v.numpy() - ref_sd[k].numpy()).ravel()
                        for k, v in ts.models["gen_B"].state_dict().items()
                        if "num_batches" not in k])
    print(f"gen_B final parameters |port - torch_ref|: mean {d.mean():.3e}, "
          f"p99 {np.quantile(d, 0.99):.3e}, max {d.max():.3e} (not gated)")


@pytest.mark.parametrize("arch", ["recongan", "gan"])
def test_arch_modes_update_their_subsets(arch):
    """gan mode leaves gen_A and dis_A untouched; recongan leaves dis_A."""
    _, cfg = configs(model_arch=arch)
    jts = jax_init(jax.random.PRNGKey(1), configs(model_arch=arch)[0])
    ts = port_state(jts, cfg)
    before = {k: [p.clone() for p in m.parameters()] for k, m in ts.models.items()}
    gen_step, dis_step = make_train_steps(cfg, F32)
    (A, B), = data(1, 1)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    dis_step(ts, A, B, 0.01)
    gen_step(ts, A, B, 0.01)

    def changed(name):
        return any(not torch.equal(a, b) for a, b in
                   zip(before[name], ts.models[name].parameters()))

    assert changed("gen_B") and changed("dis_B")
    assert changed("gen_A") == (arch == "recongan")
    assert not changed("dis_A")


def test_slim_state_mv_step_matches_jax():
    """Adam moments stored in bf16 (math in f32): one D and one G step."""
    jcfg, cfg = configs(model_arch="discogan", slim_state="mv")
    jts = jax_init(jax.random.PRNGKey(2), jcfg)
    ts = port_state(jts, cfg)
    assert all(m.dtype == torch.bfloat16 for m in ts.opt_gen.m + ts.opt_dis.v)
    gen_step, dis_step = make_train_steps(cfg, F32)
    jgen, jdis = jax_steps(jcfg, JAX_F32, jit=True)
    for (A, B), (step, jstep) in zip(data(2, 2), ((dis_step, jdis), (gen_step, jgen))):
        losses = step(ts, torch.from_numpy(A), torch.from_numpy(B), 0.01)
        jts, jl = jstep(jts, jnp.asarray(A), jnp.asarray(B), jnp.float32(0.01))
        for k, v in jl.items():
            assert abs(float(losses[k]) - float(v)) < LOSS_TOL, k
    assert_param_gates(param_stats(ts, jts), "slim mv, D + G step")
    jm = jax.tree.leaves(jts["opt_gen"]["m"])
    assert {str(a.dtype) for a in jm} == {"bfloat16"}


def test_eval_forward_after_a_step_uses_the_new_weights():
    """The eval form's operand cache is re-derived once the optimizer has
    updated the parameters in place."""
    _, cfg = configs(model_arch="discogan")
    ts = port_state(jax_init(jax.random.PRNGKey(5), configs()[0]), cfg)
    gen = ts.models["gen_B"]
    x = torch.rand(2, IMAGE_SIZE, IMAGE_SIZE, 3,
                   generator=torch.Generator().manual_seed(0))
    before = gen.eval()(x)  # fills the cache
    gen_step, _ = make_train_steps(cfg, F32)
    (A, B), = data(5, 1)
    gen.train()
    gen_step(ts, torch.from_numpy(A), torch.from_numpy(B), 0.01)
    fresh = Generator(IMAGE_SIZE)
    fresh.load_state_dict(gen.state_dict(), strict=True)
    after = gen.eval()(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh.eval()(x))


def test_kernel_calls_per_step_at_512px(monkeypatch):
    """Which kernel each call of one 512px D step and one G step takes,
    counted on the meta device (shapes only): the launch counts
    chip_smoke.py checks on the card."""
    from collections import Counter

    from discogan_modernized_torch.ops import autograd

    calls = Counter()
    for name, op in autograd.PLAIN_OPS.items():
        def counted(*args, _name=name, _op=op, **kwargs):
            calls[_name] += 1
            return _op(*args, **kwargs)
        monkeypatch.setitem(autograd.KERNEL_OPS, name, counted)
    cfg = TrainConfig(image_size=512, precision="bf16", slim_state="mv")
    with torch.device("meta"):
        models = {"gen_A": Generator(512), "gen_B": Generator(512),
                  "dis_A": Discriminator(512), "dis_B": Discriminator(512)}
        ts = TrainState({k: m.train() for k, m in models.items()},
                        *make_optimizers(models, cfg))
        A, B = torch.zeros(2, 8, 512, 512, 3)
    gen_step, dis_step = make_train_steps(cfg)
    forward = {"conv": 48, "halo": 8, "stats": 40, "bn_act": 80, "head": 4}
    for step, extra in ((dis_step, {"conv_dw": 24, "halo_dw": 4}),
                        (gen_step, {"conv_dw": 24, "halo_dw": 4, "head": 8})):
        calls.clear()
        step(ts, A, B, 0.01)
        assert dict(calls) == {**forward, **extra}
