"""The port's slim optimizer states against the JAX package's
(tests/test_slim_state.py), on the CPU:

- the state dtypes under off/mv/all equal JAX's: parameters bf16 only under
  all, moments bf16 under mv and all, running statistics f32 and the step
  counters integers in every mode;
- stochastic rounding is unbiased, with tests/test_slim_state.py's point
  (1/4 ulp above 1.0) and limits (share of round-ups within 0.03 of 1/4,
  mean within 5% of an ulp), also below zero and across an exponent
  boundary, with the CPU's generator bits and with the card's hashed bits
  (computed here); the hash in int32 tensor ops equals its uint32 model;
- one Adam update from a JAX state carried across after two steps: under
  all every parameter lies within one bf16 ulp of JAX ``adam_update``'s
  (the two draw other random bits, so they may round the same value to
  different neighbours) and every moment equals JAX's; under off and mv
  the moments equal JAX's and the parameters agree to f32 rounding: within
  one f32 ulp of the result plus 8 f32 epsilons of the update (the two
  compute the update's few f32 operations in other orders);
- four iterations (D, G, G, D) under all from the same state, port against
  JAX: the two packages' rounding bits differ, so the floor is the spread
  between two rounding seeds of the port itself, and the gate is
  max(gate, 2 x floor) with tests/test_torch_train_step.py's gates
  (losses 5e-4; parameters mean/p99/max 2e-5/1e-4/1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.train import (TrainConfig as JaxConfig,
                                           init_train_state as jax_init,
                                           make_train_steps as jax_steps)
from discogan_modernized_tpu.train.optim import adam_update
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import (discriminator_from_jax,
                                                           generator_from_jax,
                                                           train_state_from_jax)
from discogan_modernized_torch.train import optim
from discogan_modernized_torch.train.graph import trainable_subsets
from discogan_modernized_torch.train.optim import (rounding_seed, seed_word,
                                                   stochastic_round_bf16)
from discogan_modernized_torch.train.step import (TrainConfig, init_train_state,
                                                  make_train_steps)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMAGE_SIZE = 16
BATCH = 4
LOSS_TOL = 5e-4
PARAM_GATES = {"mean": 2e-5, "p99": 1e-4, "max": 1e-3}


def configs(slim):
    return (JaxConfig(image_size=IMAGE_SIZE, precision="f32", slim_state=slim),
            TrainConfig(image_size=IMAGE_SIZE, precision="f32", slim_state=slim))


def data(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32),
             rng.rand(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32))
            for _ in range(n)]


def jax_run(jts, jcfg, batches, first_iter=0):
    jgen, jdis = jax_steps(jcfg, JAX_F32, jit=True)
    log = []
    for i, (A, B) in enumerate(batches, start=first_iter):
        step = jdis if jcfg.is_dis_iter(i) else jgen
        jts, losses = step(jts, jnp.asarray(A), jnp.asarray(B),
                           jnp.float32(jcfg.rate_for(i)))
        log.append({k: float(v) for k, v in losses.items()})
    return jts, log


def port_run(ts, cfg, batches, first_iter=0):
    gen_step, dis_step = make_train_steps(cfg, F32)
    log = []
    for i, (A, B) in enumerate(batches, start=first_iter):
        step = dis_step if cfg.is_dis_iter(i) else gen_step
        losses = step(ts, torch.from_numpy(A), torch.from_numpy(B), cfg.rate_for(i))
        log.append({k: float(v) for k, v in losses.items()})
    return log


def carried(slim, steps=2, seed=0):
    """A JAX state after ``steps`` iterations, and the port's copy of it."""
    jcfg, cfg = configs(slim)
    jts, _ = jax_run(jax_init(jax.random.PRNGKey(seed), jcfg), jcfg, data(seed, steps))
    return jts, train_state_from_jax(jax.tree.map(np.asarray, jts), cfg), cfg


def port_order(tree: dict, state: dict, models: dict, keys) -> list:
    """A JAX pytree shaped like the parameters of ``keys`` -> numpy f32
    arrays in the order of the port's parameters."""
    out = []
    for k in keys:
        conv = generator_from_jax if k.startswith("gen") else discriminator_from_jax
        sd = conv(jax.tree.map(lambda a: np.asarray(a, np.float32), tree[k]), state[k])
        out += [sd[n].numpy() for n, _ in models[k].named_parameters()]
    return out


def bf16_ulp(a):
    """The spacing of bf16 at |a| (its exponent's ulp)."""
    a = np.abs(np.asarray(a, np.float32))
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7).astype(np.float32)


@pytest.mark.parametrize("slim", ["off", "mv", "all"])
def test_state_dtypes_match_jax(slim):
    jcfg, cfg = configs(slim)
    jts = jax_init(jax.random.PRNGKey(0), jcfg)
    ts = init_train_state(0, cfg)
    want_p = {str(a.dtype) for a in jax.tree.leaves(jts["models"])}
    want_m = {str(a.dtype) for a in jax.tree.leaves(jts["opt_gen"]["m"])}
    got_p = {str(p.dtype).removeprefix("torch.")
             for m in ts.models.values() for p in m.parameters()}
    got_m = {str(t.dtype).removeprefix("torch.") for opt in (ts.opt_gen, ts.opt_dis)
             for t in opt.m + opt.v}
    assert got_p == want_p == ({"bfloat16"} if slim == "all" else {"float32"})
    assert got_m == want_m == ({"float32"} if slim == "off" else {"bfloat16"})
    for m in ts.models.values():
        for name, b in m.named_buffers():
            want = torch.int64 if name.endswith("num_batches_tracked") else torch.float32
            assert b.dtype == want, (slim, name)
    assert all(str(a.dtype) == "float32" for a in jax.tree.leaves(jts["model_states"])
               if jnp.issubdtype(a.dtype, jnp.floating))


@pytest.mark.parametrize("lo,frac", [(1.0, 0.25), (-1.0, 0.25), (1.0, 0.75),
                                     (2.0 - 2.0 ** -7, 0.75)],
                         ids=["quarter", "negative", "three_quarters", "exponent"])
def test_stochastic_round_unbiased(lo, frac):
    """x sits ``frac`` of an ulp (2^-7 in [1, 2)) away from ``lo``, toward
    larger magnitude: it rounds away from lo with probability ``frac``, and
    the mean recovers x. 4096 draws of 4 values, each draw seeded as the
    optimizer seeds a step."""
    ulp = 2.0 ** -7
    hi = lo + np.sign(lo) * ulp
    x = np.float32(lo + (hi - lo) * frac)
    vals = torch.cat([stochastic_round_bf16(
        torch.full((4,), float(x)), seed_word(rounding_seed(step, 3)))
        for step in range(1, 4097)]).float().numpy()
    assert set(np.unique(vals)) <= {np.float32(lo), np.float32(hi)}
    frac_hi = float((vals == np.float32(hi)).mean())
    assert abs(frac_hi - frac) < 0.03
    assert abs(vals.mean() - x) < ulp * 0.05
    if frac == 0.25:  # round-to-nearest, the stall this replaces, stays at lo
        assert float(torch.tensor(float(x)).to(torch.bfloat16)) == lo


def test_rounding_bits_are_stateless():
    """The same (step, index) draws the same bits whatever ran before, as a
    Python int or as a tensor of one value; other steps and indices draw
    others."""
    x = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    a = stochastic_round_bf16(x, seed_word(rounding_seed(5, 2)))
    stochastic_round_bf16(x, seed_word(rounding_seed(7, 1)))  # another draw between
    b = stochastic_round_bf16(x, torch.tensor(seed_word(rounding_seed(5, 2)),
                                              dtype=torch.int32))
    assert torch.equal(a, b)
    for step, index in ((6, 2), (5, 3)):
        c = stochastic_round_bf16(x, seed_word(rounding_seed(step, index)))
        assert not torch.equal(a, c)


@pytest.mark.parametrize("lo,frac", [(1.0, 0.25), (-1.0, 0.25), (1.0, 0.75),
                                     (2.0 - 2.0 ** -7, 0.75)],
                         ids=["quarter", "negative", "three_quarters", "exponent"])
def test_card_rounding_bits_are_unbiased(lo, frac):
    """The card's bits (``rounding_bits``, run here on the CPU) at the
    points and limits of ``test_stochastic_round_unbiased``: 4096 draws of
    4 values, each seeded as the optimizer seeds a step."""
    ulp = 2.0 ** -7
    hi = lo + np.sign(lo) * ulp
    x = np.float32(lo + (hi - lo) * frac)
    word = torch.full((4,), float(x)).view(torch.int32)
    vals = torch.cat([((word + optim.rounding_bits(4, seed_word(rounding_seed(step, 3)), "cpu"))
                       & -65536).view(torch.float32)
                      for step in range(1, 4097)]).numpy()
    assert set(np.unique(vals)) <= {np.float32(lo), np.float32(hi)}
    assert abs(float((vals == np.float32(hi)).mean()) - frac) < 0.03
    assert abs(vals.mean() - x) < ulp * 0.05


@pytest.mark.parametrize("step,index", [(1, 0), (5, 2), (1000, 77)])
def test_rounding_bits_match_their_uint32_model(step, index):
    """``rounding_bits`` in int32 tensor ops equals murmur3's finalizer of
    e * golden + seed in uint32 arithmetic (numpy), top 16 bits."""
    seed = seed_word(rounding_seed(step, index))
    h = (np.arange(50000, dtype=np.uint64) * 0x9E3779B1 + (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
        h ^= h >> shift
        if mul is not None:
            h = (h * mul) & 0xFFFFFFFF
    got = optim.rounding_bits(50000, seed, "cpu").numpy()
    np.testing.assert_array_equal(got, (h >> 16).astype(np.int32))


@pytest.mark.parametrize("slim", ["off", "mv", "all"])
def test_one_adam_update_against_jax(slim):
    jts, ts, cfg = carried(slim)
    rng = np.random.RandomState(11)
    keys = trainable_subsets(cfg.model_arch)[0]
    params = {k: jts["models"][k] for k in keys}
    # The gradients arrive in the parameters' dtype, as on both sides.
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 1e-2,
                              p.dtype), params)
    new_p, new_opt = adam_update(params, grads, jts["opt_gen"], lr=cfg.learning_rate,
                                 beta1=cfg.beta1, beta2=cfg.beta2,
                                 weight_decay=cfg.weight_decay)
    dtype = torch.bfloat16 if slim == "all" else torch.float32
    old_p = [p.detach().float().numpy().copy() for p in ts.opt_gen.params]
    ts.opt_gen.update([torch.from_numpy(g).to(dtype) for g in
                       port_order(grads, jts["model_states"], ts.models, keys)])
    state = jts["model_states"]
    want_p = port_order(new_p, state, ts.models, keys)
    got_p = [p.detach().float().numpy() for p in ts.opt_gen.params]
    worst = 0.0
    eps = np.finfo(np.float32).eps
    for got, want, old in zip(got_p, want_p, old_p, strict=True):
        ulp = (bf16_ulp(np.maximum(np.abs(got), np.abs(want))) if slim == "all"
               else np.spacing(np.abs(want)) + 8 * eps * np.abs(old - want))
        ratio = float((np.abs(got - want) / ulp).max())
        assert ratio <= 1.0, (slim, ratio)
        worst = max(worst, ratio)
    for part in ("m", "v"):
        want = port_order(new_opt[part], state, ts.models, keys)
        got = [t.float().numpy() for t in getattr(ts.opt_gen, part)]
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    assert ts.opt_gen.step == int(new_opt["step"])
    changed = np.mean([float((g != w).mean()) for g, w in zip(got_p, want_p)])
    print(f"slim {slim}: worst |port - JAX| {worst:.2f} of its limit, share of parameters "
          f"that differ {changed:.4f}")


def test_all_iterations_against_jax(monkeypatch):
    """Four iterations under all, from a state carried across after two."""
    jcfg, cfg = configs("all")
    jts, ts, _ = carried("all", steps=2, seed=4)
    batches = data(40, 4)
    jts_end, jlog = jax_run(jts, jcfg, batches, first_iter=2)
    _, ts_b, _ = carried("all", steps=2, seed=4)
    log_a = port_run(ts, cfg, batches, first_iter=2)
    monkeypatch.setattr(optim, "_SEED_BASE", 0xBEEF)
    log_b = port_run(ts_b, cfg, batches, first_iter=2)

    def params(x):
        if isinstance(x, dict):
            return np.concatenate([
                np.concatenate([a.ravel() for a in port_order(
                    x["models"], x["model_states"], ts.models, (k,))])
                for k in ts.models])
        return np.concatenate([p.detach().float().numpy().ravel()
                               for k in ts.models for p in x.models[k].parameters()])

    def stats(a, b):
        d = np.abs(params(a) - params(b))
        return {"mean": d.mean(), "p99": np.quantile(d, 0.99), "max": d.max()}

    for i, (a, b, j) in enumerate(zip(log_a, log_b, jlog), start=2):
        floor = max(abs(a[k] - b[k]) for k in j)
        err = max(abs(a[k] - j[k]) for k in j)
        print(f"iteration {i}: |port - JAX| {err:.3e}, |port seed a - port seed b| "
              f"{floor:.3e}")
        assert err < max(LOSS_TOL, 2 * floor), (i, err, floor)
    got, floor = stats(ts, jts_end), stats(ts, ts_b)
    print("parameters |port - JAX| " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
          + "; |seed a - seed b| " + ", ".join(f"{k} {v:.3e}" for k, v in floor.items()))
    for k, v in got.items():
        assert v < max(PARAM_GATES[k], 2 * floor[k]), (k, v, floor[k])


@pytest.mark.parametrize("slim", ["off", "all"])
def test_train_state_from_jax_npz_equals_from_pytree(slim, tmp_path):
    """The JAX package's train_state.npz, read with numpy alone, carries
    the same state across as its pytree: parameters in the slim state's
    dtype, running statistics, both Adam states and their steps."""
    from discogan_modernized_tpu.train.checkpoint import save_train_state as jax_save
    from discogan_modernized_torch.models.torch_compat import read_jax_train_state_npz

    jts, ts, cfg = carried(slim, steps=2, seed=6)
    jax_save(tmp_path, jts, 2)
    from_npz = train_state_from_jax(
        read_jax_train_state_npz(tmp_path / "train_state.npz", IMAGE_SIZE, "discogan"), cfg)
    for name, m in ts.models.items():
        for (k, a), b in zip(m.state_dict().items(), from_npz.models[name].state_dict().values()):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)
    for a, b in ((ts.opt_gen, from_npz.opt_gen), (ts.opt_dis, from_npz.opt_dis)):
        assert a.step == b.step == int(jts["opt_gen"]["step"] if a is ts.opt_gen
                                       else jts["opt_dis"]["step"])
        for x, y in zip(a.m + a.v, b.m + b.v, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for arch, size in (("gan", IMAGE_SIZE), ("discogan", 2 * IMAGE_SIZE)):
        with pytest.raises(ValueError, match="leaves, not those of"):
            read_jax_train_state_npz(tmp_path / "train_state.npz", size, arch)
