"""The port's angle-pairing trainer against the JAX package's, on the CPU:

- ``skip_first_fm``: the feature-matching losses leave out the first
  discriminator feature (at 32px, where the discriminator has two; at
  16px, with one, they are 0), and one G and one D step's losses and gradients
  match ``jax.grad`` of JAX's graph with skip_first_fm (per tensor,
  max|diff| <= 1e-4 * max(1, max|g|), as tests/test_torch_train_step.py),
  at batch 8, seed 3; at batch 4, seed 7, where the step sits at a
  LeakyReLU's kink, within twice the floor that JAX's own gradients show
  between its fake images and the port's (ROADMAP.md, Queue 3, F7);
- the angle CLI of both packages on a tiny car sweep at 32px, f32, from
  the same weights (the JAX initial state carried into the port and given
  to it through --resume): one car's 20 views, 9 of them in each half's
  training split, at batch 9, so one batch an epoch and both train on the same
  images each iteration (in their own order within the batch). The order
  within a batch moves the sums of the batch statistics by rounding, which
  the steps amplify, so the floor is measured as in
  tests/test_torch_train_step.py: JAX run twice, on two orders (numpy's
  global seed, which its loader draws from), and every logged loss of the
  port lies within max(5e-4, 2 x that spread) of JAX's, plus the 1e-4
  that the log's four decimals can add;
- the log has no FM field (ref angle_pairing.py:350-354), the per-image
  dumps land in numbered subdirectories, and the paths have no style level.
"""

import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from discogan_modernized_tpu.core.precision import F32 as JAX_F32
from discogan_modernized_tpu.models.torch_compat import (
    discriminator_to_state_dict, generator_to_state_dict)
from discogan_modernized_tpu.train import TrainConfig as JaxConfig
from discogan_modernized_tpu.train import graph as jax_graph
from discogan_modernized_tpu.train import init_train_state as jax_init
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.torch_compat import train_state_from_jax
from discogan_modernized_torch.train.checkpoint import save_train_state, train_state_meta
from discogan_modernized_torch.train.graph import discogan_losses
from discogan_modernized_torch.train.step import TrainConfig, loss_and_grads
from tests.torch_threads import one_torch_thread  # noqa: F401

ANGLE_LINE = re.compile(
    r"Iter \[(\d+)/(\d+)\] GEN: (\d+\.\d{4})/(\d+\.\d{4}), "
    r"RECON: (\d+\.\d{4})/(\d+\.\d{4}), DIS: (\d+\.\d{4})/(\d+\.\d{4})$", re.M)
LOSS_TOL = 5e-4
LOG_ROUNDING = 1e-4


def to_sd(name, params, state):
    conv = generator_to_state_dict if name.startswith("gen") else discriminator_to_state_dict
    return {k: np.asarray(v) for k, v in conv(params, state).items()}


def _skip_first_fm_step(which, seed, batch):
    """One G or D step of the port and ``jax.grad`` of JAX's graph with
    skip_first_fm at 32px, f32, from the same state and images. Returns
    (port losses, JAX losses, names, port grads, JAX grads as state dicts,
    JAX's grads given the port's fakes as state dicts): for the last, JAX's
    two generator forwards from the real images take as their values the
    fake images that the port's step made (their gradients stay JAX's own)."""
    jcfg = JaxConfig(image_size=32, precision="f32", skip_first_fm=True)
    cfg = TrainConfig(image_size=32, precision="f32", skip_first_fm=True)
    jts = jax_init(jax.random.PRNGKey(seed), jcfg)
    ts = train_state_from_jax(jax.tree.map(np.asarray, jts), cfg)
    rng = np.random.RandomState(seed)
    A, B = (rng.rand(batch, 32, 32, 3).astype(np.float32) for _ in range(2))
    keys = jax_graph.trainable_subsets("discogan")[0 if which == "gen" else 1]
    frozen = {k: v for k, v in jts["models"].items() if k not in keys}

    made = {}  # generator -> its first output in the port's step: AB, BA

    def keep(g):
        def hook(_module, _inputs, y):
            made.setdefault(g, y.detach().numpy().copy())
        return hook
    hooks = [ts.models[g].register_forward_hook(keep(g)) for g in ("gen_A", "gen_B")]
    losses, grads = loss_and_grads(ts, torch.from_numpy(A), torch.from_numpy(B),
                                   0.9, cfg, F32, which)
    for h in hooks:
        h.remove()
    jax_apply = jax_graph.generator_apply
    fakes = ((A, made["gen_B"]), (B, made["gen_A"]))

    def given_fakes(p, s, x, **kw):
        y, s2 = jax_apply(p, s, x, **kw)
        for real, fake in fakes:
            if x is real:
                y = jax.lax.stop_gradient(fake) + (y - jax.lax.stop_gradient(y))
        return y, s2

    def loss_fn(trainable, skip=True, apply=jax_apply):
        jax_graph.generator_apply = apply
        try:
            losses, _ = jax_graph.discogan_losses({**frozen, **trainable},
                                                  jts["model_states"], A, B,
                                                  policy=JAX_F32, skip_first_fm=skip)
        finally:
            jax_graph.generator_apply = jax_apply
        gen_total, dis_total = jax_graph.mix_losses(losses, 0.9, "discogan")
        return (gen_total if which == "gen" else dis_total), losses

    trainable = {k: jts["models"][k] for k in keys}
    (_, jlosses), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    fed_grads = jax.grad(lambda t: loss_fn(t, apply=given_fakes)[0])(trainable)
    _, full = loss_fn(trainable, skip=False)
    assert float(jlosses["fm_A"]) < float(full["fm_A"])  # a feature left out
    names = [(k, n) for k in keys for n, _ in ts.models[k].named_parameters()]
    sd = lambda g: {k: to_sd(k, g[k], jts["model_states"][k]) for k in keys}  # noqa: E731
    return losses, jlosses, names, grads, sd(jgrads), sd(fed_grads)


def _rel(a, w):
    return float(np.abs(a - w).max()) / max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("which", ["gen", "dis"])
def test_skip_first_fm_step_matches_jax_grad(which):
    losses, jlosses, names, grads, want, _ = _skip_first_fm_step(which, seed=3, batch=8)
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    for (k, n), g in zip(names, grads, strict=True):
        assert _rel(g.numpy(), want[k][n]) <= 1e-4, (k, n)


@pytest.mark.parametrize("which", ["gen", "dis"])
def test_skip_first_fm_step_at_a_kink_within_jax_floor(which):
    """Batch 4, seed 7: one element of dis_B's third feature lies 1.5e-7
    from the LeakyReLU's kink with JAX's fake images, and the port's fakes
    (2.3e-6 away) can put it on the other side, which moves JAX's own
    gradients by up to 5e-3 of max|g| (ROADMAP.md, Queue 3, F7). The floor
    is that move: the spread between JAX's gradients from its own fakes and
    from the port's, max over tensors, as tests/test_torch_train_step.py
    measures a floor; every port gradient lies within max(1e-4, 2 x floor)
    of JAX's, and the losses within 1e-5."""
    losses, jlosses, names, grads, want, fed = _skip_first_fm_step(which, seed=7, batch=4)
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    floor = max(_rel(fed[k][n], want[k][n]) for k, n in names)
    err = {(k, n): _rel(g.numpy(), want[k][n]) for (k, n), g in zip(names, grads, strict=True)}
    print(f"{which}: max |port - JAX| {max(err.values()):.3e}, "
          f"|JAX given the port's fakes - JAX| {floor:.3e}")
    for kn, e in err.items():
        assert e <= max(1e-4, 2 * floor), (kn, e, floor)


@pytest.mark.parametrize("size", [16, 32])
def test_skip_first_fm_leaves_out_the_first_feature(size):
    cfg = TrainConfig(image_size=size, precision="f32")
    ts = train_state_from_jax(jax.tree.map(
        np.asarray, jax_init(jax.random.PRNGKey(1), JaxConfig(image_size=size))), cfg)
    A, B = torch.rand(2, 4, size, size, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = discogan_losses(ts.models, A, B, policy=F32)
        skipped = discogan_losses(ts.models, A, B, policy=F32, skip_first_fm=True)
    assert 0.0 < float(full["fm_A"])
    if size == 16:
        assert float(skipped["fm_A"]) == float(skipped["fm_B"]) == 0.0
    else:
        assert 0.0 < float(skipped["fm_A"]) < float(full["fm_A"])
    assert float(skipped["gen_A"]) == float(full["gen_A"])


@pytest.fixture()
def cars(tmp_path, monkeypatch):
    """One car's sweep at 0, 9, ..., 171 degrees: each half holds 10 views,
    of which 1 is held out, so a batch of 9 is the whole half; the test
    split is the last 2 views."""
    root = tmp_path / "datasets"
    rng = np.random.RandomState(0)
    for az in range(0, 180, 9):
        p = root / "data" / "cars" / f"car_a_{az:03d}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(p)
    monkeypatch.setenv("DISCOGAN_DATASETS_ROOT", str(root))
    return root


ARGV = ["--task_name=car2car", "--model_arch=discogan", "--image_size=32",
        "--batch_size=9", "--epochs=5", "--log_interval=1",
        "--image_save_interval=3", "--model_save_interval=1000", "--n_test=2",
        "--precision=f32", "--seed=3"]


def logged(result_path):
    log = (result_path / "training_log.txt").read_text()
    assert "FM:" not in log
    return {int(m[0]): [float(x) for x in m[2:]] for m in ANGLE_LINE.findall(log)}


def test_angle_cli_matches_jax(cars, tmp_path):
    from discogan_modernized_tpu.cli.angle_pairing import main as jax_main
    from discogan_modernized_torch.cli.angle_pairing import main

    np.random.seed(0)
    jax_result, _ = jax_main([*ARGV, "--steps_per_call=1",
                              f"--results_dir={tmp_path}/jr", f"--models_dir={tmp_path}/jm"])
    np.random.seed(1)
    jax_again, _ = jax_main([*ARGV, "--steps_per_call=1",
                             f"--results_dir={tmp_path}/jr2", f"--models_dir={tmp_path}/jm2"])
    # The JAX trainer's initial state, carried into the port.
    jcfg = JaxConfig(image_size=32, precision="f32", slim_state="mv", skip_first_fm=True)
    cfg = TrainConfig(image_size=32, precision="f32", slim_state="mv", skip_first_fm=True)
    ts = train_state_from_jax(jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jcfg)),
                              cfg)
    save_train_state(tmp_path / "init", ts, 0, train_state_meta(cfg, task="car2car"))
    result, model_path = main([*ARGV, "--device=cpu", f"--resume={tmp_path / 'init'}",
                               f"--results_dir={tmp_path}/r", f"--models_dir={tmp_path}/m"])
    got, want, again = logged(result), logged(jax_result), logged(jax_again)
    assert sorted(got) == sorted(want) == sorted(again) == [0, 1, 2, 3, 4]
    for i in want:
        err = max(abs(a - b) for a, b in zip(got[i], want[i]))
        floor = max(abs(a - b) for a, b in zip(again[i], want[i]))
        print(f"iteration {i}: max |port - JAX| over the logged losses {err:.4f}, "
              f"|JAX other order - JAX| {floor:.4f}")
        assert err <= max(LOSS_TOL, 2 * floor) + LOG_ROUNDING, (i, got[i], want[i])

    # Paths without a style level; dumps of iterations 0 and 3.
    assert result.parts[-3:-1] == ("car2car", "discogan")
    for sub in ("0", "1"):
        assert (result / sub / "0.A.jpg").exists() and (result / sub / "1.BAB.jpg").exists()
        assert not (result / sub / "2.A.jpg").exists()  # --n_test=2
    assert (result / "sample_grids" / "samples_iter_3.png").exists()
    assert (model_path / "gen_B_final.pth").exists()


def test_angle_defaults():
    from discogan_modernized_torch.cli.common import angle_parser

    args = angle_parser().parse_args([])
    assert (args.task_name, args.epochs, args.starting_rate, args.default_rate,
            args.image_save_interval, args.device) == ("car2car", 10, 0.9, 0.9, 500, "cuda")
    assert not hasattr(args, "style_A")


def test_kernel_calls_per_step_at_64px(monkeypatch):
    """Which kernel each call of one 64px D step and one G step at the angle
    trainer's batch takes, counted on the meta device (shapes only): the
    launch counts chip_smoke.py checks on the card (PER_STEP64), and the
    calls per G step of its 64px kernel cases."""
    from collections import Counter

    import chip_smoke
    from discogan_modernized_torch.models.discriminator import Discriminator
    from discogan_modernized_torch.models.generator import Generator
    from discogan_modernized_torch.ops import autograd
    from discogan_modernized_torch.train.step import (TrainState, make_optimizers,
                                                      make_train_steps)

    names = {"conv": "conv_k4s2p1", "halo": "halo_conv_k4s2p1", "stats": "batch_stats",
             "bn_act": "bn_act", "head": "head_convt", "conv_dw": "conv_k4s2p1_dw",
             "halo_dw": "halo_conv_k4s2p1_dw"}
    calls = Counter()
    for name, op in autograd.PLAIN_OPS.items():
        def counted(*args, _name=names[name], _op=op, **kwargs):
            calls[_name] += 1
            return _op(*args, **kwargs)
        monkeypatch.setitem(autograd.KERNEL_OPS, name, counted)
    size, batch = chip_smoke.SIZE64, chip_smoke.BATCH64
    cfg = TrainConfig(image_size=size, precision="bf16", skip_first_fm=True)
    with torch.device("meta"):
        models = {"gen_A": Generator(size), "gen_B": Generator(size),
                  "dis_A": Discriminator(size), "dis_B": Discriminator(size)}
        ts = TrainState({k: m.train() for k, m in models.items()},
                        *make_optimizers(models, cfg))
        A, B = torch.zeros(2, batch, size, size, 3)
    gen_step, dis_step = make_train_steps(cfg)
    for step, kind in ((dis_step, "dis"), (gen_step, "gen")):
        calls.clear()
        step(ts, A, B, 0.9)
        assert dict(calls) == chip_smoke.PER_STEP64[kind]
    cases = Counter()
    for kernel, _, _, path, n in chip_smoke.kernel_cases():
        if path == "train64":
            cases[chip_smoke.KIND_KERNEL.get(kernel, kernel)] += n
    assert dict(cases) == chip_smoke.PER_STEP64["gen"]
