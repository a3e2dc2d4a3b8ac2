"""The port's eval-mode Generator against the JAX package's
``generator_apply(training=False)`` and the torch reference model.

Weights come from JAX ``generator_init`` with numpy-seeded random running
statistics (the default 0/1 statistics would hide a mean/var swap in the
BN fold), carried across by ``generator_from_jax``. f32 on the CPU, where
each kernel's plain version runs; tolerance 1e-4 (f32 accumulation order).
"""

import numpy as np
import pytest
import torch

import jax

from discogan_modernized_tpu.models.generator import (generator_apply,
                                                      generator_init)
from discogan_modernized_tpu.models.torch_compat import generator_to_state_dict
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.generator import Generator
from discogan_modernized_torch.models.torch_compat import generator_from_jax
from tests.torch_ref import RefGenerator
from tests.torch_threads import one_torch_thread  # noqa: F401


def random_stats(state, rng):
    """The same BN state pytree with random running means and variances."""
    def one(st):
        if not st:
            return st
        c = np.asarray(st["mean"]).shape[0]
        return {"mean": rng.randn(c).astype(np.float32) * 0.1,
                "var": (rng.rand(c) + 0.5).astype(np.float32),
                "count": np.asarray(7, np.int32)}
    return {"encoder": [one(s) for s in state["encoder"]],
            "latent": one(state["latent"]),
            "decoder": [one(s) for s in state["decoder"]]}


def jax_generator(image_size, seed=0):
    params, state = generator_init(jax.random.PRNGKey(seed), image_size)
    params = jax.tree.map(np.asarray, params)
    return params, random_stats(state, np.random.RandomState(seed))


@pytest.mark.parametrize("image_size", [32, 64])
def test_eval_forward_matches_jax(image_size):
    params, state = jax_generator(image_size)
    x = np.random.RandomState(1).rand(2, image_size, image_size, 3).astype(
        np.float32)
    want, _ = generator_apply(params, state, x, training=False)

    gen = Generator(image_size)
    gen.load_state_dict(generator_from_jax(params, state), strict=True)
    buffers = {k: v.clone() for k, v in gen.state_dict().items()}
    y = gen(torch.from_numpy(x), policy=F32)

    assert y.dtype == torch.float32 and y.shape == (2, image_size, image_size, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for k, v in gen.state_dict().items():  # eval leaves BN buffers alone
        assert torch.equal(v, buffers[k]), k


def test_plain_and_kernel_routes_agree_on_cpu():
    """On the CPU every wrapper takes its plain version, so both routes of
    the forward are the same computation."""
    gen = Generator(32, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(gen(x), gen(x, plain=True))


@pytest.mark.parametrize("size,want", [
    (512, {"conv": 6, "halo": 1, "bn_act": 8, "head": 1}),
    (256, {"conv": 5, "halo": 1, "bn_act": 7, "head": 1}),
    (64, {"conv": 4, "bn_act": 5, "head": 1}),    # no layer wide enough for K5f
])
def test_kernel_calls_per_forward(size, want, monkeypatch):
    """Which kernel each layer takes, counted on the meta device (shapes
    only, no arithmetic): at 512px 6 K3, 1 K5f, 8 K2 and 1 K6."""
    from collections import Counter

    from discogan_modernized_torch.core.precision import BF16
    from discogan_modernized_torch.models import generator as G

    calls = Counter()

    def recorder(name):
        def op(*args, **kwargs):
            calls[name] += 1
            return G.PLAIN_OPS[name](*args, **kwargs)
        return op

    monkeypatch.setattr(G, "SERVING_OPS", {n: recorder(n) for n in G.PLAIN_OPS})
    with torch.device("meta"):
        y = Generator(size)(torch.zeros(4, size, size, 3), policy=BF16)
    assert y.shape == (4, size, size, 3) and y.dtype == torch.float32
    assert dict(calls) == want


def test_train_mode_forward_is_refused():
    """A single image: the 1x1 latent's BatchNorm would see one value per
    channel, which the train form refuses as nn.BatchNorm2d does."""
    gen = Generator(16).train()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        gen(torch.zeros(1, 16, 16, 3))


def test_512px_keys_equal_jax_export():
    params, state = generator_init(jax.random.PRNGKey(0), 512)
    want = generator_to_state_dict(params, state)
    with torch.device("meta"):
        assert set(Generator(512).state_dict()) == set(want)


def test_from_jax_loads_into_reference_model():
    params, state = jax_generator(64, seed=3)
    ref = RefGenerator(64)
    ref.load_state_dict(generator_from_jax(params, state), strict=True)


def test_saved_pth_loads_into_reference_model(tmp_path):
    params, state = jax_generator(64, seed=2)
    gen = Generator(64)
    gen.load_state_dict(generator_from_jax(params, state), strict=True)
    torch.save(gen.state_dict(), tmp_path / "gen_B_final.pth")

    ref = RefGenerator(64).eval()
    ref.load_state_dict(torch.load(tmp_path / "gen_B_final.pth",
                                   weights_only=True), strict=True)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(gen(x).numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_jax_pth_loads_into_port(tmp_path):
    """A .pth written the JAX package's way (generator_to_state_dict +
    torch.save) loads strict into the port."""
    from discogan_modernized_torch.train.checkpoint import load_reference_weights

    params, state = jax_generator(32, seed=5)
    sd = generator_to_state_dict(params, state)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / "gen_A_final.pth")
    gen = load_reference_weights(tmp_path / "gen_A_final.pth", 32)
    x = np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32)
    want, _ = generator_apply(params, state, x, training=False)
    np.testing.assert_allclose(gen(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)
