"""The port's networks in their train and eval forms against the JAX
package's ``generator_apply`` / ``discriminator_apply``.

Weights come from the JAX package's init, with numpy-seeded random BN
parameters and running statistics (the defaults would hide a mean/var or
gamma/beta swap), carried across by ``generator_from_jax`` /
``discriminator_from_jax``. f32 on the CPU, where each kernel's plain
version runs; tolerance 1e-4 (f32 accumulation order), as for the eval
generator.
"""

import numpy as np
import pytest
import torch

import jax

from discogan_modernized_tpu.models.discriminator import (discriminator_apply,
                                                          discriminator_init)
from discogan_modernized_tpu.models.generator import generator_apply
from discogan_modernized_tpu.models.torch_compat import discriminator_to_state_dict
from discogan_modernized_torch.core.precision import F32
from discogan_modernized_torch.models.discriminator import Discriminator
from discogan_modernized_torch.models.generator import Generator
from discogan_modernized_torch.models.torch_compat import (discriminator_from_jax,
                                                           generator_from_jax)
from tests.test_torch_generator import jax_generator
from tests.torch_ref import RefDiscriminator
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def random_bn(params, state, rng, key):
    """Random gamma/beta and running statistics in every BN of a
    (params, state) pair whose layers sit in ``params[key]``."""
    for layer, st in zip(params[key], state[key]):
        if "bn" not in layer:
            continue
        c = np.asarray(layer["bn"]["scale"]).shape[0]
        layer["bn"] = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
                       "bias": (rng.randn(c) * 0.1).astype(np.float32)}
        st.update(mean=(rng.randn(c) * 0.1).astype(np.float32),
                  var=(rng.rand(c) + 0.5).astype(np.float32),
                  count=np.asarray(3, np.int32))
    return params, state


def jax_discriminator(image_size, seed=0):
    params, state = discriminator_init(jax.random.PRNGKey(seed), image_size)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    return random_bn(params, state, np.random.RandomState(seed), "trunk")


def assert_bn_state(module, sd_want):
    for k, v in module.state_dict().items():
        if "running" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), np.asarray(sd_want[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("image_size", [16, 32])
def test_discriminator_matches_jax(image_size, training):
    params, state = jax_discriminator(image_size, seed=image_size)
    x = np.random.RandomState(1).rand(3, image_size, image_size, 3).astype(
        np.float32)
    (prob, feats), new_state = discriminator_apply(params, state, x,
                                                   training=training)
    dis = Discriminator(image_size)
    dis.load_state_dict(discriminator_from_jax(params, state), strict=True)
    dis.train(training)
    p, pf = dis(torch.from_numpy(x), policy=F32)
    assert p.shape == (3, 1, 1, 1) and p.dtype == torch.float32
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(prob), **TOL)
    assert len(pf) == len(feats) == np.log2(image_size) - 3
    for a, b in zip(pf, feats):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    assert_bn_state(dis, discriminator_to_state_dict(params, new_state))


def test_discriminator_layout_is_the_reference():
    params, state = jax_discriminator(32, seed=4)
    sd = discriminator_from_jax(params, state)
    RefDiscriminator(32).load_state_dict(sd, strict=True)
    RefDiscriminator(16).load_state_dict(Discriminator(16).state_dict(),
                                         strict=True)
    with torch.device("meta"):
        keys = set(Discriminator(512).state_dict())
    assert keys == set(RefDiscriminator(512).state_dict())
    assert {"conv8.weight", "bn7.running_var"} <= keys and "bn1.weight" not in keys


@pytest.mark.parametrize("image_size", [16, 32])
def test_generator_train_form_matches_jax(image_size):
    """Output and the advanced running statistics of one train-mode
    forward."""
    from discogan_modernized_tpu.models.torch_compat import generator_to_state_dict

    params, state = jax_generator(image_size, seed=image_size)
    x = np.random.RandomState(2).rand(3, image_size, image_size, 3).astype(
        np.float32)
    want, new_state = generator_apply(params, state, x, training=True)
    gen = Generator(image_size)
    gen.load_state_dict(generator_from_jax(params, state), strict=True)
    y = gen.train()(torch.from_numpy(x), policy=F32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    assert_bn_state(gen, generator_to_state_dict(params, new_state))


def test_train_and_eval_forms_agree_on_a_calibrated_batch():
    """With running statistics equal to the batch's own (momentum 1, and
    var turned back into the biased one), the eval form
    reproduces the train form: the folded epilogues and K2 compute the same
    normalization."""
    torch.manual_seed(0)
    gen = Generator(32, generator=torch.Generator().manual_seed(1))
    x = torch.rand(4, 32, 32, 3)
    bns = [m for m in gen.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        y_train = gen.train()(x)
    # the running var is the unbiased one; turn it back into the biased
    # variance the batch normalized with
    for bn, n in zip(bns, _bn_counts(gen, 4)):
        with torch.no_grad():
            bn.running_var.mul_((n - 1) / n)
    np.testing.assert_allclose(gen.eval()(x).numpy(), y_train.numpy(), **TOL)


def _bn_counts(gen, batch):
    """Values per channel each BN of a 32px generator normalizes, in module
    order (encoder enc1.., latent, decoder dec0..)."""
    enc = [batch * 8 * 8, batch * 4 * 4]       # enc1 (8x8), enc2 (4x4)
    return enc + [batch] + [batch * 4 * 4, batch * 8 * 8, batch * 16 * 16]
