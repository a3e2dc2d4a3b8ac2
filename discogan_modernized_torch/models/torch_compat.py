"""The reference's ``.pth`` layouts, and weights and train states carried
across from the JAX package.

The reference checkpoints raw ``state_dict()``s (ref
image_translation.py:419-432): the generator's nn.Sequential indices are
encoder.[0] = conv, [1] = LeakyReLU, then (conv, bn, lrelu) groups up to the
latent conv; decoder (convT, bn, relu) groups, then convT + Sigmoid (ref
model.py:79-212). ``Generator`` is built in that layout, so its own
``state_dict`` is the reference's. ``generator_from_jax`` maps the JAX
package's numpy pytrees (params, state) to it, and ``discriminator_from_jax``
does the same for the discriminator, whose reference layout is attributes
conv1..conv{n+1} and bn2..bn{n} (ref model.py:5-36; ``Discriminator``):

- conv weight: HWIO -> (O,I,kh,kw) by transpose(3,2,0,1);
- convT weight: HWIO -> (I,O,kh,kw) by transpose(2,3,0,1);
- BN: weight, bias, running_mean, running_var, num_batches_tracked.

``train_state_from_jax`` carries a whole JAX train state (the four
networks, their running statistics, both Adam states with their step
counts) into the port's ``TrainState``, in the dtypes of the port's slim
state; ``read_jax_train_state_npz`` reads the JAX package's
``train_state.npz`` into that pytree with numpy alone, from the structure
of JAX's ``init_train_state`` (dicts flattened in sorted key order, as
``jax.tree.flatten`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import encoder_channels
from .generator import enc_bn_index, enc_conv_index


def _t(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _bn(sd: dict, prefix: str, bn_params: dict, bn_state: dict) -> None:
    sd[f"{prefix}.weight"] = _t(bn_params["scale"])
    sd[f"{prefix}.bias"] = _t(bn_params["bias"])
    sd[f"{prefix}.running_mean"] = _t(bn_state["mean"])
    sd[f"{prefix}.running_var"] = _t(bn_state["var"])
    sd[f"{prefix}.num_batches_tracked"] = _t(bn_state["count"], np.int64)


def generator_from_jax(params: dict, state: dict) -> dict:
    """The JAX package's generator (params, state), as numpy-convertible
    pytrees, -> a reference-layout state dict of torch tensors."""
    sd: dict = {}
    enc = params["encoder"]
    for i, layer in enumerate(enc):
        sd[f"encoder.{enc_conv_index(i)}.weight"] = _t(
            np.asarray(layer["w"]).transpose(3, 2, 0, 1))
        if "bn" in layer:
            _bn(sd, f"encoder.{enc_bn_index(i)}", layer["bn"],
                state["encoder"][i])
    li = len(enc)
    sd[f"encoder.{enc_conv_index(li)}.weight"] = _t(
        np.asarray(params["latent"]["w"]).transpose(3, 2, 0, 1))
    _bn(sd, f"encoder.{enc_bn_index(li)}", params["latent"]["bn"],
        state["latent"])
    for j, layer in enumerate(params["decoder"]):
        sd[f"decoder.{3 * j}.weight"] = _t(
            np.asarray(layer["w"]).transpose(2, 3, 0, 1))
        if "bn" in layer:
            _bn(sd, f"decoder.{3 * j + 1}", layer["bn"], state["decoder"][j])
    return sd


def discriminator_from_jax(params: dict, state: dict) -> dict:
    """The JAX package's discriminator (params, state) -> a reference-layout
    state dict of torch tensors."""
    sd: dict = {}
    trunk = params["trunk"]
    for i, layer in enumerate(trunk):
        sd[f"conv{i + 1}.weight"] = _t(np.asarray(layer["w"]).transpose(3, 2, 0, 1))
        if "bn" in layer:
            _bn(sd, f"bn{i + 1}", layer["bn"], state["trunk"][i])
    sd[f"conv{len(trunk) + 1}.weight"] = _t(
        np.asarray(params["head"]["w"]).transpose(3, 2, 0, 1))
    return sd


LEAF = object()  # a leaf's place in a structure


def _bn_tree(with_state: bool):
    return ({"mean": LEAF, "var": LEAF, "count": LEAF} if with_state
            else {"scale": LEAF, "bias": LEAF})


def _generator_tree(image_size: int, state: bool):
    n = len(encoder_channels(image_size))
    layer = (lambda bn: _bn_tree(True) if bn else {}) if state else \
        (lambda bn: {"w": LEAF, **({"bn": _bn_tree(False)} if bn else {})})
    return {"encoder": [layer(i > 0) for i in range(n)],
            "latent": _bn_tree(True) if state else {"w": LEAF, "bn": _bn_tree(False)},
            "decoder": [layer(j < n) for j in range(n + 1)]}


def _discriminator_tree(image_size: int, state: bool):
    n = len(encoder_channels(image_size))
    if state:
        return {"trunk": [_bn_tree(True) if i > 0 else {} for i in range(n)]}
    return {"trunk": [{"w": LEAF, **({"bn": _bn_tree(False)} if i > 0 else {})}
                      for i in range(n)],
            "head": {"w": LEAF}}


def jax_train_state_tree(image_size: int, arch: str) -> dict:
    """The JAX package's train-state pytree with ``LEAF`` at every leaf."""
    from ..train.graph import trainable_subsets

    def net(name, state):
        return (_generator_tree if name.startswith("gen")
                else _discriminator_tree)(image_size, state)

    names = ("gen_A", "gen_B", "dis_A", "dis_B")
    opt = {key: {"m": {k: net(k, False) for k in keys},
                 "v": {k: net(k, False) for k in keys}, "step": LEAF}
           for key, keys in zip(("opt_gen", "opt_dis"), trainable_subsets(arch))}
    return {"models": {k: net(k, False) for k in names},
            "model_states": {k: net(k, True) for k in names}, **opt}


def _fill(tree, leaves):
    """``tree`` with its leaves taken from the iterator ``leaves`` in
    ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        filled = {k: _fill(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, list):
        return [_fill(t, leaves) for t in tree]
    return next(leaves)


def read_jax_train_state_npz(path, image_size: int, arch: str) -> dict:
    """The JAX package's ``train_state.npz`` (leaf_0, leaf_1, ... in
    flatten order; bf16 leaves stored as f32) as a pytree of numpy arrays."""
    tree = jax_train_state_tree(image_size, arch)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    it = iter(leaves)
    try:
        out = _fill(tree, it)
    except StopIteration:
        out = None
    if out is None or next(it, None) is not None:
        raise ValueError(f"{path}: {len(leaves)} leaves, not those of a "
                         f"{image_size}px {arch} train state")
    return out


def _replica(tree, r: int):
    """``tree`` with replica ``r`` taken from every leaf's leading axis."""
    if isinstance(tree, dict):
        return {k: _replica(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replica(v, r) for v in tree]
    return np.asarray(tree)[r]


def train_state_from_jax(jts: dict, cfg, device="cpu", replica: int | None = None):
    """A JAX train state (``init_train_state``'s pytree, its leaves
    numpy-convertible) -> the port's ``TrainState`` for ``cfg`` on
    ``device``: parameters in bf16 under slim state "all", moments in the
    slim state's dtype, running statistics f32, Adam step counts kept.
    ``replica``: the state is a data-parallel one under per-replica
    BatchNorm (JAX ``parallel/dp.py:48-60``: a leading replica axis on its
    BatchNorm states), and rank ``replica`` takes that replica's."""
    if replica is not None:
        jts = dict(jts, model_states=_replica(jts["model_states"], replica))
    from ..train.graph import trainable_subsets
    from ..train.step import (TrainState, cast_parameters, make_optimizers,
                              resolve_slim_state)
    from .discriminator import Discriminator
    from .generator import Generator

    models = {}
    for name in ("gen_A", "gen_B", "dis_A", "dis_B"):
        params, state = jts["models"][name], jts["model_states"][name]
        if name.startswith("gen"):
            m, sd = Generator(cfg.image_size), generator_from_jax(params, state)
        else:
            m, sd = Discriminator(cfg.image_size), discriminator_from_jax(params, state)
        m.load_state_dict(sd, strict=True)
        m = m.to(device).train()
        if resolve_slim_state(cfg) == "all":
            cast_parameters(m, torch.bfloat16)
        models[name] = m
    ts = TrainState(models, *make_optimizers(models, cfg))
    for key, opt, keys in zip(("opt_gen", "opt_dis"), (ts.opt_gen, ts.opt_dis),
                              trainable_subsets(cfg.model_arch)):
        jopt = jts[key]
        moments = []
        for k in keys:
            conv = generator_from_jax if k.startswith("gen") else discriminator_from_jax
            sd_m = conv(jopt["m"][k], jts["model_states"][k])
            sd_v = conv(jopt["v"][k], jts["model_states"][k])
            moments += [(sd_m[n], sd_v[n]) for n, _ in models[k].named_parameters()]
        with torch.no_grad():
            for m, v, (jm, jv) in zip(opt.m, opt.v, moments, strict=True):
                m.copy_(jm)
                v.copy_(jv)
        opt.step = int(np.asarray(jopt["step"]))
    return ts
