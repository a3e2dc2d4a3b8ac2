"""The reference's ``.pth`` layouts, and weights carried across from the
JAX package.

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
"""

from __future__ import annotations

import numpy as np
import torch

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
