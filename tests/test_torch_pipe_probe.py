"""The read probe P (ops/pipe_probe.py) against the TPU kernel
``benchmarks/pipe_probe.py::make_reader`` run in Pallas's TPU interpret
mode on the CPU.

Every grid step of the TPU kernel writes the same (1, 128) output block,
so it returns the max of the LAST block in grid order. Each case plants
the tensor's max in the first block, so a port that took the max of the
whole tensor would fail. The six geometries are ``CASES``' scaled down
(N 2, H 8, W 8, C 16, th 4 or 2).

Importing ``benchmarks/pipe_probe.py`` points JAX's persistent compilation
cache at another machine's directory and puts a path on ``sys.path``; the
fixture loads it by path and puts all three back afterwards, so the rest
of the worker does not load that cache.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops import pipe_probe as pp

ROOT = Path(__file__).resolve().parents[1]
N, H, W, C = 2, 8, 8, 16
# (logical shape, block): benchmarks/pipe_probe.py's CASES at the small size
CASES = {
    "4d_th32_lane64": ((N, H, W, C), (1, 4, W, C)),
    "4d_th128_lane64": ((N, H, W, C), (1, 2, W, C)),
    "4d_th32_lane128": ((N, H, W // 2, 2 * C), (1, 4, W // 2, 2 * C)),
    "4d_th128_lane128": ((N, H, W // 2, 2 * C), (1, 2, W // 2, 2 * C)),
    "3d_th32_flat": ((N, H, W * C), (1, 4, W * C)),
    "3d_th128_flat": ((N, H, W * C), (1, 2, W * C)),
}
_CONFIG_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def load_reference():
    """benchmarks/pipe_probe.py, loaded by path, with JAX's cache settings
    and sys.path put back after its import."""
    saved = {k: getattr(jax.config, k) for k in _CONFIG_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_pipe_probe_reference", ROOT / "benchmarks" / "pipe_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def reference():
    return load_reference()


def planted(shape, seed: int) -> np.ndarray:
    """bf16-representable values in [-1, 1), with 9.0 in the first block."""
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    x.reshape(-1)[3] = 9.0
    return x


def test_import_leaves_the_worker_as_it_was():
    before = ({k: getattr(jax.config, k) for k in _CONFIG_KEYS}, list(sys.path))
    mod = load_reference()
    assert ({k: getattr(jax.config, k) for k in _CONFIG_KEYS}, sys.path) == before
    assert set(mod.CASES) == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_value_equals_the_tpu_kernel(reference, name):
    from jax.experimental.pallas import tpu as pltpu

    shape, block = CASES[name]
    x = planted(shape, seed=sorted(CASES).index(name))
    with pltpu.force_tpu_interpret_mode():
        want = float(reference.make_reader(shape, block)(jnp.asarray(x, jnp.bfloat16)))
    t = torch.from_numpy(x).bfloat16()
    got = pp.probe_value(t, shape, block)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == want
    # the TPU kernel's value is the last block's, not the tensor's
    assert want < 9.0 == float(t.float().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_max_equals_numpy(name):
    shape, block = CASES[name]
    x = planted(shape, seed=10 + sorted(CASES).index(name))
    nblocks = int(np.prod(shape) // np.prod(block))
    want = x.reshape(nblocks, -1).max(1)
    got = pp.block_max(torch.from_numpy(x).bfloat16(), shape, block)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 9.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_covers_every_row_once(name):
    """The launch's splits of whole row groups cover a TPU block's rows
    exactly once, at the full size and the small one, and its lanes
    divide both a row and the block's threads."""
    shape, block = CASES[name]
    # the full size: x of (32, 256, 256, 64) bf16 in the case's shape
    big_shape = ((32, 256, 16384) if len(shape) == 3
                 else (32, 256, 16384 // (4 * shape[-1]), 4 * shape[-1]))
    big_block = (1, 32 if "th32" in name else 128, *big_shape[2:])
    for sh, bl in ((shape, block), (big_shape, big_block)):
        plan = pp.probe_plan(sh, bl, torch.bfloat16)
        assert plan.row_vecs % plan.lanes == 0 and plan.threads % plan.lanes == 0
        assert plan.rows_per_split % (plan.threads // plan.lanes) == 0
        assert (plan.splits - 1) * plan.rows_per_split < plan.rows_per_block
        assert plan.splits * plan.rows_per_split >= plan.rows_per_block
        assert plan.nblocks * plan.rows_per_block * plan.row_vecs * 16 == np.prod(sh) * 2
    assert plan.nblocks * plan.splits >= pp.PROBE_TARGET_BLOCKS // 2


@pytest.mark.parametrize("shape, block", [((2, 8, 8, 16), (2, 4, 8, 16)),
                                          ((2, 8, 8, 16), (1, 3, 8, 16)),
                                          ((2, 8, 8, 16), (1, 4, 4, 16))])
def test_refuses_blocks_that_are_not_full_rows(shape, block):
    with pytest.raises(ValueError):
        pp.block_max(torch.zeros(shape, dtype=torch.bfloat16), shape, block)
