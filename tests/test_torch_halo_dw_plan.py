"""The plan of K5b, enc1's weight gradient (``ops/halo_conv.py::halo_dw_plan``).

The CUDA kernels (csrc/halo_conv_k4s2p1_dw.cu) take their path, split,
grid and shared memory from this plan, and the C entry refuses a plan whose
parts do not cover M exactly once; so the plan is checked here, on the CPU:
bf16 takes K4's wgmma design (``dw_plan``) at every shape K5b takes, with
parity planes where W/2 % 8 == 0 and per-tap windows elsewhere; at enc1 at
batch 8 it is 4 tiles split 33 ways on the card's 132 SMs; the parts cover
M exactly once; shared memory fits a block; f32 takes the FMA kernel over
runs of output rows. Shapes: enc1 of the 512px model at batch 1, 2 and 8,
the JAX tests' shapes (tests/test_pallas_halo_conv.py), the odd 14x22 map
and the edge shapes the card's tests hold the kernel to. A numpy model of
the wgmma kernel's staging is held against the plain version at K5b shapes.
"""

import numpy as np
import pytest
import torch
from test_torch_dw_plan import _emulate_wgmma

from discogan_modernized_torch.ops.conv_k4s2p1 import (DW_BN, DW_CH, DW_CHUNK,
                                                       DW_MAX_TILES_PER_BLOCK,
                                                       H100_SMS, dw_plan)
from discogan_modernized_torch.ops.halo_conv import (
    FMA_MIN_ROWS, SMEM_PER_BLOCK, halo_conv2d_k4s2p1_dw_plain, halo_dw_plan)

ENC1 = (256, 256, 64, 128)  # h, w, ci, co of enc1 (and dis1) at 512px
MAIN = [(n, *ENC1) for n in (1, 2, 8)]
JAX_SHAPES = [(2, 16, 16, 8, 16), (1, 32, 32, 64, 128), (2, 64, 32, 16, 8)]
ODD = [(3, 14, 22, 8, 24)]
# chip_smoke.py's K5B_EDGE: CI 16/32/48 under one channel block, CO 24/72/136
# off the 128 tile, W/2 of 20 (windows), a ragged M, two images.
EDGE = [(2, 64, 64, 16, 128), (1, 48, 256, 32, 72), (2, 40, 128, 48, 136),
        (2, 128, 128, 64, 24), (3, 30, 40, 16, 72), (1, 10, 208, 64, 128),
        (2, 256, 256, 64, 128)]
SHAPES = MAIN + JAX_SHAPES + ODD + EDGE
DTYPES = [torch.bfloat16, torch.float32]


def _units(n, h, w, plan):
    """Steps of the contraction: 64-pixel chunks (wgmma) or output rows
    (FMA, whose tile[2] is W/2 pixels)."""
    return -(-(n * (h // 2) * (w // 2)) // plan.tile[2])


def test_enc1_at_batch_8():
    """4 tiles (one o tile x one channel block x 4 kh), 131,072 pixels =
    2,048 chunks in 33 parts of 63, one block an SM, 209,920 bytes."""
    plan = halo_dw_plan(8, *ENC1, torch.bfloat16)
    assert plan.path == "wgmma_planes"
    assert plan.tiles // plan.splits == 4
    assert (plan.splits, plan.steps_per_split) == (33, 63)
    assert plan.blocks == H100_SMS
    assert plan.smem_bytes == 209_920


def test_enc1_at_batch_1():
    """16,384 pixels = 256 chunks in 32 parts of 8: 128 blocks."""
    plan = halo_dw_plan(1, *ENC1, torch.bfloat16)
    assert plan.path == "wgmma_planes"
    assert (plan.splits, plan.steps_per_split, plan.blocks) == (32, 8, 128)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_is_k4s_wgmma_plan(shape):
    """K4's plan, on the wgmma path: parity planes where W/2 % 8 == 0, the
    four taps' windows elsewhere (the odd 14x22 map, W/2 = 20)."""
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, torch.bfloat16)
    assert plan == dw_plan(*shape, torch.bfloat16)
    assert plan.path == ("wgmma_planes" if (w // 2) % 8 == 0 else "wgmma_windows")
    assert plan.tile == (4 * DW_CH, DW_BN, DW_CHUNK) and plan.taps == 4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_parts_cover_m_exactly_once(shape, dtype):
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, dtype)
    units = _units(n, h, w, plan)
    count = np.zeros(units, np.int32)
    for split in range(plan.splits):
        part = range(split * plan.steps_per_split,
                     min(units, (split + 1) * plan.steps_per_split))
        assert len(part) >= 1, "a part with no pixels"
        count[part.start:part.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_walk_every_tile_once(shape):
    """Block b walks tiles b, b + blocks, ...: every tile once, one a block
    where M is split, at most DW_MAX_TILES_PER_BLOCK a block."""
    plan = halo_dw_plan(*shape, torch.bfloat16)
    walked = sorted(t for b in range(plan.blocks)
                    for t in range(b, plan.tiles, plan.blocks))
    assert walked == list(range(plan.tiles))
    assert -(-plan.tiles // plan.blocks) <= DW_MAX_TILES_PER_BLOCK
    if plan.splits > 1:
        assert plan.blocks == plan.tiles


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_fits_a_block(shape):
    plan = halo_dw_plan(*shape, torch.bfloat16)
    assert 0 < plan.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_takes_the_fma_kernel(shape):
    """Tiles of one kernel row x 64 channels of CI and CO, runs of output
    rows halved while the blocks fill fewer than two waves and each run
    keeps FMA_MIN_ROWS rows; no shared memory from the plan."""
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, torch.float32)
    out_tiles = 4 * -(-ci // 64) * -(-co // 64)
    assert plan.path == "fma" and plan.smem_bytes == 0
    assert plan.tile[2] == w // 2 and plan.blocks == plan.tiles == out_tiles * plan.splits
    rows = n * (h // 2)
    assert (out_tiles * plan.splits >= 2 * H100_SMS
            or rows // plan.splits < 2 * FMA_MIN_ROWS)


def test_plan_follows_the_card():
    """Fewer SMs, fewer parts: enc1 at batch 8 splits to fill 66 SMs."""
    plan = halo_dw_plan(8, *ENC1, torch.bfloat16, sms=66)
    assert plan.splits == 16 and plan.blocks == 64


@pytest.mark.parametrize("shape", [(1, 16, 32, 64, 128), (3, 14, 22, 8, 24),
                                   (1, 6, 40, 16, 24)])
def test_emulated_staging_matches_the_plain_version(shape):
    """K5b shapes through the numpy model of the wgmma kernel's staging:
    parity planes at enc1's channels, per-tap windows at the odd 14x22 map
    and on a map 20 wide, against the plain version (f64 sums: 1e-4)."""
    n, h, w, ci, co = shape
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, ci)
    dy = rng.randn(n, h // 2, w // 2, co)
    plan = halo_dw_plan(*shape, torch.bfloat16)
    assert plan.path == ("wgmma_planes" if (w // 2) % 8 == 0 else "wgmma_windows")
    want = halo_conv2d_k4s2p1_dw_plain(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(_emulate_wgmma(x, dy, plan), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_pairs_keep_the_single_plan(shape, dtype):
    """P = 2 (the pair axis): the plan of a single call, its partials twice
    over."""
    one, two = halo_dw_plan(*shape, dtype), halo_dw_plan(*shape, dtype, pairs=2)
    assert two._replace(pairs=1) == one
    ci, co = shape[-2:]
    assert two.workspace_floats(ci, co) == 2 * one.workspace_floats(ci, co)
