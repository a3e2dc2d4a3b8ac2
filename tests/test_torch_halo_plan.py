"""The tile plan of K5f's tensor-core path (``ops/halo_conv.py::tc_plan``).

The CUDA kernel (csrc/halo_conv_k4s2p1.cu, ``halo_wgmma_kernel``) takes
its rows per block from this plan and derives the rest of its grid from the
same constants, so the plan is checked here, on the CPU: it fits a block's
shared memory on the H100, its blocks cover every output pixel and channel
exactly once, and at the 512px enc1 shapes (batch 1 for the daemon, 4 for
the CLI, 8 for training) it fills about one wave of the card's 132 SMs.
The edge shapes are the ones the card's tests hold the kernel to
(tests/test_torch_cuda_kernels.py): bands that do not divide the map, a
strip narrower than 64, channel counts off the 64 tile, CI of 16, 32 and
48, non-square maps.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.halo_conv import (H100_SMS, SMEM_PER_BLOCK,
                                                     TC_CO_TILE, TC_STRIP,
                                                     tc_plan)

ENC1 = (256, 256, 64, 128)  # h, w, ci, co of enc1 at the 512px geometry
EDGE = [(4, 58, 40, 32, 72), (8, 46, 256, 32, 128), (8, 24, 256, 16, 128),
        (2, 24, 200, 16, 24), (1, 20, 300, 64, 136), (3, 10, 6, 48, 16)]
MAIN = [(n, *ENC1) for n in (1, 4, 8)]


def _blocks(n, h, w, co, plan):
    """(b, rows, cols, channels) of every block, in the kernel's grid order:
    x = channel tile, y = strip + strips * band, z = image."""
    ho, wo = h // 2, w // 2
    for b in range(n):
        for y in range(plan.strips * plan.bands):
            strip, band = y % plan.strips, y // plan.strips
            oy0, ox0 = band * plan.rows, strip * TC_STRIP
            for cot in range(plan.co_tiles):
                co0 = cot * TC_CO_TILE
                yield (b, range(oy0, min(oy0 + plan.rows, ho)),
                       range(ox0, min(ox0 + TC_STRIP, wo)),
                       range(co0, min(co0 + TC_CO_TILE, co)))


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_plan_fits_shared_memory(shape):
    plan = tc_plan(*shape, torch.bfloat16)
    assert plan is not None
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    if shape[3] == 64:  # enc1's CI: the 128 KB of weights and the 6-row ring
        assert plan.smem_bytes == 230_912


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_plan_covers_every_output_once(shape):
    n, h, w, ci, co = shape
    plan = tc_plan(n, h, w, ci, co, torch.bfloat16)
    count = np.zeros((n, h // 2, w // 2, co), np.int32)
    for b, rows, cols, chans in _blocks(n, h, w, co, plan):
        assert len(rows) and len(cols) and len(chans), "a block with no work"
        count[b, rows.start:rows.stop, cols.start:cols.stop,
              chans.start:chans.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("n,rows", [(1, 4), (4, 16), (8, 32)])
def test_plan_is_one_wave_at_enc1(n, rows):
    plan = tc_plan(n, *ENC1, torch.bfloat16)
    assert plan.rows == rows
    assert 120 <= n * plan.blocks_per_image <= H100_SMS


@pytest.mark.parametrize("shape", EDGE)
def test_plan_edge_shapes_cut_the_map(shape):
    """Rows per block that leave a shorter last band, and strips and channel
    tiles that the map and CO do not fill, are the cases the kernel masks."""
    n, h, w, ci, co = shape
    plan = tc_plan(n, h, w, ci, co, torch.bfloat16)
    assert plan.bands == -(-(h // 2) // plan.rows)
    assert plan.strips == -(-(w // 2) // TC_STRIP)
    assert plan.co_tiles == -(-co // TC_CO_TILE)


def test_plan_rows_divide_or_not():
    """At least one edge shape has a last band shorter than the others, and
    one has an odd number of rows per block (the two warpgroups of a block
    then take unequal counts of rows)."""
    plans = [tc_plan(*s, torch.bfloat16) for s in EDGE]
    assert any((s[1] // 2) % p.rows for s, p in zip(EDGE, plans))
    assert any(p.rows % 2 and p.rows > 1 for p in plans)


@pytest.mark.parametrize("dtype,ci,co", [
    (torch.float32, 64, 128),   # f32 takes the FMA kernel
    (torch.bfloat16, 8, 24),    # CI % 16 != 0
    (torch.bfloat16, 128, 64),  # the weights of CI > 64 do not fit
    (torch.bfloat16, 64, 12),   # CO % 8 != 0
])
def test_plan_refuses_what_the_tensor_cores_do_not_take(dtype, ci, co):
    assert tc_plan(2, 32, 32, ci, co, dtype) is None


def test_plan_follows_the_card():
    """Fewer SMs, fewer bands: the grid stays one wave where it can."""
    small = tc_plan(4, *ENC1, torch.bfloat16, sms=66)
    assert small.rows == 32 and 4 * small.blocks_per_image <= 66
