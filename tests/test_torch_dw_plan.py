"""The plan of K4, the halving convs' weight gradient
(``ops/conv_k4s2p1.py::dw_plan``).

The CUDA kernels (csrc/conv_k4s2p1_dw.cu) take their path, split, grid and
shared memory from this plan, so it is checked here, on the CPU, at every
K4 shape of the 512px model (batch 1, 2 and 8) and at the odd shapes the
card's tests hold the kernels to (tests/test_torch_cuda_kernels.py): bf16
enc2..enc6 take the wgmma kernel and the 3-channel stem its own; the grid
fills a wave of the card's 132 SMs or has no split left to add; the parts
of the contraction cover M exactly once; shared memory fits a block; f32
and shapes off the tensor cores' tiles take the FMA kernel. A numpy model of
the wgmma kernel's staging (parity planes, per-tap windows, chunks and
tiles as the plan cuts them) is held against the plain version.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.conv_k4s2p1 import (
    DW_BN, DW_CH, DW_CHUNK, DW_GROUP_PX, DW_MAX_TILES_PER_BLOCK,
    DW_MIN_CHUNKS_PER_SPLIT, H100_SMS, conv2d_k4s2p1_dw_plain, dw_plan)
from discogan_modernized_torch.ops.halo_conv import SMEM_PER_BLOCK

# (h, w, ci, co) of the K4 layers of the 512px generator (enc1 takes K5b);
# the discriminator's halving convs have the same shapes.
LAYERS = {"enc0": (512, 512, 3, 64), "enc2": (128, 128, 128, 256),
          "enc3": (64, 64, 256, 512), "enc4": (32, 32, 512, 1024),
          "enc5": (16, 16, 1024, 2048), "enc6": (8, 8, 2048, 2048)}
MAIN = [(n, *shape) for shape in LAYERS.values() for n in (1, 2, 8)]
MAIN_IDS = [f"{name}-b{n}" for name in LAYERS for n in (1, 2, 8)]
# CI 16/32/48 under one 64-channel block, CO off the 128 tile, M under one
# chunk (enc6 at batch 1), a ragged M on a map 5 wide, stems of 1 and 4
# channels, the old odd shapes.
EDGE = [(2, 16, 16, 16, 64), (2, 32, 32, 32, 64), (3, 16, 16, 48, 72),
        (1, 8, 8, 2048, 2048), (3, 14, 10, 16, 72), (2, 16, 16, 1, 8),
        (2, 32, 32, 4, 72), (3, 6, 10, 16, 72), (1, 8, 8, 24, 40)]


def _chunks(n, h, w, plan):
    return -(-(n * (h // 2) * (w // 2)) // plan.tile[2])


@pytest.mark.parametrize("shape", MAIN, ids=MAIN_IDS)
def test_bf16_layers_take_the_tensor_cores(shape):
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, torch.bfloat16)
    if ci == 3:
        assert plan.path == "wgmma_stem"
    else:
        assert plan.path == ("wgmma_planes" if (w // 2) % 8 == 0 else "wgmma_windows")
        assert plan.tile == (4 * DW_CH, DW_BN, DW_CHUNK) and plan.taps == 4


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_grid_fills_a_wave_or_has_no_split_left(shape):
    """Split M only while the tiles fill less than a wave, into as many
    parts as fit in it: one more part would pass the wave, or leave parts
    under the minimum."""
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, torch.bfloat16)
    out_tiles = plan.tiles // plan.splits
    chunks = _chunks(n, h, w, plan)
    per_sm = 4 if plan.path == "wgmma_stem" else 1
    full = plan.blocks >= H100_SMS or plan.tiles >= per_sm * H100_SMS
    no_split_left = (out_tiles * (plan.splits + 1) > per_sm * H100_SMS
                     or chunks // (plan.splits + 1) < DW_MIN_CHUNKS_PER_SPLIT
                     or -(-chunks // -(-chunks // (plan.splits + 1))) == plan.splits)
    assert full or no_split_left
    assert plan.tiles <= max(out_tiles, per_sm * H100_SMS)


@pytest.mark.parametrize("shape", MAIN + EDGE)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_splits_cover_m_exactly_once(shape, dtype):
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, dtype)
    steps = _chunks(n, h, w, plan)
    count = np.zeros(steps, np.int32)
    for split in range(plan.splits):
        part = range(split * plan.steps_per_split,
                     min(steps, (split + 1) * plan.steps_per_split))
        assert len(part) >= 1, "a part with no pixels"
        count[part.start:part.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_blocks_walk_every_tile_once(shape):
    """Block b walks tiles b, b + blocks, ...: every tile once, at most
    DW_MAX_TILES_PER_BLOCK a block, one a block where M is split."""
    plan = dw_plan(*shape, torch.bfloat16)
    walked = sorted(t for b in range(plan.blocks)
                    for t in range(b, plan.tiles, plan.blocks))
    assert walked == list(range(plan.tiles))
    assert -(-plan.tiles // plan.blocks) <= DW_MAX_TILES_PER_BLOCK
    if plan.splits > 1:
        assert plan.blocks == plan.tiles


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_shared_memory_fits_a_block(shape):
    plan = dw_plan(*shape, torch.bfloat16)
    assert 0 < plan.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype,ci,co", [
    (torch.float32, 128, 256),   # f32 takes the FMA kernel
    (torch.float32, 3, 64),
    (torch.bfloat16, 12, 64),    # CI % 8 != 0 and over the stem's 4
    (torch.bfloat16, 5, 64),
    (torch.bfloat16, 128, 12),   # CO % 8 != 0
    (torch.bfloat16, 3, 6),
])
def test_fma_takes_what_the_tensor_cores_do_not(dtype, ci, co):
    plan = dw_plan(2, 16, 16, ci, co, dtype)
    assert plan.path == "fma" and plan.smem_bytes == 0


def test_plan_follows_the_card():
    """Fewer SMs, fewer parts: enc2 at batch 8 splits to fill 66 SMs."""
    small = dw_plan(8, *LAYERS["enc2"], torch.bfloat16, sms=66)
    assert small.splits == 4 and small.blocks == 64


def _emulate_wgmma(x, dy, plan):
    """The wgmma kernel's arithmetic in numpy, with its staging: per tile
    (kernel row kh, 64 channels, 128 o) and chunk of 64 pixels, x staged as
    the kernel stages it (parity planes of 9 pixels per 8-pixel group, or
    the four taps' windows) and read back through the windows the wgmma
    descriptors point at."""
    n, h, w, ci = x.shape
    co = dy.shape[3]
    ho, wo = h // 2, w // 2
    m_total = n * ho * wo
    xf = x.reshape(n * h * w, ci)
    dyf = np.zeros((-(-m_total // DW_CHUNK) * DW_CHUNK, co), np.float64)
    dyf[:m_total] = dy.reshape(m_total, co)
    dw = np.zeros((4, 4, ci, co), np.float64)

    def pixel(b, iy, ix, c0):
        out = np.zeros(DW_CH)
        if 0 <= b < n and 0 <= iy < h and 0 <= ix < w:
            vals = xf[(b * h + iy) * w + ix, c0:c0 + DW_CH]
            out[:len(vals)] = vals
        return out

    def where(m):
        b, r = divmod(m, ho * wo)
        return b, *divmod(r, wo)

    chunks = -(-m_total // DW_CHUNK)
    for kh in range(4):
        for c0 in range(0, ci, DW_CH):
            for c in range(chunks):
                px = range(c * DW_CHUNK, (c + 1) * DW_CHUNK)
                a = np.zeros((4, DW_CHUNK, DW_CH))  # the four taps' A, [pixel][channel]
                if plan.path == "wgmma_planes":
                    planes = np.zeros((2, DW_CHUNK // 8, DW_GROUP_PX, DW_CH))
                    for g in range(DW_CHUNK // 8):
                        m = px[g * 8]
                        b, oy, ox = where(m)
                        for j in range(2 * DW_GROUP_PX):
                            if m < m_total:
                                planes[j & 1, g, j >> 1] = pixel(b, 2 * oy - 1 + kh,
                                                                 2 * ox - 1 + j, c0)
                    for kw in range(4):
                        a[kw] = planes[kw & 1, :, (kw >> 1):(kw >> 1) + 8].reshape(DW_CHUNK, DW_CH)
                else:
                    for p, m in enumerate(px):
                        b, oy, ox = where(m)
                        for kw in range(4):
                            if m < m_total:
                                a[kw, p] = pixel(b, 2 * oy - 1 + kh, 2 * ox - 1 + kw, c0)
                for kw in range(4):
                    cs = slice(c0, min(ci, c0 + DW_CH))
                    dw[kh, kw, cs] += (a[kw].T @ dyf[px.start:px.stop])[:cs.stop - cs.start]
    return dw


@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 16), (1, 6, 32, 72, 8),
                                   (3, 6, 10, 16, 24), (1, 8, 8, 128, 8)])
def test_emulated_staging_matches_the_plain_version(shape):
    """Parity planes (W/2 a multiple of 8; CI past one block, ragged at 72)
    and per-tap windows (W/2 of 5 and 4), against the plain version (f32
    sums: 1e-4)."""
    n, h, w, ci, co = shape
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, ci)
    dy = rng.randn(n, h // 2, w // 2, co)
    plan = dw_plan(*shape, torch.bfloat16)
    assert plan.path == ("wgmma_planes" if (w // 2) % 8 == 0 else "wgmma_windows")
    want = conv2d_k4s2p1_dw_plain(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(_emulate_wgmma(x, dy, plan), want, rtol=1e-5, atol=1e-4)
