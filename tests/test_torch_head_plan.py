"""The plan of K6's tensor-core path (``ops/head.py::head_plan``).

The CUDA kernel (csrc/head_convt.cu, ``head_convt_mma_kernel``) takes its
bands, strips and ring from this plan, and the C entry refuses a plan that
does not cover every input row and column exactly once; so the plan is
checked here, on the CPU: its blocks cover every output pixel once, it fits
a block's shared memory on the H100, it fills the card's 132 SMs at batch 1
and about one wave at batch 8, and it is None where the path does not take
the shape. Shapes: the head and the stems' input gradient of the 512px
model at batch 1, 4 and 8, and the edge shapes the card's tests hold the
kernel to (chip_smoke.py's K6_EDGE). A numpy model of the kernel's
four-phase GEMM (its B matrix over 9 windows, its epilogue's addresses) is
held against the plain version.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.conv_k4s2p1 import H100_SMS
from discogan_modernized_torch.ops.head import (MAX_SMEM_BYTES, SMEM_PER_SM,
                                                SMEM_RESERVED, TC_STRIP,
                                                TC_WG_PIXELS,
                                                head_convt_plain, head_plan,
                                                tc_np)

HEAD = (256, 256, 64, 3)  # h, w, ci, co of the head (and the stems' dx) at 512px
MAIN = [(n, *HEAD) for n in (1, 4, 8)]
# W off a multiple of 16 (24, 40), three strips (300), bands that do not
# divide H (10 in bands of 3, 58 in bands of 10), H 1, 2 and 6, CO 1, 3 and
# 8, CI 16/32/48/64/128 (a ring of 4 rows at CI 128, CO 8), batch 1 and 2.
EDGE = [(2, 10, 24, 64, 3), (1, 6, 40, 16, 1), (1, 8, 300, 32, 3),
        (60, 10, 24, 64, 3), (40, 58, 40, 16, 3), (2, 6, 40, 48, 3),
        (2, 1, 256, 64, 3), (2, 2, 128, 64, 8), (24, 16, 40, 32, 8),
        (1, 16, 256, 128, 3), (30, 20, 40, 128, 8)]
SHAPES = MAIN + EDGE


def _per_sm(plan):
    return min(2, SMEM_PER_SM // (plan.smem_bytes + SMEM_RESERVED))


def test_512px_plans():
    """Two strips of 128 columns, 256 blocks (two fit an SM: one wave of
    264 slots): bands of 2, 8 and 16 rows at batch 1, 4 and 8."""
    for n, rows in ((1, 2), (4, 8), (8, 16)):
        plan = head_plan(n, *HEAD, torch.bfloat16)
        assert (plan.rows, plan.strips, plan.slots, plan.blocks) == (rows, 2, 5, 256)
        assert plan.smem_bytes == 106_112 and _per_sm(plan) == 2


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_output_once(shape):
    """Block (strip, band, image) makes output pixels (2i+a, 2j+b) of its
    input rows i and columns j: each output pixel once, no block empty."""
    n, h, w, ci, co = shape
    plan = head_plan(*shape, torch.bfloat16)
    assert plan is not None and plan.blocks == n * plan.bands * plan.strips
    count = np.zeros((n, 2 * h, 2 * w), np.int32)
    for b in range(n):
        for x in range(plan.strips * plan.bands):
            strip, band = x % plan.strips, x // plan.strips
            rows = range(band * plan.rows, min(h, (band + 1) * plan.rows))
            cols = range(strip * TC_STRIP, min(w, (strip + 1) * TC_STRIP))
            assert len(rows) and len(cols), "a block with no work"
            count[b, 2 * rows.start:2 * rows.stop, 2 * cols.start:2 * cols.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_fits_a_block(shape):
    plan = head_plan(*shape, torch.bfloat16)
    assert 0 < plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.slots in (4, 5)
    if plan.slots == 4:  # only where 5 rows would not fit
        n, h, w, ci, co = shape
        planes = -(-ci // 64)
        assert plan.smem_bytes + planes * 2 * TC_WG_PIXELS * 128 > MAX_SMEM_BYTES


def test_fills_the_card():
    """At batch 1 (the daemon's) every SM gets a block; at batch 8 the grid
    is one wave, two blocks an SM."""
    one, eight = (head_plan(n, *HEAD, torch.bfloat16) for n in (1, 8))
    assert H100_SMS <= one.blocks <= _per_sm(one) * H100_SMS
    assert H100_SMS <= eight.blocks <= _per_sm(eight) * H100_SMS


def test_plan_follows_the_card():
    """Fewer SMs, longer bands: 66 SMs at batch 8 take bands of 32 rows."""
    plan = head_plan(8, *HEAD, torch.bfloat16, sms=66)
    assert (plan.rows, plan.blocks) == (32, 128)


@pytest.mark.parametrize("n,h,w,ci,co,dtype", [
    (8, 256, 256, 64, 3, torch.float32),   # f32: the FMA kernel
    (1, 40, 24, 8, 3, torch.bfloat16),     # CI % 16 != 0
    (2, 8, 8, 24, 3, torch.bfloat16),
    (2, 8, 8, 0, 3, torch.bfloat16),
    (2, 8, 8, 144, 3, torch.bfloat16),     # CI beyond the staging budget
    (2, 8, 8, 256, 3, torch.bfloat16),
    (2, 8, 8, 64, 0, torch.bfloat16),      # CO 0 and above 8
    (2, 8, 8, 64, 9, torch.bfloat16),
    (2, 8, 8, 64, 16, torch.bfloat16)])
def test_none_where_the_path_does_not_take_the_shape(n, h, w, ci, co, dtype):
    assert head_plan(n, h, w, ci, co, dtype) is None


def _emulate_mma(x, w):
    """The kernel's arithmetic in numpy (f64): B[window, c, column] as the
    kernel builds it, one 64-position row of a warpgroup as
    sum_window x[i + dy, j + dx] @ B[window], and the epilogue's addresses
    (column n = a*2CO + b*CO + o of position p at g0 + p*2CO + n % 2CO of
    output row 2i + a) into a flat y."""
    n_img, h, wd, ci = x.shape
    co = w.shape[3]
    npad = tc_np(co)
    bmat = np.zeros((9, ci, npad))
    for win in range(9):
        for col in range(4 * co):
            a, bb, o = col // (2 * co), col % (2 * co) // co, col % co
            u, v = win // 3 - a, win % 3 - bb
            if 0 <= u <= 1 and 0 <= v <= 1:
                bmat[win, :, col] = w[3 - a - 2 * u, 3 - bb - 2 * v, :, o]
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    y = np.full(n_img * 2 * h * 2 * wd * co, np.nan)
    for b in range(n_img):
        for i in range(h):
            for jg in range(0, wd, 64):
                npos = min(64, wd - jg)
                acc = sum(xp[b, i + win // 3, jg + win % 3:jg + win % 3 + npos] @ bmat[win]
                          for win in range(9))
                for a in range(2):
                    g0 = ((b * 2 * h + 2 * i + a) * 2 * wd + 2 * jg) * co
                    for m in range(2 * co):
                        y[g0 + np.arange(npos) * 2 * co + m] = acc[:, a * 2 * co + m]
    return y.reshape(n_img, 2 * h, 2 * wd, co)


@pytest.mark.parametrize("n,h,w,ci,co", [(1, 3, 70, 16, 3), (2, 2, 9, 32, 1),
                                         (1, 4, 5, 16, 8), (1, 1, 130, 64, 4)])
def test_emulated_four_phase_gemm_matches_the_plain_version(n, h, w, ci, co):
    """CO 1, 3, 4 and 8 (B 16 and 32 wide), a ragged 64-position group
    (70, 130 wide), H 1; the plain version sums in f32: 1e-5 relative."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, ci)
    wt = rng.randn(4, 4, ci, co)
    want = head_convt_plain(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(_emulate_mma(x, wt), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_pairs_keep_the_single_plan(shape):
    """P = 2 (the pair axis): each pair's bands and strips are a single
    call's; the grid holds both pairs' blocks."""
    one = head_plan(*shape, torch.bfloat16)
    two = head_plan(*shape, torch.bfloat16, pairs=2)
    assert two._replace(pairs=1, blocks=one.blocks) == one
    assert two.blocks == 2 * one.blocks
