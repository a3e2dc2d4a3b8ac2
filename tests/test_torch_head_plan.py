"""The plans of K6's two paths (``ops/head.py::head_plan``, the tensor
cores', and ``head_fma_plan``, the CUDA cores').

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

The CUDA-core kernel (``head_fma_kernel``) takes its block rows, ring and
copies from ``head_fma_plan``, which the C entry checks the same way: its
plan covers every output pixel once, fits the SM as many blocks at a time
as its warps allow, spreads over the SMs, exists for every K6 shape
chip_smoke.py runs off the tensor cores (the 512px head and stems' dx at
batch 1, 2, 4 and 8, a tp-2 spatial band, the 64px head, the odd and edge
shapes in f32) and keeps the single plan under pairs. A numpy model of the
kernel (halo staging with zero fill through the swizzled rows, the chunk
walk, the lanes' register tiles, the four phases' own taps, the epilogue's
lines and 16-byte stores) is held against the plain version, and the
lanes' float4 reads are checked for bank conflicts.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.conv_k4s2p1 import H100_SMS
from discogan_modernized_torch.ops.head import (FMA_KC, FMA_ROWS, FMA_WARPS_PER_SM,
                                                MAX_SMEM_BYTES, SMEM_PER_SM,
                                                SMEM_RESERVED, TC_STRIP,
                                                TC_WG_PIXELS, fma_co, fma_smem_bytes,
                                                head_convt_plain, head_entry_plan,
                                                head_fma_plan, head_plan, tc_np)

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


# ---- the CUDA-core path (head_fma_kernel, head_fma_plan) -------------------

F32 = torch.float32
# K6's shapes off the tensor cores that chip_smoke.py runs: the 512px head
# and stems' dx at batch 1, 2, 4 and 8, a tp-2 spatial band (h/2 + 2 rows),
# the 64px head at the angle trainer's batch, "odd 40x24" (CI 8), and the
# tensor-core edge shapes (K6_EDGE) in f32
FMA_SHAPES = ([(n, *HEAD) for n in (1, 2, 4, 8)]
              + [(2, 130, 256, 64, 3), (64, 32, 32, 64, 3), (1, 40, 24, 8, 3)] + EDGE)


def _fma_per_sm(plan):
    return FMA_WARPS_PER_SM * plan.thread_rows // plan.rows


def test_512px_fma_plans():
    """f32 at 512px: blocks of 8 input rows (4 warps, two blocks an SM) from
    batch 2 up, of 4 at batch 1 and on the spatial band; 128 columns, two
    stages of 8 channels, 16-byte copies."""
    for n, h, rows, blocks in ((8, 256, 8, 512), (4, 256, 8, 256), (2, 256, 8, 128),
                               (1, 256, 4, 128), (2, 130, 4, 132)):
        plan = head_fma_plan(n, h, 256, 64, 3, F32)
        assert (plan.rows, plan.cols, plan.thread_rows, plan.thread_cols) == (rows, 128, 2, 4)
        assert (plan.ci_chunk, plan.stages, plan.vec, plan.blocks) == (8, 2, True, blocks)
    assert head_fma_plan(8, *HEAD, F32).smem_bytes == 86_272


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FMA_SHAPES)
def test_fma_plan_covers_every_output_once(shape, dtype):
    """Block (band, strip, image) makes output pixels (2i+a, 2j+b) of its
    input rows i and columns j: each output pixel once, no block empty."""
    n, h, w, ci, co = shape
    plan = head_fma_plan(*shape, dtype)
    assert plan.grid == (plan.bands * plan.strips, n, 1)
    assert plan.cols == 32 * plan.thread_cols and plan.rows % plan.thread_rows == 0
    count = np.zeros((n, 2 * h, 2 * w), np.int32)
    for b in range(n):
        for x in range(plan.grid[0]):
            strip, band = x % plan.strips, x // plan.strips
            rows = range(band * plan.rows, min(h, (band + 1) * plan.rows))
            cols = range(strip * plan.cols, min(w, (strip + 1) * plan.cols))
            assert len(rows) and len(cols), "a block with no work"
            count[b, 2 * rows.start:2 * rows.stop, 2 * cols.start:2 * cols.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FMA_SHAPES)
def test_fma_plan_fits_the_sm(shape, dtype):
    """A block's shared memory (the ring, or the epilogue's lines) fits a
    block, and as many blocks as the SM's warps hold fit its shared memory;
    a thread's copies of a staged row fit the kernel's mask word."""
    n, h, w, ci, co = shape
    plan = head_fma_plan(*shape, dtype)
    itemsize = 4 if dtype == F32 else 2
    assert plan.smem_bytes == fma_smem_bytes(itemsize, co, plan.rows, plan.stages)
    assert 0 < plan.smem_bytes <= MAX_SMEM_BYTES
    assert _fma_per_sm(plan) * (plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM
    units = FMA_KC * itemsize // 16 * (plan.cols + 2)  # a staged row's
    assert -(-units // (16 * min(FMA_ROWS))) <= 32
    assert plan.vec == (ci % (16 // itemsize) == 0)


@pytest.mark.parametrize("n,h", [(1, 256), (2, 256), (4, 256), (8, 256), (2, 130)])
def test_fma_plan_spreads_over_the_sms(n, h):
    """Every SM gets work, or the blocks are the shortest there are; no
    other height leaves the busiest SM fewer rows; at batch 8, two waves of
    two blocks an SM."""
    plan = head_fma_plan(n, h, 256, 64, 3, F32)
    assert plan.blocks >= 0.95 * H100_SMS or plan.rows == min(FMA_ROWS)
    busiest = -(-plan.blocks // H100_SMS) * plan.rows
    for rows in FMA_ROWS:
        blocks = n * -(-h // rows) * plan.strips
        assert busiest <= -(-blocks // H100_SMS) * rows
    if n == 8:
        assert -(-plan.blocks // (_fma_per_sm(plan) * H100_SMS)) == 2


@pytest.mark.parametrize("shape", FMA_SHAPES)
def test_fma_pairs_keep_the_single_plan(shape):
    one = head_fma_plan(*shape, F32)
    two = head_fma_plan(*shape, F32, pairs=2)
    assert two._replace(pairs=1, grid=one.grid) == one
    assert two.grid == (*one.grid[:2], 2) and two.blocks == 2 * one.blocks


@pytest.mark.parametrize("n,h,w,ci,co,dtype,path", [
    (8, 256, 256, 64, 3, torch.bfloat16, "wgmma"),
    (8, 256, 256, 64, 3, F32, "fma"),
    (1, 40, 24, 8, 3, torch.bfloat16, "fma"),     # CI % 16 != 0
    (2, 8, 8, 144, 3, torch.bfloat16, "fma"),     # CI past the tensor cores' 128
    (2, 8, 8, 6, 3, F32, "fma"),                  # CI % 4 != 0: no 16-byte copies
    (2, 8, 8, 64, 9, torch.bfloat16, None),       # CO past 8: no plan
    (2, 8, 8, 64, 0, F32, None)])
def test_entry_plan_picks_the_path(n, h, w, ci, co, dtype, path):
    plan = head_entry_plan(n, h, w, ci, co, dtype)
    assert (plan and plan[0]) == path
    if path == "fma":
        fp = head_fma_plan(n, h, w, ci, co, dtype)
        assert plan[1:] == (fp.rows, fp.cols, fp.bands, fp.strips, fp.stages, FMA_KC,
                            int(fp.vec), fp.smem_bytes)


def _swz(c, tct):
    """The staged column's unit in its row (csrc/head_convt.cu swz_col)."""
    return c ^ ((c >> 3) & (3 if tct == 4 else 1))


def _emulate_fma(x, w, dtype, pairs=1):
    """head_fma_kernel in numpy (f64): per block, each chunk's stage (the
    halo tile's planes of 16-byte units through the swizzled rows, zero
    outside the map and past CI; the weights [tap][KC][CO] zero past CO and
    CI), each lane's products from its window reads and its taps' weights,
    and the epilogue's lines (at y's 16-byte phase) stored unit by unit into
    a flat y of all pairs. Returns (y, how often each value was written)."""
    npairs = x.shape[0] if pairs > 1 else 1
    xs_all = x if pairs > 1 else x[None]
    ws_all = w if pairs > 1 else w[None]
    n, h, wd, ci = xs_all.shape[1:]
    co = ws_all.shape[-1]
    plan = head_fma_plan(n, h, wd, ci, co, dtype, pairs=npairs)
    itemsize = 4 if dtype == F32 else 2
    vals = 16 // itemsize                 # values of a 16-byte unit
    planes = FMA_KC * itemsize // 16
    cot, tct, tc, rows = fma_co(co), plan.thread_cols, plan.cols, plan.rows
    xs_units, warps = tc + 2, rows // plan.thread_rows
    line_vals = 2 * tc * cot + vals
    size = n * 4 * h * wd * co
    y = np.full(npairs * size, np.nan)
    count = np.zeros(y.shape, np.int32)
    lane = np.arange(32)
    for p, band, strip, b in np.ndindex(npairs, plan.bands, plan.strips, n):
        xp, wp = xs_all[p], ws_all[p]
        i0, j0 = band * rows, strip * tc
        acc = np.zeros((warps, 32, 2, tct, 2, 2, cot))
        rr, cc = np.meshgrid(np.arange(rows + 2), np.arange(tc + 2), indexing="ij")
        iy, ix = i0 - 1 + rr, j0 - 1 + cc
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
        dst = rr * xs_units + _swz(cc, tct)
        assert (_swz(cc, tct) < xs_units).all()  # the swizzle keeps a row's units in it
        for c0 in range(0, ci, FMA_KC):
            stage = np.zeros((planes, (rows + 2) * xs_units, vals))
            for pl in range(planes):
                for k in range(vals):
                    if c0 + pl * vals + k < ci:
                        stage[pl, dst[inside], k] = xp[b, iy[inside], ix[inside],
                                                       c0 + pl * vals + k]
            kc = min(FMA_KC, ci - c0)
            wst = np.zeros((16, FMA_KC, cot))
            wst[:, :kc, :co] = wp[:, :, c0:c0 + kc].reshape(16, kc, co)
            for g in range(FMA_KC // 4):
                pl, half = (g, 0) if planes > 1 else (0, g)
                for dy in range(4):
                    units = ((2 * np.arange(warps)[:, None, None] + dy) * xs_units
                             + _swz(tct * lane[None, :, None] + np.arange(tct + 2), tct))
                    xr = stage[pl][units][..., 4 * half:4 * half + 4]  # warp, lane, dx, 4
                    for r, a in np.ndindex(2, 2):
                        u = dy - r - a
                        if not 0 <= u <= 1:
                            continue
                        for kw in range(4):
                            bb = (3 - kw) & 1
                            v = (3 - kw - bb) >> 1
                            wv = wst[(3 - a - 2 * u) * 4 + kw, 4 * g:4 * g + 4]
                            for s in range(tct):
                                acc[:, :, r, s, a, bb] += xr[:, :, s + bb + v] @ wv
        length = max(0, min(tc, wd - j0)) * 2 * co
        for wi, r, a in np.ndindex(warps, 2, 2):
            i = i0 + 2 * wi + r
            if i >= h:
                continue
            g0 = p * size + ((b * 2 * h + 2 * i + a) * 2 * wd + 2 * j0) * co
            lead = g0 % vals
            line = np.full(line_vals, np.nan)
            at = (lead + ((tct * lane[:, None, None] + np.arange(tct)[None, :, None]) * 2
                          + np.arange(2)[None, None, :])[..., None] * co + np.arange(co))
            line[at] = acc[wi, :, r, :, a, :, :co]
            start = g0 - lead
            assert start % vals == 0  # the stores' 16-byte units are y's
            for k in range(-(-(lead + length) // vals)):
                lo, hi = max(k * vals, lead), min(k * vals + vals, lead + length)
                y[start + lo:start + hi] = line[lo:hi]
                count[start + lo:start + hi] += 1
    shape = ((npairs,) if pairs > 1 else ()) + (n, 2 * h, 2 * wd, co)
    return y.reshape(shape), count


@pytest.mark.parametrize("n,h,w,ci,co,dtype", [
    (1, 5, 7, 12, 3, F32),          # one ragged band and strip
    (2, 18, 130, 8, 3, F32),        # two strips (the last 2 wide), ragged 4-row bands
    (1, 3, 5, 6, 1, F32),           # CI 6: no 16-byte copies; CO 1 on the CO-3 kernel
    (1, 6, 70, 16, 8, torch.bfloat16),   # CO 8: 2-column lane tiles, 64-column blocks
    (1, 4, 9, 20, 5, F32),          # CO 5 on the CO-8 kernel, CI 20: a half chunk
    (1, 7, 11, 8, 3, torch.bfloat16),    # bf16 CI 8: one unit a pixel
    (1, 5, 6, 12, 2, torch.bfloat16),    # bf16 CI 12: no 16-byte copies
    (1, 17, 9, 4, 7, F32),          # CI 4: half a chunk; 17 rows in blocks of 4
    (2, 3, 5, 3, 3, F32)])          # the stem's 3 channels (odd rows of y: leads)
def test_emulated_fma_kernel_matches_the_plain_version(n, h, w, ci, co, dtype):
    """Every output value written once and within 1e-5 relative of the plain
    version (which sums in f32)."""
    rng = np.random.RandomState(1)
    x = rng.randn(n, h, w, ci)
    wt = rng.randn(4, 4, ci, co)
    got, count = _emulate_fma(x, wt, dtype)
    assert (count == 1).all()
    want = head_convt_plain(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["f32", "bf16"])
def test_emulated_fma_kernel_on_a_pair_axis(dtype):
    """Two pairs, pair 1's y starting N*2H*2W*CO values after pair 0's (75
    values: off y's 16-byte phase, so its lines start at a lead): each
    pair's output equals the plain version's, every value written once."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 1, 3, 25, 8)
    wt = rng.randn(2, 4, 4, 8, 1)
    got, count = _emulate_fma(x, wt, dtype, pairs=2)
    assert (count == 1).all()
    for p in range(2):
        want = head_convt_plain(torch.from_numpy(x[p]), torch.from_numpy(wt[p])).numpy()
        np.testing.assert_allclose(got[p], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("co", [3, 8])
@pytest.mark.parametrize("rows", [4, 8, 16])  # the C entry's block heights
def test_fma_window_reads_fall_in_distinct_banks(rows, co):
    """A warp's float4 read of one window pixel (staged row 2 warp + dy,
    column TCT lane + dx) is served a quarter warp at a time: the eight
    lanes of each quarter hit eight distinct 16-byte bank groups, for every
    warp, window row and column, in every plane (planes and rows start on
    128-byte boundaries or shift all lanes alike)."""
    tct = 4 if fma_co(co) == 3 else 2
    xs_units = 32 * tct + 2
    lane = np.arange(32)
    for warp, dy, dx in np.ndindex(rows // 2, 4, tct + 2):
        unit = (2 * warp + dy) * xs_units + _swz(tct * lane + dx, tct)
        assert len(set(unit.tolist())) == 32
        for quarter in range(4):
            banks = unit[8 * quarter:8 * quarter + 8] % 8
            assert len(set(banks.tolist())) == 8, (rows, co, warp, dy, dx, quarter)


@pytest.mark.parametrize("co", [3, 8])
def test_fma_weight_reads_are_broadcasts(co):
    """A tap's weights for 4 channels are CO float4 at an address that
    depends on the tap, the channel group and the float4 alone, never on
    the lane: one broadcast wavefront each; each 16-byte aligned."""
    cot = fma_co(co)
    for kh, kw, g, m in np.ndindex(4, 4, FMA_KC // 4, cot):
        offset = ((kh * 4 + kw) * FMA_KC + 4 * g) * cot + 4 * m  # floats into the stage's w
        assert offset % 4 == 0 and offset + 4 <= 16 * FMA_KC * cot
