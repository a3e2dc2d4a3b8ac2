"""The plan of K5b, enc1's weight gradient (``ops/halo_conv.py::halo_dw_plan``).

The CUDA kernels (csrc/halo_conv_k4s2p1_dw.cu) take their path, split,
grid and shared memory from this plan, and the C entry refuses a plan whose
parts do not cover M exactly once; so the plan is checked here, on the CPU:
bf16 takes K4's wgmma design (``dw_plan``) at every shape K5b takes, with
parity planes where W/2 % 8 == 0 and per-tap windows elsewhere; at enc1 at
batch 8 it is 4 tiles split 33 ways on the card's 132 SMs; the parts cover
M exactly once; shared memory fits a block; f32 takes the CUDA-core
kernel (``halo_dw_fma_plan``), whose plan fits a block, covers the output
rows exactly once and fills the card. Shapes: enc1 of the 512px model at
batch 1, 2 and 8, the JAX tests' shapes (tests/test_pallas_halo_conv.py),
the odd 14x22 map and the edge shapes the card's tests hold the kernel to.
Numpy models of the wgmma kernel's staging and of the f32 kernel's (each
step's x one contiguous segment of an input row at a pixel stride of 2*CI,
its windows, the padding rows it skips, ragged steps, its split sums and
the pair axis) are held against the plain version at K5b shapes, with a
check of the f32 kernel's shared-memory reads' banks.
"""

import numpy as np
import pytest
import torch
from test_torch_dw_plan import _emulate_wgmma, _fma_lanes

from discogan_modernized_torch.ops.conv_k4s2p1 import (DW_BN, DW_CH, DW_CHUNK,
                                                       DW_MAX_TILES_PER_BLOCK,
                                                       H100_SMS, dw_plan)
from discogan_modernized_torch.ops.halo_conv import (
    HALO_DW_BLOCKS_PER_SM, HALO_DW_COLS, HALO_DW_MIN_ROWS, HALO_DW_ROWS, HALO_DW_STAGES,
    HALO_DW_STEP, HALO_DW_STEP_SHORT, SMEM_PER_BLOCK, halo_conv2d_k4s2p1_dw_plain,
    halo_dw_fma_plan, halo_dw_plan)

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
# The mesh's spatial bands at 512px (chip_smoke.py's mesh_cases): h/2 + 4 rows
BANDS = [(n, h // 2 + 4, w, ci, co) for n, h, w, ci, co in MAIN]
DTYPES = [torch.bfloat16, torch.float32]


def _units(n, h, w, plan):
    """Units of the contraction the parts cut: 64-pixel chunks (wgmma) or
    output rows (the f32 kernel)."""
    if plan.path == "fma":
        return n * (h // 2)
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


@pytest.mark.parametrize("shape", SHAPES + BANDS)
def test_f32_plan_fits_covers_and_fills(shape):
    """The f32 plan (``halo_dw_fma_plan``): tiles of one kernel row x
    HALO_DW_ROWS of its 4 CI dw rows x HALO_DW_COLS columns, HALO_DW_STEP
    pixels a step (HALO_DW_STEP_SHORT where that ring would not fit: CI
    over 80); its ring of segments and dy runs fits a block's shared memory
    (two of them an SM's, at two blocks an SM); the parts cover the
    N*H/2 output rows exactly once, each of at least HALO_DW_MIN_ROWS rows
    where the rows are split; the grid fills a wave of
    HALO_DW_BLOCKS_PER_SM blocks an SM or has no split left to add."""
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, torch.float32)
    assert plan == halo_dw_fma_plan(*shape)
    assert plan.path == "fma" and plan.taps == 0
    def ring(step):
        return plan.stages * (2 * ci * (step - 1) + HALO_DW_ROWS + step * HALO_DW_COLS) * 4

    step = HALO_DW_STEP if ring(HALO_DW_STEP) <= SMEM_PER_BLOCK else HALO_DW_STEP_SHORT
    assert step == HALO_DW_STEP or ci > 64
    assert plan.tile == (HALO_DW_ROWS, HALO_DW_COLS, step)
    assert plan.stages == HALO_DW_STAGES
    assert plan.smem_bytes == ring(step) <= SMEM_PER_BLOCK
    if HALO_DW_BLOCKS_PER_SM == 2 and ci <= 64:
        assert 2 * plan.smem_bytes <= 228 * 1024 - 2 * 1024  # an SM's, less a block's reserve
    rows = n * (h // 2)
    parts = [range(s * plan.steps_per_split, min(rows, (s + 1) * plan.steps_per_split))
             for s in range(plan.splits)]
    assert all(len(part) >= 1 for part in parts)
    assert sorted(i for part in parts for i in part) == list(range(rows))
    assert plan.splits == 1 or plan.steps_per_split >= HALO_DW_MIN_ROWS
    out_tiles = 4 * -(-4 * ci // HALO_DW_ROWS) * -(-co // HALO_DW_COLS)
    assert plan.tiles == plan.blocks == out_tiles * plan.splits
    wave = HALO_DW_BLOCKS_PER_SM * H100_SMS
    more = plan.splits + 1
    no_split_left = (out_tiles * more > wave or rows // more < HALO_DW_MIN_ROWS
                     or -(-rows // -(-rows // more)) == plan.splits)
    assert plan.tiles >= wave or no_split_left
    assert plan.tiles <= max(out_tiles, wave)


def test_f32_enc1_at_batch_8_and_1():
    """enc1: 4 tiles (4 kh x one window of all 256 dw rows x one column
    tile); batch 8's 1024 output rows in 32 parts of 32, batch 1's 128 in
    32 of 4: 128 blocks, one an SM. A stage is the 33,280-byte segment of 64
    pixels (stride 128 floats, the window 256) and dy's 32 KB; three of them
    198,144 bytes; the mesh's band of 132 rows a part of 16."""
    for n, (splits, per) in ((8, (32, 32)), (1, (32, 4))):
        plan = halo_dw_plan(n, *ENC1, torch.float32)
        assert (plan.splits, plan.steps_per_split, plan.blocks) == (splits, per, 128)
        assert plan.smem_bytes == 3 * (128 * 63 + 256 + 64 * 128) * 4 == 198_144
    band = halo_dw_plan(8, 132, 256, 64, 128, torch.float32)
    assert (band.splits, band.steps_per_split, band.blocks) == (33, 16, 132)


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


# ---- the f32 kernel (halo_dw_fma_kernel) ------------------------------------

THREADS = 256  # a window half's threads (csrc/dw_fma.cuh)


def _rows_at(v, ho, t):
    """Rows r in [0, v) with r % ho == t: the kernel's count."""
    return (v + ho - 1 - t) // ho


def _emulate_halo_dw_fma(xf, dyf, shape, plan, pairs=1):
    """halo_dw_fma_kernel and its reduce pass in numpy, from flat operands
    of ``pairs`` problems (each pair's x and dy one problem past the last):
    for each block (kh and window, column tile, z = pair * splits + split)
    its walk over the part's output rows, skipping the rows whose input row
    is padding, in steps of ``plan.tile[2]`` pixels; each step's x staged as
    the kernel stages it, one contiguous segment of the input row in 16-byte
    copies zero outside [0, W CI), read back at the pixel stride 2 CI; dy's
    run zero past the row's last pixel and past CO; the window's rows past
    4 CI dropped at the store; the split partials summed in order. Returns
    (pairs, 16 CI, CO)."""
    n, h, w, ci, co = shape
    ho, wo, wci = h // 2, w // 2, w * ci
    window, bn, step = plan.tile
    windows, co_tiles = -(-4 * ci // window), -(-co // bn)
    seg = 2 * ci * (step - 1) + window
    assert seg % 4 == 0
    a_index = 2 * ci * np.arange(step)[:, None] + np.arange(window)[None, :]
    assert a_index.max() < seg, "a lane's read past the segment"
    rows_total = n * ho
    parts = np.zeros((pairs, plan.splits, 16 * ci, co))
    for z in range(plan.splits * pairs):
        split, pair = z % plan.splits, z // plan.splits
        x = xf[pair * n * h * w * ci:]
        dy = dyf[pair * rows_total * wo * co:]
        row_begin = split * plan.steps_per_split
        row_end = min(rows_total, row_begin + plan.steps_per_split)
        for bx in range(4 * windows):
            kh, r0 = bx // windows, (bx % windows) * window
            pad_oy = 0 if kh == 0 else ho - 1 if kh == 3 else -1
            rows = row_end - row_begin - (0 if pad_oy < 0 else _rows_at(row_end, ho, pad_oy)
                                          - _rows_at(row_begin, ho, pad_oy))
            want_rows = [r for r in range(row_begin, row_end) if r % ho != pad_oy]
            assert rows == len(want_rows)
            nsteps = rows * -(-wo // step)
            for by in range(co_tiles):
                o0 = by * bn
                b, oy = divmod(row_begin, ho)

                def next_row(b, oy):
                    oy += 1
                    if oy == ho:
                        b, oy = b + 1, 0
                    if oy == pad_oy:
                        oy += 1
                        if oy == ho:
                            b, oy = b + 1, 0
                    return b, oy
                if oy == pad_oy:
                    b, oy = next_row(b, oy - 1)
                ox0, walked = 0, []
                acc = np.zeros((window, bn))
                for _ in range(nsteps):
                    iy = 2 * oy - 1 + kh
                    assert 0 <= iy < h and b < n, "a step on a padding row or past the map"
                    if ox0 == 0:
                        walked.append(b * ho + oy)
                    s0 = (2 * ox0 - 1) * ci + r0
                    assert s0 % 4 == 0, "a segment off a 16-byte boundary"
                    chunks = s0 + 4 * np.arange(seg // 4)
                    ok = (chunks >= 0) & (chunks < wci)  # a 16-byte copy is all in or all out
                    idx = (chunks[:, None] + np.arange(4)[None, :]).ravel()
                    segment = np.where(np.repeat(ok, 4),
                                       x[(b * h + iy) * wci + np.where(np.repeat(ok, 4), idx, 0)],
                                       0.0)
                    ox = ox0 + np.arange(step)
                    cols = o0 + np.arange(bn)
                    okb = (ox < wo)[:, None] & (cols < co)[None, :]
                    src = ((b * ho + oy) * wo + ox)[:, None] * co + cols[None, :]
                    dyt = np.where(okb, dy[np.where(okb, src, 0)], 0.0)
                    acc += segment[a_index].T @ dyt
                    ox0 += step
                    if ox0 >= wo:
                        ox0 = 0
                        b, oy = next_row(b, oy)
                assert walked == want_rows, "the walk missed or repeated a row"
                nr, nc = min(window, 4 * ci - r0), min(bn, co - o0)
                at = kh * 4 * ci + r0
                parts[pair, split, at:at + nr, o0:o0 + nc] = acc[:nr, :nc]
    out = np.zeros((pairs, 16 * ci, co))
    for s in range(plan.splits):
        out += parts[:, s]
    return out


# enc1 at batch 1 on a card of 132 SMs and of 8 (a split of 4 rows, and of 16),
# K5B_EDGE's shapes (chip_smoke.py: CI 16/32/48, CO 24/72/136, W/2 of 20, a
# ragged last part, two images), the odd 14x22 map (W/2 11: one ragged step a
# row), a band of 12 rows (a 512px band's shape cut down), CI 8 under a window
FMA_EMULATED = [((1, 256, 256, 64, 128), H100_SMS), ((1, 256, 256, 64, 128), 8),
                *[(shape, H100_SMS) for shape in EDGE[:6]],
                ((3, 14, 22, 8, 24), H100_SMS), ((2, 12, 256, 64, 128), 16),
                ((2, 16, 16, 8, 16), 4)]


@pytest.mark.parametrize("shape,sms", FMA_EMULATED)
def test_emulated_fma_matches_the_plain_version(shape, sms):
    """The f32 kernel's staging and split sums, against the plain version
    (f64 sums: 1e-4 of max|ref|); a band's dy rows past its kept rows are
    zero, as the mesh passes them."""
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, torch.float32, sms=sms)
    rng = np.random.RandomState(7)
    x = rng.randn(n, h, w, ci)
    dy = rng.randn(n, h // 2, w // 2, co)
    if h == 12:  # the band: its two dropped output rows take no cotangent
        dy[:, 0] = dy[:, -1] = 0
    got = _emulate_halo_dw_fma(x.ravel(), dy.ravel(), shape, plan)[0]
    want = halo_conv2d_k4s2p1_dw_plain(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(got.reshape(4, 4, ci, co), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_emulated_fma_pairs_match_single_calls():
    """Two problems on the pair axis (z = pair * splits + split, each pair's
    operands and partials one problem past the last): each pair's dw is its
    single call's."""
    shape = (3, 30, 40, 16, 72)
    n, h, w, ci, co = shape
    plan = halo_dw_plan(*shape, torch.float32, sms=8, pairs=2)
    assert plan.splits > 1 and plan.pairs == 2
    rng = np.random.RandomState(8)
    x = rng.randn(2, n, h, w, ci)
    dy = rng.randn(2, n, h // 2, w // 2, co)
    got = _emulate_halo_dw_fma(x.ravel(), dy.ravel(), shape, plan, pairs=2)
    for p in range(2):
        want = halo_conv2d_k4s2p1_dw_plain(torch.from_numpy(x[p]),
                                           torch.from_numpy(dy[p])).numpy()
        np.testing.assert_allclose(got[p].reshape(4, 4, ci, co), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("ci", [8, 16, 32, 48, 64])
def test_fma_reads_are_free_of_bank_conflicts(ci):
    """A warp's float4 reads of a staged pixel p: of A at p * 2 CI + its
    half's first row + the lane's rows r0 + 16 i (4 distinct 16-byte words:
    the warp's four ty), of B at the segment's end + p * HALO_DW_COLS + the
    lane's columns c0 + 32 j (8 words: its eight tx). A segment starts on a
    16-byte boundary and its length (2 CI (STEP - 1) + ROWS floats) keeps B
    on one, so the distinct words of a read fall in distinct groups of four
    banks; and the 16-byte copies of consecutive threads land in
    consecutive words."""
    window, bn, step = HALO_DW_ROWS, HALO_DW_COLS, HALO_DW_STEP
    seg = 2 * ci * (step - 1) + window
    assert seg % 4 == 0
    lanes = _fma_lanes(128, bn)
    for half in range(window // 128):
        for warp in range(THREADS // 32):
            ws = lanes[32 * warp:32 * warp + 32]
            for p in (0, 1, step - 1):
                for i in range(128 // 64):
                    words = {(p * 2 * ci + half * 128 + int(rows[4 * i])) // 4 for rows, _ in ws}
                    assert len(words) == 4 and len({wd % 8 for wd in words}) == 4, (ci, p, i)
                for j in range(bn // 64):
                    words = {(seg + p * bn + int(cols[4 * j])) // 4 for _, cols in ws}
                    assert len(words) == 8 and len({wd % 8 for wd in words}) == 8, (ci, p, j)
    # the copies: thread t's j-th A copy at 16-byte word t + BLOCK j, its B copy
    # at row t // 32 + ..., column word t % 32: a warp's 32 words consecutive
    for warp in range(THREADS * (window // 128) // 32):
        tids = np.arange(32 * warp, 32 * warp + 32)
        assert len({int(t) % 8 for t in tids}) == 8
        b_words = (seg // 4 + (tids // (bn // 4)) * (bn // 4) + tids % (bn // 4))
        assert np.all(np.diff(b_words) == 1)
