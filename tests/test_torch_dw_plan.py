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
tiles as the plan cuts them) is held against the plain version, and one of
the FMA kernel's ring (its copies, their pixel walk, the zero-filled
padding taps, the lanes' micro-tiles, the split partials in the reduce
pass's order), with a check of its shared-memory reads' banks.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.conv_k4s2p1 import (
    DW_BN, DW_CH, DW_CHUNK, DW_FMA_BLOCKS_PER_SM, DW_FMA_MIN_STEPS_PER_SPLIT,
    DW_FMA_STAGES, DW_FMA_STAGES_WIDE, DW_FMA_STEP, DW_FMA_STEP_VEC, DW_FMA_TILE,
    DW_FMA_TILE_SMALL, DW_FMA_WIDE_BLOCKS,
    DW_GROUP_PX, DW_MAX_TILES_PER_BLOCK, DW_MIN_CHUNKS_PER_SPLIT, H100_SMS,
    conv2d_k4s2p1_dw_plain, dw_plan)
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
    bm, bn, bk = plan.tile
    assert plan.path == "fma" and plan.stages == DW_FMA_STAGES
    assert plan.smem_bytes == DW_FMA_STAGES * bk * (bm + bn) * 4 <= SMEM_PER_BLOCK


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


@pytest.mark.parametrize("shape", MAIN + EDGE)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_pairs_keep_the_single_plan(shape, dtype):
    """P = 2 (the pair axis): the plan of a single call for each pair, its
    split partials twice over."""
    one, two = dw_plan(*shape, dtype), dw_plan(*shape, dtype, pairs=2)
    assert two._replace(pairs=1) == one
    ci, co = shape[-2:]
    parts = one.splits > 1 or one.path == "wgmma_stem"
    assert one.workspace_floats(ci, co) == (one.splits * 16 * ci * co if parts else 0)
    assert two.workspace_floats(ci, co) == 2 * one.workspace_floats(ci, co)


# ---- the FMA kernel (conv_dw_fma_kernel): every f32 call ---------------------

THREADS = 256
# The f32 shapes of the training step: the layers at batch 1, 2 and 8, a band
# of h/2 + 4 rows (spatial sharding over two ranks), enc2..enc6's CO/2
# (tensor parallelism over two), the edge shapes.
FMA_SHAPES = (MAIN
              + [(n, h // 2 + 4, w, ci, co) for n, h, w, ci, co in MAIN]
              + [(n, h, w, ci, co // 2) for n, h, w, ci, co in MAIN if ci > 3]
              + EDGE)


def _fma_vec(dtype, ci, co):
    """(16-byte copies of x, of dy): f32 with CI and CO multiples of 4, f32
    with CO a multiple of 4."""
    f32 = dtype == torch.float32
    return f32 and ci % 4 == 0 and co % 4 == 0, f32 and co % 4 == 0


@pytest.mark.parametrize("shape", FMA_SHAPES)
def test_fma_plan_fits_covers_and_fills(shape):
    """The f32 plan: 64 x 64 tiles where 16 CI or CO fits in one (the
    stem), else 128 x 128; 32-pixel steps where the 16-byte copies fill
    them; the ring fits a block's shared memory; the parts cover M's steps
    exactly once, each of at least the minimum where M is split; the grid
    fills a wave (DW_FMA_BLOCKS_PER_SM blocks an SM, DW_FMA_WIDE_BLOCKS
    where the copies fill 128 x 128 tiles' steps) or has no split left to
    add; a grid of those of more than one block an SM takes the ring of two
    blocks an SM, and two such rings fit an SM."""
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, torch.float32)
    bm, bn, bk = plan.tile
    assert plan.path == "fma" and plan.taps == 0
    small = 16 * ci <= DW_FMA_TILE_SMALL[0] or co <= DW_FMA_TILE_SMALL[1]
    assert (bm, bn) == (DW_FMA_TILE_SMALL if small else DW_FMA_TILE)
    vec = _fma_vec(torch.float32, ci, co)[0]
    assert bk == (DW_FMA_STEP_VEC if vec else DW_FMA_STEP)
    wide = vec and not small and plan.tiles > H100_SMS
    assert plan.stages == (DW_FMA_STAGES_WIDE if wide else DW_FMA_STAGES)
    assert plan.smem_bytes == plan.stages * bk * (bm + bn) * 4 <= SMEM_PER_BLOCK
    if wide:
        assert 2 * plan.smem_bytes <= 228 * 1024 - 2 * 1024  # an SM's, less a block's reserve
    steps = -(-(n * (h // 2) * (w // 2)) // bk)
    parts = [range(s * plan.steps_per_split, min(steps, (s + 1) * plan.steps_per_split))
             for s in range(plan.splits)]
    assert all(len(part) >= 1 for part in parts)
    assert sorted(i for part in parts for i in part) == list(range(steps))
    assert plan.splits == 1 or plan.steps_per_split >= DW_FMA_MIN_STEPS_PER_SPLIT
    out_tiles = -(-16 * ci // bm) * -(-co // bn)
    assert plan.tiles == plan.blocks == out_tiles * plan.splits
    wave = (DW_FMA_WIDE_BLOCKS if vec and not small else DW_FMA_BLOCKS_PER_SM[(bm, bn)]) * H100_SMS
    more = plan.splits + 1
    no_split_left = (out_tiles * more > wave
                     or steps // more < DW_FMA_MIN_STEPS_PER_SPLIT
                     or -(-steps // -(-steps // more)) == plan.splits)
    assert plan.tiles >= wave or no_split_left
    assert plan.splits == 1 or out_tiles * plan.splits <= wave


def test_fma_plan_splits_enc2_enc3_and_the_stem_only():
    """At batch 8: enc2's 32 tiles split M eight ways and enc3's 128 two
    ways (256 blocks: two an SM); the stem's one 64 x 64 tile over
    DW_FMA_BLOCKS_PER_SM blocks an SM; enc4..enc6 fill two blocks an SM or
    more unsplit. Every 128 x 128 layer takes the ring of two blocks an
    SM."""
    plans = {name: dw_plan(8, *shape, torch.float32) for name, shape in LAYERS.items()}
    wave = DW_FMA_BLOCKS_PER_SM[DW_FMA_TILE_SMALL] * H100_SMS
    assert plans["enc2"].splits == 8 and plans["enc3"].splits == 2
    assert 0.99 * wave <= plans["enc0"].splits <= wave
    assert all(plans[name].splits == 1 for name in ("enc4", "enc5", "enc6"))
    assert [plans[name].stages for name in LAYERS] == [DW_FMA_STAGES] + [
        DW_FMA_STAGES_WIDE] * 5
    assert dw_plan(8, *LAYERS["enc2"], torch.float32, sms=66).splits == 4
    # enc2 at batch 1 on a card of 1024 SMs: its 128 steps split 16 ways
    # (parts of 8), 512 blocks, under one an SM: the ring of one block an SM
    few = dw_plan(1, *LAYERS["enc2"], torch.float32, sms=1024)
    assert few.splits == 16 and few.stages == DW_FMA_STAGES


def _fma_lanes(bm, bn):
    """Each lane's (dw rows, columns) of its block's tile (csrc/dw_fma.cuh):
    warp w holds rows (w // 2) bm/4 .., columns (w % 2) bn/2 ..; lane 8 ty +
    tx rows wm + 4 ty + 16 i + e, columns wn + 4 tx + 32 j + f."""
    tm, tn = bm // 16, bn // 16
    out = []
    for t in range(THREADS):
        warp, lane = divmod(t, 32)
        ty, tx = divmod(lane, 8)
        r0 = (warp // 2) * (bm // 4) + 4 * ty
        c0 = (warp % 2) * (bn // 2) + 4 * tx
        rows = np.array([r0 + 16 * (i // 4) + i % 4 for i in range(tm)])
        cols = np.array([c0 + 32 * (j // 4) + j % 4 for j in range(tn)])
        out.append((rows, cols))
    return out


def _advance_of(px, hw, wo):
    db, r = divmod(px, hw)
    dy, dx = divmod(r, wo)
    return db, dy, dx


def _advance(pix, adv, ho, wo, bk):
    """The kernel's walk of a pixel slot by one step: (b, oy, ox, m) plus
    (images, rows, columns) of the step, one carry each."""
    b, oy, ox, m = pix
    db, dy, dx = adv
    ox = ox + dx
    cx = ox >= wo
    ox = np.where(cx, ox - wo, ox)
    oy = oy + dy + cx
    cy = oy >= ho
    oy = np.where(cy, oy - ho, oy)
    return b + db + cy, oy, ox, m + bk


def _emulate_dw_fma(xf, dyf, shape, plan, dtype, pairs=1):
    """conv_dw_fma_kernel and its reduce pass in numpy, from flat operands
    of ``pairs`` problems (each pair's x and dy one problem's size past the
    last): for each block (row tile, column tile, z = pair * splits +
    split), each step's A and B as its threads copy them (UA or UB values a
    copy, each value written once; the slots' pixels walked by ``_advance``,
    a tap in the padding or a pixel past the part zero), each lane's
    micro-tile of products, the partials of a split summed in the reduce
    pass's order (slices of 8 parts from 16 up). Returns (pairs, 16 CI, CO)."""
    n, h, w, ci, co = shape
    ho, wo = h // 2, w // 2
    hw, m_total, k_total = ho * wo, n * (h // 2) * (w // 2), 16 * ci
    bm, bn, bk = plan.tile
    va, vb = _fma_vec(dtype, ci, co)
    ua, ub = (4 if va else 1), (4 if vb else 1)
    a_cols, b_cols = bm // ua, bn // ub
    a_rows, b_rows = THREADS // a_cols, THREADS // b_cols
    lanes = _fma_lanes(bm, bn)
    cover = np.zeros((bm, bn), np.int32)
    for rows, cols in lanes:
        cover[np.ix_(rows, cols)] += 1
    assert (cover == 1).all(), "the lanes' micro-tiles do not cover the tile once"
    lane_rows = np.stack([r for r, _ in lanes])
    lane_cols = np.stack([c for _, c in lanes])
    tid = np.arange(THREADS)
    adv = _advance_of(bk, hw, wo)
    parts = np.zeros((pairs, plan.splits, k_total, co))
    for z in range(plan.splits * pairs):
        split, pair = z % plan.splits, z // plan.splits
        x = xf[pair * n * h * w * ci:]
        dy = dyf[pair * m_total * co:]
        m_begin = split * plan.steps_per_split * bk
        m_end = min(m_total, m_begin + plan.steps_per_split * bk)
        for k0 in range(0, k_total, bm):
            a_col, a_row = tid % a_cols, tid // a_cols
            ka = k0 + a_col * ua
            ka_ok = ka < k_total
            tap = np.where(ka_ok, ka // ci, 0)
            ch = np.where(ka_ok, ka - tap * ci, 0)
            kh, kw = tap >> 2, tap & 3
            delta = (kh * w + kw) * ci + ch
            for o0 in range(0, co, bn):
                slots = []
                for j in range(bk // a_rows):
                    m = m_begin + a_row + a_rows * j
                    b, r = np.divmod(m, hw)
                    oy, ox = np.divmod(r, wo)
                    slots.append((b, oy, ox, m))
                b_col, b_row = tid % b_cols, tid // b_cols
                col = o0 + b_col * ub
                b_ok = col < co
                acc = np.zeros((bm, bn))
                nsteps = -(-(m_end - m_begin) // bk)
                ring = [None] * plan.stages

                def stage(q):
                    """Step q's A and B into its ring slot, as the threads
                    copy them; every slot a step on."""
                    a = np.full((bk, bm), np.nan)
                    bt = np.full((bk, bn), np.nan)
                    for j, (b, oy, ox, m) in enumerate(slots):
                        iy, ix = 2 * oy - 1 + kh, 2 * ox - 1 + kw
                        ok = ka_ok & (m < m_end) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                        src = ((b * h + 2 * oy - 1) * w + 2 * ox - 1) * ci + delta
                        for e in range(ua):
                            at = (a_row + a_rows * j, a_col * ua + e)
                            assert np.isnan(a[at]).all(), "A written twice"
                            a[at] = np.where(ok, x[np.where(ok, src + e, 0)], 0.0)
                        slots[j] = _advance((b, oy, ox, m), adv, ho, wo, bk)
                    for j in range(bk // b_rows):
                        m = m_begin + q * bk + b_row + b_rows * j
                        ok = b_ok & (m < m_end)
                        for e in range(ub):
                            at = (b_row + b_rows * j, b_col * ub + e)
                            assert np.isnan(bt[at]).all(), "B written twice"
                            bt[at] = np.where(ok, dy[np.where(ok, m * co + col + e, 0)], 0.0)
                    assert not np.isnan(a).any() and not np.isnan(bt).any(), "a gap"
                    assert ring[q % plan.stages] is None, "a slot overwritten before its products"
                    ring[q % plan.stages] = (a, bt)

                # the prologue fills stages - 1 slots; step q's products
                # follow the staging of step q + stages - 1 into the slot
                # step q - 1 freed
                for q in range(min(plan.stages - 1, nsteps)):
                    stage(q)
                for q in range(nsteps):
                    if q + plan.stages - 1 < nsteps:
                        stage(q + plan.stages - 1)
                    a, bt = ring[q % plan.stages]
                    ring[q % plan.stages] = None
                    prods = np.einsum("pli,plj->lij", a[:, lane_rows], bt[:, lane_cols])
                    np.add.at(acc, (lane_rows[:, :, None], lane_cols[:, None, :]), prods)
                rows, cols = min(bm, k_total - k0), min(bn, co - o0)
                parts[pair, split, k0:k0 + rows, o0:o0 + cols] = acc[:rows, :cols]
    slices = 8 if plan.splits >= 16 else 1
    out = np.zeros((pairs, k_total, co))
    for sl in range(slices):
        out += parts[:, sl::slices].sum(1)
    return out


@pytest.mark.parametrize("shape,dtype,sms", [
    ((2, 32, 32, 128, 256), torch.float32, H100_SMS),   # enc2-like: split in 2, 16-byte copies
    ((3, 14, 10, 16, 72), torch.float32, H100_SMS),     # ragged M (105), rows span 8 taps
    ((2, 8, 8, 32, 136), torch.float32, H100_SMS),      # CO off the tile: two column tiles
    ((2, 64, 64, 3, 64), torch.float32, H100_SMS),      # the stem: 16 parts, scalar x loads
    ((2, 16, 16, 1, 8), torch.float32, H100_SMS),       # the stem at CI 1, CO 8
    ((3, 14, 10, 3, 64), torch.float32, 8),             # the stem at CI 3, ragged, split
    ((2, 16, 16, 4, 64), torch.float32, H100_SMS),      # CI 4: 16-byte copies, 64 x 64
    ((2, 16, 16, 4, 12), torch.bfloat16, H100_SMS),     # CI 4 in bf16: scalar loads
    ((3, 10, 6, 12, 6), torch.float32, 4),              # CI 12, CO 6: scalar, split
    ((2, 6, 10, 96, 132), torch.bfloat16, 8),           # bf16 CO off the wgmma tiles, split
])
def test_emulated_fma_matches_the_plain_version(shape, dtype, sms):
    """The FMA kernel's ring as its threads fill it, its lanes' micro-tiles
    and its split partials in the reduce pass's order, against the plain
    version (f32 sums: 1e-4 of max|ref|)."""
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, dtype, sms=sms)
    assert plan.path == "fma"
    rng = np.random.RandomState(5)
    x = rng.randn(n, h, w, ci)
    dy = rng.randn(n, h // 2, w // 2, co)
    got = _emulate_dw_fma(x.ravel(), dy.ravel(), shape, plan, dtype)[0]
    want = conv2d_k4s2p1_dw_plain(torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(got.reshape(4, 4, ci, co), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_emulated_fma_pairs_match_single_calls():
    """Two problems on the pair axis (z = pair * splits + split, each pair's
    operands and partials one problem past the last): each pair's dw is its
    single call's."""
    shape = (2, 32, 32, 16, 72)
    n, h, w, ci, co = shape
    plan = dw_plan(*shape, torch.float32, sms=8, pairs=2)
    assert plan.splits > 1 and plan.pairs == 2
    rng = np.random.RandomState(6)
    x = rng.randn(2, n, h, w, ci)
    dy = rng.randn(2, n, h // 2, w // 2, co)
    got = _emulate_dw_fma(x.ravel(), dy.ravel(), shape, plan, torch.float32, pairs=2)
    for p in range(2):
        want = conv2d_k4s2p1_dw_plain(torch.from_numpy(x[p]), torch.from_numpy(dy[p])).numpy()
        np.testing.assert_allclose(got[p].reshape(4, 4, ci, co), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("tile", [DW_FMA_TILE, DW_FMA_TILE_SMALL])
def test_fma_reads_are_free_of_bank_conflicts(tile):
    """A warp's float4 reads of a staged pixel: of A, each lane's rows r0 +
    16 i (4 distinct 16-byte words a warp: its four ty); of B, its columns
    c0 + 32 j (8 words: its eight tx). A pixel row starts on a 128-byte
    boundary, so the distinct words a read touches fall in distinct groups
    of four banks."""
    bm, bn = tile
    lanes = _fma_lanes(bm, bn)
    for warp in range(THREADS // 32):
        ws = lanes[32 * warp:32 * warp + 32]
        for i in range(bm // 64):
            words = {int(rows[4 * i]) // 4 for rows, _ in ws}
            assert len(words) == 4 and len({wd % 8 for wd in words}) == 4, (tile, warp, i)
        for j in range(bn // 64):
            words = {int(cols[4 * j]) // 4 for _, cols in ws}
            assert len(words) == 8 and len({wd % 8 for wd in words}) == 8, (tile, warp, j)


def test_kernel_symbols_name_each_kernel_once():
    """chip_smoke.py labels a profiled kernel by the first KERNEL_SYMBOLS
    key inside its name: no key may lie inside another, or a kernel would
    be counted under the wrong one. K4's and K5b's FMA kernels are named;
    the ones they replaced are gone, and no f32 route's off-route name lies
    inside a kernel of that route."""
    import chip_smoke

    keys = list(chip_smoke.KERNEL_SYMBOLS)
    assert not [(a, b) for a in keys for b in keys if a != b and a in b]
    assert chip_smoke.KERNEL_SYMBOLS["conv_dw_fma_kernel"].startswith("K4 ")
    assert chip_smoke.KERNEL_SYMBOLS["halo_dw_fma_kernel"].startswith("K5b ")
    assert "conv_dw_kernel" not in keys and "halo_dw_kernel" not in keys
    for main, sums, off in chip_smoke.F32_ROUTES.values():
        assert not [(o, k) for o in off for k in (main, *sums) if o in k]


def test_dw_ab_variants_keep_an_instantiated_plan():
    """tools/dw_ab.py's K4 variants: each text patch matches
    csrc/conv_k4s2p1_dw.cu once, and under its plan constants every K4
    layer's f32 plan at batch 1 and 8 asks for a ring and a step the patched
    source instantiates (RING at one block an SM, RING_WIDE at two for the
    16-byte copies' 128 x 128 tiles; step_px) and fits a block. Its K5b
    variants: each patch matches csrc/halo_conv_k4s2p1_dw.cu once, and under
    its plan constants enc1's f32 plan at batch 1 and 8 and on the mesh's
    band asks for the window, step and ring the patched source has, with as
    many blocks an SM as its launch bounds allow (128 registers a thread at
    least), and its ring fits a block (and two of them an SM at two)."""
    import re

    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.tools import dw_ab

    source = (_build.CSRC / "conv_k4s2p1_dw.cu").read_text()
    for name, (patches, constants) in dw_ab.VARIANTS.items():
        text = source
        for old, new in patches:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        ring, ring_wide = map(int, re.search(
            r"constexpr int RING = (\d+), RING_WIDE = (\d+);", text).groups())
        step = int(re.search(r"constexpr int step_px\(\) \{ return VA \? (\d+) : 16; \}",
                             text).group(1))
        with dw_ab._plan_constants(**constants):
            for n in (1, 8):
                for shape in LAYERS.values():
                    plan = dw_plan(n, *shape, torch.float32)
                    vec = _fma_vec(torch.float32, *shape[2:])[0]
                    wide_ok = vec and plan.tile[:2] == DW_FMA_TILE
                    assert plan.path == "fma" and plan.tile[2] == (step if vec else 16), name
                    assert plan.stages == ring or (wide_ok and plan.stages == ring_wide), name
                    assert plan.smem_bytes <= SMEM_PER_BLOCK, name

    from discogan_modernized_torch.ops import halo_conv

    source = (_build.CSRC / "halo_conv_k4s2p1_dw.cu").read_text()
    for name, (patches, constants) in dw_ab.K5B_VARIANTS.items():
        text = source
        for old, new in patches:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)

        def const(pattern):
            return int(re.search(pattern, text).group(1))
        window, ring = const(r"constexpr int WINDOW = (\d+);"), const(r"constexpr int RING = (\d+);")
        step, short = map(int, re.search(r"constexpr int STEP = (\d+), STEP_SHORT = (\d+);",
                                         text).groups())
        min_blocks = const(r"constexpr int MIN_BLOCKS = (\d+);")
        assert min_blocks * 256 * (window // 128) <= 512, name  # 128 registers a thread at least
        with dw_ab._plan_constants(**constants):
            assert halo_conv.HALO_DW_BLOCKS_PER_SM == min_blocks, name
            for shape in ((1, 256, 256, 64, 128), (8, 256, 256, 64, 128), (8, 132, 256, 64, 128)):
                plan = halo_conv.halo_dw_plan(*shape, torch.float32)
                assert plan.tile == (window, 128, step) and plan.stages == ring, name
                assert plan.smem_bytes <= SMEM_PER_BLOCK, name
                if min_blocks == 2:
                    assert 2 * plan.smem_bytes <= 228 * 1024 - 2 * 1024, name
            assert halo_conv.halo_dw_plan(1, 16, 16, 128, 128,
                                          torch.float32).tile[2] in (step, short), name
