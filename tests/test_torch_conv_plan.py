"""The plan of K3, the halving conv (``ops/conv_k4s2p1.py::conv_plan``).

The CUDA kernels (csrc/conv_k4s2p1.cu) take their path, tile, ring, split
over K, grid and shared memory from this plan, and the C entry refuses a
plan whose splits do not cover K exactly once; so the plan is checked here,
on the CPU, at every K3 shape of the 512px model (enc0 and enc2..enc6 at
batch 1, 2, 4 and 8), of the 64px model, and at the edge shapes the card's
tests hold the kernels to (chip_smoke.py's K3_EDGE): bf16 deep layers take
the wgmma kernel and the stem its own; f32 and shapes off the tiles take
the FMA kernel; the splits cover the K steps once; the grid fills about one
wave of the card's 132 SMs or has no split left to add; shared memory fits
a block. A numpy model of the wgmma kernel's staging (A's im2col rows in tap
order with the padding zero-filled, at their swizzled 16-byte units; B's
MN-major blocks; the split and the statistics' partial rows) and of the
stem's im2col (48 values padded to 64), fed by a seeded numpy generator, is
held against the plain version.
"""

import numpy as np
import pytest
import torch

from discogan_modernized_torch.ops.conv_k4s2p1 import (
    CONV_BK, CONV_MIN_STEPS_PER_SPLIT, CONV_SPLIT_STAT_ROWS, CONV_STEM_BLOCKS_PER_SM,
    CONV_STEM_CHUNK, CONV_STEM_MIN_CHUNKS, CONV_WIDE_FILL, H100_SMS, MAX_SMEM_BYTES,
    conv2d_k4s2p1_plain, conv_plan)

THREADS = 256  # conv_wgmma_kernel's block (two warpgroups)
STEM_THREADS = 128

# (h, w, ci, co) of the K3 layers of the 512px generator (enc1 takes K5f);
# the discriminator's halving convs have the same shapes.
LAYERS_512 = {"enc0": (512, 512, 3, 64), "enc2": (128, 128, 128, 256),
              "enc3": (64, 64, 256, 512), "enc4": (32, 32, 512, 1024),
              "enc5": (16, 16, 1024, 2048), "enc6": (8, 8, 2048, 2048)}
LAYERS_64 = {"enc0": (64, 64, 3, 64), "enc1": (32, 32, 64, 128),
             "enc2": (16, 16, 128, 256), "enc3": (8, 8, 256, 512)}
MAIN = ([(n, *s) for s in LAYERS_512.values() for n in (1, 2, 4, 8)]
        + [(n, *s) for s in LAYERS_64.values() for n in (1, 8, 64)])
MAIN_IDS = ([f"512-{k}-b{n}" for k in LAYERS_512 for n in (1, 2, 4, 8)]
            + [f"64-{k}-b{n}" for k in LAYERS_64 for n in (1, 8, 64)])
# CO 72 (off the 128 tile; split and unsplit), M under one 64-row tile (enc6
# at batch 1: 16 pixels), ragged M (105 pixels split, 8649 unsplit), a split
# that does not divide the K steps (64 steps in 13 parts), CI 32 and 96 (the
# FMA kernel), stems of 1, 3 and 4 channels.
EDGE = [(2, 16, 16, 64, 72), (16, 64, 64, 64, 72), (1, 8, 8, 2048, 2048),
        (3, 14, 10, 64, 128), (9, 62, 62, 64, 128), (5, 32, 32, 256, 128),
        (2, 32, 32, 32, 64), (2, 6, 10, 96, 136), (2, 16, 16, 1, 64),
        (3, 14, 10, 3, 64), (2, 32, 32, 4, 128)]
SHAPES = MAIN + EDGE


def _m(shape):
    n, h, w, _, _ = shape
    return n * (h // 2) * (w // 2)


@pytest.mark.parametrize("shape", MAIN, ids=MAIN_IDS)
def test_bf16_layers_take_the_tensor_cores(shape):
    plan = conv_plan(*shape, torch.bfloat16)
    if shape[3] == 3:
        assert plan.path == "wgmma_stem" and plan.tile == (64, 64, 48)
    else:
        assert plan.path == "wgmma" and plan.tile[2] == CONV_BK
        assert plan.tile[0] == (64 if _m(shape) <= 64 else 128)


@pytest.mark.parametrize("dtype,ci,co", [
    (torch.float32, 128, 256),   # f32 takes the FMA kernel
    (torch.float32, 3, 64),
    (torch.bfloat16, 32, 64),    # CI % 64 != 0 and over the stem's 4
    (torch.bfloat16, 96, 136),
    (torch.bfloat16, 16, 64),
    (torch.bfloat16, 128, 12),   # CO % 8 != 0
    (torch.bfloat16, 3, 72),     # the stem wants CO % 64 == 0
    (torch.bfloat16, 5, 64),
])
def test_fma_takes_what_the_tensor_cores_do_not(dtype, ci, co):
    plan = conv_plan(2, 16, 16, ci, co, dtype)
    assert plan.path == "fma" and plan.smem_bytes == 0 and plan.splits == 1
    assert plan.grid == (2, -(-co // 64), 1) and plan.stat_rows == 2  # M = 128


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_splits_cover_k_exactly_once(shape, dtype):
    """The wgmma path's parts of the K steps, the stem's blocks along M."""
    plan = conv_plan(*shape, dtype)
    if plan.path == "fma":
        return
    units = (16 * shape[3] // CONV_BK if plan.path == "wgmma"
             else -(-_m(shape) // CONV_STEM_CHUNK))
    count = np.zeros(units, np.int32)
    for part in range(plan.splits):
        r = range(part * plan.steps_per_split, min(units, (part + 1) * plan.steps_per_split))
        assert len(r) >= 1, "a part with no steps"
        count[r.start:r.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_fills_a_wave_or_has_no_split_left(shape):
    """Split K only while the tiles fill less than a wave, into as many
    parts as fit in it: one more part would pass the wave, leave parts under
    the minimum, or round to the same parts. The stem fills its blocks an
    SM or gives each block its minimum of chunks."""
    plan = conv_plan(*shape, torch.bfloat16)
    if plan.path == "wgmma":
        steps = 16 * shape[3] // CONV_BK
        tiles = plan.grid[0] * plan.grid[1]
        assert plan.grid[2] == plan.splits
        assert tiles * plan.splits <= max(tiles, H100_SMS)
        no_split_left = (tiles * (plan.splits + 1) > H100_SMS
                         or steps // (plan.splits + 1) < CONV_MIN_STEPS_PER_SPLIT
                         or -(-steps // -(-steps // (plan.splits + 1))) == plan.splits)
        assert no_split_left
    elif plan.path == "wgmma_stem":
        chunks = -(-_m(shape) // CONV_STEM_CHUNK)
        wave = CONV_STEM_BLOCKS_PER_SM * H100_SMS
        assert plan.grid[1] == plan.splits and plan.grid[0] * plan.splits <= wave
        fewer = plan.steps_per_split - 1  # chunks a block if one more block were had
        assert (fewer < CONV_STEM_MIN_CHUNKS or plan.splits == chunks
                or -(-chunks // fewer) * plan.grid[0] > wave)


def test_512px_batch8_tiles():
    """Wide tiles where they fill a wave unsplit (enc2, enc3), 128 x 128
    elsewhere; K split on enc5 and enc6; the stem over 4 blocks an SM."""
    want = {"enc2": ((128, 256, 64), 1), "enc3": ((128, 256, 64), 1),
            "enc4": ((128, 128, 64), 1), "enc5": ((128, 128, 64), 2),
            "enc6": ((128, 128, 64), 8), "enc0": ((64, 64, 48), 512)}
    for name, (tile, splits) in want.items():
        plan = conv_plan(8, *LAYERS_512[name], torch.bfloat16)
        assert (plan.tile, plan.splits) == (tile, splits), name
    for n in (1, 4):  # M <= 64 at enc6 (and enc5 at batch 1): 64-row tiles
        assert conv_plan(n, *LAYERS_512["enc6"], torch.bfloat16).tile == (64, 128, 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_wide_tiles_fill_a_wave(shape):
    plan = conv_plan(*shape, torch.bfloat16)
    if plan.path == "wgmma" and plan.tile[1] == 256:
        assert plan.splits == 1 and shape[4] % 256 == 0
        assert plan.grid[0] * plan.grid[1] >= CONV_WIDE_FILL * H100_SMS


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_and_workspace(shape):
    """Shared memory fits a block and holds the ring (the epilogue's line
    and partial sums reuse it); the workspace holds the split's partials
    and the statistics' partial rows."""
    plan = conv_plan(*shape, torch.bfloat16)
    co = shape[4]
    if plan.path == "fma":
        assert plan.smem_bytes == 0
        return
    assert 0 < plan.smem_bytes <= MAX_SMEM_BYTES
    if plan.path == "wgmma":
        bm, bn, bk = plan.tile
        assert plan.smem_bytes == plan.stages * (bm * 128 + bk * bn * 2)
        assert bm * (bn + 8) * 2 + 2 * (bm // 16) * bn * 4 <= plan.smem_bytes
        split = plan.splits > 1
        assert plan.partial_floats == (plan.splits * _m(shape) * co if split else 0)
        assert plan.stat_rows == (-(-_m(shape) // CONV_SPLIT_STAT_ROWS) if split
                                  else plan.grid[0])
    else:
        assert plan.partial_floats == 0 and plan.stat_rows == plan.grid[1]
    assert plan.workspace_floats(co, False) == plan.partial_floats
    assert plan.workspace_floats(co, True) == plan.partial_floats + 2 * plan.stat_rows * co


def test_plan_follows_the_card():
    """Fewer SMs, fewer parts: enc6 at batch 8 splits in 4 on 66 SMs."""
    assert conv_plan(8, *LAYERS_512["enc6"], torch.bfloat16, sms=66).splits == 4


# ---- numpy model of the kernels' staging ---------------------------------

def _a_copies(plan, x, m0, tap, c0):
    """A stage of conv_wgmma_kernel as its threads fill it: 16-byte units
    (8 values) at their swizzled places. Thread t copies unit t % 8 of tile
    rows t // 8 + 32j (output pixel m0 + row) from x[b, 2oy-1+kh,
    2ox-1+kw, c0 + 8u ..], zero where the tap falls in the padding or past M."""
    bm = plan.tile[0]
    n, h, w, ci = x.shape
    ho, wo = h // 2, w // 2
    units = np.full((bm * 8, 8), np.nan)
    writes = np.zeros(bm * 8, np.int32)
    for t in range(THREADS):
        au, ar = t % 8, t // 8
        for j in range(bm // 32):
            row = ar + 32 * j
            m = m0 + row
            b, r = divmod(m, ho * wo)
            oy, ox = divmod(r, wo)
            iy, ix = 2 * oy - 1 + tap // 4, 2 * ox - 1 + tap % 4
            ok = m < n * ho * wo and 0 <= iy < h and 0 <= ix < w
            dest = (ar * 128 + ((au ^ (ar & 7)) << 4) + j * 32 * 128) // 16
            units[dest] = x[b, iy, ix, c0 + 8 * au:c0 + 8 * au + 8] if ok else 0
            writes[dest] += 1
    assert (writes == 1).all(), "A's units collide or leave a gap"
    return units


def _b_copies(plan, wf, step, n0):
    """B stage: thread t copies unit t % (BN/8) of K rows t // (BN/8) +
    rows_per_pass * j, w's rows 64 step + those, MN-major in 64-column
    groups of 64 rows (8 KB), zero past CO."""
    bn = plan.tile[1]
    per_row = bn // 8
    rows_per_pass = THREADS // per_row
    units = np.full((bn // 64 * 64 * 8, 8), np.nan)
    writes = np.zeros(len(units), np.int32)
    co = wf.shape[1]
    for t in range(THREADS):
        bu, bk = t % per_row, t // per_row
        for j in range(CONV_BK // rows_per_pass):
            k = bk + rows_per_pass * j
            col = n0 + 8 * bu
            dest = ((bu >> 3) * 64 * 128 + bk * 128 + (((bu & 7) ^ (bk & 7)) << 4)
                    + j * rows_per_pass * 128) // 16
            units[dest] = wf[CONV_BK * step + k, col:col + 8] if col < co else 0
            writes[dest] += 1
    assert (writes == 1).all(), "B's units collide or leave a gap"
    return units


def _a_read(units, bm):
    """A as wgmma reads it (K-major, 128-byte swizzle): row r, k."""
    rows = np.arange(bm)[:, None]
    ks = np.arange(CONV_BK)[None, :]
    return units[rows * 8 + ((ks // 8) ^ (rows & 7)), ks % 8]


def _b_read(units, bn):
    """B as wgmma reads it (MN-major, 64-column groups 8 KB apart): k, n."""
    ks = np.arange(CONV_BK)[:, None]
    ns = np.arange(bn)[None, :]
    return units[(ns // 64) * 512 + ks * 8 + (((ns % 64) // 8) ^ (ks & 7)), ns % 8]


def _emulate_wgmma(x, w, plan):
    """conv_wgmma_kernel and its split pass: y's raw f32 sums and the
    statistics' partial rows, from the staged tiles."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    m_total = n * (h // 2) * (wd // 2)
    bm, bn, _ = plan.tile
    wf = w.reshape(16 * ci, co)
    cpt = ci // CONV_BK
    steps = 16 * cpt
    parts = np.zeros((plan.splits, plan.grid[0] * bm, plan.grid[1] * bn))
    for split in range(plan.splits):
        for mt in range(plan.grid[0]):
            for nt in range(plan.grid[1]):
                acc = np.zeros((bm, bn))
                for s in range(split * plan.steps_per_split,
                               min(steps, (split + 1) * plan.steps_per_split)):
                    tap, c0 = divmod(s, cpt)
                    a = _a_read(_a_copies(plan, x, mt * bm, tap, c0 * CONV_BK), bm)
                    b = _b_read(_b_copies(plan, wf, s, nt * bn), bn)
                    acc += a @ b
                parts[split, mt * bm:(mt + 1) * bm, nt * bn:(nt + 1) * bn] = acc
    full = parts.sum(0)[:m_total, :co]
    if plan.splits > 1:  # the split pass: 64-row groups
        rows = CONV_SPLIT_STAT_ROWS
    else:  # one partial row per M tile; rows past M hold zeros
        rows = bm
    padded = np.zeros((plan.stat_rows * rows, co))
    padded[:m_total] = full
    grouped = padded.reshape(plan.stat_rows, rows, co)
    stat_rows = np.stack([grouped.sum(1), np.square(grouped).sum(1)], 1)
    return full, stat_rows


def _emulate_stem(x, w, plan):
    """conv_stem_wgmma_kernel's im2col: thread t builds window rows kh0 and
    kh0 + 2 (kh0 = t // 64) of pixel t % 64 as bf16 pairs at k = 4 CI kh +
    2i, in 128-byte rows with the swizzle; 16 CI values, zero past them."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    ho, wo = h // 2, wd // 2
    m_total = n * ho * wo
    v = 4 * ci
    y = np.zeros((plan.splits * plan.steps_per_split * CONV_STEM_CHUNK, co))
    wf = w.reshape(16 * ci, co)
    for chunk in range(-(-m_total // CONV_STEM_CHUNK)):
        tile = np.zeros((CONV_STEM_CHUNK * 8, 8))
        writes = np.zeros((CONV_STEM_CHUNK * 8, 8), np.int32)
        for t in range(STEM_THREADS):
            p, kh0 = t % CONV_STEM_CHUNK, t // CONV_STEM_CHUNK
            m = chunk * CONV_STEM_CHUNK + p
            b, r = divmod(m, ho * wo)
            oy, ox = divmod(r, wo)
            for rr in range(2):
                kh = kh0 + 2 * rr
                iy = 2 * oy - 1 + kh
                for i in range(v // 2):
                    for e in range(2):
                        ix = 2 * ox - 1 + (2 * i + e) // ci
                        ok = m < m_total and 0 <= iy < h and 0 <= ix < wd
                        val = x[b, iy, ix, (2 * i + e) % ci] if ok else 0.0
                        k = v * kh + 2 * i + e
                        unit = p * 8 + ((k >> 3) ^ (p & 7))
                        tile[unit, k & 7] = val
                        writes[unit, k & 7] += 1
        assert writes.sum() == CONV_STEM_CHUNK * 16 * ci and writes.max() == 1
        rows = np.arange(CONV_STEM_CHUNK)[:, None]
        ks = np.arange(64)[None, :]
        a = tile[rows * 8 + ((ks // 8) ^ (rows & 7)), ks % 8]
        assert not a[:, 16 * ci:].any(), "the im2col's padding past 16 CI is not zero"
        y[chunk * CONV_STEM_CHUNK:(chunk + 1) * CONV_STEM_CHUNK] = a[:, :16 * ci] @ wf
    return y[:m_total]


def _inputs(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, ci)),
            rng.standard_normal((4, 4, ci, co)) * (16 * ci) ** -0.5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 72), (3, 14, 10, 64, 128),
                                   (1, 8, 8, 128, 136), (1, 16, 16, 64, 256),
                                   (2, 32, 32, 64, 256)])
def test_emulated_wgmma_matches_the_plain_version(shape, monkeypatch):
    """128 x 128 tiles split 4 ways over CO 72 (64 on one warpgroup's
    columns past CO) and a ragged M, a 64-row tile over CO 136 (two column
    tiles), 64 rows on 256 columns split, the wide tile (on a card of 4 SMs,
    where its 4 tiles fill a wave) unsplit; y's sums and the statistics'
    partial rows against the plain version (f32 sums: 1e-4)."""
    sms = 4 if shape[4] == 256 else H100_SMS
    plan = conv_plan(*shape, torch.bfloat16, sms=sms)
    assert plan.path == "wgmma"
    if shape == (2, 32, 32, 64, 256):
        assert plan.tile == (128, 256, 64) and plan.splits == 1
    x, w = _inputs(shape)
    y, stat_rows = _emulate_wgmma(x, w, plan)
    want, (mean, mean_sq) = conv2d_k4s2p1_plain(torch.from_numpy(x), torch.from_numpy(w),
                                                with_stats=True)
    m_total = y.shape[0]
    np.testing.assert_allclose(y, want.numpy().reshape(m_total, -1), rtol=1e-5, atol=1e-4)
    sums = stat_rows.sum(0) / m_total
    np.testing.assert_allclose(sums[0], mean.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sums[1], mean_sq.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 16, 16, 1, 64), (3, 14, 10, 3, 64),
                                   (1, 16, 16, 4, 128)])
def test_emulated_stem_matches_the_plain_version(shape):
    """The stem's im2col at CI 1, 3 (48 values padded to 64, a ragged last
    chunk) and 4, times w's 16 CI rows, against the plain version."""
    plan = conv_plan(*shape, torch.bfloat16)
    assert plan.path == "wgmma_stem"
    x, w = _inputs(shape, seed=1)
    want = conv2d_k4s2p1_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(_emulate_stem(x, w, plan), want.reshape(-1, shape[4]),
                               rtol=1e-5, atol=1e-4)


def test_ab_variants_patch_the_source_once():
    """tools/conv_ab.py's variants are text patches of csrc/conv_k4s2p1.cu:
    each must match the source once, and its plan must stay a wgmma plan."""
    from discogan_modernized_torch.ops import _build
    from discogan_modernized_torch.tools import conv_ab

    text = (_build.CSRC / "conv_k4s2p1.cu").read_text()
    for name, (patches, constants) in conv_ab.VARIANTS.items():
        for old, _ in patches:
            assert text.count(old) == 1, (name, old)
        with conv_ab._plan_constants(**constants):
            for _, shape, _ in conv_ab.SHAPES[:-1]:
                plan = conv_plan(*shape, torch.bfloat16)
                assert plan.path == "wgmma" and plan.smem_bytes <= MAX_SMEM_BYTES, name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_pairs_keep_the_single_plan(shape, dtype):
    """P = 2 (the pair axis): the tile plan of a single call, the grid's z
    (the split, or nothing) and the workspace twice over."""
    one, two = conv_plan(*shape, dtype), conv_plan(*shape, dtype, pairs=2)
    assert two._replace(pairs=1, grid=one.grid) == one
    assert two.grid == (one.grid[0], one.grid[1], 2 * one.grid[2])
    co = shape[-1]
    for stats in (False, True):
        assert two.workspace_floats(co, stats) == 2 * one.workspace_floats(co, stats)
