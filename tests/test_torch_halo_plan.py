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


@pytest.mark.parametrize("shape", MAIN + EDGE)
def test_pairs_keep_the_single_plan(shape):
    """P = 2 (the pair axis): each pair runs the tile plan of a single call."""
    one = tc_plan(*shape, torch.bfloat16)
    assert tc_plan(*shape, torch.bfloat16, pairs=2)._replace(pairs=1) == one
    assert tc_plan(*shape, torch.float32, pairs=2) is None


# ---- the CUDA-core path (halo_fma_kernel, ``halo_fma_plan``) ----------------
#
# The kernel's plan, its ring and its addressing, emulated in numpy as its
# threads run them: which 16-byte units of a stage each thread fills (x's
# band, zero outside the map; w's chunk, zero past CO), the order in which
# the ring's slots are filled and read, each lane's reads of its 8 pixels
# (straight from the staged band, by tap) and 8 channels, its micro-tile's
# products and the epilogue, held against the plain version.

from discogan_modernized_torch.ops.halo_conv import (  # noqa: E402
    HALO_FMA_CK, HALO_FMA_CO_TILE, HALO_FMA_COLS, HALO_FMA_PIXELS, HALO_FMA_STAGES,
    HALO_FMA_THREADS, halo_conv2d_k4s2p1_plain, halo_fma_plan, halo_plan)

FMA_MAIN = MAIN + [(8, 132, 256, 64, 128)]  # enc1 at batch 1, 4, 8; a tp-2 band
FMA_EDGE = EDGE + [(3, 14, 22, 8, 24), (2, 16, 16, 8, 16), (2, 40, 64, 24, 8),
                   (1, 30, 128, 128, 256)]


def _fma_blocks(n, h, w, co, plan):
    """(b, rows, cols, channels) of every block, in the kernel's grid order:
    x = channel tile, y = band * strips + strip, z = pair * N + image."""
    ho, wo = h // 2, w // 2
    strips = -(-wo // plan.cols)
    for z in range(plan.grid[2]):
        for by in range(plan.grid[1]):
            oy0, ox0 = by // strips * plan.rows, by % strips * plan.cols
            for bx in range(plan.grid[0]):
                co0 = bx * plan.co_tile
                yield (z % n, range(oy0, min(oy0 + plan.rows, ho)),
                       range(ox0, min(ox0 + plan.cols, wo)),
                       range(co0, min(co0 + plan.co_tile, co)))


def _waves(plan, n, sms=H100_SMS):
    return -(-(plan.grid[0] * plan.grid[1] * n) // sms)


@pytest.mark.parametrize("shape", FMA_MAIN + FMA_EDGE)
def test_fma_plan_fits_shared_memory(shape):
    plan = halo_fma_plan(*shape)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.rows * plan.cols == HALO_FMA_PIXELS and plan.cols in HALO_FMA_COLS
    assert (plan.co_tile, plan.ci_chunk, plan.stages) == (HALO_FMA_CO_TILE, HALO_FMA_CK,
                                                          HALO_FMA_STAGES)
    stage = 4 * plan.x_units + 16 * plan.ci_chunk * plan.co_tile
    assert plan.smem_bytes == plan.stages * stage * 4
    if shape[1:] == ENC1:  # 4 rows of 32: 10 x 66 units of x and 32 KB of w a stage
        assert (plan.rows, plan.cols, plan.smem_bytes) == (4, 32, 173_312)


@pytest.mark.parametrize("shape", FMA_MAIN + FMA_EDGE)
def test_fma_plan_covers_every_output_once(shape):
    n, h, w, ci, co = shape
    plan = halo_fma_plan(n, h, w, ci, co)
    count = np.zeros((n, h // 2, w // 2, co), np.int32)
    for b, rows, cols, chans in _fma_blocks(n, h, w, co, plan):
        assert len(rows) and len(cols) and len(chans), "a block with no work"
        count[b, rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", FMA_MAIN + FMA_EDGE)
def test_fma_plan_takes_the_fewest_waves(shape):
    """Every block does a whole tile's FMAs, so the grid's time is its
    waves: the plan takes the block shape with the fewest, then the most
    rows (the fewest input rows staged a pixel). A grid below one wave has
    nothing left to split: no block shape finishes sooner."""
    n, h, w, ci, co = shape
    plan = halo_fma_plan(n, h, w, ci, co)
    for cols in HALO_FMA_COLS:
        rows = HALO_FMA_PIXELS // cols
        other = plan._replace(rows=rows, cols=cols, grid=(
            plan.grid[0], -(-(h // 2) // rows) * -(-(w // 2) // cols), n))
        assert (_waves(plan, n), plan.cols) <= (_waves(other, n), cols)


@pytest.mark.parametrize("n,waves", [(1, 1), (4, 4), (8, 8)])
def test_fma_plan_fills_the_waves_at_enc1(n, waves):
    """enc1's 128 x 128 map is 128 tiles an image: at batch 1 one wave of
    128 blocks on 132 SMs, at 4 and 8 whole waves but the last."""
    plan = halo_fma_plan(n, *ENC1)
    assert plan.grid == (1, 128, n) and _waves(plan, n) == waves
    assert plan.blocks == 128 * n >= 120  # one block a tile; at batch 1, 128 of 132 SMs


@pytest.mark.parametrize("shape", FMA_MAIN + FMA_EDGE)
def test_fma_pairs_keep_the_single_plan(shape):
    one = halo_fma_plan(*shape)
    two = halo_fma_plan(*shape, pairs=2)
    assert two._replace(pairs=1, grid=one.grid) == one
    assert two.grid == (*one.grid[:2], 2 * one.grid[2])


@pytest.mark.parametrize("dtype,ci,path", [
    (torch.float32, 64, "fma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 8, "fma"),
    (torch.bfloat16, 24, "fma"), (torch.bfloat16, 128, "fma")])
def test_halo_plan_routes_by_dtype_and_channels(dtype, ci, path):
    """What the C entry receives: the tensor-core plan where ``tc_plan``
    takes the shape, else the CUDA cores' (f32; bf16 CI % 16 != 0 or CI >
    64), with its rows, columns, ring, grid and shared memory."""
    got = halo_plan(2, 32, 256, ci, 2 * ci, dtype)
    assert got[0] == path
    if path == "fma":
        fp = halo_fma_plan(2, 32, 256, ci, 2 * ci)
        assert got[1:] == (fp.rows, fp.cols, fp.stages, *fp.grid[:2], fp.smem_bytes)
    else:
        tc = tc_plan(2, 32, 256, ci, 2 * ci, dtype)
        assert got[1:] == (tc.rows, TC_STRIP, 6, tc.co_tiles, tc.strips * tc.bands,
                           tc.smem_bytes)


def _lane(t, cols):
    """Lane t's (warp, tx, ty, wm, wn) and the staged unit of its pixel 0
    at tap (0, 0) (x_lane / 4 in the kernel)."""
    warp, lane = divmod(t, 32)
    ty, tx = divmod(lane, 8)
    wm, wn = warp // 2 * 32, warp % 2 * 64
    xc = 2 * cols + 2
    return tx, ty, wm, wn, 2 * (wm // cols) * xc + 2 * (wm % cols + ty)


def _stage(plan, xb, w, c0, oy0, ox0, co0):
    """One ring stage as the threads fill it: x's units e = tid + 256 j
    (staged row e // XC, column e % XC, input pixel (2 oy0 - 1 + row, 2 ox0
    - 1 + column), CK channels from c0, zero outside the map) and w's units
    tid + 256 j (row tid // 32 + 8 j = tap * CK + channel, columns co0 + 4
    (tid % 32) .., zero past CO). Asserts each unit written once."""
    h, wd, _ = xb.shape
    co = w.shape[3]
    xc, xu = 2 * plan.cols + 2, plan.x_units
    xs = np.full((xu, HALO_FMA_CK), np.nan)
    ws = np.full((16 * HALO_FMA_CK, plan.co_tile), np.nan)
    tid = np.arange(HALO_FMA_THREADS)
    for j in range(-(-xu // HALO_FMA_THREADS)):
        e = tid + HALO_FMA_THREADS * j
        issued = e < xu
        iy, ix = 2 * oy0 - 1 + e // xc, 2 * ox0 - 1 + e % xc
        ok = issued & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
        for t in tid[issued]:
            assert np.isnan(xs[e[t]]).all(), "x unit written twice"
            xs[e[t]] = xb[iy[t], ix[t], c0:c0 + HALO_FMA_CK] if ok[t] else 0.0
    r0, u = tid // 32, tid % 32
    for j in range(16 * HALO_FMA_CK * plan.co_tile // 4 // HALO_FMA_THREADS):
        dest = tid + HALO_FMA_THREADS * j
        tap, c = r0 // HALO_FMA_CK + 2 * j, r0 % HALO_FMA_CK
        for t in tid:
            row, unit = divmod(int(dest[t]), plan.co_tile // 4)
            assert row == tap[t] * HALO_FMA_CK + c[t] and unit == u[t]
            assert np.isnan(ws[row, 4 * unit:4 * unit + 4]).all(), "w unit written twice"
            col = co0 + 4 * u[t]
            ws[row, 4 * unit:4 * unit + 4] = (w[tap[t] // 4, tap[t] % 4, c0 + c[t], col:col + 4]
                                              if col < co else 0.0)
    assert not np.isnan(xs).any() and not np.isnan(ws).any(), "a gap in the stage"
    return xs, ws


def _emulate_halo_fma(x, w, plan, scale=None, offset=None, act=None):
    """halo_fma_kernel: each block's ring of stages filled STAGES - 1 chunks
    ahead of the chunk its lanes read, each lane's 8 pixels read by address
    from the staged band at every tap and its 8 channels from the staged
    weights, its micro-tile summed over the chunks, then the epilogue; y
    written once."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    ho, wo = h // 2, wd // 2
    xc = 2 * plan.cols + 2
    y = np.full((n, ho, wo, co), np.nan)
    lanes = [_lane(t, plan.cols) for t in range(HALO_FMA_THREADS)]
    # each lane's tile pixels and channels; they cover the 128 x 128 tile once
    pix = np.array([[wm + ty + 4 * i for i in range(8)] for tx, ty, wm, wn, _ in lanes])
    chans = np.array([[wn + 4 * tx + 32 * (j // 4) + j % 4 for j in range(8)]
                      for tx, ty, wm, wn, _ in lanes])
    cover = np.zeros((HALO_FMA_PIXELS, plan.co_tile), np.int32)
    np.add.at(cover, (pix[:, :, None], chans[:, None, :]), 1)
    assert (cover == 1).all(), "the lanes' micro-tiles do not cover the tile once"
    # the unit lane t reads for pixel i at tap (kh, kw): x_lane + kh XC + kw + 8 i,
    # which is pixel p = wm + ty + 4i's window: staged row 2r + kh, column 2s + kw
    units = np.zeros((HALO_FMA_THREADS, 8, 16), np.int64)
    for t, (tx, ty, wm, wn, base) in enumerate(lanes):
        for i in range(8):
            r, s = divmod(int(pix[t, i]), plan.cols)
            for tap in range(16):
                kh, kw = divmod(tap, 4)
                units[t, i, tap] = base + kh * xc + kw + 8 * i
                assert units[t, i, tap] == (2 * r + kh) * xc + 2 * s + kw
    nchunks = ci // HALO_FMA_CK
    for b, rows, cols, chs in _fma_blocks(n, h, wd, co, plan):
        oy0, ox0, co0 = rows.start, cols.start, chs.start
        ring = [None] * plan.stages
        acc = np.zeros((HALO_FMA_THREADS, 8, 8))

        def fill(q):
            if q < nchunks:
                ring[q % plan.stages] = (q, *_stage(plan, x[b], w, q * HALO_FMA_CK,
                                                    oy0, ox0, co0))
        for q in range(plan.stages - 1):
            fill(q)
        for q in range(nchunks):
            fill(q + plan.stages - 1)  # into chunk q - 1's slot, after the barrier
            tag, xs, ws = ring[q % plan.stages]
            assert tag == q, "the ring's slot holds another chunk"
            a = xs[units]  # (lane, pixel, tap, CK)
            a = a.reshape(HALO_FMA_THREADS, 8, 16 * HALO_FMA_CK)  # k = tap * CK + channel
            bmat = ws[:, chans]  # (k, lane, 8) -> (lane, k, 8)
            acc += np.einsum("lik,lkj->lij", a, bmat.transpose(1, 0, 2))
        for t in range(HALO_FMA_THREADS):
            for i in range(8):
                oy, ox = oy0 + pix[t, i] // plan.cols, ox0 + pix[t, i] % plan.cols
                if oy >= ho or ox >= wo:
                    continue
                for j in range(8):
                    col = co0 + chans[t, j]
                    if col >= co:
                        continue
                    v = acc[t, i, j]
                    if scale is not None:
                        v = v * scale[col] + offset[col]
                    if act == "leaky":
                        v = v if v >= 0 else 0.2 * v
                    assert np.isnan(y[b, oy, ox, col]), "y written twice"
                    y[b, oy, ox, col] = v
    assert not np.isnan(y).any(), "an output left unwritten"
    return y


def _inputs(shape, seed, dtype=torch.float32):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci))).to(dtype)
    wt = torch.from_numpy(rng.standard_normal((4, 4, ci, co)) * (16 * ci) ** -0.5).to(dtype)
    return x, wt


@pytest.mark.parametrize("shape,dtype,affine", [
    ((1, 12, 256, 64, 128), torch.float32, True),    # enc1's width, CI and CO
    ((1, 16, 128, 64, 128), torch.float32, False),   # enc1 at 256px: 4 x 32 blocks
    ((3, 14, 22, 8, 24), torch.float32, True),       # ragged width and rows, CO off the tile
    ((1, 8, 40, 16, 136), torch.float32, False),     # two channel tiles, the second 8 wide
    ((2, 8, 32, 8, 16), torch.bfloat16, True),       # bf16 CI 8: 8-byte loads
    ((1, 10, 48, 24, 40), torch.bfloat16, False),    # bf16 CI 24
    ((2, 12, 64, 16, 32), torch.float32, True),      # a band of h/2 + 4 rows (map 16)
])
def test_emulated_halo_fma_matches_the_plain_version(shape, dtype, affine):
    """The kernel's ring, copies (zero-filled padding), per-tap addressing
    into the staged band, lane micro-tiles and epilogue against the plain
    version (f32 sums: 1e-4). bf16 stages the same f32 values as f32 does
    (its loads convert them), so the emulation runs on the bf16-rounded
    inputs in f32."""
    n, h, w, ci, co = shape
    plan = halo_fma_plan(*shape)
    assert halo_plan(*shape, dtype)[0] == "fma"
    x, wt = _inputs(shape, seed=3, dtype=dtype)
    rng = np.random.default_rng(4)
    scale = torch.from_numpy(rng.random(co) + 0.5).float() if affine else None
    offset = torch.from_numpy(rng.standard_normal(co) * 0.1).float() if affine else None
    act = "leaky" if affine else None
    got = _emulate_halo_fma(x.double().numpy(), wt.double().numpy(), plan,
                            None if scale is None else scale.double().numpy(),
                            None if offset is None else offset.double().numpy(), act)
    want = halo_conv2d_k4s2p1_plain(x.float(), wt.float(), scale=scale, offset=offset, act=act)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


def test_emulated_halo_fma_pairs_with_a_shared_weight():
    """The pair axis: block z = pair * N + image reads pair z // N's x (a
    shared weight: the same w for both) and writes its y; each pair's y
    equals a single call's."""
    shape = (2, 8, 64, 8, 16)
    x0, wt = _inputs(shape, seed=5)
    x1, _ = _inputs(shape, seed=6)
    plan = halo_fma_plan(*shape, pairs=2)
    assert plan.grid[2] == 2 * shape[0]
    xs = np.stack([x0.double().numpy(), x1.double().numpy()])
    n = shape[0]
    # z walks pair-major: pair p's images are z = p * N .. p * N + N - 1
    single = plan._replace(pairs=1, grid=(*plan.grid[:2], n))
    for p in range(2):
        zs = [z for z in range(plan.grid[2]) if z // n == p]
        assert [z % n for z in zs] == list(range(n))
        got = _emulate_halo_fma(xs[p], wt.double().numpy(), single)
        want = halo_conv2d_k4s2p1_plain(torch.from_numpy(xs[p]).float(), wt.float())
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cols", HALO_FMA_COLS)
def test_halo_fma_reads_are_free_of_bank_conflicts(cols):
    """A warp's float4 reads of a stage: x's four pixels (ty) at one tap and
    pixel slot i, 2 staged columns (32 bytes) apart, broadcast to the eight
    lanes of each; w's 128 consecutive bytes of one k row (tx). The distinct
    16-byte words a read touches fall in distinct groups of four banks, at
    every ring slot."""
    plan = halo_fma_plan(1, 256, 256, 64, 128)._replace(rows=HALO_FMA_PIXELS // cols, cols=cols)
    xc = 2 * cols + 2
    stage_units = (4 * plan.x_units + 16 * HALO_FMA_CK * plan.co_tile) // 4
    lanes = [_lane(t, cols) for t in range(HALO_FMA_THREADS)]
    for slot in range(plan.stages):
        base = slot * stage_units
        for warp in range(HALO_FMA_THREADS // 32):
            ws = lanes[32 * warp:32 * warp + 32]
            for tap in range(16):
                kh, kw = divmod(tap, 4)
                for i in range(8):
                    words = {base + lb + kh * xc + kw + 8 * i for *_, lb in ws}
                    assert len(words) == 4
                    assert len({wd % 8 for wd in words}) == len(words), (cols, warp, tap, i)
                for kk in range(HALO_FMA_CK):
                    for jj in range(2):
                        words = {base + plan.x_units + ((tap * HALO_FMA_CK + kk) * plan.co_tile
                                                        + wn + 4 * tx + 32 * jj) // 4
                                 for tx, ty, wm, wn, _ in ws}
                        assert len(words) == 8 and len({wd % 8 for wd in words}) == 8
