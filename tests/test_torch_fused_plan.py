"""The plans of K1 (``ops/fused.py::stats_plan``) and K2 (``bn_act_plan``).

The CUDA kernels (csrc/batch_stats.cu, csrc/bn_act.cu) take their vector
width, threads, blocks and splits from these plans, and the C entries refuse
a plan they cannot run; so the plans are checked here, on the CPU, at every
K1 and K2 shape of the 512px model (batch 1, 2, 4 and 8) and of the 64px
model, and at the edge shapes the card's tests hold the kernels to
(chip_smoke.py's FUSED_EDGE). A numpy model of each plan's index mapping
shows that every value is read once and that a thread's channels stay
fixed where the plan says so; a float32 numpy model of K1's order of sums
(each thread's rows in order, the warps' shuffles, the block's rows of
partials, the last block's sum over the splits) is held against the JAX
package's Pallas ``batch_stats`` in interpret mode.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from discogan_modernized_tpu.ops.pallas_fused import batch_stats as jax_k1
from discogan_modernized_torch.ops.fused import (
    BN_BLOCKS_PER_SM, BN_MAX_FIXED_BLOCKS, BN_THREADS, BN_UNROLL, H100_SMS, STATS_MAX_LANES,
    STATS_MAX_TILES, STATS_MIN_STEPS, STATS_TARGET_BLOCKS, STATS_THREADS, STATS_UNROLL,
    bn_act_plan, stats_plan)

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
WIDTH = {torch.float32: 4, torch.bfloat16: 8}
MAX_THREADS = {"stats": 512, "bn": 256}  # the kernels' __launch_bounds__

# (h, w, c) of the K2 calls of the 512px generator's forward: after enc1..enc6,
# the latent, dec0..dec6; K1 takes enc1, the latent and dec0..dec6 in training.
K2_512 = {"enc1": (128, 128, 128), "enc2": (64, 64, 256), "enc3": (32, 32, 512),
          "enc4": (16, 16, 1024), "enc5": (8, 8, 2048), "enc6": (4, 4, 2048),
          "latent": (1, 1, 100), "dec0": (4, 4, 2048), "dec1": (8, 8, 2048),
          "dec2": (16, 16, 1024), "dec3": (32, 32, 512), "dec4": (64, 64, 256),
          "dec5": (128, 128, 128), "dec6": (256, 256, 64)}
K1_512 = {k: v for k, v in K2_512.items() if k == "enc1" or not k.startswith("enc")}
K2_64 = {"enc1": (16, 16, 128), "enc2": (8, 8, 256), "enc3": (4, 4, 512),
         "dec0": (4, 4, 512), "dec1": (8, 8, 256), "dec2": (16, 16, 128),
         "dec3": (32, 32, 64)}
MAIN_BN = ([((n, *s), f"512-{k}-b{n}") for k, s in K2_512.items() for n in (1, 2, 4, 8)]
           + [((n, *s), f"64-{k}-b{n}") for k, s in K2_64.items() for n in (1, 8, 64)])
MAIN_STATS = ([((n, *s), f"512-{k}-b{n}") for k, s in K1_512.items() for n in (2, 4, 8)]
              + [((n, *s), f"64-{k}-b{n}") for k, s in K2_64.items() for n in (8, 64)])
# chip_smoke.py's FUSED_EDGE: C 3 (off the vectors, an odd count), C 24 (three
# vectors a row), C 100 at 75 rows, one row, rows fewer than K1's target
# splits, C 2048 at batch 1, a ragged last split
EDGE = [((3, 5, 7, 3), "c3-odd"), ((2, 5, 7, 24), "c24"), ((3, 5, 5, 100), "c100-75rows"),
        ((1, 1, 1, 256), "one-row"), ((1, 10, 10, 64), "100-rows"),
        ((1, 4, 4, 2048), "c2048-b1"), ((3, 37, 41, 128), "ragged")]
BN_SHAPES, BN_IDS = zip(*(MAIN_BN + EDGE))
STATS_SHAPES, STATS_IDS = zip(*(MAIN_STATS + EDGE))


def _numel(shape):
    return int(np.prod(shape))


# -- K2 --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
def test_bn_act_plan_fits_the_kernels(shape, dtype):
    c = shape[-1]
    plan = bn_act_plan(_numel(shape), c, dtype)
    assert plan.width == WIDTH[dtype]
    assert plan.threads == BN_THREADS <= MAX_THREADS["bn"] and plan.threads % 32 == 0
    assert plan.blocks >= 1
    if plan.fixed:
        assert c % plan.width == 0 and plan.unroll == BN_UNROLL
        assert plan.threads * plan.blocks * plan.width % c == 0
        assert plan.blocks <= BN_MAX_FIXED_BLOCKS
    else:
        assert plan.unroll == 1
        assert plan.blocks <= BN_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [s for s, _ in MAIN_BN], ids=[i for _, i in MAIN_BN])
def test_bn_act_main_path_keeps_its_channels(shape, dtype):
    """Every main-path C is a multiple of the vector but bf16's latent 100;
    the large calls fill BN_BLOCKS_PER_SM blocks an SM and loop, the small
    ones take one vector a thread, with no block left idle."""
    c = shape[-1]
    numel = _numel(shape)
    plan = bn_act_plan(numel, c, dtype)
    assert plan.fixed == (c % WIDTH[dtype] == 0)
    assert plan.fixed or (dtype == torch.bfloat16 and c == 100)
    vectors = numel // plan.width
    if vectors >= BN_BLOCKS_PER_SM * H100_SMS * BN_THREADS:
        assert plan.blocks == BN_BLOCKS_PER_SM * H100_SMS
    else:  # fixed: rounded up to a multiple that keeps the channels
        groups = c // plan.width
        period = groups // math.gcd(BN_THREADS, groups) if plan.fixed else 1
        assert plan.blocks == -(-(-(-vectors // BN_THREADS)) // period) * period


def _bn_act_visits(plan, numel, c):
    """numpy model of the kernels' loops: (vector index, first channel the
    kernel gives it) for every vector each thread visits, and the tail's
    (element, thread) pairs."""
    stride = plan.threads * plan.blocks
    vectors = numel // plan.width
    t = np.arange(stride)
    steps = -(-vectors // stride) if vectors else 0
    # bn_act_vec_kernel: i = t, t + U*stride, ...; vectors i + u*stride, u < U
    # (the same set as t + k*stride); bn_act_any_kernel: i = t, t + stride, ...
    k = np.arange(steps)
    j = t[None, :] + stride * k[:, None]
    thread = np.broadcast_to(t[None, :], j.shape)
    keep = j < vectors
    if plan.fixed:
        ch = np.broadcast_to((t * plan.width % c)[None, :], j.shape)
    else:  # the channel stepped by the stride's remainder once a vector
        ch = (t[None, :] * plan.width + k[:, None] * (stride * plan.width % c)) % c
    tail = numel - vectors * plan.width
    return j[keep], ch[keep], thread[keep], tail


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
def test_bn_act_plan_covers_every_value_once(shape, dtype):
    numel, c = _numel(shape), shape[-1]
    plan = bn_act_plan(numel, c, dtype)
    j, ch, thread, tail = _bn_act_visits(plan, numel, c)
    counts = np.bincount(j, minlength=numel // plan.width)
    assert counts.min(initial=1) == 1 and counts.max(initial=1) == 1
    # the channel the kernel applies is the vector's own
    assert np.array_equal(ch, j * plan.width % c)
    if plan.fixed:  # one channel group a thread
        first = np.full(plan.threads * plan.blocks, -1)
        first[thread[::-1]] = ch[::-1]
        assert np.array_equal(ch, first[thread])
    else:  # the tail: one value a thread of the first block
        assert 0 <= tail < plan.width and tail <= plan.threads
    assert plan.fixed or tail == numel % plan.width
    if plan.fixed:
        assert tail == 0


def test_bn_act_general_path_reaches_odd_counts():
    plan = bn_act_plan(315, 3, torch.bfloat16)
    assert not plan.fixed and 315 % plan.width == 3
    assert bn_act_plan(315, 3, torch.float32).fixed is False
    plan = bn_act_plan(2 * 5 * 7 * 24, 24, torch.bfloat16)  # three vectors a row
    assert plan.fixed and plan.blocks % 3 == 0


# -- K1 --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", STATS_SHAPES, ids=STATS_IDS)
def test_stats_plan_fits_the_kernel(shape, dtype):
    c = shape[-1]
    rows = _numel(shape) // c
    plan = stats_plan(rows, c, dtype)
    assert plan.width in (WIDTH[dtype], 1) and c % plan.width == 0
    assert plan.width == WIDTH[dtype] or c % WIDTH[dtype]
    assert plan.threads == STATS_THREADS <= MAX_THREADS["stats"]
    assert 1 <= plan.lanes <= min(STATS_MAX_LANES, c // plan.width)
    assert plan.row_lanes == plan.threads // plan.lanes
    assert plan.ctiles == -(-(c // plan.width) // plan.lanes) <= STATS_MAX_TILES
    assert plan.shuffle == (plan.lanes < 32 and 32 % plan.lanes == 0)
    assert plan.unroll == STATS_UNROLL
    # the splits cover the rows once, none shorter than STATS_MIN_STEPS
    # unrolled steps of every row lane but the last
    shortest = plan.row_lanes * plan.unroll * STATS_MIN_STEPS
    assert plan.splits * plan.rows_per_split >= rows
    assert (plan.splits - 1) * plan.rows_per_split < rows
    assert plan.rows_per_split >= shortest
    # about the target of blocks, or every split as short as it may be
    blocks = plan.splits * plan.ctiles
    assert blocks <= STATS_TARGET_BLOCKS + plan.ctiles
    assert blocks >= 0.9 * STATS_TARGET_BLOCKS or plan.rows_per_split == shortest
    # shared memory: the block's rows of partials and the last block's groups
    prows = plan.threads // 32 if plan.shuffle else plan.row_lanes
    assert prows * plan.lanes * plan.width <= plan.threads * plan.width
    fv = 1 if plan.width == 1 else 4
    assert (plan.lanes * plan.width) % fv == 0 and plan.lanes * plan.width // fv <= plan.threads


def _stats_reads(plan, rows, c):
    """numpy model of the kernel's reads: the (split, row lane) and the
    (tile, lane) of every row and channel. A thread's channels are its
    lane's for the whole call, so rows and channels are covered once each
    if and only if every (row, channel) value is."""
    row_owner = []
    for sp in range(plan.splits):
        r0 = sp * plan.rows_per_split
        r1 = min(rows, r0 + plan.rows_per_split)
        for rl in range(plan.row_lanes):
            row_owner += [(r, sp, rl) for r in range(r0 + rl, r1, plan.row_lanes)]
    ch_owner = []
    for tile in range(plan.ctiles):
        for lane in range(plan.lanes):
            first = (tile * plan.lanes + lane) * plan.width
            if first < c:
                ch_owner += [(first + k, tile, lane) for k in range(plan.width)]
    return np.array(row_owner), np.array(ch_owner)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", STATS_SHAPES, ids=STATS_IDS)
def test_stats_plan_reads_every_value_once(shape, dtype):
    c = shape[-1]
    rows = _numel(shape) // c
    plan = stats_plan(rows, c, dtype)
    row_owner, ch_owner = _stats_reads(plan, rows, c)
    assert np.array_equal(np.bincount(row_owner[:, 0], minlength=rows), np.ones(rows))
    assert np.array_equal(np.bincount(ch_owner[:, 0], minlength=c), np.ones(c))
    # a warp reads contiguous bytes: its threads' (row, lane) in order
    assert ch_owner[:, 0].max() < c


def test_stats_splits_depend_on_the_shape_only(monkeypatch):
    """No argument but the shape and the dtype, no query of the card; the
    same rows and channels give the same plan however N, H, W make them."""
    assert list(inspect.signature(stats_plan).parameters) == ["rows", "c", "dtype"]

    def refuse(*_):
        raise AssertionError("stats_plan asked the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    for dtype in DTYPES:
        for rows, c in ((8 * 16 * 16, 64), (2 * 32 * 32, 64), (75, 100), (512, 2048)):
            assert stats_plan(rows, c, dtype) == stats_plan(rows, c, dtype)
    a, b = (stats_plan(n * h * w, 128, torch.bfloat16) for n, h, w in ((8, 16, 16), (2, 32, 32)))
    assert a == b


def _fma(a, b, c):
    """f32 a * b + c with one rounding (exact product in f64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def k1_model(x: np.ndarray, plan):
    """K1's sums in the kernel's order, in float32: each thread over its
    rows in order; the shuffle butterfly of a warp's row lanes (where the
    plan says so); the block's rows of partials in order; the last block's
    groups over the splits (group g: splits g, g + groups, ...), then the
    groups in order."""
    rows, c = x.shape
    f32 = np.float32
    part_s = np.zeros((plan.splits, c), f32)
    part_q = np.zeros((plan.splits, c), f32)
    for sp in range(plan.splits):
        r0 = sp * plan.rows_per_split
        r1 = min(rows, r0 + plan.rows_per_split)
        s = np.zeros((plan.row_lanes, c), f32)
        q = np.zeros((plan.row_lanes, c), f32)
        for rl in range(plan.row_lanes):
            for r in range(r0 + rl, r1, plan.row_lanes):
                s[rl] = s[rl] + x[r]
                q[rl] = _fma(x[r], x[r], q[rl])
        if plan.shuffle:  # lanes divides 32: a warp holds 32 // lanes row lanes
            n = 32 // plan.lanes
            s, q = s.reshape(-1, n, c), q.reshape(-1, n, c)
            off = 1
            while off < n:
                idx = np.arange(n) ^ off
                s, q = s + s[:, idx], q + q[:, idx]
                off *= 2
            s, q = s[:, 0], q[:, 0]
        for row_s, row_q in zip(s, q):
            part_s[sp] = part_s[sp] + row_s
            part_q[sp] = part_q[sp] + row_q
    mean = np.zeros(c, f32)
    var = np.zeros(c, f32)
    tile = plan.lanes * plan.width
    fv = 1 if plan.width == 1 else 4
    for c0 in range(0, c, tile):
        w = min(tile, c - c0)
        groups = plan.threads // (w // fv)
        acc_s = np.zeros((groups, w), f32)
        acc_q = np.zeros((groups, w), f32)
        for g in range(groups):
            for sp in range(g, plan.splits, groups):
                acc_s[g] = acc_s[g] + part_s[sp, c0:c0 + w]
                acc_q[g] = acc_q[g] + part_q[sp, c0:c0 + w]
        ts = np.zeros(w, f32)
        tq = np.zeros(w, f32)
        for g in range(groups):
            ts, tq = ts + acc_s[g], tq + acc_q[g]
        m = ts / f32(rows)
        mean[c0:c0 + w] = m
        var[c0:c0 + w] = np.maximum(_fma(-m, m, tq / f32(rows)), f32(0))
    return mean, var


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,tile_rows", [
    ((4, 8, 8, 128), 64), ((3, 5, 5, 128), 32),  # tests/test_torch_train_ops.py's K1 shapes
    ((3, 5, 5, 100), 32), ((2, 5, 7, 24), 32),   # C 100 and 24, ragged rows
    ((8, 32, 32, 64), 512)])                     # eight splits (bf16), four (f32)
def test_k1_order_of_sums_matches_jax(shape, tile_rows, dtype):
    """The model in the plan's order, on values that bf16 holds exactly
    where the plan is bf16's, against JAX's Pallas batch_stats (interpret)
    at 1e-5; and against float64 sums, where the one-pass form costs its
    own rounding."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) + 0.5
    if dtype == torch.bfloat16:
        x = torch.from_numpy(x).to(dtype).float().numpy()
    c = shape[-1]
    rows = x.size // c
    plan = stats_plan(rows, c, dtype)
    mean, var = k1_model(x.reshape(rows, c), plan)
    want_mean, want_var = jax_k1(jnp.asarray(x), tile_rows=tile_rows, interpret=True)
    np.testing.assert_allclose(mean, np.asarray(want_mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var, np.asarray(want_var), atol=1e-5, rtol=1e-5)
    x64 = x.reshape(rows, c).astype(np.float64)
    np.testing.assert_allclose(mean, x64.mean(0), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var, x64.var(0), atol=1e-5, rtol=1e-5)
