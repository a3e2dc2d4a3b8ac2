// K5b: the weight gradient of the k4/s2/p1 conv that K5f computes, for the
// wide-map, few-channel layer (enc1/dis1: x (B,256,256,64), dy
// (B,128,128,128) at the 512px geometry).
//
// Replaces discogan_modernized_tpu/ops/pallas_halo_conv.py::
// halo_conv2d_k4s2p1_dw (the pallas_call at line 230). Contract: x
// (N,H,W,CI) NHWC, dy (N,H/2,W/2,CO), CI and CO multiples of 8, W/2 <= 256;
// dw[kh,kw,ci,o] = sum_{b,q,c} x[b, 2q+kh-1, 2c+kw-1, ci] * dy[b,q,c,o],
// f32 accumulation, written once in x's dtype as (4,4,CI,CO) HWIO. The
// Pallas kernel's column-pair lane packing and rolled dy copies are TPU
// layout and are not carried over.
//
// Bound on the H100: operations. At enc1, batch 8: 34.4 GFLOP against
// 101 MB of x and dy in bf16, far above the ridge of 295 flop/byte; in f32
// 0.513 ms of FMAs at 67 TFLOP/s against 201 MB (0.06 ms).
//
// The function is K4's; only the shape differs (few channels, a wide map,
// so M is long and the output small). The wrapper plans each call
// (ops/halo_conv.py::halo_dw_plan) and passes the path, the tile, the
// split, the grid and the shared memory here. Two paths:
// - bf16: halo_dw_wgmma_kernel, this file's entry around the wgmma body
//   K4 uses (conv_dw_wgmma.cuh): a tile is one kernel row's four taps x 64
//   input channels x 128 output channels, so enc1 is 4 tiles; M is split
//   into as many parts as fill one wave of the card's SMs (33 parts of 63
//   chunks of 64 pixels at batch 8), the four kh tiles of a part side by
//   side so they read its dy chunks from L2 together. x is staged as
//   column-parity planes (W/2 % 8 == 0) or per-tap windows.
// - f32: halo_dw_fma_kernel, exact f32 FMA on the CUDA cores (no tensor
//   cores, no TF32) on dw_fma.cuh's 8 x 8 register micro-tiles. A block
//   owns one kernel row kh, a window of WINDOW of that row's 4*CI dw rows
//   (r = kw*CI + ci), BN output channels and a run of output rows. The conv
//   has stride 2, so output pixel ox of row oy reads, for dw row r of the
//   window at r0, X[(2*ox - 1)*CI + r0 + r], X the input row 2*oy + kh - 1
//   read as one flat run of W*CI floats: a step of STEP pixels from ox0
//   reads one contiguous segment of 2*CI*(STEP - 1) + WINDOW floats at a
//   pixel stride of 2*CI (at enc1, CI 64, the stride is the window's 128
//   rows and the segment 16 KB). Each step stages that segment and dy's
//   STEP x BN run with 16-byte cp.async through a ring of RING stages,
//   zero-filled outside [0, W*CI) (the padding columns) and past the row's
//   last pixel; no per-pixel address arithmetic. A padding input row
//   (2*oy + kh - 1 outside the map) is skipped by the whole block. The
//   window is all 4*CI = 256 rows of a kernel row at enc1, in two halves of
//   256 threads that share each staged segment and dy run: half the copies
//   a product of two 128-row windows (tools/dw_ab.py: 7% faster), at one
//   block of 512 threads an SM (128 registers a thread). The runs are
//   split while the blocks fill less than a wave of MIN_BLOCKS blocks an
//   SM.
// Split parts write f32 partials that halo_dw_reduce_kernel sums in a fixed
// order and casts: no float atomics, two launches give the same bits.
#include "conv_dw_wgmma.cuh"
#include "dw_fma.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100

// ---- f32 path: halo_dw_fma_kernel -------------------------------------------

namespace fma {

using dw_fma::THREADS;
// The plan's tile, steps and ring (ops/halo_conv.py, HALO_DW_*), which the
// entry checks: WINDOW dw rows a block (256: two halves of THREADS threads,
// one dw_fma tile of 128 rows each, that share one staged segment; 128: one
// tile), BN output channels, STEP pixels a step (STEP_SHORT where the ring
// of STEP would not fit a block: CI over 80), RING stages; MIN_BLOCKS
// blocks an SM (a block of 512 threads at 128 registers fills the SM's).
constexpr int WINDOW = 256;
constexpr int STEP = 64, STEP_SHORT = 32;
constexpr int RING = 3;
constexpr int MIN_BLOCKS = 1;
constexpr int HALF = 128, BN = 128;
constexpr int HALVES = WINDOW / HALF;
constexpr int BLOCK = THREADS * HALVES;

// Floats of a step's x segment, and of a stage (the segment and dy's run).
__host__ __device__ constexpr int seg_floats(int ci, int step) {
  return 2 * ci * (step - 1) + WINDOW;
}
__host__ __device__ constexpr int stage_floats(int ci, int step) {
  return seg_floats(ci, step) + step * BN;
}

// Rows r in [0, v) with r % ho == t (v >= 0, 0 <= t < ho).
__device__ __forceinline__ long long rows_at(long long v, int ho, int t) {
  return (v + ho - 1 - t) / ho;
}

// Block (blockIdx.x = kh * windows + window, blockIdx.y = column tile,
// blockIdx.z = pair * splits + split): dw rows kh*4*CI + r0 .. + WINDOW - 1,
// columns o0 .. o0 + BN - 1, the output rows [row_begin, row_end) of split
// z % splits, each in steps of STEP pixels. The walk (w_b, w_oy, w_ox0) of
// the step the next `stage` fills skips the rows whose input row is
// padding; their count is known up front. One barrier a step. With
// `partial` (a split) the block writes its f32 sums to partial[split].
template <int STEP>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    halo_dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       float* __restrict__ dw, float* __restrict__ partial, int n, int h, int wd,
                       int ci, int co, int windows, int splits, int rows_per_split,
                       PairStrides ps) {
  extern __shared__ __align__(16) float fsm[];
  const int kh = blockIdx.x / windows, r0 = (blockIdx.x - kh * windows) * WINDOW;
  const int o0 = blockIdx.y * BN;
  const int split = blockIdx.z % splits, pair = blockIdx.z / splits;
  x = at_pair(x, ps.x, pair);
  dy = at_pair(dy, ps.w, pair);
  dw = at_pair(dw, ps.y, pair);
  partial = at_pair(partial, ps.ws, pair);
  const int ho = h / 2, wo = wd / 2, wci = wd * ci;
  const int seg = seg_floats(ci, STEP), stage_fl = stage_floats(ci, STEP);
  const long long row_begin = static_cast<long long>(split) * rows_per_split;
  const long long row_end = min(static_cast<long long>(n) * ho, row_begin + rows_per_split);
  // The output rows whose input row 2*oy + kh - 1 is padding: oy 0 for kh
  // 0, oy ho - 1 for kh 3 (-1: none).
  const int pad_oy = kh == 0 ? 0 : kh == 3 ? ho - 1 : -1;
  const long long rows =
      row_end - row_begin -
      (pad_oy < 0 ? 0 : rows_at(row_end, ho, pad_oy) - rows_at(row_begin, ho, pad_oy));
  const int nsteps = static_cast<int>(rows) * ((wo + STEP - 1) / STEP);
  const int tid = threadIdx.x;

  // The walk: image w_b, output row w_oy, first column w_ox0 of the step.
  int w_b = static_cast<int>(row_begin / ho), w_oy = static_cast<int>(row_begin % ho), w_ox0 = 0;
  // The next output row that is not padding (ho >= 2: never two in a row).
  auto next_row = [&]() {
    if (++w_oy == ho) {
      w_oy = 0;
      ++w_b;
    }
    if (w_oy == pad_oy && ++w_oy == ho) {
      w_oy = 0;
      ++w_b;
    }
  };
  if (w_oy == pad_oy) {
    --w_oy;
    next_row();
  }
  // B: this thread's 4 columns col .. col + 3 of pixels b_p + B_ROWS j.
  constexpr int B_UNITS = BN / 4, B_ROWS = BLOCK / B_UNITS, B_SLOTS = STEP / B_ROWS;
  static_assert(B_SLOTS * B_ROWS == STEP, "whole pixel rows a pass");
  const int b_u = tid % B_UNITS, b_p = tid / B_UNITS;
  const int col = o0 + 4 * b_u;
  const bool col_ok = col < co;  // CO % 8 == 0 keeps the four together
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(fsm));
  int st_q = 0;  // the step the next `stage` fills
  // Step st_q's segment and dy run into its ring slot (if `go`), then the
  // walk one step on.
  auto stage = [&](bool go) {
    if (!go) return;
    const int slot = (st_q % RING) * stage_fl;
    const float* xrow = x + (static_cast<long long>(w_b) * h + 2 * w_oy - 1 + kh) * wci;
    const int s0 = (2 * w_ox0 - 1) * ci + r0;
    for (int e = 4 * tid; e < seg; e += 4 * BLOCK) {
      const int i = s0 + e;
      const bool ok = static_cast<unsigned>(i) < static_cast<unsigned>(wci);
      hopper::cp_async16(sbase + 4 * (slot + e), ok ? xrow + i : x, ok);
    }
    const float* dyrow = dy + (static_cast<long long>(w_b) * ho + w_oy) * wo * co + col;
#pragma unroll
    for (int j = 0; j < B_SLOTS; ++j) {
      const int p = b_p + B_ROWS * j, ox = w_ox0 + p;
      const bool ok = col_ok && ox < wo;
      hopper::cp_async16(sbase + 4 * (slot + seg + p * BN + 4 * b_u),
                         ok ? dyrow + static_cast<long long>(ox) * co : dy, ok);
    }
    ++st_q;
    w_ox0 += STEP;
    if (w_ox0 >= wo) {
      w_ox0 = 0;
      next_row();
    }
  };

  float acc[dw_fma::lane_rows<HALF>()][dw_fma::lane_cols<BN>()];
#pragma unroll
  for (int i = 0; i < dw_fma::lane_rows<HALF>(); ++i)
#pragma unroll
    for (int j = 0; j < dw_fma::lane_cols<BN>(); ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < RING - 1; ++q) {
    stage(q < nsteps);
    hopper::cp_async_commit();
  }
  // This lane's first dw row in the window (its half's tile, then its
  // micro-tile) and its first column.
  const dw_fma::Lane lane = dw_fma::lane_origin<HALF, BN>(tid % THREADS);
  const int a_row = (tid / THREADS) * HALF + lane.row;
  // Step q: its copies landed (this thread's, then everyone's at the
  // barrier, which also sees every warp past step q - 1's products); step
  // q + RING - 1 issued into step q - 1's slot; step q's products, A read
  // at the segment's pixel stride of 2*CI.
#pragma unroll 1
  for (int q = 0; q < nsteps; ++q) {
    dw_fma::copies_landed<RING - 2>();
    __syncthreads();
    stage(q + RING - 1 < nsteps);
    hopper::cp_async_commit();
    const float* s = fsm + (q % RING) * stage_fl;
    dw_fma::step_products<HALF, BN, STEP>(acc, s + a_row, s + seg + lane.col, 2 * ci);
  }
  dw_fma::copies_landed<0>();
  const long long ko = 16LL * ci * co, at = static_cast<long long>(kh) * 4 * ci * co;
  dw_fma::store_tile<float, HALF, BN>(acc, partial != nullptr ? partial + split * ko + at : nullptr,
                                      dw + at, 4 * ci, co, r0 + a_row, o0 + lane.col);
}

template <int STEP>
int launch(dim3 grid, int smem, cudaStream_t s, const void* x, const void* dy, void* dw,
           float* partial, int n, int h, int wd, int ci, int co, int windows, int splits,
           int rows_per_split, const PairStrides& ps) {
  const cudaError_t err = cudaFuncSetAttribute(
      halo_dw_fma_kernel<STEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_dw_fma_kernel<STEP><<<grid, BLOCK, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dw),
      partial, n, h, wd, ci, co, windows, splits, rows_per_split, ps);
  return launch_status();
}

}  // namespace fma

// ---- tensor-core path (bf16): wgmma -----------------------------------------

// K5b's entry around the body it shares with K4 (conv_dw_wgmma.cuh).
template <bool PLANES>
__global__ void __launch_bounds__(dw_wgmma::THREADS, 1)
    halo_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                         __nv_bfloat16* __restrict__ dw, float* __restrict__ partial, int n, int h,
                         int wd, int ci, int co, int splits, int steps_per_split,
                         PairStrides ps) {
  const int pair = blockIdx.y;
  dw_wgmma::body<PLANES>(x + pair * ps.x, dy + pair * ps.w, dw + pair * ps.y,
                         at_pair(partial, ps.ws, pair), n, h, wd, ci, co, splits, steps_per_split);
}

// Sum of the split parts, in order, cast once.
template <typename T>
__global__ void halo_dw_reduce_kernel(const float* __restrict__ partial, int splits,
                                      long long ko, T* __restrict__ dw, PairStrides ps) {
  partial += blockIdx.y * ps.ws;  // y: the pair
  dw += blockIdx.y * ps.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < ko;
       i += stride) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * ko + i];
    dw[i] = from_f32<T>(v);
  }
}

}  // namespace

// path (the wrapper's plan, ops/halo_conv.py::halo_dw_plan): PATH_FMA (f32:
// tile_rows, step, stages the FMA kernel's window, pixels a step and ring,
// which must be the source's (step STEP_SHORT only where STEP's ring does
// not fit a block); steps_per_split counts output rows; blocks =
// 4 * windows * column tiles * splits; smem its ring), or the wgmma kernel
// with parity planes (PATH_PLANES) or per-tap windows (PATH_WINDOWS) (bf16;
// tile_rows, step and stages unused; steps_per_split counts 64-pixel
// chunks; blocks and smem its grid and dynamic shared memory). splits > 1:
// `workspace` holds splits x 16*CI*CO f32 partials. A plan whose parts do
// not cover the rows (or M) exactly once is refused. pairs, x_ps, dy_ps:
// the pair axis (common.cuh); pair p's dw starts 16*CI*CO values, its
// workspace part splits x 16*CI*CO floats after pair 0's.
extern "C" int discogan_halo_conv_k4s2p1_dw(const void* x, const void* dy, void* dw,
                                            void* workspace, int n, int h, int wd, int ci,
                                            int co, int dtype, int path, int tile_rows,
                                            int step, int stages, int splits,
                                            int steps_per_split, int blocks, int smem,
                                            int pairs, long long x_ps, long long dy_ps,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  const long long ko = 16LL * ci * co;
  if (ko == 0 || pairs == 0) return 0;
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || pairs > 65535 / (splits > 0 ? splits : 1) ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, dy_ps, itemsize))
    return BAD;
  if (n == 0 || h < 2 || wd < 2) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, pairs * ko * itemsize, s));
  }
  const PairStrides ps{x_ps, dy_ps, ko, 0, splits * ko, 0};
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  if (splits > 1 && partial == nullptr) return BAD;
  int err;
  if (path == PATH_FMA) {
    const long long rows = static_cast<long long>(n) * (h / 2);
    const int windows = (4 * ci + fma::WINDOW - 1) / fma::WINDOW;
    const int co_tiles = (co + fma::BN - 1) / fma::BN;
    const long long need = 4LL * fma::RING * fma::stage_floats(ci, step);
    const bool long_fits = 4LL * fma::RING * fma::stage_floats(ci, fma::STEP) <= MAX_SMEM;
    if (dtype != DT_F32 || ci % 8 || co % 8 || tile_rows != fma::WINDOW ||
        step != (long_fits ? fma::STEP : fma::STEP_SHORT) || stages != fma::RING ||
        !covers_once(rows, splits, steps_per_split) ||
        blocks != 4 * windows * co_tiles * splits || smem < need || smem > MAX_SMEM ||
        static_cast<long long>(wd) * ci >= (1LL << 31) - 64 ||
        reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16 ||
        reinterpret_cast<uintptr_t>(dw) % 16)
      return BAD;
    const dim3 grid(static_cast<unsigned>(4 * windows), static_cast<unsigned>(co_tiles),
                    static_cast<unsigned>(splits * pairs));
    err = (long_fits ? fma::launch<fma::STEP> : fma::launch<fma::STEP_SHORT>)(
        grid, smem, s, x, dy, dw, partial, n, h, wd, ci, co, windows, splits, steps_per_split,
        ps);
  } else if (dtype == DT_BF16 && (path == PATH_PLANES || path == PATH_WINDOWS)) {
    err = path == PATH_PLANES
              ? dw_wgmma::launch<true>(halo_dw_wgmma_kernel<true>, blocks, smem, s, x, dy, dw,
                                       partial, n, h, wd, ci, co, splits, steps_per_split,
                                       pairs, ps)
              : dw_wgmma::launch<false>(halo_dw_wgmma_kernel<false>, blocks, smem, s, x, dy, dw,
                                        partial, n, h, wd, ci, co, splits, steps_per_split,
                                        pairs, ps);
  } else {
    return BAD;
  }
  if (err != 0 || partial == nullptr) return err;
  const long long want = (ko + 255) / 256;
  const int rblocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  if (dtype == DT_F32) {
    halo_dw_reduce_kernel<float><<<dim3(rblocks, pairs), 256, 0, s>>>(
        partial, splits, ko, static_cast<float*>(dw), ps);
  } else {
    halo_dw_reduce_kernel<__nv_bfloat16><<<dim3(rblocks, pairs), 256, 0, s>>>(
        partial, splits, ko, static_cast<__nv_bfloat16*>(dw), ps);
  }
  return launch_status();
}
