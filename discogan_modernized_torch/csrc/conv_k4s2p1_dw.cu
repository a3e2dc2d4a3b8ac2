// K4: the weight gradient of the k4/s2/p1 "halving" conv.
//
// Replaces discogan_modernized_tpu/ops/pallas_conv.py::conv2d_k4s2p1_dw (the
// pallas_call at line 245): x (N,H,W,I) NHWC, dy (N,H/2,W/2,O),
// dw[kh,kw,i,o] = sum_{b,r,c} x_pad[b, 2r+kh, 2c+kw, i] * dy[b,r,c,o] with
// f32 accumulation, written once in x's dtype as (4,4,I,O) HWIO.
//
// It is a GEMM whose output is dw viewed as (K = 16*I) x O and whose
// contraction runs over the M = N*Ho*Wo output pixels: A[m, k] is the
// im2col gather of x (tap = k / I, channel = k % I, padding applied on the
// fly) and B[m, o] = dy.
//
// Bound on the H100: in f32 the FMAs (67 TFLOP/s: 2*M*K*O flops) at
// enc2..enc6 of the 512px model (enc6 at batch 8: 34 GFLOP, 0.51 ms,
// against 268 MB of dw, 0.08 ms) and at the stem (enc0 at batch 8: 3.2
// GFLOP, 0.048 ms, against 134 MB of dy and 25 MB of x, 0.048 ms); in bf16
// the tensor cores' bytes at the stem and where M is short.
//
// The wrapper plans each call (ops/conv_k4s2p1.py::dw_plan) and passes the
// path, the tile, the split over M, the grid and the shared memory here,
// which the entry checks against its own arithmetic. Split parts write f32
// partials to a workspace the wrapper allocates, and a second pass
// (conv_dw_reduce_kernel) sums them in a fixed order and casts (the Pallas
// function's per-batch-tile f32 parts summed by the caller, as one pass).
// No float atomics: two launches give the same bits. Three paths:
// - bf16 with I % 8 == 0 and O % 8 == 0 (enc2..enc6): conv_dw_wgmma_kernel,
//   this file's entry around the body it shares with K5b
//   (conv_dw_wgmma.cuh): tiles of one kernel row's four taps x 64 input
//   channels x 128 output channels, both wgmma operands MN-major in shared
//   memory, x staged as column-parity planes (per-tap windows on enc6's
//   4-wide map), a cp.async ring two chunks ahead of m64n128k16. M is split
//   only while the tiles fill less than one wave of the card's SMs (enc2,
//   enc3); unsplit, one block per SM walks its tiles.
// - bf16 with I <= 4 (the stem): conv_dw_stem_kernel, one warpgroup a block
//   over an im2col tile of the 16*I dw rows (x read as 4 contiguous window
//   rows a pixel), wgmma m64n64k16, parts summed by the second pass.
// - everything else (every f32 call, the stem's included; bf16 channel
//   counts off those tiles): conv_dw_fma_kernel, exact f32 FMA on the CUDA
//   cores (no tensor cores, no TF32). A block of 256 threads holds a 128 x
//   128 tile of dw (64 x 64 where 16*I or O is at most 64: the stem's 48 x
//   64), each lane an 8 x 8 (4 x 4) register micro-tile read as float4 from
//   pixel rows of A and B (dw_fma.cuh); M in steps of 32 pixels (16 off the
//   16-byte copies) through a cp.async ring: 3 stages and two blocks an SM
//   where the 16-byte copies fill the steps and the grid holds more than
//   one block an SM, else 4 stages; M split while the tiles fill less than
//   a wave (two blocks an SM at enc2 and enc3; the stem), its parts summed
//   by the second pass.
#include "conv_dw_wgmma.cuh"
#include "dw_fma.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100

// ---- CUDA-core path (f32; bf16 off the wgmma tiles) ------------------------

namespace fma {

using dw_fma::THREADS;
// The ring's stages (copies stages - 1 steps ahead) at one block an SM, and
// at two (WIDE: a 128 x 128 tile's block capped at 128 registers a thread,
// its ring small enough that two fit an SM's shared memory). Two blocks let
// one block's fill and epilogue run beside the other's FMAs: 4-10% faster
// at every layer at batch 8 on an H100 at 700 W, enc2 and enc3 split over M
// to fill them (tools/dw_ab.py, "1 block/SM").
constexpr int RING = 4, RING_WIDE = 3;
template <bool WIDE>
__host__ __device__ constexpr int stages() { return WIDE ? RING_WIDE : RING; }

// Pixels of a step: 32 where x's and dy's 16-byte copies fill the stage
// (VA), else 16.
template <bool VA>
__host__ __device__ constexpr int step_px() { return VA ? 32 : 16; }
// A (BK pixel rows of BM floats) and B (BK rows of BN) of a step.
template <int BM, int BN, bool VA>
__host__ __device__ constexpr int stage_floats() { return step_px<VA>() * (BM + BN); }
// Blocks an SM: a 128 x 128 tile's 64 accumulators and 16 operands take
// 167 registers a thread at one block; capped at 128 (two blocks) for WIDE
// and for 64 x 64 tiles (101-107).
template <int BM, bool WIDE>
__host__ __device__ constexpr int min_blocks() { return BM == 128 && !WIDE ? 1 : 2; }

// A copy's pixel: image b, output row oy and column ox, index m in M.
struct Pixel {
  int b, oy, ox, m;
};

__device__ __forceinline__ Pixel pixel_at(int m, int hw, int wo) {
  const int b = m / hw, r = m - b * hw, oy = r / wo;
  return {b, oy, r - oy * wo, m};
}

// A step's advance of a pixel, (images, rows, columns) with rows < ho and
// columns < wo, added with one carry each: no division a step.
struct Advance {
  int db, dy, dx, dm;
};

__device__ __forceinline__ Advance advance_of(int px, int hw, int wo) {
  const int db = px / hw, r = px - db * hw, dy = r / wo;
  return {db, dy, r - dy * wo, px};
}

__device__ __forceinline__ void advance(Pixel& p, const Advance& a, int ho, int wo) {
  p.m += a.dm;
  p.ox += a.dx;
  const int cx = p.ox >= wo;
  p.ox -= cx ? wo : 0;
  p.oy += a.dy + cx;
  const int cy = p.oy >= ho;
  p.oy -= cy ? ho : 0;
  p.b += a.db + cy;
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): dw rows k0 .. k0+BM-1 (k = tap *
// CI + channel), columns o0 .. o0+BN-1 and the pixels [m_begin, m_end) of split
// z % splits (pair z / splits), in steps of BK through a ring of STAGES =
// stages<WIDE>() stages (dw_fma.cuh's layout and micro-tiles). A step's A row
// of pixel m is x at each of the tile's rows' taps, x[b, 2oy-1+kh, 2ox-1+kw,
// c], zero where the tap falls in the padding or m is past the part; its B row
// dy[m, o0 .. o0+BN-1]. Each thread stages the same dw rows (a fixed tap and
// channel) and columns for pixel slots a_row + A_ROWS j, walked a step at a
// time by `advance`. VA (f32, CI % 4 == 0, CO % 4 == 0): 4 dw rows a copy, one
// 16-byte cp.async (4 channels of one tap: CI % 4 == 0 keeps a group inside a
// tap, so a tile's rows may span taps), zero-filled through its source size. VB
// (f32, CO % 4 == 0): 4 columns a 16-byte cp.async. Otherwise (bf16; CI or CO
// off a multiple of 4: the stem's CI 3) one value a load, converted to f32:
// issued before the step's products and stored after them, into the slot the
// products of the step before freed. One barrier a step. With `partial` (a
// split) the block writes its f32 sums to partial[split], else dw in T.
template <typename T, int BM, int BN, bool VA, bool VB, bool WIDE>
__global__ void __launch_bounds__(THREADS, min_blocks<BM, WIDE>())
    conv_dw_fma_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw,
                       float* __restrict__ partial, int n, int h, int wd, int ci, int co,
                       int splits, int steps_per_split, PairStrides ps) {
  constexpr int BK = step_px<VA>(), STAGE = stage_floats<BM, BN, VA>();
  constexpr int STAGES = stages<WIDE>();
  constexpr int UA = VA ? 4 : 1, UB = VB ? 4 : 1;  // values of one copy
  constexpr int A_COLS = BM / UA, A_ROWS = THREADS / A_COLS, A_SLOTS = BK / A_ROWS;
  constexpr int B_COLS = BN / UB, B_ROWS = THREADS / B_COLS, B_SLOTS = BK / B_ROWS;
  static_assert(A_SLOTS * A_ROWS == BK && B_SLOTS * B_ROWS == BK, "whole pixel rows a pass");
  static_assert(!(VA || VB) || sizeof(T) == 4, "16-byte copies of f32 only");
  extern __shared__ __align__(16) float fsm[];
  const int split = blockIdx.z % splits, pair = blockIdx.z / splits;
  x = at_pair(x, ps.x, pair);
  dy = at_pair(dy, ps.w, pair);
  dw = at_pair(dw, ps.y, pair);
  partial = at_pair(partial, ps.ws, pair);
  const int ho = h / 2, wo = wd / 2, hw = ho * wo, m_total = n * hw, k_total = 16 * ci;
  const int k0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  const int m_begin = split * steps_per_split * BK;
  const long long m_stop = m_begin + static_cast<long long>(steps_per_split) * BK;
  const int m_end = static_cast<int>(min(static_cast<long long>(m_total), m_stop));
  const int nsteps = (m_end - m_begin + BK - 1) / BK;
  const int tid = threadIdx.x;

  // A: dw rows ka .. ka + UA - 1, one tap (kh, kw) and channels ch ..;
  // a_delta: their offset in x from the pixel's window corner.
  const int a_col = tid % A_COLS, a_row = tid / A_COLS;
  const int ka = k0 + a_col * UA;
  const bool ka_ok = ka < k_total;
  const int tap = ka_ok ? ka / ci : 0, ch = ka_ok ? ka - tap * ci : 0;
  const int kh = tap >> 2, kw = tap & 3;
  const long long a_delta = (static_cast<long long>(kh) * wd + kw) * ci + ch;
  const Advance adv = advance_of(BK, hw, wo);
  Pixel pa[A_SLOTS];
#pragma unroll
  for (int j = 0; j < A_SLOTS; ++j) pa[j] = pixel_at(m_begin + a_row + A_ROWS * j, hw, wo);
  // B: columns col .. col + UB - 1 of pixels b_m + B_ROWS j.
  const int b_col = tid % B_COLS, b_row = tid / B_COLS;
  const int col = o0 + b_col * UB;
  const bool b_ok = col < co;  // VB: CO % 4 == 0 keeps the four together
  const T* b_src = dy + static_cast<long long>(m_begin + b_row) * co + (b_ok ? col : 0);
  int b_m = m_begin + b_row;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(fsm));

  // Whether slot j's tap lies inside the map and its pixel inside the part,
  // and where it starts in x.
  auto a_ok = [&](const Pixel& p) {
    const int iy = 2 * p.oy - 1 + kh, ix = 2 * p.ox - 1 + kw;
    return ka_ok & (p.m < m_end) & (static_cast<unsigned>(iy) < static_cast<unsigned>(h)) &
           (static_cast<unsigned>(ix) < static_cast<unsigned>(wd));
  };
  auto a_src = [&](const Pixel& p) {
    return x + ((static_cast<long long>(p.b) * h + 2 * p.oy - 1) * wd + 2 * p.ox - 1) * ci +
           a_delta;
  };
  // Scalar operands of the step in flight (loaded, not yet stored).
  float av[VA ? 1 : A_SLOTS], bv[VB ? 1 : B_SLOTS];
  int st_q = 0;  // the step the next `stage` fills
  // Step st_q's copies into its ring slot (if `go`): cp.async for VA and
  // VB, scalar loads into av and bv otherwise; then every slot one step on.
  auto stage = [&](bool go) {
    const int slot = (st_q % STAGES) * STAGE;
#pragma unroll
    for (int j = 0; j < A_SLOTS; ++j) {
      const bool ok = go && a_ok(pa[j]);
      if constexpr (VA) {
        if (go)
          hopper::cp_async16(sbase + 4 * (slot + (a_row + A_ROWS * j) * BM + a_col * UA),
                             ok ? a_src(pa[j]) : x, ok);
      } else {
        av[j] = ok ? to_f32(*a_src(pa[j])) : 0.f;
      }
      advance(pa[j], adv, ho, wo);
    }
#pragma unroll
    for (int j = 0; j < B_SLOTS; ++j) {
      const bool ok = go && b_ok && b_m + B_ROWS * j < m_end;
      const T* src = b_src + static_cast<long long>(B_ROWS) * j * co;
      if constexpr (VB) {
        const int at = slot + BK * BM + (b_row + B_ROWS * j) * BN + b_col * UB;
        if (go) hopper::cp_async16(sbase + 4 * at, ok ? src : dy, ok);
      } else {
        bv[j] = ok ? to_f32(*src) : 0.f;
      }
    }
    b_src += static_cast<long long>(BK) * co;
    b_m += BK;
    ++st_q;
  };
  // The scalar operands of step q into its slot.
  auto store = [&](int q) {
    float* s = fsm + (q % STAGES) * STAGE;
    if constexpr (!VA) {
#pragma unroll
      for (int j = 0; j < A_SLOTS; ++j) s[(a_row + A_ROWS * j) * BM + a_col] = av[j];
    }
    if constexpr (!VB) {
#pragma unroll
      for (int j = 0; j < B_SLOTS; ++j) s[BK * BM + (b_row + B_ROWS * j) * BN + b_col] = bv[j];
    }
  };

  float acc[dw_fma::lane_rows<BM>()][dw_fma::lane_cols<BN>()];
#pragma unroll
  for (int i = 0; i < dw_fma::lane_rows<BM>(); ++i)
#pragma unroll
    for (int j = 0; j < dw_fma::lane_cols<BN>(); ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    stage(q < nsteps);
    store(q);
    hopper::cp_async_commit();
  }
  const dw_fma::Lane lane = dw_fma::lane_origin<BM, BN>(tid);
  // Step q: its copies landed (this thread's, then everyone's at the
  // barrier, which also sees every warp past step q - 1's products); step
  // q + STAGES - 1 issued into step q - 1's slot; step q's products; the
  // scalar operands of step q + STAGES - 1 stored.
#pragma unroll 1
  for (int q = 0; q < nsteps; ++q) {
    dw_fma::copies_landed<STAGES - 2>();
    __syncthreads();
    stage(q + STAGES - 1 < nsteps);
    hopper::cp_async_commit();
    const float* s = fsm + (q % STAGES) * STAGE;
    dw_fma::step_products<BM, BN, BK>(acc, s + lane.row, s + BK * BM + lane.col);
    store(q + STAGES - 1);
  }
  dw_fma::copies_landed<0>();
  dw_fma::store_tile<T, BM, BN>(
      acc, partial != nullptr ? partial + static_cast<long long>(split) * k_total * co : nullptr,
      dw, k_total, co, k0 + lane.row, o0 + lane.col);
}

template <typename T, int BM, int BN, bool VA, bool VB, bool WIDE>
int launch(dim3 grid, int smem, cudaStream_t s, const void* x, const void* dy, void* dw,
           float* partial, int n, int h, int wd, int ci, int co, int splits, int steps_per_split,
           const PairStrides& ps) {
  if (smem < stages<WIDE>() * stage_floats<BM, BN, VA>() * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = conv_dw_fma_kernel<T, BM, BN, VA, VB, WIDE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                     static_cast<T*>(dw), partial, n, h, wd, ci, co, splits,
                                     steps_per_split, ps);
  return launch_status();
}

// The instantiation of the tile and ring: 128 x 128 with RING stages, or
// with RING_WIDE (two blocks an SM) for f32 with 16-byte copies; 64 x 64 (16
// CI or CO at most 64: the stem) with RING; -1 for another plan.
template <typename T, bool VA, bool VB, typename... Args>
int launch_tile(int bm, int bn, int ring, Args&&... args) {
  if (bm == 128 && bn == 128 && ring == RING) return launch<T, 128, 128, VA, VB, false>(args...);
  if constexpr (VA && VB) {
    if (bm == 128 && bn == 128 && ring == RING_WIDE)
      return launch<T, 128, 128, VA, VB, true>(args...);
  }
  if (bm == 64 && bn == 64 && ring == RING) return launch<T, 64, 64, VA, VB, false>(args...);
  return -1;
}

}  // namespace fma

// ---- tensor-core path (bf16, CI % 8 == 0, CO % 8 == 0): wgmma -------------

// K4's entry around the body it shares with K5b (conv_dw_wgmma.cuh).
template <bool PLANES>
__global__ void __launch_bounds__(dw_wgmma::THREADS, 1)
    conv_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                         __nv_bfloat16* __restrict__ dw, float* __restrict__ partial, int n, int h,
                         int wd, int ci, int co, int splits, int steps_per_split,
                         PairStrides ps) {
  const int pair = blockIdx.y;
  dw_wgmma::body<PLANES>(x + pair * ps.x, dy + pair * ps.w, dw + pair * ps.y,
                         at_pair(partial, ps.ws, pair), n, h, wd, ci, co, splits, steps_per_split);
}

// ---- the stem (bf16, CI <= 4, CO % 8 == 0): wgmma over an im2col tile ---

namespace stem {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int THREADS = 128;       // one warpgroup
constexpr int CHUNK = 64;          // output pixels a stage holds
constexpr int BO = 64;             // output channels of a block
constexpr int TILE = CHUNK * 128;  // a stage's A (im2col of x) or B (dy) tile
constexpr int SMEM = 4 * TILE;     // two stages of A and B

// One block: output channels o0 .. o0+63 (blockIdx.x), chunks [c0, c0 +
// steps_per_split) of the contraction (blockIdx.y); f32 partials of the
// 16*CI (<= 64) dw rows to `partial`, summed by the reduce pass. A is the
// im2col of x, [pixel][tap * CI + channel] in 128-byte rows (rows past
// 16*CI stay zero), built by the threads from coalesced loads of each
// pixel's four window rows (4*CI contiguous values each); B is dy,
// [pixel][64 o], by cp.async. Both MN-major, two stages: the next chunk's
// loads are in flight while this chunk's wgmmas run. Several blocks share
// an SM.
template <int CI>
__global__ void __launch_bounds__(THREADS)
    conv_dw_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        float* __restrict__ partial, int n, int h, int wd, int co,
                        int steps_per_split, PairStrides ps) {
  constexpr int V = 4 * CI;  // values of one window row
  x += blockIdx.z * ps.x;  // z: the pair
  dy += blockIdx.z * ps.w;
  partial += blockIdx.z * ps.ws;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int ho = h / 2, wo = wd / 2, hw = ho * wo, m_total = n * hw;
  const int o0 = blockIdx.x * BO, c0 = blockIdx.y * steps_per_split;
  const int nch = min(steps_per_split, (m_total + CHUNK - 1) / CHUNK - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < SMEM / 16; e += THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);

  // This thread's part of A: pixel p, window rows kh0 and kh0 + 2, as bf16
  // pairs (V is even).
  const int p = tid & (CHUNK - 1), kh0 = tid >> 6;
  uint32_t xv[2][V / 2];
  auto load_x = [&](int t) {
    const int m = (c0 + t) * CHUNK + p;
    const int b = m / hw, r = m - b * hw, oy = r / wo, ox = r - oy * wo;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int iy = 2 * oy - 1 + kh0 + 2 * rr;
      const bool row_ok = (t < nch) & (m < m_total) & (iy >= 0) & (iy < h);
      const unsigned short* src = reinterpret_cast<const unsigned short*>(x) +
                                  ((static_cast<long long>(b) * h + iy) * wd + 2 * ox - 1) * CI;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        uint32_t pair = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ix = 2 * ox - 1 + (2 * i + e) / CI;
          const bool ok = row_ok & (ix >= 0) & (ix < wd);
          pair |= static_cast<uint32_t>(ok ? src[2 * i + e] : 0) << (16 * e);
        }
        xv[rr][i] = pair;
      }
    }
  };
  auto store_x = [&](int t) {  // into stage t's A: row p, k = 4*CI*kh + v
    const uint32_t a = sbase + (t & 1) * 2 * TILE + p * 128;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const int k = V * (kh0 + 2 * rr) + 2 * i;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a + (((k >> 3) ^ (p & 7)) << 4) +
                                                        (k & 7) * 2),
                     "r"(xv[rr][i])
                     : "memory");
      }
  };
  auto stage_dy = [&](int t) {  // stage t's B: 64 pixels x 64 o
    const uint32_t bt = sbase + (t & 1) * 2 * TILE + TILE;
#pragma unroll
    for (int i = 0; i < CHUNK * BO / 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, px = e >> 3, u = e & 7;
      const int m = (c0 + t) * CHUNK + px, o = o0 + u * 8;
      const bool ok = (t < nch) & (m < m_total) & (o < co);
      cp_async16(bt + px * 128 + ((u ^ (px & 7)) << 4),
                 ok ? dy + static_cast<long long>(m) * co + o : dy, ok);
    }
  };

  float acc[32];  // set by the first chunk's wgmmas (scale-d 0)
  __syncthreads();  // A's zeros
  load_x(0);
  store_x(0);
  stage_dy(0);
  cp_async_commit();
#pragma unroll 1
  for (int t = 0; t < nch; ++t) {
    load_x(t + 1);
    stage_dy(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk t's dy; with the fence, A's stores of chunk t too
    __syncthreads();
    const uint32_t a = sbase + (t & 1) * 2 * TILE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < CHUNK / 16; ++s)
      wgmma_m64n64k16<1>(acc, sw128_desc(a + s * 2048, 8192, 1024),
                         sw128_desc(a + TILE + s * 2048, 8192, 1024), (t | s) != 0);
    wgmma_commit();
    store_x(t + 1);  // chunk t - 1's slot: its wgmmas are done
    wgmma_wait<0>();
  }
  cp_async_wait();
#pragma unroll
  for (int e = 0; e < 32; ++e) keep(acc[e]);
  // acc[4 nt + 2 hf + e]: dw row 16 warp + lane/4 + 8 hf, o 8 nt + 2 (lane % 4) + e
  float* part = partial + static_cast<long long>(blockIdx.y) * 16 * CI * co;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int k = 16 * warp + (lane >> 2) + 8 * hf;
#pragma unroll
    for (int nt = 0; nt < BO / 8; ++nt) {
      const int o = o0 + 8 * nt + 2 * (lane & 3);
      if (k < 16 * CI && o < co)
        *reinterpret_cast<float2*>(part + static_cast<long long>(k) * co + o) =
            make_float2(acc[4 * nt + 2 * hf], acc[4 * nt + 2 * hf + 1]);
    }
  }
}

template <int CI>
int launch(int splits, cudaStream_t s, const void* x, const void* dy, float* partial, int n,
           int h, int wd, int co, int steps_per_split, int pairs, const PairStrides& ps) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dw_stem_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((co + BO - 1) / BO), static_cast<unsigned>(splits),
                  static_cast<unsigned>(pairs));
  conv_dw_stem_kernel<CI><<<grid, THREADS, SMEM, s>>>(static_cast<const bf16*>(x),
                                                      static_cast<const bf16*>(dy), partial, n, h,
                                                      wd, co, steps_per_split, ps);
  return launch_status();
}

}  // namespace stem

// Sum of the split parts, in order, cast once: a block takes 256 / SLICES
// consecutive elements; slice l of them sums the parts s = l, l + SLICES,
// ..., then slice 0 adds the SLICES sums in order. Many parts over few
// elements (the stem) take 8 slices; a few parts (enc2, enc3) one.
template <typename T, int SLICES>
__global__ void __launch_bounds__(256)
    conv_dw_reduce_kernel(const float* __restrict__ partial, int splits, long long ko,
                          T* __restrict__ dw, PairStrides ps) {
  constexpr int E = 256 / SLICES;
  partial += blockIdx.y * ps.ws;  // y: the pair
  dw += blockIdx.y * ps.y;
  __shared__ float sums[SLICES][E];
  const int e = threadIdx.x % E, sl = threadIdx.x / E;
  const long long i = static_cast<long long>(blockIdx.x) * E + e;
  float v = 0.f;
  if (i < ko)
    for (int s = sl; s < splits; s += SLICES) v += partial[s * ko + i];
  if (SLICES > 1) {
    sums[sl][e] = v;
    __syncthreads();
    if (sl > 0) return;
    v = 0.f;
#pragma unroll
    for (int w = 0; w < SLICES; ++w) v += sums[w][e];
  }
  if (i < ko) dw[i] = from_f32<T>(v);
}

template <typename T>
int reduce(const float* partial, int splits, long long ko, void* dw, int pairs,
           const PairStrides& ps, cudaStream_t s) {
  const unsigned p = static_cast<unsigned>(pairs);
  if (splits >= 16) {
    conv_dw_reduce_kernel<T, 8><<<dim3(static_cast<unsigned>((ko + 31) / 32), p), 256, 0, s>>>(
        partial, splits, ko, static_cast<T*>(dw), ps);
  } else {
    conv_dw_reduce_kernel<T, 1><<<dim3(static_cast<unsigned>((ko + 255) / 256), p), 256, 0, s>>>(
        partial, splits, ko, static_cast<T*>(dw), ps);
  }
  return launch_status();
}
}  // namespace

// path (the wrapper's plan, ops/conv_k4s2p1.py::dw_plan): PATH_FMA, or the
// wgmma kernel with parity planes (PATH_PLANES, WO % 8 == 0) or per-tap
// windows (PATH_WINDOWS), or the stem's (PATH_STEM); tile_rows, tile_cols,
// stages: the FMA kernel's tile of dw and its ring (the wgmma paths' are
// fixed); splits > 1: `workspace` holds splits x 16*CI*CO f32 partials;
// steps_per_split counts FMA steps (32 or 16 pixels: fma::step_px) or
// 64-pixel chunks (wgmma); blocks: the FMA kernel's tiles times splits, or
// the wgmma kernel's grid; smem: dynamic shared memory. pairs, x_ps, dy_ps:
// the pair axis (common.cuh); pair p's dw starts 16*CI*CO values, its
// workspace part splits x 16*CI*CO floats after pair 0's.
extern "C" int discogan_conv_k4s2p1_dw(const void* x, const void* dy, void* dw, void* workspace,
                                       int n, int h, int wd, int ci, int co, int dtype, int path,
                                       int tile_rows, int tile_cols, int stages, int splits,
                                       int steps_per_split, int blocks, int smem, int pairs,
                                       long long x_ps, long long dy_ps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  const long long ko = 16LL * ci * co;
  if (ko == 0 || pairs == 0) return 0;
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || pairs > 65535 / (splits > 0 ? splits : 1) ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, dy_ps, itemsize))
    return BAD;
  if (n == 0 || h < 2 || wd < 2) {  // no pixels: dw is zero
    return static_cast<int>(cudaMemsetAsync(dw, 0, pairs * ko * itemsize, s));
  }
  const PairStrides ps{x_ps, dy_ps, ko, 0, splits * ko, 0};
  // The stem always writes partials (its reduce pass casts).
  float* partial = splits > 1 || path == PATH_STEM ? static_cast<float*>(workspace) : nullptr;
  if (splits < 1 || steps_per_split < 1 || ((splits > 1 || path == PATH_STEM) && !partial))
    return BAD;
  int err;
  if (path == PATH_FMA) {
    // 16-byte copies of x where f32 CI and CO are multiples of 4 (steps of
    // 32 pixels), of dy where f32 CO is, as the plan has it; they need
    // 16-byte aligned operands, which the wrapper passes.
    const bool va = dtype == DT_F32 && ci % 4 == 0 && co % 4 == 0;
    const bool vb = dtype == DT_F32 && co % 4 == 0;
    const int bk = va ? fma::step_px<true>() : fma::step_px<false>();
    const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
    const long long tiles = tile_rows < 1 || tile_cols < 1
                                ? 0
                                : (16LL * ci + tile_rows - 1) / tile_rows *
                                      ((co + tile_cols - 1) / tile_cols);
    if ((dtype != DT_F32 && dtype != DT_BF16) || m_total >= (1LL << 31) - 64 ||
        !covers_once((m_total + bk - 1) / bk, splits, steps_per_split) || tiles < 1 ||
        blocks != tiles * splits || smem > MAX_SMEM ||
        (vb && (reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(dw) % 16 ||
                (va && reinterpret_cast<uintptr_t>(x) % 16))))
      return BAD;
    const dim3 grid(static_cast<unsigned>((16 * ci + tile_rows - 1) / tile_rows),
                    static_cast<unsigned>((co + tile_cols - 1) / tile_cols),
                    static_cast<unsigned>(splits * pairs));
    const auto args = [&](auto launch_tile) {
      return launch_tile(tile_rows, tile_cols, stages, grid, smem, s, x, dy, dw, partial, n, h,
                         wd, ci, co, splits, steps_per_split, ps);
    };
    if (dtype == DT_BF16)
      err = args([](auto... a) { return fma::launch_tile<__nv_bfloat16, false, false>(a...); });
    else if (va)
      err = args([](auto... a) { return fma::launch_tile<float, true, true>(a...); });
    else if (vb)
      err = args([](auto... a) { return fma::launch_tile<float, false, true>(a...); });
    else
      err = args([](auto... a) { return fma::launch_tile<float, false, false>(a...); });
    if (err < 0) return BAD;
  } else if (path == PATH_STEM) {
    if (dtype != DT_BF16 || ci < 1 || ci > 4 || co % 8 ||
        static_cast<long long>(n) * (h / 2) * (wd / 2) >= (1LL << 31))
      return BAD;
    auto run = [&](auto launch) {
      return launch(splits, s, x, dy, partial, n, h, wd, co, steps_per_split, pairs, ps);
    };
    switch (ci) {
      case 1: err = run(stem::launch<1>); break;
      case 2: err = run(stem::launch<2>); break;
      case 3: err = run(stem::launch<3>); break;
      default: err = run(stem::launch<4>);
    }
  } else {
    if (dtype != DT_BF16) return BAD;
    // One tile a block where M is split; else `blocks` persistent blocks.
    err = path == PATH_PLANES
              ? dw_wgmma::launch<true>(conv_dw_wgmma_kernel<true>, blocks, smem, s, x, dy, dw,
                                       partial, n, h, wd, ci, co, splits, steps_per_split,
                                       pairs, ps)
              : dw_wgmma::launch<false>(conv_dw_wgmma_kernel<false>, blocks, smem, s, x, dy, dw,
                                        partial, n, h, wd, ci, co, splits, steps_per_split,
                                        pairs, ps);
  }
  if (err != 0 || partial == nullptr) return err;
  return dtype == DT_F32 ? reduce<float>(partial, splits, ko, dw, pairs, ps, s)
                         : reduce<__nv_bfloat16>(partial, splits, ko, dw, pairs, ps, s);
}
