// K3: the k4/s2/p1 "halving" conv with a fused scale/offset/act epilogue.
//
// Replaces discogan_modernized_tpu/ops/pallas_conv.py::conv2d_k4s2p1 (the
// pallas_call at line 184), forward, epilogue and with_stats output.
//
// Contract: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO, even H and W,
// y (N,H/2,W/2,CO) = act(conv(x, w) * scale + offset), f32 accumulation,
// one cast on store. scale/offset may be null (no affine). With stats, it
// also writes the per-channel means of the raw f32 accumulator and of its
// square over the N*Ho*Wo rows (train-mode BatchNorm's one-pass
// statistics), taken before the epilogue and before y's bf16 rounding.
//
// The conv is an implicit GEMM: M = N*Ho*Wo output pixels, K = 16*CI in
// tap-major order (k = tap*CI + c, w's HWIO row order), N = CO. Bound on the
// H100: operations (2*M*K*CO flops at 989 TFLOP/s) for enc2..enc5 of the
// 512px model at batch 8; bytes where M is short (enc6, and enc5 at batch
// <= 4: reading 67-134 MB of weights) and at the stem (enc0: writing y, 67
// MB at batch 8, against 3.2 GFLOP).
//
// The wrapper plans each call (ops/conv_k4s2p1.py::conv_plan) and passes
// the path, tile, stages, split, grid and shared memory; the C entry
// refuses a plan whose splits do not cover K once or whose shared memory
// passes a block's 232,448 bytes. Three paths:
// - bf16 with CI % 64 == 0 and CO % 8 == 0 (enc2..enc6; enc1 of the 64px
//   model): conv_wgmma_kernel. A block computes a 128 x 128 output tile
//   with two warpgroups, wgmma m64n128k16 from shared memory; 128 x 256
//   (m64n256k16) where those tiles fill a wave without a split (enc2 and
//   enc3 at batch 8, enc2 at batch 4): they read a third less from L2 per
//   product, which is what holds the 128 x 128 tile (its copies alone take
//   ~80% of its time); 64 x 128 (m64n64k16, the warpgroups splitting N)
//   where M <= 64. A K step is one tap and 64 channels: A holds, for each
//   output pixel of the tile, the 128 contiguous bytes x[b, 2oy-1+kh,
//   2ox-1+kw, c0:c0+64], one K-major row in the 128-byte swizzle, copied by
//   cp.async and zero-filled where the tap falls in the padding (each
//   thread's taps inside the map are a 16-bit mask, so a step costs no
//   gather arithmetic); B holds w's 64 rows of the step by the tile's
//   columns, MN-major, in groups of 64 columns. A ring of stages in dynamic
//   shared memory keeps the copies STAGES - 2 steps ahead of the wgmmas
//   (deeper rings ran no faster). The epilogue runs on the
//   accumulators in registers: serving applies scale, offset and act;
//   training also takes the statistics (each column summed over the
//   thread's rows, over its eight lanes by fixed shuffles, then over the
//   tile's 16-row groups in order through shared memory: one partial row
//   per M tile). y goes out as bf16 through a shared-memory line in
//   16-byte row stores. Where the tiles fill less than one wave of the
//   card, K is split over blocks (enc5, enc6, and the deep layers at small
//   batch), which write f32 partials that a second pass sums in order and
//   finishes; the grid walks M fastest, so the blocks that share a slice of
//   w run side by side and fetch it from device memory once.
// - bf16 with CI <= 4 and CO % 64 == 0 (the stem, enc0):
//   conv_stem_wgmma_kernel, one warpgroup a block over 64 output channels
//   and a run of 64-pixel chunks. A is the im2col of a chunk, [pixel][tap *
//   CI + channel] in 128-byte rows (16*CI values, zero past them), built by
//   the threads from coalesced loads of each pixel's four window rows as
//   K4's stem builds it; the 16*CI x 64 weights stay resident as an
//   MN-major B; wgmma m64n64k16 over CI steps of 16; leaky in registers and
//   16-byte row stores of y, which bound the call.
// - everything else (f32, and channel counts off those tiles): f32 FMA on
//   the CUDA cores, one 64x64 output tile per block of 256 threads, each
//   thread a 4x4 micro-tile, K in steps of 16 (16 divides every 16*CI).
//
// Statistics are summed in a fixed order with no float atomics, so two
// launches give the same bits: each block (or, on a split, each 64-row
// group of the split pass) writes one f32 partial row, and a last pass sums
// the partial rows per channel in order.
#include "common.cuh"
#include "wgmma.cuh"

// The plan's paths (ops/conv_k4s2p1.py::CONV_PATH_CODES).
enum ConvPath { CONV_FMA = 0, CONV_WGMMA = 1, CONV_STEM = 2 };

namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100

// ---- f32 FMA path ---------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv_k4s2p1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ offset,
                       T* __restrict__ y, float* __restrict__ stat_part, int n, int h, int wd,
                       int ci, int co, int act) {
  __shared__ float As[BK][BM + 1];  // +1: the transposed store is conflict-free
  __shared__ float Bs[BK][BN];

  const int ho = h / 2, wo = wd / 2;
  const long long m_total = static_cast<long long>(n) * ho * wo;
  const int k_total = 16 * ci;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A loader: column a_k of the K slice, rows a_m + 16*r of the M tile.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int rb[4], roy[4], rox[4];
  bool rvalid[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + a_m + 16 * r;
    rvalid[r] = m < m_total;
    const long long mm = rvalid[r] ? m : 0;
    rox[r] = static_cast<int>(mm % wo);
    roy[r] = static_cast<int>((mm / wo) % ho);
    rb[r] = static_cast<int>(mm / (static_cast<long long>(wo) * ho));
  }
  // B loader: column b_n of the CO tile, K rows b_k + 4*r.
  const int b_n = tid % BN;
  const int b_k = tid / BN;

  // Compute mapping: rows ty + 16*i, columns tx + 16*j.
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    {
      const int k = k0 + a_k;
      const int tap = k / ci;
      const int c = k - tap * ci;
      const int kh = tap >> 2, kw = tap & 3;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = 2 * roy[r] - 1 + kh;
        const int ix = 2 * rox[r] - 1 + kw;
        float v = 0.f;
        if (rvalid[r] && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
          v = to_f32(x[((static_cast<long long>(rb[r]) * h + iy) * wd + ix) * ci + c]);
        }
        As[a_k][a_m + 16 * r] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + b_k + 4 * r;
      const int col = n0 + b_n;
      Bs[b_k + 4 * r][b_n] = col < co ? to_f32(w[static_cast<long long>(k) * co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= co) continue;
      float v = acc[i][j];
      if (scale != nullptr) v = v * scale[col] + offset[col];
      y[m * co + col] = from_f32<T>(apply_act(v, act));
    }
  }
  if (stat_part == nullptr) return;
  // Column sums of the raw accumulators over this tile's valid rows: per
  // thread over its 4 rows, then over the 16 row groups in order.
  float(*red_s)[BM + 1] = As;  // [16][64], free after the K loop
  float(*red_q)[BN] = Bs;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + ty + 16 * i < m_total) {
        s += acc[i][j];
        q = fmaf(acc[i][j], acc[i][j], q);
      }
    }
    red_s[ty][tx + 16 * j] = s;
    red_q[ty][tx + 16 * j] = q;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < co) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      s += red_s[g][tid];
      q += red_q[g][tid];
    }
    const long long row = static_cast<long long>(blockIdx.x) * 2 * co;
    stat_part[row + n0 + tid] = s;
    stat_part[row + co + n0 + tid] = q;
  }
}

// ---- wgmma path (bf16, CI % 64 == 0, CO % 8 == 0) ------------------------

namespace wg {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int THREADS = 256;  // two warpgroups
constexpr int BK = 64;        // K of a step: one tap, 64 channels

// A (BM rows of 128 bytes) and B (BK rows of BN bf16) of a step.
template <int BM, int BN>
__host__ __device__ constexpr int stage_bytes() { return BM * 128 + BK * BN * 2; }
// The epilogue's line of y (rows of BN + 8 bf16, against bank conflicts)
// and the statistics' partial sums, in the ring.
template <int BM, int BN>
__host__ __device__ constexpr int epilogue_bytes() {
  return BM * (BN + 8) * 2 + 2 * (BM / 16) * BN * 4;
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): output rows m0 .. m0+BM-1,
// columns n0 .. n0+BN-1 and K steps [s_begin, s_begin + steps_per_split) of
// 16 * CI / 64. Warpgroup g takes rows 64g .. 64g+63 of all BN columns
// (BM 128) or all 64 rows of columns (BN/2) g .. (BN/2) (g+1) - 1 (BM 64).
// With `partial` (a split), it writes its f32 sums to
// partial[blockIdx.z][m][co]; otherwise y and, with `stat_part`, one partial
// row of the statistics. Run by THREADS threads, one block an SM, with
// STAGES * stage_bytes<BM, BN>() of dynamic shared memory.
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ offset,
                      bf16* __restrict__ y, float* __restrict__ partial,
                      float* __restrict__ stat_part, int n, int h, int wd, int ci, int co,
                      int act, int steps_per_split) {
  constexpr int A_BYTES = BM * 128, STAGE = stage_bytes<BM, BN>();
  constexpr int A_COPIES = BM / 32;            // A rows a thread copies a step
  constexpr int WN = BM == 128 ? BN : BN / 2;  // a warpgroup's columns
  constexpr int NACC = WN / 2, NT = WN / 8;    // its accumulators, its 8-column groups
  constexpr int RG = BM / 16;                  // 16-row groups of the tile
  constexpr int UNITS = BN / 8;                // 16-byte units of a tile row
  constexpr int B_ROWS = THREADS / UNITS;      // B rows the block copies at once
  constexpr int LINE_PITCH = BN + 8;
  static_assert(epilogue_bytes<BM, BN>() <= STAGES * STAGE, "the epilogue reuses the ring");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int wo = wd / 2, hw = (h / 2) * wo, m_total = n * hw;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cpt = ci / BK;  // steps of a tap
  const int s_begin = blockIdx.z * steps_per_split;
  const int nsteps = min(steps_per_split, 16 * cpt - s_begin);
  const int tid = threadIdx.x, g = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  // A: this thread copies 16-byte unit au of tile rows ar + 32j, i.e. of
  // output pixel m0 + ar + 32j: x[b, 2oy-1+kh, 2ox-1+kw, c0 + 8au ..] at
  // x + a_off[j] + (kh * W + kw) * CI + c0. a_taps[j]: the taps inside the
  // map (bit 4kh + kw), none past M. Each thread's copies keep their place
  // in every stage, so their shared-memory offsets are fixed here.
  const int au = tid & 7, ar = tid >> 3;
  long long a_off[A_COPIES];
  uint32_t a_taps[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    const int m = m0 + ar + 32 * j, mm = min(m, m_total - 1);
    const int b = mm / hw, r = mm - b * hw, oy = r / wo, ox = r - oy * wo;
    uint32_t taps = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int iy = 2 * oy - 1 + (t >> 2), ix = 2 * ox - 1 + (t & 3);
      taps |= static_cast<uint32_t>((m < m_total) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd))
              << t;
    }
    a_taps[j] = taps;
    a_off[j] = ((static_cast<long long>(b) * h + 2 * oy - 1) * wd + 2 * ox - 1) * ci + 8 * au;
  }
  const uint32_t a_soff = ar * 128 + ((au ^ (ar & 7)) << 4);
  // B: unit bu of the tile's BN / 8 across its columns, K rows bk + B_ROWS j
  // of the step; MN-major, groups of 64 columns x 64 rows.
  const int bu = tid % UNITS, bk = tid / UNITS;
  const bool b_ok = n0 + 8 * bu < co;
  const bf16* b_src =
      w + (static_cast<long long>(s_begin) * BK + bk) * co + (b_ok ? n0 + 8 * bu : 0);
  const uint32_t b_soff =
      A_BYTES + (bu >> 3) * (BK * 128) + bk * 128 + (((bu & 7) ^ (bk & 7)) << 4);

  // Copy the next step (tap st_tap, channels st_c0 .., the st_q-th of the
  // block) into its ring slot, if `go`. Predicated, not branched: it runs
  // while wgmmas are in flight.
  int st_tap = s_begin / cpt, st_c0 = (s_begin - st_tap * cpt) * BK, st_q = 0;
  auto stage = [&](bool go) {
    const uint32_t slot = sbase + (st_q % STAGES) * STAGE;
    const long long xo = (static_cast<long long>(st_tap >> 2) * wd + (st_tap & 3)) * ci + st_c0;
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) {
      const bool ok = (a_taps[j] >> st_tap) & 1;
      cp_async16(slot + a_soff + j * 32 * 128, ok ? x + a_off[j] + xo : x, ok, go);
    }
    const bf16* bs = b_src + static_cast<long long>(st_q) * BK * co;
#pragma unroll
    for (int j = 0; j < BK / B_ROWS; ++j)
      cp_async16(slot + b_soff + j * B_ROWS * 128, b_ok ? bs + 1LL * B_ROWS * j * co : w, b_ok,
                 go);
    ++st_q;
    st_c0 += BK;
    const bool wrap = st_c0 == ci;
    st_c0 = wrap ? 0 : st_c0;
    st_tap += wrap;
  };

  float acc[NACC];  // set by the first step's wgmmas (scale-d 0)
#pragma unroll
  for (int q = 0; q < STAGES - 2; ++q) {
    stage(q < nsteps);
    cp_async_commit();
  }
  const uint32_t a_wg = BM == 128 ? g * 64 * 128 : 0;
  const uint32_t b_wg = A_BYTES + (BM == 128 ? 0 : g * (WN / 64) * BK * 128);
  // Step q: its copies landed (this thread's, then everyone's at the
  // barrier, which also sees every warpgroup past step q - 2's wgmmas); its
  // wgmmas issued; step q + STAGES - 2 copied into step q - 2's slot; then
  // wait until only step q's wgmmas are in flight.
#pragma unroll 1
  for (int q = 0; q < nsteps; ++q) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    const uint32_t slot = sbase + (q % STAGES) * STAGE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      // A: the k16 slice s of the warpgroup's 64 rows, 32 bytes along them;
      // B: w rows 16s .. 16s+15 of the step.
      const uint64_t da = k_desc(slot + a_wg + 32 * s), db = mn_desc(slot + b_wg + s * 16 * 128);
      if constexpr (WN == 256)
        wgmma_m64n256k16(acc, da, db, (q | s) != 0);
      else if constexpr (WN == 128)
        wgmma_m64n128k16(acc, da, db, (q | s) != 0);
      else
        wgmma_m64n64k16(acc, da, db, (q | s) != 0);
    }
    wgmma_commit();
    stage(q + STAGES - 2 < nsteps);
    cp_async_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < NACC; ++e) keep(acc[e]);
  cp_async_wait();
  __syncthreads();  // every warpgroup's wgmmas are done: the ring is free

  // acc[4 nt + 2 hf + e]: tile row rb + 8 hf, column cb + 8 nt + e.
  const int rb = (BM == 128 ? 64 * g : 0) + 16 * warp + (lane >> 2);
  const int cb = (BM == 128 ? 0 : WN * g) + 2 * (lane & 3);
  if (partial != nullptr) {  // a split: f32 pairs, summed by the split pass
    float* part = partial + static_cast<long long>(blockIdx.z) * m_total * co;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + rb + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + cb + 8 * nt;
        if (m < m_total && col < co)
          *reinterpret_cast<float2*>(part + static_cast<long long>(m) * co + col) =
              make_float2(acc[4 * nt + 2 * hf], acc[4 * nt + 2 * hf + 1]);
      }
    }
    return;
  }
  unsigned char* line = smem;                                          // [BM][LINE_PITCH] bf16
  float* red = reinterpret_cast<float*>(smem + BM * LINE_PITCH * 2);  // [sum, sq][RG][BN]
  if (stat_part != nullptr) {
    // Column sums of the raw accumulators over this thread's two rows, then
    // the eight lanes that share its columns; rows past M hold zeros (their
    // A rows are zero-filled).
    const int rg = rb >> 4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = acc[4 * nt + e], v1 = acc[4 * nt + 2 + e];
        float s = v0 + v1, q = fmaf(v1, v1, v0 * v0);
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (lane < 4) {
          red[rg * BN + cb + 8 * nt + e] = s;
          red[(RG + rg) * BN + cb + 8 * nt + e] = q;
        }
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = cb + 8 * nt, gc = n0 + col;
    float sc0 = 1.f, sc1 = 1.f, of0 = 0.f, of1 = 0.f;
    if (scale != nullptr && gc < co) {
      sc0 = scale[gc];
      sc1 = scale[gc + 1];
      of0 = offset[gc];
      of1 = offset[gc + 1];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(line + ((rb + 8 * hf) * LINE_PITCH + col) * 2) =
          pack_bf16x2(apply_act(acc[4 * nt + 2 * hf] * sc0 + of0, act),
                      apply_act(acc[4 * nt + 2 * hf + 1] * sc1 + of1, act));
  }
  __syncthreads();
  if (stat_part != nullptr && tid < BN && n0 + tid < co) {  // the 16-row groups in order
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      s += red[i * BN + tid];
      q += red[(RG + i) * BN + tid];
    }
    const long long row = static_cast<long long>(blockIdx.x) * 2 * co;
    stat_part[row + n0 + tid] = s;
    stat_part[row + co + n0 + tid] = q;
  }
#pragma unroll
  for (int i = 0; i < BM * UNITS / THREADS; ++i) {
    const int e = tid + i * THREADS, row = e / UNITS, u = e % UNITS;
    const int m = m0 + row, col = n0 + 8 * u;
    if (m < m_total && col < co)
      *reinterpret_cast<uint4*>(y + static_cast<long long>(m) * co + col) =
          *reinterpret_cast<const uint4*>(line + (row * LINE_PITCH + 8 * u) * 2);
  }
}

template <int BM, int BN, int STAGES>
int launch(dim3 grid, int smem, cudaStream_t s, const void* x, const void* w, const float* scale,
           const float* offset, void* y, float* partial, float* stat_part, int n, int h, int wd,
           int ci, int co, int act, int steps_per_split) {
  if (smem < STAGES * stage_bytes<BM, BN>()) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      conv_wgmma_kernel<BM, BN, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_wgmma_kernel<BM, BN, STAGES><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, offset,
      static_cast<bf16*>(y), partial, stat_part, n, h, wd, ci, co, act, steps_per_split);
  return launch_status();
}

// Sum of the split-K partials, then the epilogue.
__global__ void splitk_epilogue_kernel(const float* __restrict__ partial, int splits,
                                       long long mco, int co, const float* __restrict__ scale,
                                       const float* __restrict__ offset, bf16* __restrict__ y,
                                       int act) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < mco;
       i += stride) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * mco + i];
    const int col = static_cast<int>(i % co);
    if (scale != nullptr) v = v * scale[col] + offset[col];
    y[i] = __float2bfloat16(apply_act(v, act));
  }
}

// Sum of the split-K partials, the epilogue, and the statistics of the
// summed f32 accumulator: block (64-row group, 64-column tile), 4 row lanes
// of 64 column lanes, folded in order into one partial row per row group.
constexpr int SR_ROWS = 64;
constexpr int SR_COLS = 64;
constexpr int SR_LANES = 4;

__global__ void __launch_bounds__(SR_COLS * SR_LANES)
    splitk_stats_epilogue_kernel(const float* __restrict__ partial, int splits,
                                 long long m_total, int co, const float* __restrict__ scale,
                                 const float* __restrict__ offset, bf16* __restrict__ y, int act,
                                 float* __restrict__ stat_part) {
  __shared__ float red[2][SR_LANES][SR_COLS];
  const int lc = threadIdx.x % SR_COLS, lr = threadIdx.x / SR_COLS;
  const int col = blockIdx.y * SR_COLS + lc;
  const long long m0 = static_cast<long long>(blockIdx.x) * SR_ROWS;
  const long long mco = m_total * co;
  float s = 0.f, q = 0.f;
  if (col < co) {
    for (int rr = lr; rr < SR_ROWS; rr += SR_LANES) {
      const long long m = m0 + rr;
      if (m >= m_total) break;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp) v += partial[sp * mco + m * co + col];
      s += v;
      q = fmaf(v, v, q);
      if (scale != nullptr) v = v * scale[col] + offset[col];
      y[m * co + col] = __float2bfloat16(apply_act(v, act));
    }
  }
  red[0][lr][lc] = s;
  red[1][lr][lc] = q;
  __syncthreads();
  if (lr == 0 && col < co) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int i = 0; i < SR_LANES; ++i) {
      ts += red[0][i][lc];
      tq += red[1][i][lc];
    }
    const long long row = static_cast<long long>(blockIdx.x) * 2 * co;
    stat_part[row + col] = ts;
    stat_part[row + co + col] = tq;
  }
}

}  // namespace wg

// ---- the stem (bf16, CI <= 4, CO % 64 == 0): wgmma over an im2col tile ----

namespace stem {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int THREADS = 128;        // one warpgroup
constexpr int CHUNK = 64;           // output pixels a step
constexpr int BO = 64;              // output channels of a block
constexpr int TILE = CHUNK * 128;   // A (a chunk's im2col) or B (w)
constexpr int LINE_PITCH = BO + 8;  // bf16 values of an epilogue row
constexpr int SMEM = 3 * TILE + CHUNK * LINE_PITCH * 2 + 2 * 4 * BO * 4 + 2 * BO * 4;

// Block (blockIdx.x, blockIdx.y): output channels o0 .. o0+63 and chunks
// [c0, c0 + chunks_per_block) of 64 pixels. A is the im2col of a chunk,
// [pixel][tap * CI + channel] in 128-byte rows (16*CI values; the rest stay
// zero), K-major, built by the threads from coalesced loads of each pixel's
// four window rows (4*CI contiguous values each) as K4's stem builds it,
// two stages: the next chunk's loads are in flight while this chunk's
// wgmmas run. B is w's 16*CI rows by the block's 64 columns, MN-major,
// resident. With `stat_part`, one partial row of the statistics per block.
template <int CI>
__global__ void __launch_bounds__(THREADS)
    conv_stem_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const float* __restrict__ scale, const float* __restrict__ offset,
                           bf16* __restrict__ y, float* __restrict__ stat_part, int n, int h,
                           int wd, int co, int act, int chunks_per_block) {
  constexpr int V = 4 * CI;  // values of one window row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_tile = sbase + 2 * TILE;
  unsigned char* line = smem + 3 * TILE;                                 // [CHUNK][LINE_PITCH]
  float* red = reinterpret_cast<float*>(line + CHUNK * LINE_PITCH * 2);  // [sum, sq][4 warps][BO]
  float* aff = red + 2 * 4 * BO;                                         // scale, offset
  const int ho = h / 2, wo = wd / 2, hw = ho * wo, m_total = n * hw;
  const int o0 = blockIdx.x * BO, c0 = blockIdx.y * chunks_per_block;
  const int nch = min(chunks_per_block, (m_total + CHUNK - 1) / CHUNK - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 3 * TILE / 16; e += THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  if (tid < BO) {
    aff[tid] = scale != nullptr ? scale[o0 + tid] : 1.f;
    aff[BO + tid] = scale != nullptr ? offset[o0 + tid] : 0.f;
  }
  __syncthreads();  // the zeros
  for (int e = tid; e < 16 * CI * 8; e += THREADS) {  // B: row k = tap * CI + c, 8 units
    const int k = e >> 3, u = e & 7;
    cp_async16(b_tile + k * 128 + ((u ^ (k & 7)) << 4),
               w + static_cast<long long>(k) * co + o0 + 8 * u, true);
  }
  cp_async_commit();

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
    const uint32_t a = sbase + (t & 1) * TILE + p * 128;
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

  // acc[4 nt + 2 hf + e]: chunk row 16 warp + lane/4 + 8 hf, column 8 nt +
  // 2 (lane % 4) + e; col_s, col_q: this thread's column sums over its rows.
  float acc[32], col_s[16], col_q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) col_s[i] = col_q[i] = 0.f;
  const int rb = 16 * warp + (lane >> 2), cb = 2 * (lane & 3);
  load_x(0);
  store_x(0);
#pragma unroll 1
  for (int t = 0; t < nch; ++t) {
    load_x(t + 1);
    cp_async_wait();  // B; with the fence, A's stores of chunk t too
    __syncthreads();  // and every thread's stores of chunk t - 1 have read the line
    const uint32_t a = sbase + (t & 1) * TILE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < CI; ++s)  // K = 16 * CI in steps of 16
      wgmma_m64n64k16(acc, k_desc(a + 32 * s), mn_desc(b_tile + s * 16 * 128), s != 0);
    wgmma_commit();
    store_x(t + 1);  // chunk t - 1's slot: its wgmmas are done
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) keep(acc[e]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = cb + 8 * nt;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v0 = acc[4 * nt + 2 * hf], v1 = acc[4 * nt + 2 * hf + 1];
        col_s[2 * nt] += v0;
        col_q[2 * nt] = fmaf(v0, v0, col_q[2 * nt]);
        col_s[2 * nt + 1] += v1;
        col_q[2 * nt + 1] = fmaf(v1, v1, col_q[2 * nt + 1]);
        *reinterpret_cast<uint32_t*>(line + ((rb + 8 * hf) * LINE_PITCH + col) * 2) =
            pack_bf16x2(apply_act(v0 * aff[col] + aff[BO + col], act),
                        apply_act(v1 * aff[col + 1] + aff[BO + col + 1], act));
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CHUNK * BO / 8 / THREADS; ++i) {
      const int e = tid + i * THREADS, row = e >> 3, u = e & 7;
      const int m = (c0 + t) * CHUNK + row;
      if (m < m_total)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(m) * co + o0 + 8 * u) =
            *reinterpret_cast<const uint4*>(line + (row * LINE_PITCH + 8 * u) * 2);
    }
  }
  if (stat_part == nullptr) return;
  // The eight lanes that share a column (fixed shuffles), then the four
  // warps in order; rows past M hold zeros (their A rows are zero).
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      col_s[i] += __shfl_xor_sync(0xffffffffu, col_s[i], off);
      col_q[i] += __shfl_xor_sync(0xffffffffu, col_q[i], off);
    }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = cb + 8 * (i >> 1) + (i & 1);
      red[warp * BO + col] = col_s[i];
      red[(4 + warp) * BO + col] = col_q[i];
    }
  }
  __syncthreads();
  if (tid < BO) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += red[i * BO + tid];
      q += red[(4 + i) * BO + tid];
    }
    const long long row = static_cast<long long>(blockIdx.y) * 2 * co;
    stat_part[row + o0 + tid] = s;
    stat_part[row + co + o0 + tid] = q;
  }
}

template <int CI>
int launch(dim3 grid, int smem, cudaStream_t s, const void* x, const void* w, const float* scale,
           const float* offset, void* y, float* stat_part, int n, int h, int wd, int co, int act,
           int chunks_per_block) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_stem_wgmma_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_stem_wgmma_kernel<CI><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, offset,
      static_cast<bf16*>(y), stat_part, n, h, wd, co, act, chunks_per_block);
  return launch_status();
}

}  // namespace stem

// Per-channel sums of the partial rows, in order, divided by the count.
__global__ void conv_stats_finalize_kernel(const float* __restrict__ stat_part, int parts,
                                           int co, long long count, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= co) return;
  float s = 0.f, q = 0.f;
  for (int p = 0; p < parts; ++p) {
    s += stat_part[static_cast<long long>(p) * 2 * co + col];
    q += stat_part[static_cast<long long>(p) * 2 * co + co + col];
  }
  out[col] = s / static_cast<float>(count);
  out[co + col] = q / static_cast<float>(count);
}

}  // namespace

// The wrapper's plan (ops/conv_k4s2p1.py::conv_plan): path (ConvPath); bm,
// bn, stages: the wgmma tile's rows and columns and its ring; splits, steps_per_split: the
// wgmma path's parts of K (steps of one tap and 64 channels) or the stem's
// blocks along M (chunks of 64 pixels); grid_x, grid_y: the grid (the split
// is its z); smem: dynamic shared memory; stat_rows: partial rows of the
// statistics. workspace: the split's f32 partials (splits x M x CO, where
// splits > 1 on the wgmma path), then 2 * CO floats per partial row of the
// statistics where `stats` is given. stats: null, or 2 * CO floats that
// receive the per-channel means of the raw accumulator and of its square.
extern "C" int discogan_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                    const void* offset, void* y, void* workspace, void* stats,
                                    int n, int h, int wd, int ci, int co, int act, int dtype,
                                    int path, int bm, int bn, int stages, int splits,
                                    int steps_per_split,
                                    int grid_x, int grid_y, int smem, int stat_rows,
                                    void* stream) {
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (m_total == 0 || co == 0) return 0;
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  const bool split = path == CONV_WGMMA && splits > 1;
  float* ws = static_cast<float*>(workspace);
  const long long split_ws = split ? splits * m_total * co : 0;
  if ((split || stats != nullptr) && ws == nullptr) return BAD;
  if (m_total >= (1LL << 31) || smem < 0 || smem > MAX_SMEM || grid_x < 1 || grid_y < 1)
    return BAD;
  float* stat_part = stats != nullptr ? ws + split_ws : nullptr;
  const long long tiles_m = (m_total + bm - 1) / (bm > 0 ? bm : 1);
  int err;
  if (path == CONV_WGMMA) {
    if (dtype != DT_BF16 || ci < wg::BK || ci % wg::BK || co % 8 ||
        !covers_once(16 * ci / wg::BK, splits, steps_per_split) || grid_x != tiles_m ||
        grid_y != (co + bn - 1) / (bn > 0 ? bn : 1) ||
        stat_rows != (split ? (m_total + wg::SR_ROWS - 1) / wg::SR_ROWS : tiles_m))
      return BAD;
    const dim3 grid(grid_x, grid_y, splits);
    float* partial = split ? ws : nullptr;
    float* tile_stats = split ? nullptr : stat_part;
    auto run = [&](auto launch) {
      return launch(grid, smem, s, x, w, sc, of, y, partial, tile_stats, n, h, wd, ci, co, act,
                    steps_per_split);
    };
    if (bm == 128 && bn == 256 && stages == 4) {
      err = run(wg::launch<128, 256, 4>);
    } else if (bm == 128 && bn == 128 && stages == 5) {
      err = run(wg::launch<128, 128, 5>);
    } else if (bm == 64 && bn == 128 && stages == 6) {
      err = run(wg::launch<64, 128, 6>);
    } else {
      return BAD;
    }
    if (err != 0) return err;
    if (split && stats != nullptr) {
      const dim3 rgrid(static_cast<unsigned>(stat_rows),
                       static_cast<unsigned>((co + wg::SR_COLS - 1) / wg::SR_COLS));
      wg::splitk_stats_epilogue_kernel<<<rgrid, wg::SR_COLS * wg::SR_LANES, 0, s>>>(
          partial, splits, m_total, co, sc, of, static_cast<wg::bf16*>(y), act, stat_part);
    } else if (split) {
      const long long mco = m_total * co;
      const long long want = (mco + 255) / 256;
      const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
      wg::splitk_epilogue_kernel<<<blocks, 256, 0, s>>>(partial, splits, mco, co, sc, of,
                                                        static_cast<wg::bf16*>(y), act);
    }
    err = launch_status();
  } else if (path == CONV_STEM) {
    const long long chunks = (m_total + stem::CHUNK - 1) / stem::CHUNK;
    if (dtype != DT_BF16 || ci < 1 || ci > 4 || co % stem::BO || grid_x != co / stem::BO ||
        splits != grid_y || !covers_once(chunks, grid_y, steps_per_split) ||
        stat_rows != grid_y || smem < stem::SMEM)
      return BAD;
    const dim3 grid(grid_x, grid_y);
    auto run = [&](auto launch) {
      return launch(grid, smem, s, x, w, sc, of, y, stat_part, n, h, wd, co, act, steps_per_split);
    };
    switch (ci) {
      case 1: err = run(stem::launch<1>); break;
      case 2: err = run(stem::launch<2>); break;
      case 3: err = run(stem::launch<3>); break;
      default: err = run(stem::launch<4>);
    }
  } else if (path == CONV_FMA) {
    if (bm != BM || splits != 1 || grid_x != tiles_m || grid_y != (co + BN - 1) / BN ||
        stat_rows != tiles_m)
      return BAD;
    const dim3 grid(grid_x, grid_y);
    if (dtype == DT_F32) {
      conv_k4s2p1_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), sc, of,
          static_cast<float*>(y), stat_part, n, h, wd, ci, co, act);
    } else {
      conv_k4s2p1_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc, of,
          static_cast<__nv_bfloat16*>(y), stat_part, n, h, wd, ci, co, act);
    }
    err = launch_status();
  } else {
    return BAD;
  }
  if (err != 0 || stats == nullptr) return err;
  conv_stats_finalize_kernel<<<(co + 255) / 256, 256, 0, s>>>(
      stat_part, stat_rows, co, m_total, static_cast<float*>(stats));
  return launch_status();
}
