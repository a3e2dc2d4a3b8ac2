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
// Bound on the H100: operations for the wide layers. The conv is an
// implicit GEMM of M = N*Ho*Wo rows, K = 16*CI and CO columns, 2*M*K*CO
// flops against 989 TFLOP/s (bf16) and bytes (x, w, y once each) against
// 3.35 TB/s; enc2..enc4 at 512px sit far above the ridge, enc0 (CI = 3)
// near it, and enc5/enc6 (M = 256 / 64 rows at batch 4) are bound by
// reading their 16-32 MB weights.
//
// Two paths, chosen by dtype and shape:
// - bf16 with CI % 32 == 0 and CO % 8 == 0 (enc2..enc6): the tensor
//   cores. 128x128 output tiles of 8 warps, each warp 64x32 as 4x2 WMMA
//   16x16x16 bf16 fragments with f32 accumulators; K in steps of 32, which
//   stay inside one tap because CI % 32 == 0, so each im2col row of a step
//   is 64 contiguous bytes of x (two 16-byte loads, zero for the padding).
//   The next step's tiles are loaded into registers while the current one
//   multiplies. Where the output tiles are fewer than the card's 132 SMs
//   (the deep layers), K is split over blocks that write f32 partials to a
//   workspace the wrapper allocates, and a second pass sums them and
//   applies the epilogue.
// - everything else (f32, and enc0's 3 channels, K = 48): f32 FMA on the
//   CUDA cores, one 64x64 output tile per block of 256 threads, each
//   thread a 4x4 micro-tile, K in steps of 16 (16 divides every 16*CI).
// Both gather the im2col tile with the padding applied on the fly (no
// padded copy of x) and run the epilogue on the f32 accumulators before
// the single store.
//
// Statistics: each block folds its tile's column sums (and sums of
// squares) in a fixed order and writes them as one f32 partial row; a last
// pass sums the partial rows per channel in order. No float atomics, so
// two launches give the same bits. On the split-K path no split holds the
// whole accumulator, so the statistics come from the pass that sums the
// splits.
#include <mma.h>

#include "common.cuh"

namespace {

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

// ---- tensor-core path (bf16, CI % 32 == 0, CO % 8 == 0) ----------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
// Shared-memory row pitches in elements: multiples of 8 (WMMA's rule for
// 16-bit types), padded against bank conflicts.
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int TARGET_BLOCKS = 132;  // SMs on the H100
constexpr int MIN_K_TILES_PER_SPLIT = 8;

__global__ void __launch_bounds__(THREADS)
    conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   bf16* __restrict__ y, float* __restrict__ partial,
                   float* __restrict__ stat_part, int n, int h, int wd, int ci, int co, int act,
                   int k_tiles_per_split) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int ho = h / 2, wo = wd / 2;
  const long long m_total = static_cast<long long>(n) * ho * wo;
  const int k_tiles = 16 * ci / BK;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int kt_begin = blockIdx.z * k_tiles_per_split;
  const int kt_end = min(k_tiles, kt_begin + k_tiles_per_split);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // the warp's 64x32: rows wm*64, cols wn*32

  // A loader: tile row a_row (one output pixel), 16 channels from a_col.
  const int a_row = tid / 2;
  const int a_col = (tid % 2) * 16;
  const long long am = m0 + a_row;
  const bool a_valid = am < m_total;
  const long long amm = a_valid ? am : 0;
  const int a_ox = static_cast<int>(amm % wo);
  const int a_oy = static_cast<int>((amm / wo) % ho);
  const int a_b = static_cast<int>(amm / (static_cast<long long>(wo) * ho));
  // B loader: K row b_row, 16 output channels from b_col.
  const int b_row = tid / 8;
  const int b_col = (tid % 8) * 16;

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / ci, c0 = k0 - tap * ci;
    const int iy = 2 * a_oy - 1 + (tap >> 2), ix = 2 * a_ox - 1 + (tap & 3);
    if (a_valid && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
      const uint4* src = reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(a_b) * h + iy) * wd + ix) * ci + c0 + a_col);
      ra[0] = src[0];
      ra[1] = src[1];
    } else {
      ra[0] = ra[1] = make_uint4(0, 0, 0, 0);
    }
    const bf16* wrow = w + static_cast<long long>(k0 + b_row) * co;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = n0 + b_col + 8 * v;
      rb[v] = col < co ? *reinterpret_cast<const uint4*>(wrow + col) : make_uint4(0, 0, 0, 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (kt_begin < kt_end) load(kt_begin);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();  // the previous step's fragments are read
    *reinterpret_cast<uint4*>(&As[a_row * LDA + a_col]) = ra[0];
    *reinterpret_cast<uint4*>(&As[a_row * LDA + a_col + 8]) = ra[1];
    *reinterpret_cast<uint4*>(&Bs[b_row * LDB + b_col]) = rb[0];
    *reinterpret_cast<uint4*>(&Bs[b_row * LDB + b_col + 8]) = rb[1];
    __syncthreads();
    if (kt + 1 < kt_end) load(kt + 1);  // in flight while this step multiplies
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Epilogue through a per-warp 16x16 scratch: lane -> row lane/2, 8 columns.
  // With stats (never on the split-K path), each lane also sums its 8
  // columns over the rows it stores.
  const bool stats = stat_part != nullptr && partial == nullptr;
  float col_s[2][8], col_q[2][8];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) col_s[j][q] = col_q[j][q] = 0.f;
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 64 + i * 16 + r;
      const int col0 = n0 + wn * 32 + j * 16 + c;
      if (m < m_total) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + q;
          if (col >= co) break;
          float v = cs[r * 16 + c + q];
          if (partial != nullptr) {
            partial[(static_cast<long long>(blockIdx.z) * m_total + m) * co + col] = v;
          } else {
            col_s[j][q] += v;
            col_q[j][q] = fmaf(v, v, col_q[j][q]);
            if (scale != nullptr) v = v * scale[col] + offset[col];
            y[m * co + col] = __float2bfloat16(apply_act(v, act));
          }
        }
      }
      __syncwarp();
    }
  if (!stats) return;
  // Fold the 16 row lanes of each column (lanes of one parity), then the
  // two warps that share the block's columns, in a fixed order.
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int off = 2; off < 32; off *= 2) {
        col_s[j][q] += __shfl_xor_sync(0xffffffffu, col_s[j][q], off);
        col_q[j][q] += __shfl_xor_sync(0xffffffffu, col_q[j][q], off);
      }
  __syncthreads();  // Cs is reused below
  float* red = &Cs[0][0];  // [2 (wm)][2 (sum, sq)][BN]
  if (lane < 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int cl = wn * 32 + j * 16 + c + q;
        red[(wm * 2 + 0) * BN + cl] = col_s[j][q];
        red[(wm * 2 + 1) * BN + cl] = col_q[j][q];
      }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < co) {
    const long long row = static_cast<long long>(blockIdx.x) * 2 * co;
    stat_part[row + n0 + tid] = red[0 * BN + tid] + red[2 * BN + tid];
    stat_part[row + co + n0 + tid] = red[1 * BN + tid] + red[3 * BN + tid];
  }
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

// x and w are 16-byte aligned (the wrapper raises otherwise), so the
// 16-byte loads need no check here.
bool applies(int dtype, int ci, int co) {
  return dtype == DT_BF16 && ci % 32 == 0 && co % 8 == 0;
}

// K splits: doubled while the output tiles fill fewer than 132 blocks and
// each split keeps at least 8 K steps.
int splits(long long m_total, int ci, int co) {
  const long long blocks = ((m_total + BM - 1) / BM) * ((co + BN - 1) / BN);
  const int k_tiles = 16 * ci / BK;
  int s = 1;
  while (blocks * s < TARGET_BLOCKS && k_tiles / (2 * s) >= MIN_K_TILES_PER_SPLIT) s *= 2;
  return s;
}

}  // namespace tc

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

// The call's plan: split-K count, and the partial rows of the statistics.
struct Plan {
  bool tc;
  int splits;
  long long stat_parts;
};

Plan plan(long long m_total, int ci, int co, int dtype) {
  Plan p{tc::applies(dtype, ci, co), 1, 0};
  if (p.tc) p.splits = tc::splits(m_total, ci, co);
  const long long rows = p.tc ? (p.splits > 1 ? tc::SR_ROWS : tc::BM) : BM;
  p.stat_parts = (m_total + rows - 1) / rows;
  return p;
}

}  // namespace

// Floats of workspace the call needs (0: none): the split-K partial sums,
// then, with stats, 2 * CO floats per partial row of the statistics.
extern "C" long long discogan_conv_k4s2p1_workspace(int n, int h, int wd, int ci, int co,
                                                    int dtype, int with_stats) {
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (m_total == 0 || co == 0) return 0;
  const Plan p = plan(m_total, ci, co, dtype);
  const long long split_ws = p.splits > 1 ? p.splits * m_total * co : 0;
  return split_ws + (with_stats ? 2 * p.stat_parts * co : 0);
}

// stats: null, or 2 * CO floats that receive the per-channel means of the
// raw accumulator and of its square.
extern "C" int discogan_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                    const void* offset, void* y, void* workspace, void* stats,
                                    int n, int h, int wd, int ci, int co, int act, int dtype,
                                    void* stream) {
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (m_total == 0 || co == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  const Plan p = plan(m_total, ci, co, dtype);
  float* ws = static_cast<float*>(workspace);
  const long long split_ws = p.splits > 1 ? p.splits * m_total * co : 0;
  if ((split_ws > 0 || stats != nullptr) && ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* stat_part = stats != nullptr ? ws + split_ws : nullptr;
  if (p.tc) {
    const int k_tiles = 16 * ci / tc::BK;
    const dim3 grid(static_cast<unsigned>((m_total + tc::BM - 1) / tc::BM),
                    static_cast<unsigned>((co + tc::BN - 1) / tc::BN),
                    static_cast<unsigned>(p.splits));
    float* partial = p.splits > 1 ? ws : nullptr;
    tc::conv_tc_kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(w), sc, of,
        static_cast<tc::bf16*>(y), partial, stat_part, n, h, wd, ci, co, act,
        (k_tiles + p.splits - 1) / p.splits);
    int err = launch_status();
    if (err != 0) return err;
    if (p.splits > 1 && stats != nullptr) {
      const dim3 rgrid(static_cast<unsigned>(p.stat_parts),
                       static_cast<unsigned>((co + tc::SR_COLS - 1) / tc::SR_COLS));
      tc::splitk_stats_epilogue_kernel<<<rgrid, tc::SR_COLS * tc::SR_LANES, 0, s>>>(
          partial, p.splits, m_total, co, sc, of, static_cast<tc::bf16*>(y), act, stat_part);
    } else if (p.splits > 1) {
      const long long mco = m_total * co;
      const long long want = (mco + 255) / 256;
      const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
      tc::splitk_epilogue_kernel<<<blocks, 256, 0, s>>>(partial, p.splits, mco, co, sc, of,
                                                        static_cast<tc::bf16*>(y), act);
    }
    err = launch_status();
    if (err != 0) return err;
  } else {
    const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM),
                    static_cast<unsigned>((co + BN - 1) / BN));
    if (dtype == DT_F32) {
      conv_k4s2p1_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), sc, of,
          static_cast<float*>(y), stat_part, n, h, wd, ci, co, act);
    } else {
      conv_k4s2p1_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc, of,
          static_cast<__nv_bfloat16*>(y), stat_part, n, h, wd, ci, co, act);
    }
    const int err = launch_status();
    if (err != 0) return err;
  }
  if (stats == nullptr) return 0;
  conv_stats_finalize_kernel<<<(co + 255) / 256, 256, 0, s>>>(
      stat_part, static_cast<int>(p.stat_parts), co, m_total, static_cast<float*>(stats));
  return launch_status();
}
