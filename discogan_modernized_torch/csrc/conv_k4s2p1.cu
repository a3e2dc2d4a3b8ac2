// K3: the k4/s2/p1 "halving" conv with a fused scale/offset/act epilogue.
//
// Replaces discogan_modernized_tpu/ops/pallas_conv.py::conv2d_k4s2p1 (the
// pallas_call at line 184), forward and epilogue; its with_stats output
// belongs to train-mode BatchNorm and is not ported here.
//
// Contract: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO, even H and W,
// y (N,H/2,W/2,CO) = act(conv(x, w) * scale + offset), f32 accumulation,
// one cast on store. scale/offset may be null (no affine).
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
                       T* __restrict__ y, int n, int h, int wd, int ci, int co, int act) {
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
                   bf16* __restrict__ y, float* __restrict__ partial, int n, int h, int wd,
                   int ci, int co, int act, int k_tiles_per_split) {
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
            if (scale != nullptr) v = v * scale[col] + offset[col];
            y[m * co + col] = __float2bfloat16(apply_act(v, act));
          }
        }
      }
      __syncwarp();
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

}  // namespace

// Floats of split-K workspace the call needs (0: none).
extern "C" long long discogan_conv_k4s2p1_workspace(int n, int h, int wd, int ci, int co,
                                                    int dtype) {
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (m_total == 0 || co == 0 || !tc::applies(dtype, ci, co)) return 0;
  const int s = tc::splits(m_total, ci, co);
  return s > 1 ? s * m_total * co : 0;
}

extern "C" int discogan_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                    const void* offset, void* y, void* workspace, int n, int h,
                                    int wd, int ci, int co, int act, int dtype, void* stream) {
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (m_total == 0 || co == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (tc::applies(dtype, ci, co)) {
    const int splits = tc::splits(m_total, ci, co);
    if (splits > 1 && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int k_tiles = 16 * ci / tc::BK;
    const dim3 grid(static_cast<unsigned>((m_total + tc::BM - 1) / tc::BM),
                    static_cast<unsigned>((co + tc::BN - 1) / tc::BN),
                    static_cast<unsigned>(splits));
    float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
    tc::conv_tc_kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(w), sc, of,
        static_cast<tc::bf16*>(y), partial, n, h, wd, ci, co, act,
        (k_tiles + splits - 1) / splits);
    if (splits == 1) return launch_status();
    const int err = launch_status();
    if (err != 0) return err;
    const long long mco = m_total * co;
    const long long want = (mco + 255) / 256;
    const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
    tc::splitk_epilogue_kernel<<<blocks, 256, 0, s>>>(partial, splits, mco, co, sc, of,
                                                      static_cast<tc::bf16*>(y), act);
    return launch_status();
  }
  const dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM),
                  static_cast<unsigned>((co + BN - 1) / BN));
  if (dtype == DT_F32) {
    conv_k4s2p1_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, of,
        static_cast<float*>(y), n, h, wd, ci, co, act);
  } else {
    conv_k4s2p1_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc, of,
        static_cast<__nv_bfloat16*>(y), n, h, wd, ci, co, act);
  }
  return launch_status();
}
