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
// Bound on the H100: operations (2*M*K*O flops) for every layer of the
// 512px model; bytes only where M is short (enc6 at batch 8: 17 GFLOP
// against 134 MB of dw and 33 MB of x in bf16).
//
// The layers span two regimes, and one tiling covers both: output tiles
// of the (K, O) matrix across blocks, and the contraction over M split
// across blocks as well while the output tiles alone fill fewer than two
// waves of the card's 132 SMs.
// - enc0/dis0 (K = 48, O = 64, M = B*65536): one output tile, so M is split
//   into up to 512 parts;
// - enc5/enc6 (K = 16384 / 32768, O = 2048, M = B*64 / B*16): thousands of
//   output tiles and no split.
// Split parts write f32 partials to a workspace the wrapper allocates, and
// a second pass sums them in order and casts (the Pallas function's
// per-batch-tile f32 parts summed by the caller, as one pass). No float
// atomics: two launches give the same bits.
// Two paths, chosen by dtype and shape:
// - bf16 with I % 16 == 0 and O % 8 == 0 (enc2..enc6): the tensor cores.
//   128 (k) x 128 (o) tiles of 8 warps, each warp 64x32 as 4x2 WMMA
//   16x16x16 bf16 fragments with f32 accumulators; M in steps of 32 pixels.
//   Shared tiles are [pixel][k] and [pixel][o]: A^T loads as a col-major
//   fragment, so a gathered row is 16 contiguous channels of one tap (two
//   16-byte loads). The next step's tiles are loaded into registers while
//   the current one multiplies.
// - everything else (f32, and enc0's 3 channels): f32 FMA on the CUDA
//   cores, 64x64 output tiles of 256 threads, each a 4x4 micro-tile, M in
//   steps of 16 pixels.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int MIN_STEPS_PER_SPLIT = 8;

// ---- f32 FMA path ---------------------------------------------------------

constexpr int BK = 64;  // k rows of the output tile
constexpr int BN = 64;  // o columns
constexpr int BM = 16;  // pixels per step
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw,
                   float* __restrict__ partial, int n, int h, int wd, int ci, int co,
                   int steps_per_split) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BM][BN];
  const int ho = h / 2, wo = wd / 2;
  const long long m_total = static_cast<long long>(n) * ho * wo;
  const int k_total = 16 * ci;
  const int k0 = blockIdx.x * BK, o0 = blockIdx.y * BN;
  const long long step_begin = static_cast<long long>(blockIdx.z) * steps_per_split;
  const long long m_begin = step_begin * BM;
  const long long m_end = min(m_total, (step_begin + steps_per_split) * BM);
  const int tid = threadIdx.x;

  // A loader: tile column a_k (fixed), pixels a_m + 4*r of each step.
  const int a_k = tid % BK, a_m = tid / BK;
  const int k = k0 + a_k;
  const bool k_valid = k < k_total;
  const int tap = k_valid ? k / ci : 0;
  const int ch = k_valid ? k - tap * ci : 0;
  const int kh = tap >> 2, kw = tap & 3;
  // B loader: column b_o, pixels b_m + 4*r.
  const int b_o = tid % BN, b_m = tid / BN;
  // Compute mapping: k rows ty + 16*i, o columns tx + 16*j.
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long ms = m_begin; ms < m_end; ms += BM) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long m = ms + a_m + 4 * r;
      float v = 0.f;
      if (k_valid && m < m_end) {
        const int ox = static_cast<int>(m % wo);
        const int oy = static_cast<int>((m / wo) % ho);
        const long long b = m / (static_cast<long long>(wo) * ho);
        const int iy = 2 * oy - 1 + kh, ix = 2 * ox - 1 + kw;
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
          v = to_f32(x[((b * h + iy) * wd + ix) * ci + ch]);
        }
      }
      As[a_m + 4 * r][a_k] = v;
      const long long mb = ms + b_m + 4 * r;
      const int col = o0 + b_o;
      Bs[b_m + 4 * r][b_o] = (mb < m_end && col < co) ? to_f32(dy[mb * co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long ko = static_cast<long long>(k_total) * co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= k_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = o0 + tx + 16 * j;
      if (col >= co) continue;
      const long long idx = static_cast<long long>(kr) * co + col;
      if (partial != nullptr) {
        partial[blockIdx.z * ko + idx] = acc[i][j];
      } else {
        dw[idx] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// ---- tensor-core path (bf16, I % 16 == 0, O % 8 == 0) ---------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BK = 128;  // k rows
constexpr int BN = 128;  // o columns
constexpr int BM = 32;   // pixels per step
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;  // multiples of 8 (WMMA), padded against bank conflicts
constexpr int LDB = BN + 8;

__global__ void __launch_bounds__(THREADS)
    conv_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      bf16* __restrict__ dw, float* __restrict__ partial, int n, int h, int wd,
                      int ci, int co, int steps_per_split) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[BM * LDA];  // [pixel][k]
  __shared__ __align__(128) bf16 Bs[BM * LDB];  // [pixel][o]
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int ho = h / 2, wo = wd / 2;
  const long long m_total = static_cast<long long>(n) * ho * wo;
  const int k0 = blockIdx.x * BK, o0 = blockIdx.y * BN;
  const long long step_begin = static_cast<long long>(blockIdx.z) * steps_per_split;
  const long long m_end = min(m_total, (step_begin + steps_per_split) * BM);
  const long long s_begin = step_begin * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // the warp's 64x32: k rows wm*64, o cols wn*32

  // A loader: pixel row ld_m of the step, 16 k from ld_c (one tap, I % 16 == 0).
  const int ld_m = tid / 8, ld_c = (tid % 8) * 16;
  const int k = k0 + ld_c;
  const int tap = k / ci, ch = k - tap * ci;
  const int kh = tap >> 2, kw = tap & 3;

  uint4 ra[2], rb[2];
  auto load = [&](long long ms) {
    const long long m = ms + ld_m;
    ra[0] = ra[1] = rb[0] = rb[1] = make_uint4(0, 0, 0, 0);
    if (m >= m_end) return;
    const int ox = static_cast<int>(m % wo);
    const int oy = static_cast<int>((m / wo) % ho);
    const long long b = m / (static_cast<long long>(wo) * ho);
    const int iy = 2 * oy - 1 + kh, ix = 2 * ox - 1 + kw;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
      const uint4* src = reinterpret_cast<const uint4*>(x + ((b * h + iy) * wd + ix) * ci + ch);
      ra[0] = src[0];
      ra[1] = src[1];
    }
    const bf16* drow = dy + m * co;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = o0 + ld_c + 8 * v;
      if (col < co) rb[v] = *reinterpret_cast<const uint4*>(drow + col);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (s_begin < m_end) load(s_begin);
  for (long long ms = s_begin; ms < m_end; ms += BM) {
    __syncthreads();  // the previous step's fragments are read
    *reinterpret_cast<uint4*>(&As[ld_m * LDA + ld_c]) = ra[0];
    *reinterpret_cast<uint4*>(&As[ld_m * LDA + ld_c + 8]) = ra[1];
    *reinterpret_cast<uint4*>(&Bs[ld_m * LDB + ld_c]) = rb[0];
    *reinterpret_cast<uint4*>(&Bs[ld_m * LDB + ld_c + 8]) = rb[1];
    __syncthreads();
    if (ms + BM < m_end) load(ms + BM);  // in flight while this step multiplies
#pragma unroll
    for (int mm = 0; mm < BM; mm += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + mm * LDA + wm * 64 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + mm * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Store through a per-warp 16x16 scratch: lane -> row lane/2, 8 columns.
  const long long ko = 16LL * ci * co;
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long kr = k0 + wm * 64 + i * 16 + r;
      const int col0 = o0 + wn * 32 + j * 16 + c;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = col0 + q;
        if (col >= co) break;
        const float v = cs[r * 16 + c + q];
        if (partial != nullptr) {
          partial[blockIdx.z * ko + kr * co + col] = v;
        } else {
          dw[kr * co + col] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
}

bool applies(int dtype, int ci, int co) { return dtype == DT_BF16 && ci % 16 == 0 && co % 8 == 0; }

}  // namespace tc

// Sum of the split parts, in order, cast once.
template <typename T>
__global__ void conv_dw_reduce_kernel(const float* __restrict__ partial, int splits,
                                      long long ko, T* __restrict__ dw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < ko;
       i += stride) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * ko + i];
    dw[i] = from_f32<T>(v);
  }
}

struct Plan {
  bool tc;
  int k_tiles, o_tiles, splits;
  long long steps_per_split;
};

// Splits over M: doubled while the output tiles fill fewer than two waves
// and each split keeps at least 8 steps.
Plan plan(int n, int h, int wd, int ci, int co, int dtype) {
  Plan p{};
  p.tc = tc::applies(dtype, ci, co);
  const int bk = p.tc ? tc::BK : BK, bn = p.tc ? tc::BN : BN, bm = p.tc ? tc::BM : BM;
  const long long m_total = static_cast<long long>(n) * (h / 2) * (wd / 2);
  p.k_tiles = (16 * ci + bk - 1) / bk;
  p.o_tiles = (co + bn - 1) / bn;
  const long long steps = (m_total + bm - 1) / bm;
  const long long blocks = static_cast<long long>(p.k_tiles) * p.o_tiles;
  long long s = 1;
  while (blocks * s < TARGET_BLOCKS && steps / (2 * s) >= MIN_STEPS_PER_SPLIT) s *= 2;
  p.steps_per_split = (steps + s - 1) / s;
  p.splits = static_cast<int>((steps + p.steps_per_split - 1) / p.steps_per_split);
  return p;
}

}  // namespace

// Floats of split workspace the call needs (0: none).
extern "C" long long discogan_conv_k4s2p1_dw_workspace(int n, int h, int wd, int ci, int co,
                                                       int dtype) {
  if (n == 0 || h < 2 || wd < 2 || co == 0) return 0;
  const Plan p = plan(n, h, wd, ci, co, dtype);
  return p.splits > 1 ? static_cast<long long>(p.splits) * 16 * ci * co : 0;
}

extern "C" int discogan_conv_k4s2p1_dw(const void* x, const void* dy, void* dw, void* workspace,
                                       int n, int h, int wd, int ci, int co, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ko = 16LL * ci * co;
  if (ko == 0) return 0;
  if (n == 0 || h < 2 || wd < 2) {  // no pixels: dw is zero
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, ko * (dtype == DT_F32 ? 4 : 2), s));
  }
  const Plan p = plan(n, h, wd, ci, co, dtype);
  float* partial = p.splits > 1 ? static_cast<float*>(workspace) : nullptr;
  if (p.splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p.k_tiles), static_cast<unsigned>(p.o_tiles),
                  static_cast<unsigned>(p.splits));
  const int sps = static_cast<int>(p.steps_per_split);
  if (p.tc) {
    tc::conv_dw_tc_kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(dy),
        static_cast<tc::bf16*>(dw), partial, n, h, wd, ci, co, sps);
  } else if (dtype == DT_F32) {
    conv_dw_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<const float*>(dy),
                                              static_cast<float*>(dw), partial, n, h, wd, ci,
                                              co, sps);
  } else {
    conv_dw_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dw), partial, n, h, wd, ci, co, sps);
  }
  int err = launch_status();
  if (err != 0 || p.splits == 1) return err;
  const long long want = (ko + 255) / 256;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  if (dtype == DT_F32) {
    conv_dw_reduce_kernel<float><<<blocks, 256, 0, s>>>(partial, p.splits, ko,
                                                   static_cast<float*>(dw));
  } else {
    conv_dw_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(partial, p.splits, ko,
                                                           static_cast<__nv_bfloat16*>(dw));
  }
  return launch_status();
}
