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
// 101 MB of x and dy in bf16, far above the ridge of 295 flop/byte.
//
// The Pallas grid walks (image, row tile) in order and carries one dw
// block across it. Here a block owns one kernel row kh, a 64-channel tile
// of CI and of CO, and a contiguous range of output rows (image, oy): for
// each row it stages the one input row 2*oy + kh - 1 that feeds it, with
// its halo columns (zero for the padding), in shared memory in segments
// of 32 output pixels, together with those pixels' dy, and every one of
// the four kw taps reads its strided window from the staged segment. The
// row ranges are split over blocks until the card holds two waves; each
// range writes an f32 partial of its dw tile and a second pass sums the
// partials in order and casts. No float atomics: two launches give the
// same bits.
// Two paths, chosen by dtype:
// - bf16: the tensor cores. Sixteen neighbouring output pixels of one tap
//   are sixteen staged columns two apart, so a WMMA 16x16x16 A^T fragment
//   (channels x pixels) loads col-major straight from the segment; each of
//   the 8 warps owns one kw and 2x4 fragments of the 64x64 (ci, co) tile.
// - f32: FMA on the CUDA cores, each thread 4 kw x 4 ci x 4 co
//   accumulators.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;  // ci and co tile
constexpr int PX = 32;  // output pixels per staged segment
constexpr int SEG_COLS = 2 * PX + 2;
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int MIN_ROWS_PER_SPLIT = 4;

struct Geo {
  int n, h, wd, ci, co, ho, wo;
  long long rows_per_split;
};

// ---- f32 FMA path -----------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    halo_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ dw, float* __restrict__ partial, Geo g) {
  __shared__ float xs[SEG_COLS][CT];
  __shared__ float ds[PX][CT];
  const int kh = blockIdx.x & 3;
  const int co_t = blockIdx.x >> 2;
  const int ci0 = blockIdx.y * CT, co0 = co_t * CT;
  const long long row_begin = static_cast<long long>(blockIdx.z) * g.rows_per_split;
  const long long row_end = min(static_cast<long long>(g.n) * g.ho, row_begin + g.rows_per_split);
  const int tid = threadIdx.x;
  const int tc = (tid % 16) * 4, tcc = (tid / 16) * 4;  // this thread's co and ci offsets
  float acc[4][4][4];                                   // [kw][ci][co]
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][i][j] = 0.f;

  for (long long row = row_begin; row < row_end; ++row) {
    const int oy = static_cast<int>(row % g.ho);
    const long long b = row / g.ho;
    const int iy = 2 * oy - 1 + kh;
    if (iy < 0 || iy >= g.h) continue;  // a padding row: no contribution
    const float* xrow = x + (b * g.h + iy) * g.wd * g.ci;
    const float* dyrow = dy + row * g.wo * g.co;
    for (int ox0 = 0; ox0 < g.wo; ox0 += PX) {
      __syncthreads();  // the previous segment is read
      for (int e = tid; e < SEG_COLS * CT; e += THREADS) {
        const int col = e / CT, c = e % CT;
        const int ix = 2 * ox0 - 1 + col;
        xs[col][c] = (ix >= 0 && ix < g.wd && ci0 + c < g.ci) ? xrow[ix * g.ci + ci0 + c] : 0.f;
      }
      for (int e = tid; e < PX * CT; e += THREADS) {
        const int p = e / CT, c = e % CT;
        ds[p][c] = (ox0 + p < g.wo && co0 + c < g.co) ? dyrow[(ox0 + p) * g.co + co0 + c] : 0.f;
      }
      __syncthreads();
      for (int p = 0; p < PX; ++p) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ds[p][tc + j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = xs[2 * p + a][tcc + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[a][i][j] = fmaf(av, bv[j], acc[a][i][j]);
          }
      }
    }
  }

  const long long ko = 16LL * g.ci * g.co;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ci0 + tcc + i;
      if (c >= g.ci) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = co0 + tc + j;
        if (o >= g.co) continue;
        const long long idx = (static_cast<long long>(kh * 4 + a) * g.ci + c) * g.co + o;
        if (partial != nullptr) {
          partial[blockIdx.z * ko + idx] = acc[a][i][j];
        } else {
          dw[idx] = acc[a][i][j];
        }
      }
    }
}

// ---- tensor-core path (bf16) ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
// Row pitch of the staged segments in elements: a multiple of 16, so every
// fragment pointer below is 32-byte aligned, padded against bank conflicts.
constexpr int LD = CT + 16;

__global__ void __launch_bounds__(THREADS)
    halo_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      bf16* __restrict__ dw, float* __restrict__ partial, Geo g) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 xs[SEG_COLS * LD];  // [staged column][ci]
  __shared__ __align__(128) bf16 ds[PX * LD];        // [pixel][co]
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  const int kh = blockIdx.x & 3;
  const int co_t = blockIdx.x >> 2;
  const int ci0 = blockIdx.y * CT, co0 = co_t * CT;
  const long long row_begin = static_cast<long long>(blockIdx.z) * g.rows_per_split;
  const long long row_end = min(static_cast<long long>(g.n) * g.ho, row_begin + g.rows_per_split);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw = warp / 2, ci_f0 = (warp % 2) * 2;  // the warp's tap and its 2 ci fragments

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long row = row_begin; row < row_end; ++row) {
    const int oy = static_cast<int>(row % g.ho);
    const long long b = row / g.ho;
    const int iy = 2 * oy - 1 + kh;
    if (iy < 0 || iy >= g.h) continue;
    const bf16* xrow = x + (b * g.h + iy) * g.wd * g.ci;
    const bf16* dyrow = dy + row * g.wo * g.co;
    for (int ox0 = 0; ox0 < g.wo; ox0 += PX) {
      __syncthreads();
      // 8 channels (16 bytes) per load; CI and CO are multiples of 8.
      for (int e = tid; e < SEG_COLS * (CT / 8); e += THREADS) {
        const int col = e / (CT / 8), c = (e % (CT / 8)) * 8;
        const int ix = 2 * ox0 - 1 + col;
        *reinterpret_cast<uint4*>(&xs[col * LD + c]) =
            (ix >= 0 && ix < g.wd && ci0 + c < g.ci)
                ? *reinterpret_cast<const uint4*>(xrow + static_cast<long long>(ix) * g.ci + ci0 + c)
                : zero;
      }
      {
        const int p = tid / (CT / 8), c = (tid % (CT / 8)) * 8;  // 256 threads = 32 x 8
        *reinterpret_cast<uint4*>(&ds[p * LD + c]) =
            (ox0 + p < g.wo && co0 + c < g.co)
                ? *reinterpret_cast<const uint4*>(dyrow + static_cast<long long>(ox0 + p) * g.co +
                                                  co0 + c)
                : zero;
      }
      __syncthreads();
#pragma unroll
      for (int pg = 0; pg < PX / 16; ++pg) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
        // A^T (ci x pixel): pixel m of the group reads staged column
        // 2*(16*pg + m) + kw, i.e. a col-major tile with leading dimension 2*LD.
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + (32 * pg + kw) * LD + (ci_f0 + i) * 16, 2 * LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], ds + 16 * pg * LD + j * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }

  const long long ko = 16LL * g.ci * g.co;
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int ch = ci0 + (ci_f0 + i) * 16 + r;
      if (ch < g.ci) {
        const long long base = (static_cast<long long>(kh * 4 + kw) * g.ci + ch) * g.co;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int o = co0 + j * 16 + c + q;
          if (o >= g.co) break;
          const float v = cs[r * 16 + c + q];
          if (partial != nullptr) {
            partial[blockIdx.z * ko + base + o] = v;
          } else {
            dw[base + o] = __float2bfloat16(v);
          }
        }
      }
      __syncwarp();
    }
}

}  // namespace tc

template <typename T>
__global__ void halo_dw_reduce_kernel(const float* __restrict__ partial, int splits,
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
  dim3 grid;
  int splits;
  long long rows_per_split;
};

// Row ranges: halved while the (kh, co tile, ci tile) blocks fill fewer
// than two waves and each range keeps at least 4 rows.
Plan plan(int n, int h, int ci, int co) {
  const int co_tiles = (co + CT - 1) / CT, ci_tiles = (ci + CT - 1) / CT;
  const long long rows = static_cast<long long>(n) * (h / 2);
  const long long blocks = 4LL * co_tiles * ci_tiles;
  long long s = 1;
  while (blocks * s < TARGET_BLOCKS && rows / (2 * s) >= MIN_ROWS_PER_SPLIT) s *= 2;
  Plan p;
  p.rows_per_split = (rows + s - 1) / s;
  p.splits = static_cast<int>((rows + p.rows_per_split - 1) / p.rows_per_split);
  p.grid = dim3(static_cast<unsigned>(4 * co_tiles), static_cast<unsigned>(ci_tiles),
                static_cast<unsigned>(p.splits));
  return p;
}

}  // namespace

extern "C" long long discogan_halo_conv_k4s2p1_dw_workspace(int n, int h, int wd, int ci,
                                                            int co) {
  if (n == 0 || h < 2 || wd < 2 || ci == 0 || co == 0) return 0;
  const Plan p = plan(n, h, ci, co);
  return p.splits > 1 ? static_cast<long long>(p.splits) * 16 * ci * co : 0;
}

extern "C" int discogan_halo_conv_k4s2p1_dw(const void* x, const void* dy, void* dw,
                                            void* workspace, int n, int h, int wd, int ci,
                                            int co, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ko = 16LL * ci * co;
  if (ko == 0) return 0;
  if (n == 0 || h < 2 || wd < 2) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, ko * (dtype == DT_F32 ? 4 : 2), s));
  }
  const Plan p = plan(n, h, ci, co);
  float* partial = p.splits > 1 ? static_cast<float*>(workspace) : nullptr;
  if (p.splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{n, h, wd, ci, co, h / 2, wd / 2, p.rows_per_split};
  if (dtype == DT_F32) {
    halo_dw_kernel<<<p.grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(dy),
                                               static_cast<float*>(dw), partial, g);
  } else {
    tc::halo_dw_tc_kernel<<<p.grid, THREADS, 0, s>>>(
        static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(dy),
        static_cast<tc::bf16*>(dw), partial, g);
  }
  int err = launch_status();
  if (err != 0 || p.splits == 1) return err;
  const long long want = (ko + 255) / 256;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  if (dtype == DT_F32) {
    halo_dw_reduce_kernel<float><<<blocks, 256, 0, s>>>(partial, p.splits, ko,
                                                   static_cast<float*>(dw));
  } else {
    halo_dw_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(partial, p.splits, ko,
                                                           static_cast<__nv_bfloat16*>(dw));
  }
  return launch_status();
}
