// K5f: the k4/s2/p1 conv tiled over bands of output rows with 1-row halos,
// for the wide-map, few-channel layer (enc1: 64 -> 128 on the 256x256 map
// at the 512px geometry), with the fused scale/offset/act epilogue.
//
// Replaces discogan_modernized_tpu/ops/pallas_halo_conv.py::
// halo_conv2d_k4s2p1 (the pallas_call at line 158). Its column-pair view
// and accumulator rolls are TPU lane layout and are not carried over; the
// contract is the conv itself: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO, even
// H and W, CI and CO multiples of 8, y = act(conv(x, w) * scale + offset).
//
// Bound on the H100: operations. At enc1 (batch 4) the conv is 17.2 GFLOP
// against 33.6 MB of x, w and y, far above the ridge of 295 flop/byte.
// What the layer wastes instead, in an im2col formulation, is the 4x4
// window's re-reads of x: each input pixel feeds 4 output pixels of each
// of 4 taps.
//
// Design: a block owns one image's band of TO output rows across the
// whole width (TO * Wo <= 256 pixels) and one 64-wide tile of output
// channels. Per chunk of input channels it stages the band's 2*TO + 2
// input rows (the halo rows included, zero rows and columns for the
// padding) and the chunk's weights in shared memory, once, and every
// window is read from there. Two paths, chosen by dtype and shape:
// - bf16, CI % 16 == 0, Wo a power of two >= 16 (enc1): the tensor cores.
//   The band is staged as bf16 16-channel chunks. Sixteen neighbouring
//   output pixels of one row, for one tap, are 16 rows of the staged band
//   2*16 elements apart, so each WMMA 16x16x16 A fragment loads straight
//   from the band with no im2col copy; each warp owns 32 pixels x 64
//   channels (2x4 fragments, f32 accumulators).
// - everything else (f32, and odd shapes): f32 FMA on the CUDA cores,
//   8-channel f32 chunks, 8 pixels x 8 channels of accumulators a thread.
// The epilogue runs on the f32 accumulators before the single store. The
// staged band is above 48 KB at enc1 and is dynamic shared memory (the
// launch raises the block's limit first).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CI_CHUNK = 8;
constexpr int CO_TILE = 64;
constexpr int PIX_PER_THREAD = 8;
constexpr int CH_PER_THREAD = 8;
constexpr int PIX_GROUPS = THREADS / (CO_TILE / CH_PER_THREAD);  // 32
constexpr int MAX_PIX = PIX_GROUPS * PIX_PER_THREAD;              // 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
    halo_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ offset,
                     T* __restrict__ y, int h, int wd, int ci, int co, int to, int act) {
  extern __shared__ float smem[];
  const int ho = h / 2, wo = wd / 2;
  const int rows = 2 * to + 2;
  const int cols = wd + 2;
  float* xs = smem;                          // [rows][cols][CI_CHUNK]
  float* ws = smem + rows * cols * CI_CHUNK;  // [16][CI_CHUNK][CO_TILE]

  const int band = blockIdx.x;
  const int cot = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % (CO_TILE / CH_PER_THREAD);
  const int pg = tid / (CO_TILE / CH_PER_THREAD);
  const int oy0 = band * to;
  const int iy0 = 2 * oy0 - 1;  // input row of staged row 0

  // This thread's pixels p = pg + 32*j of the band and their window
  // origins in the staged band.
  int xoff[PIX_PER_THREAD];
  bool pvalid[PIX_PER_THREAD];
#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j) {
    const int p = pg + PIX_GROUPS * j;
    const int oyl = p / wo, ox = p % wo;
    pvalid[j] = p < to * wo && oy0 + oyl < ho;
    xoff[j] = pvalid[j] ? ((2 * oyl) * cols + 2 * ox) * CI_CHUNK : 0;
  }

  float acc[PIX_PER_THREAD][CH_PER_THREAD];
#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j)
#pragma unroll
    for (int c = 0; c < CH_PER_THREAD; ++c) acc[j][c] = 0.f;

  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  for (int c0 = 0; c0 < ci; c0 += CI_CHUNK) {
    __syncthreads();
    const int x_elems = rows * cols * CI_CHUNK;
    for (int e = tid; e < x_elems; e += THREADS) {
      const int c = e % CI_CHUNK;
      const int col = (e / CI_CHUNK) % cols;
      const int row = e / (CI_CHUNK * cols);
      const int iy = iy0 + row, ix = col - 1;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = to_f32(xb[(static_cast<long long>(iy) * wd + ix) * ci + c0 + c]);
      }
      xs[e] = v;
    }
    for (int e = tid; e < 16 * CI_CHUNK * CO_TILE; e += THREADS) {
      const int o = e % CO_TILE;
      const int c = (e / CO_TILE) % CI_CHUNK;
      const int tap = e / (CO_TILE * CI_CHUNK);
      const int col = cot * CO_TILE + o;
      ws[e] = col < co ? to_f32(w[(static_cast<long long>(tap) * ci + c0 + c) * co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int kh = 0; kh < 4; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 4; ++kw) {
        const int tap_off = (kh * cols + kw) * CI_CHUNK;
        const float* wt = ws + (kh * 4 + kw) * CI_CHUNK * CO_TILE + cg * CH_PER_THREAD;
#pragma unroll
        for (int c = 0; c < CI_CHUNK; ++c) {
          float xv[PIX_PER_THREAD], wv[CH_PER_THREAD];
#pragma unroll
          for (int j = 0; j < PIX_PER_THREAD; ++j) xv[j] = xs[xoff[j] + tap_off + c];
#pragma unroll
          for (int q = 0; q < CH_PER_THREAD; ++q) wv[q] = wt[c * CO_TILE + q];
#pragma unroll
          for (int j = 0; j < PIX_PER_THREAD; ++j)
#pragma unroll
            for (int q = 0; q < CH_PER_THREAD; ++q) acc[j][q] = fmaf(xv[j], wv[q], acc[j][q]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j) {
    if (!pvalid[j]) continue;
    const int p = pg + PIX_GROUPS * j;
    const int oy = oy0 + p / wo, ox = p % wo;
    T* yp = y + ((static_cast<long long>(b) * ho + oy) * wo + ox) * co;
#pragma unroll
    for (int q = 0; q < CH_PER_THREAD; ++q) {
      const int col = cot * CO_TILE + cg * CH_PER_THREAD + q;
      if (col >= co) continue;
      float v = acc[j][q];
      if (scale != nullptr) v = v * scale[col] + offset[col];
      yp[col] = from_f32<T>(apply_act(v, act));
    }
  }
}

// ---- tensor-core path ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CC = 16;  // input channels per staged chunk: one WMMA K step
constexpr int CO_TILE = 64;
constexpr int PIX = 256;  // output pixels per block: 8 warps x 32

__global__ void __launch_bounds__(THREADS)
    halo_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   bf16* __restrict__ y, int h, int wd, int ci, int co, int to, int act) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ho = h / 2, wo = wd / 2;
  const int rows = 2 * to + 2, cols = wd + 2;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [rows][cols][CC]
  bf16* ws = xs + rows * cols * CC;              // [16 taps][CC][CO_TILE]
  float* cs = reinterpret_cast<float*>(ws + 16 * CC * CO_TILE);  // [WARPS][16*16]

  const int band = blockIdx.x, cot = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int oy0 = band * to;
  const int iy0 = 2 * oy0 - 1;  // input row of staged row 0

  // The warp's two 16-pixel fragments, each inside one output row.
  int f_oyl[2], f_ox[2];
  bool f_valid[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int p = warp * 32 + f * 16;
    f_oyl[f] = p / wo;
    f_ox[f] = p % wo;
    f_valid[f] = f_oyl[f] < to && oy0 + f_oyl[f] < ho;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wmma::fill_fragment(acc[f][jj], 0.f);

  const bf16* xb = x + static_cast<long long>(b) * h * wd * ci;
  for (int c0 = 0; c0 < ci; c0 += CC) {
    __syncthreads();
    for (int e = tid; e < rows * cols * 2; e += THREADS) {
      const int half = e & 1, pos = e >> 1;
      const int col = pos % cols, row = pos / cols;
      const int iy = iy0 + row, ix = col - 1;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = *reinterpret_cast<const uint4*>(
            xb + (static_cast<long long>(iy) * wd + ix) * ci + c0 + 8 * half);
      }
      *reinterpret_cast<uint4*>(xs + pos * CC + 8 * half) = v;
    }
    for (int e = tid; e < 16 * CC * CO_TILE / 8; e += THREADS) {
      const int o8 = e % (CO_TILE / 8);
      const int c = (e / (CO_TILE / 8)) % CC;
      const int tap = e / (CO_TILE / 8 * CC);
      const int col = cot * CO_TILE + o8 * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (col < co) {
        v = *reinterpret_cast<const uint4*>(
            w + (static_cast<long long>(tap) * ci + c0 + c) * co + col);
      }
      *reinterpret_cast<uint4*>(ws + (tap * CC + c) * CO_TILE + o8 * 8) = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 16; ++tap) {
      const int kh = tap >> 2, kw = tap & 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wmma::load_matrix_sync(fb[jj], ws + tap * CC * CO_TILE + jj * 16, CO_TILE);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (!f_valid[f]) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(
            fa, xs + ((2 * f_oyl[f] + kh) * cols + 2 * f_ox[f] + kw) * CC, 2 * CC);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wmma::mma_sync(acc[f][jj], fa, fb[jj], acc[f][jj]);
      }
    }
  }

  // Epilogue through a per-warp 16x16 scratch: lane -> pixel lane/2, 8 channels.
  float* scratch = cs + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    if (!f_valid[f]) continue;
    const int oy = oy0 + f_oyl[f], ox = f_ox[f] + r;
    bf16* yp = y + ((static_cast<long long>(b) * ho + oy) * wo + ox) * co;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      wmma::store_matrix_sync(scratch, acc[f][jj], 16, wmma::mem_row_major);
      __syncwarp();
      const int col0 = cot * CO_TILE + jj * 16 + c8;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = col0 + q;
        if (col >= co) break;
        float v = scratch[r * 16 + c8 + q];
        if (scale != nullptr) v = v * scale[col] + offset[col];
        yp[col] = __float2bfloat16(apply_act(v, act));
      }
      __syncwarp();
    }
  }
}

// x and w are 16-byte aligned (the wrapper raises otherwise).
bool applies(int dtype, int h, int wd, int ci, int co) {
  const int wo = wd / 2;
  return dtype == DT_BF16 && ci % CC == 0 && co % 8 == 0 && wo >= 16 && wo <= PIX &&
         (wo & (wo - 1)) == 0 && h >= 2;
}

long long smem_bytes(int wd, int to) {
  return static_cast<long long>(2 * to + 2) * (wd + 2) * CC * sizeof(bf16) +
         16 * CC * CO_TILE * sizeof(bf16) + WARPS * 256 * sizeof(float);
}

}  // namespace tc

// Rows per band for a map Wo pixels wide: as many as fit 256 pixels.
int band_rows(int ho, int wo) {
  if (wo <= 0 || wo > MAX_PIX) return 0;
  int to = MAX_PIX / wo;
  return to < ho ? to : ho;
}

long long smem_bytes(int wd, int to) {
  return (static_cast<long long>(2 * to + 2) * (wd + 2) * CI_CHUNK + 16 * CI_CHUNK * CO_TILE) *
         static_cast<long long>(sizeof(float));
}

}  // namespace

extern "C" int discogan_halo_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                         const void* offset, void* y, int n, int h, int wd,
                                         int ci, int co, int act, int dtype, void* stream) {
  const int ho = h / 2, wo = wd / 2;
  const int to = band_rows(ho, wo);
  if (to <= 0 || ci % CI_CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || co == 0) return 0;
  const dim3 grid(static_cast<unsigned>((ho + to - 1) / to),
                  static_cast<unsigned>((co + CO_TILE - 1) / CO_TILE), static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  cudaError_t err;
  if (tc::applies(dtype, h, wd, ci, co)) {
    const long long smem = tc::smem_bytes(wd, to);
    err = cudaFuncSetAttribute(tc::halo_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::halo_tc_kernel<<<grid, tc::THREADS, smem, s>>>(
        static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(w), sc, of,
        static_cast<tc::bf16*>(y), h, wd, ci, co, to, act);
    return launch_status();
  }
  const long long smem = smem_bytes(wd, to);
  if (dtype == DT_F32) {
    err = cudaFuncSetAttribute(halo_conv_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    halo_conv_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, of,
        static_cast<float*>(y), h, wd, ci, co, to, act);
  } else {
    err = cudaFuncSetAttribute(halo_conv_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    halo_conv_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc, of,
        static_cast<__nv_bfloat16*>(y), h, wd, ci, co, to, act);
  }
  return launch_status();
}
