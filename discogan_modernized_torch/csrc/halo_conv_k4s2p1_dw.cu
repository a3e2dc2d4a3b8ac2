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
// The function is K4's; only the shape differs (few channels, a wide map,
// so M is long and the output small). The wrapper plans each call
// (ops/halo_conv.py::halo_dw_plan, from K4's dw_plan) and passes the path,
// the split, the grid and the shared memory here. Two paths:
// - bf16: halo_dw_wgmma_kernel, this file's entry around the wgmma body
//   K4 uses (conv_dw_wgmma.cuh): a tile is one kernel row's four taps x 64
//   input channels x 128 output channels, so enc1 is 4 tiles; M is split
//   into as many parts as fill one wave of the card's SMs (33 parts of 63
//   chunks of 64 pixels at batch 8), the four kh tiles of a part side by
//   side so they read its dy chunks from L2 together. x is staged as
//   column-parity planes (W/2 % 8 == 0) or per-tap windows.
// - f32: halo_dw_kernel, FMA on the CUDA cores: a block owns one kernel row
//   kh, a 64-channel tile of CI and of CO and a run of output rows; for
//   each row it stages the input row 2*oy + kh - 1 with its halo columns in
//   segments of 32 output pixels, with those pixels' dy, and each thread
//   takes 4 kw x 4 ci x 4 co accumulators. The runs are split while the
//   blocks fill fewer than two waves.
// Split parts write f32 partials that halo_dw_reduce_kernel sums in a fixed
// order and casts: no float atomics, two launches give the same bits.
#include "conv_dw_wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;  // ci and co tile
constexpr int PX = 32;  // output pixels per staged segment
constexpr int SEG_COLS = 2 * PX + 2;

struct Geo {
  int n, h, wd, ci, co, ho, wo;
  long long rows_per_split;
};

// ---- f32 FMA path -----------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    halo_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ dw, float* __restrict__ partial, Geo g, int splits,
                   PairStrides ps) {
  __shared__ float xs[SEG_COLS][CT];
  __shared__ float ds[PX][CT];
  const int kh = blockIdx.x & 3;
  const int co_t = blockIdx.x >> 2;
  const int ci0 = blockIdx.y * CT, co0 = co_t * CT;
  const int split = blockIdx.z % splits, pair = blockIdx.z / splits;  // z = pair * splits + split
  x += pair * ps.x;
  dy += pair * ps.w;
  dw += pair * ps.y;
  partial = at_pair(partial, ps.ws, pair);
  const long long row_begin = static_cast<long long>(split) * g.rows_per_split;
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
          partial[split * ko + idx] = acc[a][i][j];
        } else {
          dw[idx] = acc[a][i][j];
        }
      }
    }
}

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

// path (the wrapper's plan, ops/halo_conv.py::halo_dw_plan): PATH_FMA (f32;
// steps_per_split counts output rows, blocks = 4 * CO tiles * CI tiles *
// splits), or the wgmma kernel with parity planes (PATH_PLANES) or per-tap
// windows (PATH_WINDOWS) (bf16; steps_per_split counts 64-pixel chunks;
// blocks and smem its grid and dynamic shared memory). splits > 1:
// `workspace` holds splits x 16*CI*CO f32 partials. A plan whose parts do
// not cover M exactly once is refused. pairs, x_ps, dy_ps: the pair axis
// (common.cuh); pair p's dw starts 16*CI*CO values, its workspace part
// splits x 16*CI*CO floats after pair 0's.
extern "C" int discogan_halo_conv_k4s2p1_dw(const void* x, const void* dy, void* dw,
                                            void* workspace, int n, int h, int wd, int ci,
                                            int co, int dtype, int path, int splits,
                                            int steps_per_split, int blocks, int smem,
                                            int pairs, long long x_ps, long long dy_ps,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ko = 16LL * ci * co;
  if (ko == 0 || pairs == 0) return 0;
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || pairs > 65535 / (splits > 0 ? splits : 1) ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, dy_ps, itemsize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || h < 2 || wd < 2) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, pairs * ko * itemsize, s));
  }
  const PairStrides ps{x_ps, dy_ps, ko, 0, splits * ko, 0};
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (path == PATH_FMA) {
    const long long rows = static_cast<long long>(n) * (h / 2);
    const int co_tiles = (co + CT - 1) / CT, ci_tiles = (ci + CT - 1) / CT;
    if (dtype != DT_F32 || !covers_once(rows, splits, steps_per_split) ||
        blocks != 4 * co_tiles * ci_tiles * splits)
      return static_cast<int>(cudaErrorInvalidValue);
    const Geo g{n, h, wd, ci, co, h / 2, wd / 2, steps_per_split};
    halo_dw_kernel<<<dim3(static_cast<unsigned>(4 * co_tiles), static_cast<unsigned>(ci_tiles),
                          static_cast<unsigned>(splits * pairs)),
                     THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(dy),
                                      static_cast<float*>(dw), partial, g, splits, ps);
    err = launch_status();
  } else if (dtype == DT_BF16 && (path == PATH_PLANES || path == PATH_WINDOWS)) {
    err = path == PATH_PLANES
              ? dw_wgmma::launch<true>(halo_dw_wgmma_kernel<true>, blocks, smem, s, x, dy, dw,
                                       partial, n, h, wd, ci, co, splits, steps_per_split,
                                       pairs, ps)
              : dw_wgmma::launch<false>(halo_dw_wgmma_kernel<false>, blocks, smem, s, x, dy, dw,
                                        partial, n, h, wd, ci, co, splits, steps_per_split,
                                        pairs, ps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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

