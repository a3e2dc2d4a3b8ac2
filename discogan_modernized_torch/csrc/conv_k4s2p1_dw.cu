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
// Bound on the H100: operations (2*M*K*O flops) for enc2..enc5 of the
// 512px model; bytes for the stem (enc0 at batch 8: 67 MB of dy and 12.6 MB
// of x against 3.2 GFLOP) and where M is short (enc6 at batch 8: 17 GFLOP
// against 134 MB of dw and 33 MB of x).
//
// The wrapper plans each call (ops/conv_k4s2p1.py::dw_plan) and passes the
// path, the split over M, the grid and the shared memory here. Split parts
// write f32 partials to a workspace the wrapper allocates, and a second
// pass sums them in a fixed order and casts (the Pallas function's
// per-batch-tile f32 parts summed by the caller, as one pass). No float
// atomics: two launches give the same bits. Three paths:
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
// - everything else (f32, channel counts off those tiles): f32 FMA on the
//   CUDA cores, 64x64 output tiles of 256 threads, each a 4x4 micro-tile, M
//   in steps of 16 pixels, split while the tiles fill fewer than two waves.
#include "conv_dw_wgmma.cuh"

namespace {

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

// ---- tensor-core path (bf16, CI % 8 == 0, CO % 8 == 0): wgmma -------------

// K4's entry around the body it shares with K5b (conv_dw_wgmma.cuh).
template <bool PLANES>
__global__ void __launch_bounds__(dw_wgmma::THREADS, 1)
    conv_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                         __nv_bfloat16* __restrict__ dw, float* __restrict__ partial, int n, int h,
                         int wd, int ci, int co, int splits, int steps_per_split) {
  dw_wgmma::body<PLANES>(x, dy, dw, partial, n, h, wd, ci, co, splits, steps_per_split);
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
                        int steps_per_split) {
  constexpr int V = 4 * CI;  // values of one window row
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
           int h, int wd, int co, int steps_per_split) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dw_stem_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((co + BO - 1) / BO), static_cast<unsigned>(splits));
  conv_dw_stem_kernel<CI><<<grid, THREADS, SMEM, s>>>(static_cast<const bf16*>(x),
                                                      static_cast<const bf16*>(dy), partial, n, h,
                                                      wd, co, steps_per_split);
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
                          T* __restrict__ dw) {
  constexpr int E = 256 / SLICES;
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
int reduce(const float* partial, int splits, long long ko, void* dw, cudaStream_t s) {
  if (splits >= 16) {
    conv_dw_reduce_kernel<T, 8><<<static_cast<unsigned>((ko + 31) / 32), 256, 0, s>>>(
        partial, splits, ko, static_cast<T*>(dw));
  } else {
    conv_dw_reduce_kernel<T, 1><<<static_cast<unsigned>((ko + 255) / 256), 256, 0, s>>>(
        partial, splits, ko, static_cast<T*>(dw));
  }
  return launch_status();
}
}  // namespace

// path (the wrapper's plan, ops/conv_k4s2p1.py::dw_plan): PATH_FMA, or the
// wgmma kernel with parity planes (PATH_PLANES, WO % 8 == 0) or per-tap
// windows (PATH_WINDOWS); splits > 1: `workspace` holds splits x 16*CI*CO
// f32 partials; steps_per_split counts 16-pixel steps (FMA) or 64-pixel
// chunks (wgmma); blocks, smem: the wgmma kernel's grid and dynamic shared
// memory.
extern "C" int discogan_conv_k4s2p1_dw(const void* x, const void* dy, void* dw, void* workspace,
                                       int n, int h, int wd, int ci, int co, int dtype, int path,
                                       int splits, int steps_per_split, int blocks, int smem,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ko = 16LL * ci * co;
  if (ko == 0) return 0;
  if (n == 0 || h < 2 || wd < 2) {  // no pixels: dw is zero
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, ko * (dtype == DT_F32 ? 4 : 2), s));
  }
  // The stem always writes partials (its reduce pass casts).
  float* partial = splits > 1 || path == PATH_STEM ? static_cast<float*>(workspace) : nullptr;
  if (splits < 1 || steps_per_split < 1 || ((splits > 1 || path == PATH_STEM) && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (path == PATH_FMA) {
    const dim3 grid(static_cast<unsigned>((16 * ci + BK - 1) / BK),
                    static_cast<unsigned>((co + BN - 1) / BN), static_cast<unsigned>(splits));
    if (dtype == DT_F32) {
      conv_dw_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dw),
          partial, n, h, wd, ci, co, steps_per_split);
    } else {
      conv_dw_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
          static_cast<__nv_bfloat16*>(dw), partial, n, h, wd, ci, co, steps_per_split);
    }
    err = launch_status();
  } else if (path == PATH_STEM) {
    if (dtype != DT_BF16 || ci < 1 || ci > 4 || co % 8 ||
        static_cast<long long>(n) * (h / 2) * (wd / 2) >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (ci) {
      case 1: err = stem::launch<1>(splits, s, x, dy, partial, n, h, wd, co, steps_per_split); break;
      case 2: err = stem::launch<2>(splits, s, x, dy, partial, n, h, wd, co, steps_per_split); break;
      case 3: err = stem::launch<3>(splits, s, x, dy, partial, n, h, wd, co, steps_per_split); break;
      default: err = stem::launch<4>(splits, s, x, dy, partial, n, h, wd, co, steps_per_split);
    }
  } else {
    if (dtype != DT_BF16) return static_cast<int>(cudaErrorInvalidValue);
    // One tile a block where M is split; else `blocks` persistent blocks.
    err = path == PATH_PLANES
              ? dw_wgmma::launch<true>(conv_dw_wgmma_kernel<true>, blocks, smem, s, x, dy, dw,
                                       partial, n, h, wd, ci, co, splits, steps_per_split)
              : dw_wgmma::launch<false>(conv_dw_wgmma_kernel<false>, blocks, smem, s, x, dy, dw,
                                        partial, n, h, wd, ci, co, splits, steps_per_split);
  }
  if (err != 0 || partial == nullptr) return err;
  return dtype == DT_F32 ? reduce<float>(partial, splits, ko, dw, s)
                         : reduce<__nv_bfloat16>(partial, splits, ko, dw, s);
}
