// K6: the generator head, ConvTranspose2d(k=4, s=2, p=1) to a thin output
// (64 -> 3 channels at every geometry), before the sigmoid.
//
// Replaces discogan_modernized_tpu/ops/pallas_head.py::head_convt_fwd (the
// pallas_call at line 198). Its kmajor/flat6 layouts only choose how the
// TPU writes the result; both are the same NHWC function, computed here
// directly.
//
// Contract: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO with I = the convT's
// input channels, y (N,2H,2W,CO). In subpixel form, with wf = w flipped in
// both spatial axes, output pixel (2i+a, 2j+b) reads the 2x2 input window
// x[i+a+u-1, j+b+v-1] (u, v in {0,1}, zero outside) through taps
// wf[a+2u, b+2v] = w[3-a-2u, 3-b-2v].
//
// Bound on the H100: bytes. At 512px (batch 4) it reads 33.6 MB of x and
// writes 12.6 MB of y (f32) for 1.6 GFLOP, about 35 flop/byte, under the
// ridge.
//
// Design: a block owns one input row i of one image, 256 columns wide, and
// each thread one input position (i, j): it computes the four output
// pixels (a, b in {0,1}) that the position's 3x3 neighbourhood feeds, for
// all CO channels, in registers. Per chunk of 16 input channels the block
// stages rows i-1..i+1 (with the zero padding) in shared memory once, with
// an odd per-column pitch so that neighbouring threads read different
// banks; the weights are staged once as f32 and read by every thread in
// the same order (broadcast). The narrow 3-channel store is left as it is.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // input columns per block
constexpr int CC = 16;        // input channels staged per chunk
constexpr int PITCH = CC + 1;  // floats per staged column, odd against bank conflicts
constexpr int COLS = THREADS + 2;

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
    head_convt_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int h,
                      int wd, int ci) {
  extern __shared__ float smem[];
  float* ws = smem;                 // [4][4][ci][CO], the HWIO weight as f32
  float* xs = smem + 16 * ci * CO;  // [3][COLS][PITCH]
  const int i = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * THREADS;
  const int j = j0 + threadIdx.x;
  for (int e = threadIdx.x; e < 16 * ci * CO; e += THREADS) ws[e] = to_f32(w[e]);

  float acc[2][2][CO];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[a][bb][o] = 0.f;

  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  for (int c0 = 0; c0 < ci; c0 += CC) {
    const int cc = min(CC, ci - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * COLS * CC; e += THREADS) {
      const int c = e % CC;
      const int col = (e / CC) % COLS;
      const int r = e / (CC * COLS);
      const int iy = i - 1 + r, ix = j0 - 1 + col;
      float v = 0.f;
      if (c < cc && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = to_f32(xb[(static_cast<long long>(iy) * wd + ix) * ci + c0 + c]);
      }
      xs[(r * COLS + col) * PITCH + c] = v;
    }
    __syncthreads();
    if (j >= wd) continue;
    for (int c = 0; c < cc; ++c) {
      float xv[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          xv[dy][dx] = xs[(dy * COLS + threadIdx.x + dx) * PITCH + c];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int kh = 3 - a - 2 * u, kw = 3 - bb - 2 * v;
              const float xval = xv[a + u][bb + v];
              const float* wt = ws + ((kh * 4 + kw) * ci + c0 + c) * CO;
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[a][bb][o] = fmaf(xval, wt[o], acc[a][bb][o]);
            }
    }
  }
  if (j >= wd) return;

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      T* yp = y + ((static_cast<long long>(b) * 2 * h + 2 * i + a) * 2 * wd + 2 * j + bb) * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) yp[o] = from_f32<T>(acc[a][bb][o]);
    }
}

template <typename T, int CO>
int launch(const void* x, const void* w, void* y, int n, int h, int wd, int ci,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((wd + THREADS - 1) / THREADS), static_cast<unsigned>(h),
                  static_cast<unsigned>(n));
  const int smem = (16 * ci * CO + 3 * COLS * PITCH) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_convt_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  head_convt_kernel<T, CO><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), h, wd, ci);
  return launch_status();
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int h, int wd, int ci, int co,
             cudaStream_t s) {
  switch (co) {
    case 1: return launch<T, 1>(x, w, y, n, h, wd, ci, s);
    case 2: return launch<T, 2>(x, w, y, n, h, wd, ci, s);
    case 3: return launch<T, 3>(x, w, y, n, h, wd, ci, s);
    case 4: return launch<T, 4>(x, w, y, n, h, wd, ci, s);
    case 5: return launch<T, 5>(x, w, y, n, h, wd, ci, s);
    case 6: return launch<T, 6>(x, w, y, n, h, wd, ci, s);
    case 7: return launch<T, 7>(x, w, y, n, h, wd, ci, s);
    case 8: return launch<T, 8>(x, w, y, n, h, wd, ci, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int discogan_head_convt(const void* x, const void* w, void* y, int n, int h, int wd,
                                   int ci, int co, int dtype, void* stream) {
  if (static_cast<long long>(n) * h * wd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch<float>(x, w, y, n, h, wd, ci, co, s);
  return dispatch<__nv_bfloat16>(x, w, y, n, h, wd, ci, co, s);
}
