// K2: eval-form BatchNorm + activation, y = act(x * scale[c] + offset[c]).
//
// Replaces discogan_modernized_tpu/ops/pallas_fused.py::fused_batchnorm_act
// (the pallas_call at line 122), whose (scale, offset) fold of the running
// statistics happens in the Python wrapper (ops/fused.py) in f32.
//
// Bound on the H100: bytes. It reads x once and writes y once, 2 * N*H*W*C
// elements against 3.35 TB/s; the 2 flops per element are nothing beside
// that. The simple design is one grid-stride pass over the flat NHWC
// array with channel = index mod C: neighbouring threads touch
// neighbouring elements, so every load and store is coalesced, and the
// per-channel scale/offset (<= 8 KB) stay in L1.
#include "common.cuh"

template <typename T>
__global__ void bn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ offset, T* __restrict__ y,
                              long long n, int c, int act) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int ch = static_cast<int>(i % c);
    const float v = to_f32(x[i]) * scale[ch] + offset[ch];
    y[i] = from_f32<T>(apply_act(v, act));
  }
}

extern "C" int discogan_bn_act(const void* x, const void* scale, const void* offset, void* y,
                               long long n, int c, int act, int dtype, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  // Enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest.
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (dtype == DT_F32) {
    bn_act_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x), sc, of,
                                                    static_cast<float*>(y), n, c, act);
  } else {
    bn_act_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc, of, static_cast<__nv_bfloat16*>(y), n, c, act);
  }
  return launch_status();
}
