// K2: eval-form BatchNorm + activation, y = act(x * scale[c] + offset[c]).
//
// Replaces discogan_modernized_tpu/ops/pallas_fused.py::fused_batchnorm_act
// (the pallas_call at line 122), whose (scale, offset) fold of the running
// statistics happens in the Python wrapper (ops/fused.py) in f32.
//
// Bound on the H100: bytes. It reads x once and writes y once, 2 * N*H*W*C
// elements against 3.35 TB/s; the 2 flops per element are nothing beside
// that. So the design keeps enough 16-byte loads in flight and spends
// nothing per element but the math. Every access is a 16-byte vector (8
// bf16 or 4 f32 values), neighbouring threads on neighbouring vectors, over
// the flat NHWC array in a grid-stride loop; ops/fused.py::bn_act_plan picks
// one of two kernels and their grid:
// - bn_act_vec_kernel, where C is a multiple of the vector and the grid's
//   stride (threads x blocks vectors) a multiple of C: a thread's channels
//   never change, so it loads its scales and offsets once and its loop has
//   no division. Each thread issues UNROLL independent loads before its
//   first store, and the plan launches at most a few blocks an SM (64 KB of
//   loads in flight an SM where the call is large, one short grid where it
//   is small).
// - bn_act_any_kernel, any other C: the same vectors with a 32-bit channel
//   index that steps once a vector, scales and offsets read per element
//   (they stay in L1), and a scalar tail for the last numel % width
//   elements.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int UNROLL = 4;  // bn_act_vec_kernel's loads in flight a thread

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    bn_act_vec_kernel(const uint4* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ offset, uint4* __restrict__ y,
                      long long vectors, int c, int act) {
  constexpr int V = Vec16<T>::N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // The plan makes stride * V a multiple of c: these are the thread's
  // channels at every step (a multiple of V, so 16-byte aligned).
  const int ch = static_cast<int>((i * V) % c);
  float s[V], o[V];
#pragma unroll
  for (int k = 0; k < V; k += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + ch + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(offset + ch + k));
    s[k] = a.x, s[k + 1] = a.y, s[k + 2] = a.z, s[k + 3] = a.w;
    o[k] = b.x, o[k + 1] = b.y, o[k + 2] = b.z, o[k + 3] = b.w;
  }
  for (; i < vectors; i += UNROLL * stride) {
    uint4 u[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      u[j] = i + j * stride < vectors ? __ldg(x + i + j * stride) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (i + j * stride < vectors) {
        float v[V];
        Vec16<T>::unpack(u[j], v);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = apply_act(v[k] * s[k] + o[k], act);
        y[i + j * stride] = Vec16<T>::pack(v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    bn_act_any_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ offset, T* __restrict__ y, long long vectors,
                      int tail, int c, int act) {
  constexpr int V = Vec16<T>::N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Channel of the vector's first value, stepped by the stride's remainder:
  // one compare and subtract a vector, the 64-bit remainders only here.
  const int step = static_cast<int>((stride * V) % c);
  int ch0 = static_cast<int>((i * V) % c);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (; i < vectors; i += stride) {
    float v[V];
    Vec16<T>::unpack(__ldg(xv + i), v);
    int ch = ch0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = apply_act(v[k] * __ldg(scale + ch) + __ldg(offset + ch), act);
      if (++ch == c) ch = 0;
    }
    yv[i] = Vec16<T>::pack(v);
    ch0 += step;
    if (ch0 >= c) ch0 -= c;
  }
  // The last numel % V values, one a thread of the first block.
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const long long e = vectors * V + threadIdx.x;
    const int ce = static_cast<int>(e % c);
    y[e] = from_f32<T>(apply_act(to_f32(x[e]) * scale[ce] + offset[ce], act));
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* offset, void* y, long long n, int c,
           int act, int fixed, int threads, int blocks, cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  const long long vectors = n / V;
  if (fixed) {
    bn_act_vec_kernel<T><<<blocks, threads, 0, s>>>(static_cast<const uint4*>(x), scale, offset,
                                                    static_cast<uint4*>(y), vectors, c, act);
  } else {
    bn_act_any_kernel<T><<<blocks, threads, 0, s>>>(static_cast<const T*>(x), scale, offset,
                                                    static_cast<T*>(y), vectors,
                                                    static_cast<int>(n % V), c, act);
  }
  return launch_status();
}

}  // namespace

// The plan (width, fixed, threads, blocks, unroll) is
// ops/fused.py::bn_act_plan's; one that the kernels cannot run is refused.
extern "C" int discogan_bn_act(const void* x, const void* scale, const void* offset, void* y,
                               long long n, int c, int act, int dtype, int width, int fixed,
                               int threads, int blocks, int unroll, void* stream) {
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int v = dtype == DT_F32 ? Vec16<float>::N : Vec16<__nv_bfloat16>::N;
  if (c <= 0 || n % c != 0 || width != v || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || blocks < 1) {
    return BAD;
  }
  if (fixed ? (c % v != 0 || unroll != UNROLL ||
               static_cast<long long>(threads) * blocks * v % c != 0)
            : unroll != 1) {
    return BAD;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  return dtype == DT_F32
             ? launch<float>(x, sc, of, y, n, c, act, fixed, threads, blocks, s)
             : launch<__nv_bfloat16>(x, sc, of, y, n, c, act, fixed, threads, blocks, s);
}
