// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its activations in f32 or bf16 (dtype code below),
// accumulates and applies its epilogue in f32, and casts once on store.
// The C entry points take raw pointers and PyTorch's current stream and
// return the cudaError_t of the launch (0 = success), which the Python
// wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The values of one 16-byte vector of T (4 f32 or 8 bf16) as f32, and back
// (bf16 rounded to nearest even, as from_f32).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float2 half(unsigned w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  __device__ __forceinline__ static unsigned word(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = half(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    return make_uint4(word(v[0], v[1]), word(v[2], v[3]), word(v[4], v[5]), word(v[6], v[7]));
  }
};

// relu / LeakyReLU(0.2) (the reference's slope, model.py:9), f32.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// Error of the launch just made: a refused launch (too many threads, too
// much shared memory) never runs and a later synchronize does not say so.
static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Whether `parts` parts of `per_part` units each cover `units` exactly once
// (every part holds at least one unit).
inline bool covers_once(long long units, int parts, int per_part) {
  return parts >= 1 && per_part >= 1 && static_cast<long long>(parts) * per_part >= units &&
         static_cast<long long>(parts - 1) * per_part < units;
}

// The pair axis: one launch computes P problems of one shape, the pair
// index folded into a grid axis (one the kernel leaves free, or the one
// that holds its batch or its split). Pair p's operands start p times their
// pair stride, in elements, past pair 0's; a stride of 0 shares an operand
// (the weight of a discriminator's real and fake halves). Each pair runs
// the tile plan of a single call on its own operands, so a pair launch
// writes the bits of P single launches.
struct PairStrides {
  long long x;    // the input
  long long w;    // the weight (K3, K5f, K6), or dy (K4, K5b)
  long long y;    // the output: y, or dw
  long long aff;  // scale and offset (K2, K3, K5f)
  long long ws;   // the f32 workspace: split and statistics partials
  long long st;   // the statistics (K1's mean and var, K3's two means)
};

// p advanced to pair `pair`'s operand; a null operand stays null.
template <typename T>
__device__ __forceinline__ T* at_pair(T* p, long long stride, int pair) {
  return p == nullptr ? p : p + pair * stride;
}

// Whether every pair's operand keeps the 16-byte alignment of pair 0's.
inline bool pair_aligned(int pairs, long long stride, int itemsize) {
  return pairs == 1 || (stride * itemsize) % 16 == 0;
}
