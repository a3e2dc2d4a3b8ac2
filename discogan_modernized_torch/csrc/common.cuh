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

// relu / LeakyReLU(0.2) (the reference's slope, model.py:9), f32.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// Error of the launch just made: a refused launch (too many threads, too
// much shared memory) never runs and a later synchronize does not say so.
static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
