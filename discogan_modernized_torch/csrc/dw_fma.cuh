// The CUDA-core micro-tile of a weight-gradient GEMM, dw (K x O) = A^T B
// over a contraction along pixels, in exact f32 FMA (no tensor cores, no
// TF32). K4's conv_dw_fma_kernel (conv_k4s2p1_dw.cu) is built on it; the
// copies that stage a step are the caller's, so another weight gradient
// (K5b's, over row bands: halo_conv_k4s2p1_dw.cu) stages its own pixels and
// reuses the rest.
//
// A step of BK pixels sits in shared memory as f32 pixel rows: A [pixel][BM
// dw rows] and B [pixel][BN o columns], both contiguous along dw's own
// dimensions (x's channels of a tap, dy's channels), so no transpose. A's
// pixel rows lie BM floats apart (K4), or at another stride (K5b: 2*CI
// floats into one contiguous input segment, where they may overlap). A
// block of 256 threads holds a BM x BN tile of dw: 8 warps of (BM/4) x
// (BN/2), each lane a TM x TN register micro-tile (8 x 8 on 128 x 128
// tiles, 4 x 4 on 64 x 64). Lane 8 ty + tx of warp (wm, wn) holds dw rows
// wm + 4 ty + 16 i + e (i < TM/4, e < 4) and columns wn + 4 tx + 32 j + f (j
// < TN/4, f < 4): per pixel it reads TM/4 float4 of A and TN/4 float4 of B,
// each float4 half the warp's rows or columns from its other, and does TM x
// TN FMAs (16 per read at 8 x 8). A warp's A read touches 4 consecutive
// 16-byte words (its four ty) and its B read 8 (its eight tx): distinct
// bank groups, no conflict. 8 consecutive columns a lane would put the
// eight tx lanes' float4 32 bytes apart: two words to a bank group.
#pragma once

#include "common.cuh"

namespace dw_fma {

constexpr int THREADS = 256;

// A lane's rows and columns (TM x TN) of a BM x BN tile.
template <int BM>
__host__ __device__ constexpr int lane_rows() { return BM / 16; }
template <int BN>
__host__ __device__ constexpr int lane_cols() { return BN / 16; }

// This thread's cp.async copies but its last N commit groups have landed.
// (No proxy fence: the CUDA cores read them, not wgmma.)
template <int N>
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first dw row and column of this lane's micro-tile in its block's tile.
struct Lane {
  int row, col;
};

template <int BM, int BN>
__device__ __forceinline__ Lane lane_origin(int tid) {
  constexpr int WARPS_N = 2;
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tiles of 64 or 128");
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / WARPS_N) * (BM / 4), wn = (warp % WARPS_N) * (BN / 2);
  return {wm + 4 * (lane >> 3), wn + 4 * (lane & 7)};
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The products of one staged step: acc += A[p]^T B[p] over its BK pixels.
// `as`, `bs`: the step's A and B, already offset to this lane's first row
// and column (as + lane.row, bs + lane.col); `a_stride`: floats from one of
// A's pixel rows to the next (a multiple of 4).
template <int BM, int BN, int BK>
__device__ __forceinline__ void step_products(float (&acc)[lane_rows<BM>()][lane_cols<BN>()],
                                              const float* as, const float* bs,
                                              int a_stride = BM) {
  constexpr int TM = lane_rows<BM>(), TN = lane_cols<BN>();
#pragma unroll
  for (int p = 0; p < BK; ++p) {
    float4 a[TM / 4], b[TN / 4];
#pragma unroll
    for (int i = 0; i < TM / 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + p * a_stride + 16 * i);
#pragma unroll
    for (int j = 0; j < TN / 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(bs + p * BN + 32 * j);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float ai = lane_of(a[i / 4], i % 4);
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, lane_of(b[j / 4], j % 4), acc[i][j]);
    }
  }
}

// Writes the micro-tile once: to `part` (f32 split partials) or, unsplit,
// to `out` in T, both (rows x cols) row-major; (r0, c0): the lane's first
// row and column in them. Rows and columns past the matrix are dropped.
// float4 stores where each row's four columns are 16-byte aligned (cols %
// 4 == 0 and f32), else one value at a time.
template <typename T, int BM, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[lane_rows<BM>()][lane_cols<BN>()],
                                           float* part, T* out, int rows, int cols, int r0,
                                           int c0) {
  constexpr int TM = lane_rows<BM>(), TN = lane_cols<BN>();
  const bool vec = cols % 4 == 0 && (part != nullptr || sizeof(T) == 4);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + 16 * (i / 4) + i % 4;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int c = c0 + 32 * j;
      const long long at = static_cast<long long>(r) * cols + c;
      const float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                                   acc[i][4 * j + 3]);
      if (vec) {
        if (c >= cols) continue;
        if (part != nullptr)
          *reinterpret_cast<float4*>(part + at) = v;
        else if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float4*>(out + at) = v;
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (c + f >= cols) continue;
          if (part != nullptr)
            part[at + f] = lane_of(v, f);
          else
            out[at + f] = from_f32<T>(lane_of(v, f));
        }
      }
    }
  }
}

}  // namespace dw_fma
