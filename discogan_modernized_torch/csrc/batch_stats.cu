// K1: per-channel batch statistics of train-mode BatchNorm.
//
// Replaces discogan_modernized_tpu/ops/pallas_fused.py::batch_stats (the
// pallas_call at line 68): x (rows, C), the NHWC activation viewed flat, f32
// or bf16 in; mean (C) and biased var (C) out in f32, with the one-pass
// form var = max(E[x^2] - E[x]^2, 0) and f32 accumulation.
//
// Bound on the H100: bytes. It reads x once (rows * C elements) and writes
// 2 * C floats; the 3 flops per element are nothing beside that.
//
// The Pallas kernel carries the two sums across its sequential grid. On the
// card one launch does it all, in an order fixed by the shape of x alone
// (ops/fused.py::stats_plan), with no float atomics, so two launches give
// the same bits:
// - a block (row split, channel tile) reads its contiguous range of rows,
//   `lanes` threads across a row, each on one 16-byte vector (8 bf16 or 4
//   f32 channels; one channel on the general path, where C is off the
//   vector), the rest of the block on the next rows, so a warp reads whole
//   128-byte lines. Each thread keeps its channels' sums and sums of
//   squares in f32 registers and issues UNROLL loads before it adds them;
// - the block folds its row lanes in a fixed order: xor shuffles across the
//   lanes of a warp that share channels (where `lanes` divides 32), then the
//   warps' (or the row lanes') partials in shared memory, and writes its
//   split's partial sums;
// - where the rows take more than one split, every block then takes a
//   ticket from its channel tile's counter, after a __threadfence. The
//   block that takes the last one sums the tile's partials in split order
//   (its threads on interleaved splits, then their groups in order), writes
//   mean and var. The atomic only elects that block; the order of the sums
//   is fixed. A single split writes mean and var from its own sums.
//
// The counters and partials are the call's own (a workspace the wrapper
// allocates per call; the entry zeroes the counters with cudaMemsetAsync on
// the call's stream), so a launch captured in a CUDA graph keeps pointing at
// memory of its own, and replays zero the counters again.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_LANES = 32;
constexpr int MAX_TILES = 1024;  // counters a launch (ctiles a pair)
constexpr int UNROLL = 4;        // loads in flight a thread
constexpr int SPLIT_UNROLL = 8;  // partials a thread loads at once when it sums them

// V values of x from p on, as f32: a 16-byte vector, or one value.
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
}

// FV partials from p on, through L2 (other blocks wrote them).
template <int FV>
__device__ __forceinline__ void load_part(const float* p, float (&v)[FV]) {
  if constexpr (FV == 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// mean and biased var of channel ch from its sum and sum of squares.
__device__ __forceinline__ void write_stats(float ts, float tq, long long rows, int ch,
                                            float* __restrict__ mean, float* __restrict__ var) {
  const float m = ts / static_cast<float>(rows);
  mean[ch] = m;
  var[ch] = fmaxf(tq / static_cast<float>(rows) - m * m, 0.f);
}

// The last block of a tile: the sum of the tile's partials over the splits
// in a fixed order, then mean and var. The tile's w channels are `cols`
// columns of FV floats; the threads cover them `groups` times over, group g
// summing splits g, g + groups, ... in order, then the groups in order.
template <int FV, int SQ>
__device__ __forceinline__ void sum_splits(const float* __restrict__ part, int splits,
                                           long long rows, int c, int c0, int w,
                                           float* __restrict__ mean, float* __restrict__ var,
                                           float* sh) {
  const int cols = w / FV;
  const int groups = blockDim.x / cols;
  const int col = threadIdx.x % cols, g = threadIdx.x / cols;
  float as[FV], aq[FV];
#pragma unroll
  for (int k = 0; k < FV; ++k) as[k] = aq[k] = 0.f;
  if (g < groups) {
    const float* ps = part + c0 + col * FV;
    const float* pq = ps + static_cast<long long>(splits) * c;
    // SPLIT_UNROLL loads in flight a thread; the ones past the last split
    // add zeros, which leaves the sums' bits as they were.
    for (int sp = g; sp < splits; sp += SPLIT_UNROLL * groups) {
      float a[SPLIT_UNROLL][FV], b[SPLIT_UNROLL][FV];
#pragma unroll
      for (int u = 0; u < SPLIT_UNROLL; ++u) {
        const int i = sp + u * groups;
        if (i < splits) {
          load_part<FV>(ps + static_cast<long long>(i) * c, a[u]);
          load_part<FV>(pq + static_cast<long long>(i) * c, b[u]);
        } else {
#pragma unroll
          for (int k = 0; k < FV; ++k) a[u][k] = b[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < SPLIT_UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < FV; ++k) {
          as[k] += a[u][k];
          aq[k] += b[u][k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < FV; ++k) {
      sh[g * w + col * FV + k] = as[k];
      sh[SQ + g * w + col * FV + k] = aq[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    float ts = 0.f, tq = 0.f;
    for (int gg = 0; gg < groups; ++gg) {
      ts += sh[gg * w + j];
      tq += sh[SQ + gg * w + j];
    }
    write_stats(ts, tq, rows, c0 + j, mean, var);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    batch_stats_kernel(const T* __restrict__ x, long long rows, int c, int lanes,
                       long long rows_per_split, float* __restrict__ part,
                       unsigned* __restrict__ tickets, float* __restrict__ mean,
                       float* __restrict__ var, PairStrides ps) {
  constexpr int FV = V == 1 ? 1 : 4;  // floats of a partial load (C % 4 == 0 where V > 1)
  constexpr int SQ = MAX_THREADS * V; // the squares' half of sh
  __shared__ __align__(16) float sh[2 * SQ];
  __shared__ bool last;
  const int splits = gridDim.x;
  const int row_lanes = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, row_lane = threadIdx.x / lanes;
  const int width = lanes * V;        // channels of a tile
  const int c0 = blockIdx.y * width;  // the tile's first channel
  const int w = min(width, c - c0);   // its channels in x
  const int ch = c0 + lane * V;
  const int pair = blockIdx.z;  // each pair its partials, tickets and statistics
  x += pair * ps.x;
  part += pair * ps.ws;
  tickets += pair * gridDim.y;
  mean += pair * ps.st;
  var += pair * ps.st;

  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r1 = min(rows, r0 + rows_per_split);
  if (row_lane < row_lanes && ch < c) {
    const long long step = static_cast<long long>(row_lanes) * c;
    long long r = r0 + row_lane;
    const T* p = x + r * c + ch;
    for (; r + (UNROLL - 1) * row_lanes < r1; r += UNROLL * row_lanes, p += UNROLL * step) {
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_x<T, V>(p + u * step, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += v[u][k];
          q[k] = fmaf(v[u][k], v[u][k], q[k]);
        }
      }
    }
    for (; r < r1; r += row_lanes, p += step) {
      float v[V];
      load_x<T, V>(p, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }

  // Fold the row lanes: a warp's first (lanes of them), where lanes
  // divides 32, then the rows of partials in shared memory in order.
  const bool shuffle = lanes < 32 && 32 % lanes == 0;
  int prow = row_lane;
  bool writes = row_lane < row_lanes;
  if (shuffle) {
    for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
        q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
      }
    }
    prow = threadIdx.x / 32;
    writes = threadIdx.x % 32 < static_cast<unsigned>(lanes);
  }
  const int prows = shuffle ? blockDim.x / 32 : row_lanes;
  if (writes) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sh[prow * width + lane * V + k] = s[k];
      sh[SQ + prow * width + lane * V + k] = q[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < prows; ++r) {
      ts += sh[r * width + j];
      tq += sh[SQ + r * width + j];
    }
    if (splits == 1) {  // the block's sums are the tile's
      write_stats(ts, tq, rows, c0 + j, mean, var);
    } else {
      part[static_cast<long long>(blockIdx.x) * c + c0 + j] = ts;
      part[static_cast<long long>(splits + blockIdx.x) * c + c0 + j] = tq;
    }
  }
  if (splits == 1) return;

  // The tile's last block to finish sums its partials. The barrier orders
  // the block's partial stores before thread 0's fence and ticket; its
  // second fence orders the other blocks' partials before the loads.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + blockIdx.y, 1u) == static_cast<unsigned>(splits - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  sum_splits<FV, SQ>(part, splits, rows, c, c0, w, mean, var, sh);
}

template <typename T, int V>
int launch(const void* x, long long rows, int c, int lanes, int ctiles, int splits,
           long long rows_per_split, int threads, float* part, unsigned* tickets, float* mean,
           float* var, int pairs, const PairStrides& ps, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(ctiles),
                  static_cast<unsigned>(pairs));
  batch_stats_kernel<T, V><<<grid, threads, 0, s>>>(static_cast<const T*>(x), rows, c, lanes,
                                                    rows_per_split, part, tickets, mean, var, ps);
  return launch_status();
}

}  // namespace

// The plan (width, threads, lanes, row_lanes, ctiles, splits,
// rows_per_split, unroll, shuffle) is ops/fused.py::stats_plan's; one the
// kernel cannot run, or whose splits do not cover the rows exactly once, is
// refused. `part` holds 2 * splits * C floats (16-byte aligned) a pair;
// `tickets` ctiles counters a pair, zeroed here before the launch.
// pairs, x_ps: the pair axis (common.cuh); pair p's x starts x_ps values
// after pair 0's, its mean and var C floats after pair 0's.
extern "C" int discogan_batch_stats(const void* x, void* part, void* tickets, void* mean,
                                    void* var, long long rows, int c, int dtype, int width,
                                    int threads, int lanes, int row_lanes, int ctiles,
                                    int splits, long long rows_per_split, int unroll,
                                    int shuffle, int pairs, long long x_ps, void* stream) {
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || c <= 0 || pairs == 0) return 0;
  const int v = dtype == DT_F32 ? Vec16<float>::N : Vec16<__nv_bfloat16>::N;
  if ((width != v && width != 1) || c % width != 0) return BAD;
  if (threads % 32 != 0 || threads < 2 * MAX_LANES || threads > MAX_THREADS) return BAD;
  if (lanes < 1 || lanes > MAX_LANES || row_lanes != threads / lanes) return BAD;
  const int groups = c / width;
  if (lanes > groups || ctiles != (groups + lanes - 1) / lanes) return BAD;
  if (pairs < 1 || static_cast<long long>(pairs) * ctiles > MAX_TILES || x_ps < rows * c ||
      !pair_aligned(pairs, x_ps, dtype == DT_F32 ? 4 : 2))
    return BAD;
  if (splits < 1 || rows_per_split < 1 || static_cast<long long>(splits) * rows_per_split < rows ||
      static_cast<long long>(splits - 1) * rows_per_split >= rows) {
    return BAD;
  }
  if (unroll != UNROLL || shuffle != (lanes < 32 && 32 % lanes == 0)) return BAD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  unsigned* t = static_cast<unsigned*>(tickets);
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(t, 0, sizeof(unsigned) * pairs * ctiles, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  float* m = static_cast<float*>(mean);
  float* vr = static_cast<float*>(var);
  const PairStrides ps{x_ps, 0, 0, 0, 2LL * splits * c, c};
  if (dtype == DT_F32) {
    return width == 1 ? launch<float, 1>(x, rows, c, lanes, ctiles, splits, rows_per_split,
                                         threads, p, t, m, vr, pairs, ps, s)
                      : launch<float, 4>(x, rows, c, lanes, ctiles, splits, rows_per_split,
                                         threads, p, t, m, vr, pairs, ps, s);
  }
  return width == 1 ? launch<__nv_bfloat16, 1>(x, rows, c, lanes, ctiles, splits,
                                               rows_per_split, threads, p, t, m, vr, pairs, ps, s)
                    : launch<__nv_bfloat16, 8>(x, rows, c, lanes, ctiles, splits,
                                               rows_per_split, threads, p, t, m, vr, pairs, ps, s);
}
