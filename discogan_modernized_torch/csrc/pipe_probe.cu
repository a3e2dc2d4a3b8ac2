// P: the read probe, the max of each block of a tensor of full-row blocks.
//
// Replaces benchmarks/pipe_probe.py::make_reader (the pallas_call at line
// 38), which asked whether the TPU's block pipeline reads rows of 64 bf16
// channels (128 bytes) at the full memory rate. x, viewed as the case's
// logical shape (N, H, W', C') or (N, H, W*C), is cut into blocks of th full
// rows (1, th, W', C'), in grid order; out gets each block's max in f32
// (the TPU kernel keeps only the last one: ops/pipe_probe.py).
//
// Bound on the H100: bytes. It reads x once and writes 4 bytes a block; one
// max an element is nothing beside that.
//
// A TPU block of full rows is contiguous, so the blocks lie one after the
// other. The TPU's grid runs in order on one core; here each TPU block is
// cut into `splits` runs of whole row groups, one CUDA block each, enough
// blocks to fill the 132 SMs (ops/pipe_probe.py::probe_plan):
// - a CUDA block reads its rows in the case's row width: `lanes` threads
//   across a row (gcd(16-byte vectors of a row, threads): 8 for 128-byte
//   rows, 16 for 256-byte rows, all the threads for a flat band), one
//   16-byte vector each, the block's other threads on the next rows, so a
//   warp reads neighbouring addresses; a thread issues UNROLL loads before
//   it folds them;
// - the block folds its threads' maxima by xor shuffles, then its warps'
//   in shared memory, and writes one partial a split (or the block's max
//   where there is one split);
// - a second kernel folds each TPU block's partials. Max does not depend on
//   the order, so the result is exact, and NaN propagates as in torch.amax.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int UNROLL = 4;  // loads in flight a thread

// max that keeps a NaN from either side, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void pipe_probe_kernel(const T* __restrict__ x, float* __restrict__ out,
                                  long long block_vecs, int row_vecs, int lanes,
                                  long long rows_per_block, long long rows_per_split,
                                  int splits) {
  constexpr int V = Vec16<T>::N;
  const long long tpu_block = blockIdx.x / splits;
  const long long split = blockIdx.x % splits;
  const uint4* base = reinterpret_cast<const uint4*>(x) + tpu_block * block_vecs;
  const int rows_at_once = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int row_lane = threadIdx.x / lanes;
  const int per_row = row_vecs / lanes;
  const long long r1 = min(rows_per_block, (split + 1) * rows_per_split);
  long long row = split * rows_per_split + row_lane;
  const uint4* p = base + row * row_vecs + lane;
  const long long group_vecs = static_cast<long long>(rows_at_once) * row_vecs;
  int j = 0;
  float m = __int_as_float(0xff800000);  // -inf
  while (row < r1) {
    uint4 buf[UNROLL];
    int n = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (row < r1) {
        buf[u] = __ldg(p + static_cast<long long>(j) * lanes);
        n = u + 1;
        if (++j == per_row) {
          j = 0;
          row += rows_at_once;
          p += group_vecs;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < n) {
        float v[V];
        Vec16<T>::unpack(buf[u], v);
#pragma unroll
        for (int k = 0; k < V; ++k) m = nan_max(m, v[k]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[MAX_THREADS / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) m = nan_max(m, warp_max[w]);
    out[blockIdx.x] = m;
  }
}

// out[b] = the max of partials[b * splits .. (b + 1) * splits)
__global__ void pipe_probe_fold_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, long long nblocks, int splits) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  float m = partials[b * splits];
  for (int s = 1; s < splits; ++s) m = nan_max(m, partials[b * splits + s]);
  out[b] = m;
}

template <typename T>
int launch(const void* x, void* partials, void* out, long long nblocks, long long block_vecs,
           int row_vecs, int lanes, long long rows_per_block, long long rows_per_split,
           int splits, int threads, cudaStream_t s) {
  float* first = static_cast<float*>(splits == 1 ? out : partials);
  pipe_probe_kernel<T><<<static_cast<unsigned>(nblocks * splits), threads, 0, s>>>(
      static_cast<const T*>(x), first, block_vecs, row_vecs, lanes, rows_per_block,
      rows_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  constexpr int FOLD_THREADS = 256;
  pipe_probe_fold_kernel<<<static_cast<unsigned>((nblocks + FOLD_THREADS - 1) / FOLD_THREADS),
                           FOLD_THREADS, 0, s>>>(static_cast<const float*>(partials),
                                                 static_cast<float*>(out), nblocks, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: nblocks blocks of rows_per_block rows of row_vecs 16-byte vectors,
// contiguous; partials: nblocks * splits floats where splits > 1 (else
// unused); out: nblocks floats. The plan (ops/pipe_probe.py::probe_plan) is
// checked: lanes divides both the row and the threads, the splits' runs of
// rows_per_split rows (a multiple of the rows a block reads at once) cover
// the block's rows exactly.
extern "C" int discogan_pipe_probe(const void* x, void* partials, void* out, long long nblocks,
                                   long long rows_per_block, int row_vecs, int dtype, int lanes,
                                   int threads, long long rows_per_split, int splits,
                                   void* stream) {
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0 || rows_per_block <= 0 || row_vecs <= 0 || lanes <= 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || row_vecs % lanes != 0 ||
      threads % lanes != 0 || splits < 1 || rows_per_split <= 0 ||
      rows_per_split % (threads / lanes) != 0 ||
      (static_cast<long long>(splits) - 1) * rows_per_split >= rows_per_block ||
      static_cast<long long>(splits) * rows_per_split < rows_per_block ||
      nblocks * splits > 0x7fffffffLL || (splits > 1 && partials == nullptr) ||
      (dtype != DT_F32 && dtype != DT_BF16)) {
    return BAD;
  }
  const long long block_vecs = rows_per_block * row_vecs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == DT_F32
             ? launch<float>(x, partials, out, nblocks, block_vecs, row_vecs, lanes,
                             rows_per_block, rows_per_split, splits, threads, s)
             : launch<__nv_bfloat16>(x, partials, out, nblocks, block_vecs, row_vecs, lanes,
                                     rows_per_block, rows_per_split, splits, threads, s);
}
