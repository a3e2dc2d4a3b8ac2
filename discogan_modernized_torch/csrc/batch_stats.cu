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
// The Pallas kernel carries the two sums across its sequential grid. On
// the card blocks run in no order, so the reduction is two passes with no
// float atomics, which keeps the bits the same from launch to launch:
// - pass 1: block (row split r, 32-channel tile) sums its contiguous range
//   of rows, 8 row lanes of 32 channel lanes (neighbouring threads read
//   neighbouring channels, so each warp reads one contiguous run), then
//   folds the 8 lanes in a fixed order and writes f32 partial sums;
// - pass 2: one thread per channel sums the partials in order and writes
//   mean and var.
// The number of row splits depends only on the shape (enough blocks to
// fill the card a few times over), so the summation order does too.
#include "common.cuh"

namespace {

constexpr int CH = 32;        // channels per block
constexpr int ROW_LANES = 8;  // row lanes per block
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr long long MIN_ROWS_PER_SPLIT = 64;

template <typename T>
__global__ void __launch_bounds__(CH * ROW_LANES)
    batch_stats_partial_kernel(const T* __restrict__ x, long long rows, int c,
                               long long rows_per_split, float* __restrict__ part_sum,
                               float* __restrict__ part_sq) {
  __shared__ float s_sum[ROW_LANES][CH];
  __shared__ float s_sq[ROW_LANES][CH];
  const int lane_c = threadIdx.x % CH;
  const int lane_r = threadIdx.x / CH;
  const int ch = blockIdx.y * CH + lane_c;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_split;
  const long long r1 = min(rows, r0 + rows_per_split);
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (long long r = r0 + lane_r; r < r1; r += ROW_LANES) {
      const float v = to_f32(x[r * c + ch]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  s_sum[lane_r][lane_c] = s;
  s_sq[lane_r][lane_c] = q;
  __syncthreads();
  if (lane_r == 0 && ch < c) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_LANES; ++i) {
      ts += s_sum[i][lane_c];
      tq += s_sq[i][lane_c];
    }
    part_sum[static_cast<long long>(blockIdx.x) * c + ch] = ts;
    part_sq[static_cast<long long>(blockIdx.x) * c + ch] = tq;
  }
}

__global__ void batch_stats_finalize_kernel(const float* __restrict__ part_sum,
                                            const float* __restrict__ part_sq, int splits, int c,
                                            long long rows, float* __restrict__ mean,
                                            float* __restrict__ var) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f, q = 0.f;
  for (int i = 0; i < splits; ++i) {
    s += part_sum[static_cast<long long>(i) * c + ch];
    q += part_sq[static_cast<long long>(i) * c + ch];
  }
  const float m = s / static_cast<float>(rows);
  mean[ch] = m;
  var[ch] = fmaxf(q / static_cast<float>(rows) - m * m, 0.f);
}

int splits_for(long long rows, int c) {
  const int ctiles = (c + CH - 1) / CH;
  long long s = (TARGET_BLOCKS + ctiles - 1) / ctiles;
  const long long cap = (rows + MIN_ROWS_PER_SPLIT - 1) / MIN_ROWS_PER_SPLIT;
  if (s > cap) s = cap;
  return static_cast<int>(s < 1 ? 1 : s);
}

}  // namespace

// Floats of workspace the call needs: two partial sums per split and channel.
extern "C" long long discogan_batch_stats_workspace(long long rows, int c) {
  if (rows <= 0 || c <= 0) return 0;
  return 2LL * splits_for(rows, c) * c;
}

extern "C" int discogan_batch_stats(const void* x, void* workspace, void* mean, void* var,
                                    long long rows, int c, int dtype, void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = splits_for(rows, c);
  const long long per = (rows + splits - 1) / splits;
  float* part_sum = static_cast<float*>(workspace);
  float* part_sq = part_sum + static_cast<long long>(splits) * c;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>((c + CH - 1) / CH));
  if (dtype == DT_F32) {
    batch_stats_partial_kernel<float><<<grid, CH * ROW_LANES, 0, s>>>(
        static_cast<const float*>(x), rows, c, per, part_sum, part_sq);
  } else {
    batch_stats_partial_kernel<__nv_bfloat16><<<grid, CH * ROW_LANES, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), rows, c, per, part_sum, part_sq);
  }
  const int err = launch_status();
  if (err != 0) return err;
  batch_stats_finalize_kernel<<<(c + 255) / 256, 256, 0, s>>>(
      part_sum, part_sq, splits, c, rows, static_cast<float*>(mean), static_cast<float*>(var));
  return launch_status();
}
