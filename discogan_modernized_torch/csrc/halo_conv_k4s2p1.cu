// K5f: the k4/s2/p1 conv of the wide-map, few-channel layer (enc1: 64 -> 128
// on the 256x256 map at the 512px geometry), with the fused scale/offset/act
// epilogue.
//
// Replaces discogan_modernized_tpu/ops/pallas_halo_conv.py::
// halo_conv2d_k4s2p1 (the pallas_call at line 158). The contract is the conv
// itself: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO, even H and W, CI and CO
// multiples of 8, y = act(conv(x, w) * scale + offset).
//
// Bound on the H100: both. At enc1, batch 4, the conv is 17.2 GFLOP against
// 50.6 MB of x, w and y (33.55 + 0.26 + 16.78 MB): ~340 flop/byte, just
// above the bf16 ridge of 295, so the operations bound (17.4 us at 989
// TFLOP/s) and the bytes bound (15.1 us at 3.35 TB/s) nearly meet. A kernel
// for this layer has to read x from device memory about once and keep the
// tensor cores fed at the same time.
//
// In f32 (exact FMA on the CUDA cores, 67 TFLOP/s) the operations bound
// alone: at enc1, batch 8, 34.4 GFLOP take 0.513 ms and the 201.9 MB of x,
// w and y 0.060 ms at 3.35 TB/s.
//
// Two paths; the wrapper plans each call (ops/halo_conv.py: tc_plan,
// halo_fma_plan) and passes the path, rows and columns of a block, ring,
// grid and shared memory, which the C entry checks against its own
// arithmetic:
// - bf16 with CI % 16 == 0 and CI <= 64 (enc1): halo_wgmma_kernel, below.
// - everything else (f32, and bf16 with CI % 16 != 0 or CI > 64):
//   halo_fma_kernel, exact f32 FMA on the CUDA cores (no tensor cores, no
//   TF32), f32 accumulation in both dtypes. A block of 256 threads owns
//   128 output pixels (one 128-pixel row at enc1's 128-wide map, or 2 rows
//   of 64, or 4 rows of 32 columns: halo_fma_plan takes the fewest waves,
//   then the most rows, which stage the fewest input rows a pixel) by 128
//   output channels (enc1's whole CO, so the band is staged once), each
//   lane an 8 x 8 register micro-tile.
//   CI goes by chunks of 4 channels through a ring of 4 stages, each
//   holding the band's input rows with their 1-row halos at the block's
//   columns (16 bytes a column) and the chunk's 16 x 4 x 128 weights, filled
//   by 16-byte cp.async (f32; zero-filled through the source size for the
//   padding) or 8-byte loads (bf16) three chunks ahead of the FMAs. Every
//   tap reads its window straight from the staged band: output pixel (r, s)
//   at tap (kh, kw) reads staged row 2r + kh, column 2s + kw. No im2col, no
//   split, no atomics. Shared memory: 4 x (4 x 258 x 4 + 16 x 4 x 128) x 4
//   = 197,120 bytes at 1 x 128 (4 x 32: 173,312), one block an SM (the
//   micro-tile's 168 registers). On an H100 at 700 W (tools/halo_ab.py) it
//   runs at 0.61-0.62 of the f32 bound at enc1, batch 4 and 8; blocks of
//   2 x 64 or 1 x 128 ran 2-5% slower and a 3-stage ring 1.5% slower.
//   Without w's shared-memory reads it ran 10% faster, without the copies
//   no faster: w's reads, not the copies, hold it back.
//
// halo_wgmma_kernel:
// - Weights resident, x streamed. A block owns one image, one strip of 64
//   output columns (130 input columns with the halo), one 64-wide tile of
//   output channels and a run of `rows` consecutive output rows, which the
//   wrapper picks so the grid is about one wave. The tile's weights (16 taps
//   x CI x 64 channels, 128 KB at CI 64) are copied into shared memory once;
//   the block then walks down its rows through a ring of 6 input rows
//   (output row oy reads input rows 2oy-1 .. 2oy+2). x comes from device
//   memory once; the other channel tile's blocks, which run in the same
//   wave, read it again from L2.
// - im2col for free: each staged input row is two column-parity planes of
//   65 pixels, 128 bytes a pixel (even and odd input columns; the GPU form of
//   the Pallas kernel's column-pair view). The 64 output pixels of a tap are
//   then 64 consecutive pixels of one plane, and a wgmma descriptor points
//   straight at them. Every 16-byte chunk of the ring and of the weights
//   sits at unit index u ^ ((u >> 3) & 7) (u counts 16-byte units of the
//   shared-memory address): the 128-byte swizzle wgmma reads, under which
//   8 consecutive pixels (or weight rows) with the same channel chunk fall
//   in 8 different bank groups. wgmma takes the swizzle from the address
//   bits, so a window that starts one pixel into an 8-pixel group needs no
//   descriptor base offset (measured: with one set, results are wrong).
// - wgmma m64n64k16 bf16 with f32 accumulators, both operands in shared
//   memory: 64 pixels x 64 channels per instruction, K in kh -> kw -> CI/16
//   steps (64 per output row at CI 64), consecutive steps into two
//   accumulators. No branch and no accumulator read sits between a row's
//   first wgmma and its wait: ptxas serializes the wgmmas otherwise.
// - Two warpgroups take alternate output rows (ping-pong): while one's
//   wgmmas run, the other applies its epilogue (scale, offset, act on the
//   f32 accumulators in registers, stored as bf16 pairs). As soon as the
//   first half of its row (kernel rows 0, 1) is done, a warpgroup copies
//   the two input rows its row after next needs, with cp.async.cg 16-byte
//   copies (zero-filled for the padding), into the slots that only that
//   half and the other warpgroup's last row read. Named barriers pass
//   "rows landed" and "row done" between the two. The prologue is split
//   too: warpgroup 0's row 0 starts once half of the weights and its first
//   two input rows have landed.
// - Shared memory at CI 64: 6 x 130 x 128 + 16 x 64 x 64 x 2 = 230,912
//   bytes of the 232,448 a block may have: one block per SM. No atomics:
//   each output element is written by one block.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---- CUDA-core path (f32; bf16 off the tensor-core tiles) ---------------

namespace fma {

constexpr int THREADS = 256;
constexpr int PIXELS = 128;   // output pixels of a block: ROWS output rows x COLS columns
constexpr int CO_TILE = 128;  // output channels of a block
constexpr int CK = 4;         // channels of a CI chunk: 16 f32 bytes a staged column
constexpr int STAGES = 4;     // the ring: copies STAGES - 1 chunks ahead
constexpr int TM = 8, TN = 8; // a lane's pixels and channels
constexpr int WARPS_N = CO_TILE / (8 * TN);  // 2: a warp holds 32 pixels x 64 channels
constexpr int W_UNITS = 16 * CK * CO_TILE / 4;  // 16-byte units of a chunk's weights
constexpr int W_COPIES = W_UNITS / THREADS;

// A stage: the band's 2 ROWS + 2 input rows by 2 COLS + 2 columns, CK
// channels each (one 16-byte unit a column), then the chunk's weights
// [tap][CK][CO_TILE]; sizes in floats.
__host__ __device__ constexpr int x_cols(int cols) { return 2 * cols + 2; }
__host__ __device__ constexpr int x_units(int cols) {
  return (2 * (PIXELS / cols) + 2) * x_cols(cols);
}
__host__ __device__ constexpr int stage_floats(int cols) {
  return 4 * x_units(cols) + 16 * CK * CO_TILE;
}
__host__ __device__ constexpr int smem_bytes(int cols) { return STAGES * stage_floats(cols) * 4; }

// This thread's cp.async copies but its last N commit groups have landed
// (no proxy fence: the CUDA cores read them).
template <int N>
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four consecutive values of T as f32 (bf16: one 8-byte load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = Vec16<__nv_bfloat16>::half(u.x), hi = Vec16<__nv_bfloat16>::half(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(Vec16<__nv_bfloat16>::word(v[0], v[1]),
                                            Vec16<__nv_bfloat16>::word(v[2], v[3]));
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): output channels co0 .. co0 +
// 127 (x), output rows oy0 .. oy0 + ROWS - 1 and columns ox0 .. ox0 + COLS
// - 1 (y = band * strips + strip) of image z % N, pair z / N. CI goes by
// chunks of CK channels through a ring of STAGES stages; a stage holds the
// band's input rows 2 oy0 - 1 .. 2 oy0 + 2 ROWS and columns 2 ox0 - 1 .. 2
// ox0 + 2 COLS at the chunk's channels ([row][column][CK], zero outside the
// map) and the chunk's weights ([tap][CK][co]); output pixel (r, s) at
// tap (kh, kw) reads staged row 2r + kh, column 2s + kw: no im2col. 8 warps
// of 32 pixels x 64 channels, each lane an 8 x 8 register micro-tile: pixels
// p = wm + ty + 4i (i < 8; r = p / COLS, s = p % COLS, so a warp's 32
// pixels lie in one output row), channels wn + 32jj + 4tx + e (jj < 2, e <
// 4), lane = 8 ty + tx. Per tap and chunk a lane reads 8 float4 of x (its
// pixels' CK channels) and 8 float4 of w (its channels at the CK channels):
// 16 FMAs a read. The four pixels a warp reads at once are 2 columns, 32
// bytes, apart: their float4s fall in distinct banks; the eight lanes of a
// pixel read 128 consecutive bytes of w. f32 (VEC): the stage is filled by
// 16-byte cp.async, zero-filled through its source size; bf16: by 8-byte
// loads converted to f32 and stored. Each thread's copies sit at the same
// places in every stage (units tid + 256 j), so a chunk moves only their
// channel offset.
template <typename T, int COLS>
__global__ void __launch_bounds__(THREADS, 1)
    halo_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ offset,
                    T* __restrict__ y, int n, int h, int wd, int ci, int co, int act,
                    PairStrides ps) {
  constexpr int ROWS = PIXELS / COLS, XC = x_cols(COLS), XU = x_units(COLS);
  constexpr int X_COPIES = (XU + THREADS - 1) / THREADS;
  constexpr int STAGE = stage_floats(COLS);
  constexpr bool VEC = sizeof(T) == 4;
  static_assert(COLS % 32 == 0 && PIXELS % COLS == 0, "a warp's 32 pixels in one row");
  static_assert(W_UNITS % THREADS == 0 && X_COPIES <= 32, "copies a thread");
  extern __shared__ __align__(16) float fsm[];
  const int ho = h / 2, wo = wd / 2;
  const int strips = (wo + COLS - 1) / COLS;
  const int co0 = blockIdx.x * CO_TILE;
  const int oy0 = (blockIdx.y / strips) * ROWS, ox0 = (blockIdx.y % strips) * COLS;
  const int b = blockIdx.z % n, pair = blockIdx.z / n;  // z = pair * N + image
  x += pair * ps.x;
  w += pair * ps.w;
  y += pair * ps.y;
  scale = at_pair(scale, ps.aff, pair);
  offset = at_pair(offset, ps.aff, pair);
  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane & 7, ty = lane >> 3;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 8 * TN;

  // x: unit e = tid + THREADS j of a stage is staged row e / XC, column e %
  // XC; x_pix its input pixel iy * W + ix, x_ok whether it lies in the map.
  int x_pix[X_COPIES];
  uint32_t x_ok = 0;
#pragma unroll
  for (int j = 0; j < X_COPIES; ++j) {
    const int e = tid + THREADS * j;
    const int iy = 2 * oy0 - 1 + e / XC, ix = 2 * ox0 - 1 + e % XC;
    const bool ok = e < XU && iy >= 0 && iy < h && ix >= 0 && ix < wd;
    x_pix[j] = ok ? iy * wd + ix : 0;
    x_ok |= static_cast<uint32_t>(ok) << j;
  }
  // w: unit tid + THREADS j is row tid / 32 + 8 j of the chunk's 16 CK rows
  // (tap r / CK = tid / 128 + 2 j, channel r % CK = (tid / 32) % 4), columns
  // co0 + 4 (tid % 32) .. + 3, zero past CO.
  const bool w_ok = co0 + 4 * (tid & 31) < co;
  const T* w_src = w + (static_cast<long long>((tid >> 5) / CK) * ci + (tid >> 5) % CK) * co +
                   (w_ok ? co0 + 4 * (tid & 31) : 0);
  const long long w_step = 2LL * ci * co;  // two taps
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(fsm));
  const int nchunks = ci / CK;

  // Stage chunk q (channels CK q ..) into its ring slot, if `go`.
  auto stage = [&](int q, bool go) {
    if (!go) return;
    const int slot = (q % STAGES) * STAGE, c0 = q * CK;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < X_COPIES; ++j) {
        const bool ok = (x_ok >> j) & 1;
        if (j + 1 < X_COPIES || tid + THREADS * j < XU)
          hopper::cp_async16(sbase + 4 * (slot + 4 * (tid + THREADS * j)),
                             ok ? xb + static_cast<long long>(x_pix[j]) * ci + c0 : x, ok);
      }
#pragma unroll
      for (int j = 0; j < W_COPIES; ++j)
        hopper::cp_async16(sbase + 4 * (slot + 4 * (XU + tid + THREADS * j)),
                           w_ok ? w_src + j * w_step + static_cast<long long>(c0) * co : w,
                           w_ok);
    } else {
      float4 xv[X_COPIES], wv[W_COPIES];
#pragma unroll
      for (int j = 0; j < X_COPIES; ++j)
        xv[j] = (x_ok >> j) & 1 ? load4(xb + static_cast<long long>(x_pix[j]) * ci + c0)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < W_COPIES; ++j)
        wv[j] = w_ok ? load4(w_src + j * w_step + static_cast<long long>(c0) * co)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < X_COPIES; ++j)
        if (j + 1 < X_COPIES || tid + THREADS * j < XU)
          *reinterpret_cast<float4*>(fsm + slot + 4 * (tid + THREADS * j)) = xv[j];
#pragma unroll
      for (int j = 0; j < W_COPIES; ++j)
        *reinterpret_cast<float4*>(fsm + slot + 4 * (XU + tid + THREADS * j)) = wv[j];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    stage(q, q < nchunks);
    hopper::cp_async_commit();
  }
  // This lane's pixel i at tap (kh, kw): staged unit (2r + kh) XC + 2s + kw
  // with r = wm / COLS, s = wm % COLS + ty + 4i.
  const int x_lane = 4 * (2 * (wm / COLS) * XC + 2 * (wm % COLS + ty));
  // Chunk q: its copies landed (this thread's, then everyone's at the
  // barrier, which also sees every warp past chunk q - 1's reads); chunk q +
  // STAGES - 1 staged into chunk q - 1's slot; then chunk q's products.
#pragma unroll 1
  for (int q = 0; q < nchunks; ++q) {
    copies_landed<STAGES - 2>();
    __syncthreads();
    stage(q + STAGES - 1, q + STAGES - 1 < nchunks);
    hopper::cp_async_commit();
    const float* xs = fsm + (q % STAGES) * STAGE + x_lane;
    const float* ws = fsm + (q % STAGES) * STAGE + 4 * XU + wn + 4 * tx;
#pragma unroll 1
    for (int kh = 0; kh < 4; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 4; ++kw) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + 4 * (kh * XC + kw) + 32 * i);
#pragma unroll
        for (int kk = 0; kk < CK; ++kk) {
          const float* wr = ws + ((kh * 4 + kw) * CK + kk) * CO_TILE;
          float bv[TN];
#pragma unroll
          for (int jj = 0; jj < TN / 4; ++jj) {
            const float4 v = *reinterpret_cast<const float4*>(wr + 32 * jj);
            bv[4 * jj] = v.x, bv[4 * jj + 1] = v.y, bv[4 * jj + 2] = v.z, bv[4 * jj + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float ai = lane_of(a[i], kk);
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  copies_landed<0>();

  // The epilogue on the accumulators: y = act(acc * scale + offset), four
  // consecutive channels a store.
  float sc[TN], of[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = co0 + wn + 4 * tx + 32 * (j / 4) + j % 4;
    const bool ok = scale != nullptr && col < co;
    sc[j] = ok ? scale[col] : 1.f;
    of[j] = ok ? offset[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = wm + ty + 4 * i;
    const int oy = oy0 + p / COLS, ox = ox0 + p % COLS;
    if (oy >= ho || ox >= wo) continue;
    T* yp = y + ((static_cast<long long>(b) * ho + oy) * wo + ox) * co;
#pragma unroll
    for (int jj = 0; jj < TN / 4; ++jj) {
      const int col = co0 + wn + 4 * tx + 32 * jj;
      if (col >= co) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = apply_act(acc[i][4 * jj + e] * sc[4 * jj + e] + of[4 * jj + e], act);
      store4(yp + col, v);
    }
  }
}

template <typename T, int COLS>
int launch(dim3 grid, cudaStream_t s, const void* x, const void* w, const float* sc,
           const float* of, void* y, int n, int h, int wd, int ci, int co, int act,
           const PairStrides& ps) {
  const int smem = smem_bytes(COLS);
  const cudaError_t err = cudaFuncSetAttribute(
      halo_fma_kernel<T, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_fma_kernel<T, COLS><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), sc, of, static_cast<T*>(y), n, h, wd,
      ci, co, act, ps);
  return launch_status();
}

template <typename T>
int launch_cols(int cols, dim3 grid, cudaStream_t s, const void* x, const void* w,
                const float* sc, const float* of, void* y, int n, int h, int wd, int ci, int co,
                int act, const PairStrides& ps) {
  switch (cols) {
    case 32: return launch<T, 32>(grid, s, x, w, sc, of, y, n, h, wd, ci, co, act, ps);
    case 64: return launch<T, 64>(grid, s, x, w, sc, of, y, n, h, wd, ci, co, act, ps);
    default: return launch<T, 128>(grid, s, x, w, sc, of, y, n, h, wd, ci, co, act, ps);
  }
}

}  // namespace fma

// ---- tensor-core path (bf16, CI % 16 == 0, CI <= 64) -------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int STRIP = 64;         // output columns per block
constexpr int CO_TILE = 64;       // output channels per block
constexpr int PLANE = STRIP + 1;  // pixels per column-parity plane of a staged row
constexpr int SLOTS = 6;          // input rows in the ring
constexpr int SLOT_BYTES = 2 * PLANE * 128;  // a staged input row, 128 bytes a pixel
constexpr int MAX_CI = 64;
constexpr int THREADS = 256;  // two warpgroups, taking alternate output rows
constexpr int CHAINS = 2;     // accumulators a row's wgmmas alternate between

// Named barriers (0 is __syncthreads): 1 + g, warpgroup g alone; the
// signals of warpgroup g, in two generations p so that a signal is never
// raised twice before it is taken: LOADED 3 + 2g + p, DONE 7 + 2g + p; and
// PROLOGUE, warpgroup 0's copies of the weights for warpgroup 1.
__device__ __forceinline__ int loaded_bar(int g, int t) { return 3 + 2 * g + ((t >> 1) & 1); }
__device__ __forceinline__ int done_bar(int g, int t) { return 7 + 2 * g + ((t >> 1) & 1); }
constexpr int PROLOGUE_BAR = 11;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// bar.arrive / bar.sync under a predicate, with no branch for ptxas to see.
__device__ __forceinline__ void bar_arrive_if(bool p, int id, int count) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p bar.arrive %1, %2;\n}\n" ::"r"(
                   static_cast<int>(p)),
               "r"(id), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_sync_if(bool p, int id, int count) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p bar.sync %1, %2;\n}\n" ::"r"(
                   static_cast<int>(p)),
               "r"(id), "r"(count)
               : "memory");
}

using namespace hopper;

// Copy input row iy (columns ix0 .. ix0 + 129) into ring slot `slot` as its
// two column-parity planes, 128 bytes a pixel (CI channels used); rows and
// columns outside the map read as zeros. NTHR threads, this one `tid`; no
// copy unless `go`. Unrolled and predicated: it runs while wgmmas are in
// flight, where a branch would serialize them.
template <int CI, int NTHR>
__device__ __forceinline__ void stage_row(uint32_t ring, int slot, const bf16* xb, int iy, int h,
                                          int wd, int ix0, int tid, bool go = true) {
  constexpr int CPP = CI / 8;  // 16-byte chunks per pixel
  constexpr int UNITS = 2 * PLANE * CPP;
  const bool row_ok = (iy >= 0) & (iy < h);
  const uint32_t slot_unit = (ring + slot * SLOT_BYTES) / 16;
#pragma unroll
  for (int i = 0; i < (UNITS + NTHR - 1) / NTHR; ++i) {
    const int e = tid + i * NTHR;
    const int c = e / CPP, chunk = e % CPP;  // c: column of the 130
    const int ix = ix0 + c;
    const bool ok = row_ok & (ix >= 0) & (ix < wd);
    const bf16* src = ok ? xb + (static_cast<long long>(iy) * wd + ix) * CI + chunk * 8 : xb;
    cp_async16(swz(slot_unit + ((c & 1) * PLANE + (c >> 1)) * 8 + chunk) * 16, src, ok,
               go & (e < UNITS));
  }
}

// The epilogue's per-channel affine for channels col0 + 8 nt + 2q, +1
// (identity without one).
__device__ __forceinline__ void load_affine(float (&sc)[8][2], float (&of)[8][2],
                                            const float* scale, const float* offset, int col0,
                                            int co, int q) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + nt * 8 + 2 * q + e;
      const bool ok = scale != nullptr && col < co;
      sc[nt][e] = ok ? scale[col] : 1.f;
      of[nt][e] = ok ? offset[col] : 0.f;
    }
}

// Store one warp's 16 pixels of an output row: acc[4 nt + e] holds, in the
// mma layout, pixel ox_first + lane/4 (e = 0, 1) and + 8 (e = 2, 3) at
// channels col0 + 8 nt + 2 (lane % 4) + (e & 1); each pair goes out as one
// 4-byte store after the epilogue.
__device__ __forceinline__ void store_tile(const float* acc, const float (&sc)[8][2],
                                           const float (&of)[8][2], bf16* yrow, int ox_first,
                                           int wo, int co, int col0, int lane, int act) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int ox = ox_first + hf * 8 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = col0 + nt * 8 + 2 * (lane & 3);
      const uint32_t v =
          pack_bf16x2(apply_act(fmaf(acc[4 * nt + 2 * hf], sc[nt][0], of[nt][0]), act),
                      apply_act(fmaf(acc[4 * nt + 2 * hf + 1], sc[nt][1], of[nt][1]), act));
      if (ox < wo && col < co)
        *reinterpret_cast<uint32_t*>(yrow + static_cast<long long>(ox) * co + col) = v;
    }
  }
}

template <int KS>  // CI = 16 * KS
__global__ void __launch_bounds__(THREADS, 1)
    halo_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ offset,
                      bf16* __restrict__ y, int n, int h, int wd, int co, int rows, int act,
                      PairStrides ps) {
  constexpr int CI = 16 * KS;
  constexpr int W_UNITS = 16 * CI * CO_TILE / 8;  // the weights; the ring follows
  // Swizzled positions come from shared-memory address bits, as wgmma takes
  // them; the alignment puts the weights' 8-row groups on 1024-byte bounds.
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = sbase + W_UNITS * 16;

  const int ho = h / 2, wo = wd / 2;
  const int strips = (wo + STRIP - 1) / STRIP;
  const int co0 = blockIdx.x * CO_TILE;
  const int ox0 = (blockIdx.y % strips) * STRIP;
  const int oy0 = (blockIdx.y / strips) * rows;
  const int nrows = min(rows, ho - oy0);
  const int b = blockIdx.z % n, pair = blockIdx.z / n;  // z = pair * N + image
  x += pair * ps.x;
  w += pair * ps.w;
  y += pair * ps.y;
  scale = at_pair(scale, ps.aff, pair);
  offset = at_pair(offset, ps.aff, pair);
  const int ix0 = 2 * ox0 - 1;  // input column of staged column 0
  const int iy0 = 2 * oy0 - 1;  // input row of ring row 0
  const bf16* xb = x + static_cast<long long>(b) * h * wd * CI;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid >> 7, other = g ^ 1, gtid = tid & 127, warp = (tid >> 5) & 3;

  // Warpgroup 0 copies the tile's weights ([tap][ci][64 channels]; channels
  // past CO read as zeros) and ring rows 0..3 in two groups, kernel rows 0,
  // 1 with ring rows 0, 1 first, so its row 0 starts on half of them;
  // warpgroup 1 copies ring rows 4, 5.
  if (g == 0) {
    for (int half = 0; half < 2; ++half) {
      for (int e = half * W_UNITS / 2 + gtid; e < (half + 1) * W_UNITS / 2; e += 128) {
        const int row = e >> 3, col = co0 + (e & 7) * 8;  // row = tap * CI + ci
        const bool ok = col < co;
        cp_async16(swz(sbase / 16 + e) * 16, ok ? w + static_cast<long long>(row) * co + col : w,
                   ok);
      }
      for (int r = 2 * half; r < 2 * half + 2; ++r)
        stage_row<CI, 128>(ring, r, xb, iy0 + r, h, wd, ix0, gtid);
      cp_async_commit();
    }
  } else {
    for (int r = 4; r < 6; ++r) stage_row<CI, 128>(ring, r, xb, iy0 + r, h, wd, ix0, gtid);
    cp_async_commit();
  }
  float sc[8][2], of[8][2];
  load_affine(sc, of, scale, offset, co0, co, lane & 3);
  const uint64_t w_desc0 = mn_desc(sbase);

  // Warpgroup g takes band rows t = g, g + 2, ...; row t reads ring rows
  // 2t .. 2t+3. While one warpgroup's wgmmas run, the other stores its last
  // row; as soon as the first half of its row t (kernel rows 0, 1) is done,
  // a warpgroup copies ring rows 2t+6, 2t+7 (for its row t+2) into the
  // slots of rows 2t, 2t+1, which rows t and t-1 alone read.
  float acc[CHAINS][32];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
#pragma unroll 1
  for (int t = g; t < nrows; t += 2) {
    uint32_t slot[4];
#pragma unroll
    for (int kh = 0; kh < 4; ++kh) slot[kh] = ring + ((2 * t + kh) % SLOTS) * SLOT_BYTES;
    if (t == 0) {  // the first half of the weights and ring rows 0, 1
      cp_async_wait<1>();
      bar_sync(1 + g, 128);
    }
    if (t == 1) bar_sync(PROLOGUE_BAR, 2 * 128);  // the weights, ring rows 2, 3
    // Ring rows 2t, 2t+1 (t >= 2): copied by the other warpgroup in its row
    // t-3 (ring rows 4, 5: in its prologue, signalled in its row 1).
    if (t >= 2) bar_sync(loaded_bar(other, t - 3), 2 * 128);
    // No branch from here to the last wait: ptxas would serialize the wgmmas.
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < 4; ++kh) {
      if (kh == 2) {
        wgmma_commit();
        // Ring rows 2t+2, 2t+3: this warpgroup's copies in its row t-2 or
        // prologue, which the other warpgroup's row t+1 reads too (with the
        // second half of the weights, after row 0).
        cp_async_wait();
        bar_sync(1 + g, 128);
        bar_arrive_if((t >= 1) & (t + 1 < nrows), loaded_bar(g, t - 2), 2 * 128);
        bar_arrive_if((t == 0) & (nrows > 1), PROLOGUE_BAR, 2 * 128);
      }
#pragma unroll
      for (int j = 0; j < 4 * KS; ++j) {
        const int step = kh * 4 * KS + j, kw = j / KS, ks = j % KS;
        // pixel p of tap kw is pixel p + kw/2 of plane kw&1
        const uint32_t a = slot[kh] + ((kw & 1) * PLANE + (kw >> 1)) * 128 + ks * 32;
        wgmma_m64n64k16(acc[step % CHAINS], k_desc(a),
                        w_desc0 + ((kh * 4 + kw) * CI + 16 * ks) * 8, step >= CHAINS);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // kernel rows 0, 1 of row t are done
    const bool copy = t + 2 < nrows;
    bar_sync_if(copy & (t >= 1), done_bar(other, t - 1), 2 * 128);  // and row t-1
#pragma unroll
    for (int r = 6; r < 8; ++r)
      stage_row<CI, 128>(ring, (2 * t + r) % SLOTS, xb, iy0 + 2 * t + r, h, wd, ix0, gtid, copy);
    cp_async_commit();
    wgmma_wait<0>();
    // Row t no longer reads its slots: in its row t+1 the other warpgroup
    // copies into those of ring rows 2t+2, 2t+3.
    if (t + 3 < nrows) bar_arrive(done_bar(g, t), 2 * 128);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) keep(acc[c][e]);
#pragma unroll
      for (int c = 1; c < CHAINS; ++c) acc[0][e] += acc[c][e];
    }
    bf16* yrow = y + (static_cast<long long>(b) * ho + oy0 + t) * wo * co;
    store_tile(acc[0], sc, of, yrow, ox0 + warp * 16, wo, co, co0, lane, act);
  }
  cp_async_wait();  // a warpgroup with no rows still has its prologue copies in flight
}

bool applies(int dtype, int ci, int co) {
  return dtype == DT_BF16 && ci % 16 == 0 && ci > 0 && ci <= MAX_CI && co % 8 == 0;
}

long long smem_bytes(int ci) {
  return static_cast<long long>(SLOTS) * SLOT_BYTES + 16LL * ci * CO_TILE * 2;
}

template <int KS>
int launch(dim3 grid, cudaStream_t s, const void* x, const void* w, const float* sc,
           const float* of, void* y, int n, int h, int wd, int co, int rows, int act,
           const PairStrides& ps) {
  const long long smem = smem_bytes(16 * KS);
  const cudaError_t err = cudaFuncSetAttribute(
      halo_wgmma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_wgmma_kernel<KS><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, of, static_cast<bf16*>(y), n,
      h, wd, co, rows, act, ps);
  return launch_status();
}

}  // namespace tc

}  // namespace

// The plan's paths (ops/halo_conv.py::HALO_PATH_CODES).
enum HaloPath { HALO_FMA = 0, HALO_WGMMA = 1 };

// The wrapper's plan (ops/halo_conv.py: tc_plan for the tensor-core path,
// halo_fma_plan for the CUDA cores): path (HaloPath); rows, cols: output
// rows and columns of a block (wgmma: its run of rows and its 64-column
// strip; FMA: rows x cols = 128 pixels, cols 32, 64 or 128); stages: the
// ring (wgmma: its 6 input rows; FMA: its 4 chunks); grid_x, grid_y: the
// grid (channel tiles; strips x bands; the pairs' images are its z); smem:
// dynamic shared memory. The entry refuses a plan that differs from its own
// arithmetic. pairs, x_ps, w_ps, aff_ps: the pair axis (common.cuh), w_ps 0
// for a shared weight; pair p's y starts N*HO*WO*CO values after pair 0's
// (the grid's z is pair * N + image).
extern "C" int discogan_halo_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                         const void* offset, void* y, int n, int h, int wd,
                                         int ci, int co, int act, int dtype, int path, int rows,
                                         int cols, int stages, int grid_x, int grid_y, int smem,
                                         int pairs, long long x_ps, long long w_ps,
                                         long long aff_ps, void* stream) {
  const int ho = h / 2, wo = wd / 2;
  if (pairs == 0) return 0;
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || static_cast<long long>(pairs) * n > 65535 ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, w_ps, itemsize) ||
      !pair_aligned(pairs, aff_ps, 4) || rows < 1 || cols < 1)
    return BAD;
  if (n == 0 || ho == 0 || wo == 0 || co == 0) return 0;
  const PairStrides ps{x_ps, w_ps, static_cast<long long>(n) * ho * wo * co, aff_ps, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  const long long blocks_y =
      static_cast<long long>((wo + cols - 1) / cols) * ((ho + rows - 1) / rows);
  if (path == HALO_WGMMA) {
    if (!tc::applies(dtype, ci, co) || cols != tc::STRIP || stages != tc::SLOTS ||
        grid_x != (co + tc::CO_TILE - 1) / tc::CO_TILE || grid_y != blocks_y ||
        smem != tc::smem_bytes(ci))
      return BAD;
    const dim3 grid(grid_x, grid_y, static_cast<unsigned>(n * pairs));
    switch (ci / 16) {
      case 1: return tc::launch<1>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      case 2: return tc::launch<2>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      case 3: return tc::launch<3>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      default: return tc::launch<4>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
    }
  }
  // The CUDA cores: f32 by 16-byte copies (16-byte aligned operands, which
  // the wrapper passes), bf16 by 8-byte loads.
  if (path != HALO_FMA || (dtype != DT_F32 && dtype != DT_BF16) || ci % fma::CK || ci < 1 ||
      co % 4 || (cols != 32 && cols != 64 && cols != 128) || rows * cols != fma::PIXELS ||
      stages != fma::STAGES || grid_x != (co + fma::CO_TILE - 1) / fma::CO_TILE ||
      grid_y != blocks_y || smem != fma::smem_bytes(cols) || smem > 232448 ||
      static_cast<long long>(h) * wd >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return BAD;
  const dim3 grid(grid_x, grid_y, static_cast<unsigned>(n * pairs));
  return dtype == DT_F32
             ? fma::launch_cols<float>(cols, grid, s, x, w, sc, of, y, n, h, wd, ci, co, act, ps)
             : fma::launch_cols<__nv_bfloat16>(cols, grid, s, x, w, sc, of, y, n, h, wd, ci,
                                               co, act, ps);
}
