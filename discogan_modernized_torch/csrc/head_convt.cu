// K6: the generator head, ConvTranspose2d(k=4, s=2, p=1) to a thin output
// (64 -> 3 channels at every geometry), before the sigmoid; in a G step the
// same function is the input gradient of the 3-channel stems.
//
// Replaces discogan_modernized_tpu/ops/pallas_head.py::head_convt_fwd (the
// pallas_call at line 198). Its kmajor/flat6 layouts only choose how the
// TPU writes the result; both are the same NHWC function, computed here
// directly.
//
// Contract: x (N,H,W,CI) NHWC, w (4,4,CI,CO) HWIO with I = the convT's
// input channels, y (N,2H,2W,CO) in x's dtype, f32 accumulation. In
// subpixel form, with wf = w flipped in both spatial axes, output pixel
// (2i+a, 2j+b) reads the 2x2 input window x[i+a+u-1, j+b+v-1] (u, v in
// {0,1}, zero outside) through taps wf[a+2u, b+2v] = w[3-a-2u, 3-b-2v].
//
// Bound on the H100 in bf16: bytes. At 512px, batch 8, it reads 67.1 MB of x and
// writes 12.6 MB of y (bf16) for 3.2 GFLOP of useful products, about 40
// flop/byte, far under the bf16 ridge of 295: 23.8 us at 3.35 TB/s. What
// counts is reading x once and writing y in whole lines.
//
// Two paths; the wrapper picks one by dtype and shape and passes its plan
// (ops/head.py: head_plan for the first, head_fma_plan for the second):
// - bf16 with CI % 16 == 0, 16 <= CI <= 128 and 1 <= CO <= 8 (the head and
//   the stems' input gradient at every geometry): head_convt_mma_kernel on
//   the tensor cores, below (namespace tc).
// - everything else (f32, which --precision f32 and the f32 equivalence
//   step use, and bf16 off those shapes): head_fma_kernel, exact f32 FMA on
//   the CUDA cores (namespace fma).
//
// head_fma_kernel. In f32 the head is balanced between the card's two
// roofs: at 512px batch 8 it reads 134.2 MB of x and writes 25.2 MB of y
// (47.6 us at 3.35 TB/s) for 1.61 G useful FMAs (48.1 us at 67 TFLOP/s). So
// it reads x from device memory once, does only the useful products, and
// keeps the shared-memory reads a product low enough for the FMAs to run:
// - Exact four-phase form: output (2i+a, 2j+b) takes its own 4 taps only,
//   16 CI CO FMAs a position (the 9-window GEMM of the tensor-core path
//   does 36 CI CO).
// - A block owns one image (and pair), `rows` input rows (4 or 8 from the
//   plan: 2 or 4 warps, two blocks of 4 an SM; the entry takes up to 16)
//   and TC input columns (128 at CO <= 3, 64 at CO 4..8). Each warp owns 2
//   of the rows across the TC columns; each lane a register tile of 2 rows
//   x TCT neighbouring columns (TCT = 4, or 2 at CO 4..8), with the 4
//   phases x CO f32 accumulators of each position (96 at CO 3, 128 at CO
//   8).
// - CI goes in chunks of KC = 8 channels through a ring of STAGES = 2 (a
//   third was slower: 229 KB of shared memory at 16 rows). A stage holds
//   the block's halo tile, rows + 2 input rows by TC + 2 columns of the
//   chunk's channels (zero outside the map and past CI), as planes of one
//   16-byte unit a pixel (f32: 2 planes of 4 channels; bf16: one of 8,
//   converted on read), and the chunk's weights [tap][KC][CO] as f32 (zero
//   past CO and CI). The copies of chunk q + 1 are issued before chunk q's
//   products: with VEC (f32 CI % 4 == 0, bf16 CI % 8 == 0) 16-byte
//   cp.async, zero-filled through their source size, so each x value
//   leaves device memory once and the halo comes from L2; otherwise scalar
//   loads stored at once. Weights: f32 by 4-byte cp.async, bf16 by loads
//   converted and stored. A thread copies the same few units of every
//   staged row (their columns' sources and destinations computed once,
//   walked down the rows by one add each); a chunk moves the channel
//   offset alone.
// - Products: per 4 channels, for each of the window's 4 rows the lane
//   reads its TCT + 2 pixels as float4 over the channels, then for each
//   tap that reads that row the tap's 4 x CO weights as CO float4 (the
//   same address across the warp: one broadcast wavefront each), and does
//   4 CO FMAs per position the tap feeds. Neighbouring positions share
//   their window pixels. At 2 x 4 that is 24 x reads (4 wavefronts each)
//   and 96 w reads a lane per 1536 FMAs, 48 wavefronts a channel for a
//   warp against 96 that the SM's shared memory gives it a channel.
// - Banks: lane l reads staged column TCT l + dx of one row; a staged row
//   is TC + 2 units and column c sits at unit c ^ ((c >> 3) & SWZ) (SWZ =
//   3 at TCT 4, 1 at TCT 2), so the eight lanes of a quarter warp fall on
//   eight distinct 16-byte bank groups for every dx
//   (tests/test_torch_head_plan.py checks the addresses).
// - Epilogue: after the ring drains, each warp writes its 4 output lines
//   (input rows 2w, 2w+1 of the block, phases a = 0, 1; 2 TC CO values
//   each, laid out as in y, started at y's 16-byte phase) into shared
//   memory, 16 bytes at a time where a line starts on a 16-byte boundary
//   of y and CO is the template's, then stores them in aligned 16-byte
//   units, the ragged lead and tail by value.
// - No split over CI and no atomics: two launches give the same bits; the
//   launch neither syncs nor allocates (CUDA-graph capture).
// - What holds it (tools/head_ab.py --dtype f32): its copies alone (32
//   bytes a pixel a chunk at a 256-byte stride) and its products alone
//   each take about two thirds of its time, and they overlap poorly; the
//   products run at 255 registers, two warps a scheduler.
//
// head_convt_mma_kernel:
// - One GEMM for the four phases. The four output pixels (2i+a, 2j+b) of
//   input position (i, j) read its 3x3 neighbourhood, window (dy, dx) in
//   {-1,0,1}^2. So a row of 64 positions is a 64 x (9 CI) by (9 CI) x NP
//   product: K runs over the 9 windows' channels, column n = a*2CO + b*CO +
//   o over the phases (NP = 16 for CO <= 4, 32 up to CO 8), and B holds
//   w[3-a-2u, 3-b-2v] at window (a+u-1, b+v-1) and zeros where a phase does
//   not read the window. wgmma m64nNPk16, both operands K-major in shared
//   memory, 9 * CI/16 of them per row of 64 positions. The four-phase form
//   reads each staged x value 9 times from shared memory (per-phase GEMMs,
//   K = 4 CI each, would read it 16 times) and does 3x the useful products
//   (a phase reads 4 of the 9 windows; 12 of 16 columns at CO 3).
// - A block owns one image, a strip of 128 input columns (two warpgroups of
//   64) and a band of `rows` consecutive input rows, which the plan picks so
//   that the grid is about one wave of two blocks per SM. It copies w into
//   shared memory and builds B from it once (9 x CI x NP bf16, 18 KB at CI
//   64). Then each warpgroup walks down the band on its own, so that one's
//   copies and epilogue overlap the other's wgmmas: input row i makes output
//   rows 2i and 2i+1 from ring rows i-1, i, i+1, so each x row comes from
//   device memory once and the band's two halo rows from L2.
// - The ring: SLOTS (5, or 4 where shared memory is short) input rows, in
//   which each warpgroup stages its own 66 pixels (its 64 columns and their
//   padding columns), 128 bytes a pixel for each 64 channels, zero-filled
//   outside the image, by 16-byte cp.async.cg copies that run SLOTS - 2 rows
//   ahead of its wgmmas, in the 128-byte swizzle wgmma reads (wgmma.cuh):
//   window (dy, dx) of its 64 positions is 64 consecutive pixels of ring row
//   i+dy starting at pixel 1 + dx, and a descriptor points straight at them.
// - Epilogue: each thread's accumulator pairs (two neighbouring values of
//   an output row, one 4-byte bf16 pair) go to a shared-memory line of the
//   warpgroup's part of output rows 2i and 2i+1, laid out as in y (64 x 2CO
//   values, 768 bytes at CO 3), which then goes out in aligned 16-byte
//   stores.
// - What holds it (tools/head_ab.py splits it): the row copies alone and
//   the wgmmas with the epilogue alone each take most of the kernel's time.
// - No branch and no accumulator read sits between a row's first wgmma and
//   its wait (ptxas would serialize the wgmmas); the first wgmma of a row
//   takes scale-d 0 instead of zeroed accumulators.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---- CUDA-core path (f32, and bf16 off the tensor-core shapes) ----------

namespace fma {

constexpr int KC = 8;             // channels of a CI chunk (a ring stage)
constexpr int STAGES = 2;         // the ring: copies run a chunk ahead (3 was slower)
constexpr int TRT = 2;            // input rows of a lane's tile: a warp's rows
constexpr int MIN_ROWS = 4;       // a block's input rows: 2 warps ...
constexpr int MAX_ROWS = 16;      // ... to 8
constexpr int MAX_THREADS = 32 * MAX_ROWS / TRT;

// The kernel's CO (3 or 8) for co output channels (1..3 -> 3, 4..8 -> 8:
// the weights past co are zeros); a lane's columns (TCT) and a block's (TC).
__host__ __device__ constexpr int co_of(int co) { return co <= 3 ? 3 : 8; }
__host__ __device__ constexpr int thread_cols(int CO) { return CO <= 3 ? 4 : 2; }
__host__ __device__ constexpr int tile_cols(int CO) { return 32 * thread_cols(CO); }
// A stage: PL planes of the halo tile, each rows + 2 staged rows of TC + 2
// 16-byte units (one a pixel), then the chunk's weights [tap][KC][CO] f32.
__host__ __device__ constexpr int planes(int itemsize) { return (KC * itemsize + 15) / 16; }
__host__ __device__ constexpr int stage_bytes(int itemsize, int CO, int rows) {
  return 16 * planes(itemsize) * (rows + 2) * (tile_cols(CO) + 2) + 4 * 16 * KC * CO;
}
// An epilogue line: an output row's 2 TC CO values of T and room for a
// lead of up to 15 bytes (a multiple of 16 bytes in all).
__host__ __device__ constexpr int line_vals(int itemsize, int CO) {
  return 2 * tile_cols(CO) * CO + 16 / itemsize;
}
// The ring, or the epilogue's lines (4 a warp) where larger.
__host__ __device__ constexpr int smem_bytes(int itemsize, int CO, int rows, int stages) {
  const int ring = stages * stage_bytes(itemsize, CO, rows);
  const int lines = rows / TRT * 4 * line_vals(itemsize, CO) * itemsize;
  return ring > lines ? ring : lines;
}

template <int N>
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Column c of a staged row at unit c ^ ((c >> 3) & SWZ): lanes TCT apart
// then fall on distinct 16-byte bank groups in each quarter warp; the last
// two columns, TC and TC + 1, keep their units.
template <int TCT>
__host__ __device__ constexpr int swz_col(int c) {
  return c ^ ((c >> 3) & (TCT == 4 ? 3 : 1));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// Four channels of a staged pixel as f32: f32 a float4 of its plane;
// bf16 the half `g` (8 bytes) of its one unit, at p.
__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = Vec16<__nv_bfloat16>::half(u.x), hi = Vec16<__nv_bfloat16>::half(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): input columns j0 .. j0 + TC -
// 1 (x = band * strips + strip) and rows i0 .. i0 + rows - 1 of image y,
// pair z. Staged row r, column c is input pixel (i0 - 1 + r, j0 - 1 + c).
// Lane `lane` of warp `warp` owns input rows i0 + 2 warp + t (t < 2) and
// columns j0 + TCT lane + s (s < TCT); phase (a, b) of position (t, s)
// reads window row dy = t + a + u, staged row 2 warp + dy, and column dx =
// s + b + v, staged column TCT lane + dx, through tap w[3-a-2u][3-b-2v]
// (u, v in {0, 1}).
template <typename T, int CO, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    head_fma_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int h,
                    int wd, int ci, int co, int rows, PairStrides ps) {
  constexpr int TCT = thread_cols(CO), TC = tile_cols(CO), XS = TC + 2;  // staged columns
  constexpr int PL = planes(sizeof(T));        // planes of a stage
  constexpr int U = 16 / sizeof(T);            // channels of a 16-byte unit
  constexpr int NW = TCT + 2;                  // pixels of a window row
  // a thread's x units of a staged row: most at the fewest threads
  constexpr int X_SLOTS = (PL * XS + 16 * MIN_ROWS - 1) / (16 * MIN_ROWS);
  constexpr int W_VALS = 16 * KC * CO;
  constexpr int W_COPIES = (W_VALS + 16 * MIN_ROWS - 1) / (16 * MIN_ROWS);
  constexpr int LV = line_vals(sizeof(T), CO);
  static_assert(swz_col<TCT>(TC) == TC && swz_col<TCT>(TC + 1) == TC + 1,
                "the last two columns keep their units");
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int strips = (wd + TC - 1) / TC;
  const int j0 = (blockIdx.x % strips) * TC, i0 = (blockIdx.x / strips) * rows;
  const int b = blockIdx.y;
  x += blockIdx.z * ps.x;  // z: the pair
  w += blockIdx.z * ps.w;
  y += blockIdx.z * ps.y;
  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  const int stage = stage_bytes(sizeof(T), CO, rows);
  const int plane_bytes = 16 * (rows + 2) * XS;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // x: unit k of a staged row is plane k % PL of column k / PL; this thread
  // copies units tid + threads m (m < X_SLOTS) of every row: plane tid % PL
  // (threads is a multiple of 32). x_col: the column's first channel in its
  // input row, x_cdst: the unit's byte offset in a staged row.
  const int plane = tid % PL;
  int x_col[X_SLOTS], x_cdst[X_SLOTS];
  uint32_t x_live = 0, x_ok = 0;
#pragma unroll
  for (int m = 0; m < X_SLOTS; ++m) {
    const int k = tid + threads * m, c = k / PL, ix = j0 - 1 + c;
    const bool live = k < PL * XS, ok = live && ix >= 0 && ix < wd;
    x_live |= static_cast<uint32_t>(live) << m;
    x_ok |= static_cast<uint32_t>(ok) << m;
    x_col[m] = ok ? ix * ci + plane * U : 0;
    x_cdst[m] = plane * plane_bytes + swz_col<TCT>(live ? c : 0) * 16;
  }

  // Stage chunk q (channels KC q ..) into its slot, if `go`: staged row r
  // is input row i0 - 1 + r, its units XS * 16 bytes further.
  auto stage_chunk = [&](int q, bool go) {
    if (!go) return;
    const int c0 = q * KC, slot = (q % STAGES) * stage;
    const bool ch_ok = c0 + plane * U < ci;  // the unit's channels inside CI
    const T* src_row = xb + static_cast<long long>(i0 - 1) * wd * ci + c0;
    int dst_row = slot;
#pragma unroll 1
    for (int r = 0; r < rows + 2; ++r, src_row += wd * ci, dst_row += XS * 16) {
      const bool row_ok = ch_ok && i0 - 1 + r >= 0 && i0 - 1 + r < h;
#pragma unroll
      for (int m = 0; m < X_SLOTS; ++m) {
        if (!((x_live >> m) & 1)) continue;
        const bool ok = row_ok && ((x_ok >> m) & 1);
        const T* src = src_row + x_col[m];
        if constexpr (VEC) {
          hopper::cp_async16(sbase + dst_row + x_cdst[m], ok ? src : x, ok);
        } else {
          alignas(16) T v[U];
#pragma unroll
          for (int e = 0; e < U; ++e)
            v[e] = ok && c0 + plane * U + e < ci ? src[e] : from_f32<T>(0.f);
          *reinterpret_cast<uint4*>(smem + dst_row + x_cdst[m]) =
              *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    // w: value e = tid + threads j of [tap][KC][CO] is w[tap][c0 + c][o]
#pragma unroll
    for (int j = 0; j < W_COPIES; ++j) {
      const int e = tid + threads * j;
      if (e >= W_VALS) continue;
      const int tap = e / (KC * CO), c = e / CO % KC, o = e % CO;
      const bool ok = o < co && c0 + c < ci;
      const T* src = w + (tap * ci + c0 + c) * co + o;
      const int dst = slot + PL * plane_bytes + 4 * e;
      if constexpr (sizeof(T) == 4) {
        cp_async4(sbase + dst, ok ? src : w, ok);
      } else {
        *reinterpret_cast<float*>(smem + dst) = ok ? to_f32(*src) : 0.f;
      }
    }
  };

  float acc[TRT][TCT][2][2][CO];
#pragma unroll
  for (int t = 0; t < TRT; ++t)
#pragma unroll
    for (int s = 0; s < TCT; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int o = 0; o < CO; ++o) acc[t][s][a][bb][o] = 0.f;

  const int nchunks = (ci + KC - 1) / KC;
  for (int q = 0; q < STAGES - 1; ++q) {
    stage_chunk(q, q < nchunks);
    hopper::cp_async_commit();
  }
  // This lane's window pixels in a plane: staged row 2 warp, columns TCT
  // lane + dx; window row dy is dy XS units further.
  int x_read[NW];
#pragma unroll
  for (int dx = 0; dx < NW; ++dx)
    x_read[dx] = (TRT * warp * XS + swz_col<TCT>(TCT * lane + dx)) * 16;

  // Chunk q: its copies landed (this thread's, then everyone's at the
  // barrier, which also sees every warp past chunk q - 1's reads); chunk q +
  // STAGES - 1 staged into chunk q - 1's slot; then chunk q's products.
#pragma unroll 1
  for (int q = 0; q < nchunks; ++q) {
    copies_landed<STAGES - 2>();
    __syncthreads();
    stage_chunk(q + STAGES - 1, q + STAGES - 1 < nchunks);
    hopper::cp_async_commit();
    const unsigned char* xs = smem + (q % STAGES) * stage;
    const float* ws = reinterpret_cast<const float*>(xs + PL * plane_bytes);
#pragma unroll
    for (int g = 0; g < KC / 4; ++g) {  // 4 channels: f32 plane g, bf16 half g of the unit
      const unsigned char* xg = xs + (PL > 1 ? g * plane_bytes : g * 8);
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
        float4 xr[NW];
#pragma unroll
        for (int dx = 0; dx < NW; ++dx)
          xr[dx] = read4(reinterpret_cast<const T*>(xg + x_read[dx] + dy * XS * 16));
#pragma unroll
        for (int t = 0; t < TRT; ++t)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int u = dy - t - a;
            if (u < 0 || u > 1) continue;
#pragma unroll
            for (int kw = 0; kw < 4; ++kw) {
              const int bb = (3 - kw) & 1, v = (3 - kw - bb) >> 1;
              const float* wt = ws + (((3 - a - 2 * u) * 4 + kw) * KC + 4 * g) * CO;
              float wv[4 * CO];  // [channel][o]
#pragma unroll
              for (int m = 0; m < CO; ++m) {
                const float4 f = *reinterpret_cast<const float4*>(wt + 4 * m);
                wv[4 * m] = f.x, wv[4 * m + 1] = f.y, wv[4 * m + 2] = f.z, wv[4 * m + 3] = f.w;
              }
#pragma unroll
              for (int s = 0; s < TCT; ++s)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const float xv = comp(xr[s + bb + v], c);
#pragma unroll
                  for (int o = 0; o < CO; ++o)
                    acc[t][s][a][bb][o] = fmaf(xv, wv[c * CO + o], acc[t][s][a][bb][o]);
                }
            }
          }
      }
    }
  }
  copies_landed<0>();
  __syncthreads();

  // Epilogue: this warp's lines (input row 2 warp + t, phase a) in the
  // drained ring; line (t, a) holds output row 2i + a from column 2 j0 at
  // offset `lead`, y's 16-byte phase there, so that its 16-byte units are
  // y's. The lane's 2 TCT CO values of a line are contiguous: 16-byte
  // stores where the line has no lead and co is the kernel's CO.
  T* lines = reinterpret_cast<T*>(smem) + warp * 4 * LV;
  const int npos = max(0, min(TC, wd - j0));
  const int len = npos * 2 * co;
#pragma unroll
  for (int t = 0; t < TRT; ++t)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + TRT * warp + t;
      if (i >= h) continue;
      T* line = lines + (2 * t + a) * LV;
      const T* row = y + ((static_cast<long long>(b) * 2 * h + 2 * i + a) * 2 * wd + 2 * j0) * co;
      const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(row) / sizeof(T) % U);
      if (co == CO && lead == 0) {
        float v[2 * TCT * CO];
#pragma unroll
        for (int s = 0; s < TCT; ++s)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
#pragma unroll
            for (int o = 0; o < CO; ++o) v[(s * 2 + bb) * CO + o] = acc[t][s][a][bb][o];
#pragma unroll
        for (int k = 0; k < 2 * TCT * CO / U; ++k) {
          float part[U];
#pragma unroll
          for (int e = 0; e < U; ++e) part[e] = v[k * U + e];
          *reinterpret_cast<uint4*>(line + 2 * TCT * CO * lane + k * U) = Vec16<T>::pack(part);
        }
      } else {
#pragma unroll
        for (int s = 0; s < TCT; ++s)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
#pragma unroll
            for (int o = 0; o < CO; ++o)
              if (o < co)
                line[lead + ((TCT * lane + s) * 2 + bb) * co + o] =
                    from_f32<T>(acc[t][s][a][bb][o]);
      }
    }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < TRT; ++t)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + TRT * warp + t;
      if (i >= h) continue;
      const T* line = lines + (2 * t + a) * LV;
      T* row = y + ((static_cast<long long>(b) * 2 * h + 2 * i + a) * 2 * wd + 2 * j0) * co;
      const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(row) / sizeof(T) % U);
      T* dst = row - lead;
      for (int k = lane; k * U < lead + len; k += 32) {
        if (k * U >= lead && k * U + U <= lead + len) {
          *reinterpret_cast<uint4*>(dst + k * U) = *reinterpret_cast<const uint4*>(line + k * U);
        } else {
          for (int e = max(k * U, lead); e < min(k * U + U, lead + len); ++e) dst[e] = line[e];
        }
      }
    }
}

template <typename T, int CO, bool VEC>
int launch(dim3 grid, int threads, int smem, cudaStream_t s, const void* x, const void* w,
           void* y, int h, int wd, int ci, int co, int rows, const PairStrides& ps) {
  const cudaError_t err = cudaFuncSetAttribute(
      head_fma_kernel<T, CO, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_fma_kernel<T, CO, VEC><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), h, wd, ci, co,
      rows, ps);
  return launch_status();
}

template <typename T>
int dispatch(bool vec, dim3 grid, int threads, int smem, cudaStream_t s, const void* x,
             const void* w, void* y, int h, int wd, int ci, int co, int rows,
             const PairStrides& ps) {
  if (co_of(co) == 3)
    return vec ? launch<T, 3, true>(grid, threads, smem, s, x, w, y, h, wd, ci, co, rows, ps)
               : launch<T, 3, false>(grid, threads, smem, s, x, w, y, h, wd, ci, co, rows, ps);
  return vec ? launch<T, 8, true>(grid, threads, smem, s, x, w, y, h, wd, ci, co, rows, ps)
             : launch<T, 8, false>(grid, threads, smem, s, x, w, y, h, wd, ci, co, rows, ps);
}

}  // namespace fma

// ---- tensor-core path (bf16, CI % 16 == 0, 16 <= CI <= 128, CO <= 8) ----

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int THREADS = 256;          // two warpgroups, 64 input columns each
constexpr int STRIP = 128;            // input columns per block
constexpr int WPIX = 64 + 2;          // pixels a warpgroup stages of a row: its 64 and the padding
constexpr int PLANE_BYTES = 2 * WPIX * 128;  // a staged row's 64-channel plane, both warpgroups'
constexpr int MAX_CI = 128;
constexpr int MAX_CO = 8;
// w passes through one ring slot: 16 CI CO bf16 values in PLANES planes.
static_assert(16 * 64 * MAX_CO * 2 <= PLANE_BYTES, "w does not fit a ring slot");

// B's columns: 4 CO phases and channels, padded to a wgmma width.
__host__ __device__ constexpr int np_of(int co) { return co <= 4 ? 16 : 32; }
// bf16 values of one warpgroup's part of one output row in the epilogue's
// line: 64 positions x 2 CO, and up to 7 values ahead for y's alignment.
__host__ __device__ constexpr int line_elems(int co) { return 128 * co + 16; }

long long smem_bytes(int ci, int co, int slots) {
  const long long planes = (ci + 63) / 64;
  return 9 * planes * np_of(co) * 128 + slots * planes * PLANE_BYTES + 4LL * line_elems(co) * 2;
}

// Two blocks share an SM up to CI 64; from CI 80 a block's ring alone
// takes more than half of the SM's shared memory, so one block may have
// all 255 registers a thread.
template <int KS, int NP, int AHEAD>  // CI = 16 KS; copies AHEAD rows ahead
__global__ void __launch_bounds__(THREADS, KS <= 4 ? 2 : 1)
    head_convt_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          bf16* __restrict__ y, int h, int wd, int co, int rows,
                          PairStrides ps) {
  constexpr int CI = 16 * KS;
  constexpr int PLANES = (CI + 63) / 64;
  constexpr int CPP = CI / 8;                   // 16-byte chunks per pixel
  constexpr int SLOTS = AHEAD + 3;              // rows i-1, i, i+1 and AHEAD in flight
  constexpr int SLOT_BYTES = PLANES * PLANE_BYTES;
  constexpr int WG_BYTES = SLOT_BYTES / 2;      // a warpgroup's part of a slot
  constexpr int W_BYTES = 9 * PLANES * NP * 128;
  constexpr int UNITS = WPIX * CPP;             // a warpgroup's 16-byte copies of a row
  constexpr int UPT = (UNITS + 127) / 128;
  constexpr int NT = NP / 8;                    // 8-column groups of the accumulator
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = sbase + W_BYTES;
  bf16* lines = reinterpret_cast<bf16*>(smem + W_BYTES + SLOTS * SLOT_BYTES);

  const int strips = (wd + STRIP - 1) / STRIP;
  const int j0 = (blockIdx.x % strips) * STRIP;
  const int r0 = (blockIdx.x / strips) * rows;
  const int nrows = min(rows, h - r0);
  const int b = blockIdx.y;
  x += blockIdx.z * ps.x;  // z: the pair
  w += blockIdx.z * ps.w;
  y += blockIdx.z * ps.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid >> 7, gtid = tid & 127, warp = (tid >> 5) & 3;
  const bf16* xb = x + static_cast<long long>(b) * h * wd * CI;

  const int jg = j0 + 64 * g;                   // this warpgroup's first position
  const int npos = max(0, min(64, wd - jg));    // of its 64, those inside the map

  // Each warpgroup stages its own 66 pixels of every row (input columns
  // jg - 1 .. jg + 64) and walks the band on its own, so that one's copies
  // and epilogue overlap the other's wgmmas. This thread's copies, the same
  // in every row: unit e = gtid + 128 k is chunk e % CPP of pixel e / CPP,
  // at unit (plane * WPIX + pixel) * 8 + chunk % 8 of the warpgroup's part
  // of the slot.
  int src_off[UPT], dst_unit[UPT];
  bool col_ok[UPT], live[UPT];
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const int e = gtid + k * 128, s = e / CPP, chunk = e % CPP, ix = jg - 1 + s;
    live[k] = e < UNITS;
    col_ok[k] = live[k] && ix >= 0 && ix < wd;
    src_off[k] = col_ok[k] ? ix * CI + chunk * 8 : 0;
    dst_unit[k] = ((chunk >> 3) * WPIX + s) * 8 + (chunk & 7);
  }
  // Ring row r (input row r0 - 1 + r) into its slot; zeros outside the map.
  auto stage = [&](int r, bool go) {
    const int iy = r0 - 1 + r;
    const bool row_ok = iy >= 0 && iy < h;
    const bf16* xr = xb + static_cast<long long>(row_ok ? iy : 0) * wd * CI;
    const uint32_t su = (ring + (r % SLOTS) * SLOT_BYTES + g * WG_BYTES) / 16;
#pragma unroll
    for (int k = 0; k < UPT; ++k)
      cp_async16(swz(su + dst_unit[k]) * 16, xr + src_off[k], row_ok && col_ok[k], go && live[k]);
  };

  // Where each of this thread's accumulator pairs goes in the epilogue:
  // columns n = 8 nt + 2 (lane % 4) and n + 1 (one output row a, since 2CO
  // is even) go to line a, at value m = n % 2CO of their position.
  int col_a[NT], col_m[NT];
  bool col_live[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + 2 * (lane & 3);
    col_live[nt] = n < 4 * co;
    col_a[nt] = n / (2 * co);
    col_m[nt] = n % (2 * co);
  }

  // w (16 CI CO values) goes as it is into the ring's last slot, which
  // stays free until B is built; ring rows 0 .. SLOTS - 2 go in meanwhile.
  const uint32_t w_copy = ring + (SLOTS - 1) * SLOT_BYTES;
  for (int e = tid; e < 2 * CI * co; e += THREADS) cp_async16(w_copy + e * 16, w + e * 8, true);
  cp_async_commit();
  stage(0, true);
  stage(1, true);
  stage(2, true);
  cp_async_commit();
#pragma unroll
  for (int k = 1; k < AHEAD; ++k) {
    stage(2 + k, 2 + k <= nrows + 1);
    cp_async_commit();
  }
  cp_async_wait<AHEAD>();
  __syncthreads();
  const bf16* ws = reinterpret_cast<const bf16*>(smem + (w_copy - sbase));
  // B, from that copy: unit e = ((window * PLANES + plane) * NP + n) * 8 +
  // chunk holds channels 64 plane + 8 chunk .. + 7 of column n = a*2CO +
  // b*CO + o at window (dy, dx) = (window / 3 - 1, window % 3 - 1):
  // w[3-a-2u, 3-b-2v] with u = dy + 1 - a and v = dx + 1 - b, where both
  // are 0 or 1.
  for (int e = tid; e < W_BYTES / 16; e += THREADS) {
    const int chunk = e & 7, n = (e >> 3) % NP, wq = (e >> 3) / NP;
    const int c0 = (wq % PLANES) * 64 + chunk * 8, win = wq / PLANES;
    if (c0 >= CI) continue;
    const int a = n / (2 * co), bb = n % (2 * co) / co, o = n % co;
    const int u = win / 3 - a, v = win % 3 - bb;
    const bool ok = n < 4 * co && u >= 0 && u <= 1 && v >= 0 && v <= 1;
    const bf16* src = ws + (((3 - a - 2 * u) * 4 + 3 - bb - 2 * v) * CI + c0) * co + o;
    uint32_t pk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      pk[k] = ok ? pack_bf16x2(__bfloat162float(src[2 * k * co]),
                               __bfloat162float(src[(2 * k + 1) * co]))
                 : 0u;
    *reinterpret_cast<uint4*>(smem + swz(sbase / 16 + e) * 16 - sbase) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
  // B is read by wgmma (the async proxy) after the barrier, and the last
  // slot is free for ring row SLOTS - 1.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  stage(SLOTS - 1, SLOTS - 1 <= nrows + 1);
  cp_async_commit();

  float acc[2][NP / 2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) acc[c][e] = 0.f;

#pragma unroll 1
  for (int t = 0; t < nrows; ++t) {
    // Ring rows t .. t+2 have landed (each thread's own copies, then the
    // warpgroup's barrier for all of its copies), and the warpgroup's
    // stores of row t-1 have read its lines.
    cp_async_wait<AHEAD>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");

    uint32_t row_base[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      row_base[dy] = ring + ((t + dy) % SLOTS) * SLOT_BYTES + g * WG_BYTES;
    // No branch from here to the wait: ptxas would serialize the wgmmas.
    wgmma_fence();
#pragma unroll
    for (int win = 0; win < 9; ++win)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int step = win * KS + ks, q = ks >> 2;
        const uint32_t a_addr =
            row_base[win / 3] + q * WPIX * 128 + (win % 3) * 128 + (ks & 3) * 32;
        const uint32_t b_addr = sbase + (win * PLANES + q) * NP * 128 + (ks & 3) * 32;
        wgmma_m64nNk16_kk(acc[step & 1], k_desc(a_addr), k_desc(b_addr), step >= 2);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) {
      keep(acc[0][e]);
      keep(acc[1][e]);
      acc[0][e] += acc[1][e];
    }

    // Output rows 2i + a, i = r0 + t: this warpgroup's part starts at value
    // g0 of y and goes to its line from offset g0 % 8, so that the line's
    // 16-byte units fall on y's.
    long long g0[2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      g0[a] = ((static_cast<long long>(b) * 2 * h + 2 * (r0 + t) + a) * 2 * wd + 2 * jg) * co;
    // acc[4 nt + 2 hf + {0, 1}]: position 16 warp + lane / 4 + 8 hf, columns
    // n, n + 1 of group nt.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = warp * 16 + (lane >> 2) + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (!col_live[nt] || p >= npos) continue;
        const int a = col_a[nt];
        const int off = static_cast<int>(g0[a] & 7) + p * 2 * co + col_m[nt];
        *reinterpret_cast<uint32_t*>(lines + (2 * g + a) * line_elems(co) + off) =
            pack_bf16x2(acc[0][4 * nt + 2 * hf], acc[0][4 * nt + 2 * hf + 1]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    // The warpgroup's wgmmas no longer read ring row t: its slot takes ring
    // row t + SLOTS.
    stage(t + SLOTS, t + SLOTS <= nrows + 1);
    cp_async_commit();
    const int len = npos * 2 * co;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int lead = static_cast<int>(g0[a] & 7);
      const bf16* line = lines + (2 * g + a) * line_elems(co);
      bf16* dst = y + (g0[a] - lead);
      for (int k = gtid; k * 8 < lead + len; k += 128) {
        if (k * 8 >= lead && k * 8 + 8 <= lead + len) {
          *reinterpret_cast<uint4*>(dst + k * 8) = *reinterpret_cast<const uint4*>(line + k * 8);
        } else {
          for (int e = max(k * 8, lead); e < min(k * 8 + 8, lead + len); ++e) dst[e] = line[e];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int KS, int NP, int AHEAD>
int launch(dim3 grid, long long smem, cudaStream_t s, const void* x, const void* w, void* y,
           int h, int wd, int co, int rows, const PairStrides& ps) {
  const cudaError_t err =
      cudaFuncSetAttribute(head_convt_mma_kernel<KS, NP, AHEAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  head_convt_mma_kernel<KS, NP, AHEAD><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), h, wd, co,
      rows, ps);
  return launch_status();
}

template <int KS>
int launch_ks(int np, int slots, dim3 grid, long long smem, cudaStream_t s, const void* x,
              const void* w, void* y, int h, int wd, int co, int rows, const PairStrides& ps) {
  if (np == 16)
    return slots == 5 ? launch<KS, 16, 2>(grid, smem, s, x, w, y, h, wd, co, rows, ps)
                      : launch<KS, 16, 1>(grid, smem, s, x, w, y, h, wd, co, rows, ps);
  return slots == 5 ? launch<KS, 32, 2>(grid, smem, s, x, w, y, h, wd, co, rows, ps)
                    : launch<KS, 32, 1>(grid, smem, s, x, w, y, h, wd, co, rows, ps);
}

}  // namespace tc

}  // namespace

// The wrapper's plan, refused unless it covers every input row and column
// once and matches the kernel's own layout: path 1, the tensor-core path
// (bands of `rows` input rows, `strips` strips of `cols` = 128 columns, a
// ring of `slots` rows, `smem` bytes; kc and vec unused); path 0, the
// CUDA-core path (bands of `rows` input rows, `strips` strips of `cols`
// columns, a ring of `slots` stages of `kc` channels, 16-byte copies where
// `vec`, `smem` bytes). pairs, x_ps, w_ps: the pair axis (common.cuh); pair
// p's y starts N*2H*2W*CO values after pair 0's.
extern "C" int discogan_head_convt(const void* x, const void* w, void* y, int n, int h, int wd,
                                   int ci, int co, int dtype, int path, int rows, int cols,
                                   int bands, int strips, int slots, int kc, int vec,
                                   long long smem, int pairs, long long x_ps, long long w_ps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs == 0) return 0;
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || static_cast<long long>(pairs) * n > 65535 ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, w_ps, itemsize) || co < 1 ||
      co > tc::MAX_CO || (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairStrides ps{x_ps, w_ps, 4LL * n * h * wd * co, 0, 0, 0};
  if (path == 1) {
    if (dtype != DT_BF16 || ci % 16 != 0 || ci < 16 || ci > tc::MAX_CI || cols != tc::STRIP ||
        (slots != 4 && slots != 5) || smem != tc::smem_bytes(ci, co, slots))
      return static_cast<int>(cudaErrorInvalidValue);
    if (static_cast<long long>(n) * h * wd == 0) return 0;
    if (!covers_once(h, bands, rows) || !covers_once(wd, strips, cols))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(strips * bands), static_cast<unsigned>(n),
                    static_cast<unsigned>(pairs));
    const int np = tc::np_of(co);
    switch (ci / 16) {
      case 1: return tc::launch_ks<1>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 2: return tc::launch_ks<2>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 3: return tc::launch_ks<3>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 4: return tc::launch_ks<4>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 5: return tc::launch_ks<5>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 6: return tc::launch_ks<6>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      case 7: return tc::launch_ks<7>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
      default: return tc::launch_ks<8>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows, ps);
    }
  }
  const int cot = fma::co_of(co);
  if (path != 0 || ci < 1 || kc != fma::KC || rows % fma::TRT != 0 || rows < fma::MIN_ROWS ||
      rows > fma::MAX_ROWS || cols != fma::tile_cols(cot) || slots != fma::STAGES ||
      vec != static_cast<int>(ci % (16 / itemsize) == 0) ||
      smem != fma::smem_bytes(itemsize, cot, rows, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(n) * h * wd == 0) return 0;
  if (!covers_once(h, bands, rows) || !covers_once(wd, strips, cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(strips * bands), static_cast<unsigned>(n),
                  static_cast<unsigned>(pairs));
  const int threads = 32 * rows / fma::TRT, bytes = static_cast<int>(smem);
  if (dtype == DT_F32)
    return fma::dispatch<float>(vec, grid, threads, bytes, s, x, w, y, h, wd, ci, co, rows, ps);
  return fma::dispatch<__nv_bfloat16>(vec, grid, threads, bytes, s, x, w, y, h, wd, ci, co, rows,
                                      ps);
}
