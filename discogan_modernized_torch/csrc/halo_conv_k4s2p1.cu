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
// Two paths; the wrapper picks one by dtype and shape (ops/halo_conv.py::
// tc_plan) and passes `rows` > 0 for the first:
// - bf16 with CI % 16 == 0 and CI <= 64 (enc1): halo_wgmma_kernel, below.
// - everything else (f32, and CI % 16 != 0): halo_conv_kernel, f32 FMA on
//   the CUDA cores over bands of output rows with 1-row halos, 8-channel f32
//   chunks of the band staged in shared memory, 8 pixels x 8 channels of
//   accumulators a thread.
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

constexpr int THREADS = 256;
constexpr int CI_CHUNK = 8;
constexpr int CO_TILE = 64;
constexpr int PIX_PER_THREAD = 8;
constexpr int CH_PER_THREAD = 8;
constexpr int PIX_GROUPS = THREADS / (CO_TILE / CH_PER_THREAD);  // 32
constexpr int MAX_PIX = PIX_GROUPS * PIX_PER_THREAD;              // 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
    halo_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ offset,
                     T* __restrict__ y, int n, int h, int wd, int ci, int co, int to, int act,
                     PairStrides ps) {
  extern __shared__ float smem[];
  const int ho = h / 2, wo = wd / 2;
  const int rows = 2 * to + 2;
  const int cols = wd + 2;
  float* xs = smem;                          // [rows][cols][CI_CHUNK]
  float* ws = smem + rows * cols * CI_CHUNK;  // [16][CI_CHUNK][CO_TILE]

  const int band = blockIdx.x;
  const int cot = blockIdx.y;
  const int b = blockIdx.z % n, pair = blockIdx.z / n;  // z = pair * N + image
  x += pair * ps.x;
  w += pair * ps.w;
  y += pair * ps.y;
  scale = at_pair(scale, ps.aff, pair);
  offset = at_pair(offset, ps.aff, pair);
  const int tid = threadIdx.x;
  const int cg = tid % (CO_TILE / CH_PER_THREAD);
  const int pg = tid / (CO_TILE / CH_PER_THREAD);
  const int oy0 = band * to;
  const int iy0 = 2 * oy0 - 1;  // input row of staged row 0

  // This thread's pixels p = pg + 32*j of the band and their window
  // origins in the staged band.
  int xoff[PIX_PER_THREAD];
  bool pvalid[PIX_PER_THREAD];
#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j) {
    const int p = pg + PIX_GROUPS * j;
    const int oyl = p / wo, ox = p % wo;
    pvalid[j] = p < to * wo && oy0 + oyl < ho;
    xoff[j] = pvalid[j] ? ((2 * oyl) * cols + 2 * ox) * CI_CHUNK : 0;
  }

  float acc[PIX_PER_THREAD][CH_PER_THREAD];
#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j)
#pragma unroll
    for (int c = 0; c < CH_PER_THREAD; ++c) acc[j][c] = 0.f;

  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  for (int c0 = 0; c0 < ci; c0 += CI_CHUNK) {
    __syncthreads();
    const int x_elems = rows * cols * CI_CHUNK;
    for (int e = tid; e < x_elems; e += THREADS) {
      const int c = e % CI_CHUNK;
      const int col = (e / CI_CHUNK) % cols;
      const int row = e / (CI_CHUNK * cols);
      const int iy = iy0 + row, ix = col - 1;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = to_f32(xb[(static_cast<long long>(iy) * wd + ix) * ci + c0 + c]);
      }
      xs[e] = v;
    }
    for (int e = tid; e < 16 * CI_CHUNK * CO_TILE; e += THREADS) {
      const int o = e % CO_TILE;
      const int c = (e / CO_TILE) % CI_CHUNK;
      const int tap = e / (CO_TILE * CI_CHUNK);
      const int col = cot * CO_TILE + o;
      ws[e] = col < co ? to_f32(w[(static_cast<long long>(tap) * ci + c0 + c) * co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int kh = 0; kh < 4; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 4; ++kw) {
        const int tap_off = (kh * cols + kw) * CI_CHUNK;
        const float* wt = ws + (kh * 4 + kw) * CI_CHUNK * CO_TILE + cg * CH_PER_THREAD;
#pragma unroll
        for (int c = 0; c < CI_CHUNK; ++c) {
          float xv[PIX_PER_THREAD], wv[CH_PER_THREAD];
#pragma unroll
          for (int j = 0; j < PIX_PER_THREAD; ++j) xv[j] = xs[xoff[j] + tap_off + c];
#pragma unroll
          for (int q = 0; q < CH_PER_THREAD; ++q) wv[q] = wt[c * CO_TILE + q];
#pragma unroll
          for (int j = 0; j < PIX_PER_THREAD; ++j)
#pragma unroll
            for (int q = 0; q < CH_PER_THREAD; ++q) acc[j][q] = fmaf(xv[j], wv[q], acc[j][q]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PIX_PER_THREAD; ++j) {
    if (!pvalid[j]) continue;
    const int p = pg + PIX_GROUPS * j;
    const int oy = oy0 + p / wo, ox = p % wo;
    T* yp = y + ((static_cast<long long>(b) * ho + oy) * wo + ox) * co;
#pragma unroll
    for (int q = 0; q < CH_PER_THREAD; ++q) {
      const int col = cot * CO_TILE + cg * CH_PER_THREAD + q;
      if (col >= co) continue;
      float v = acc[j][q];
      if (scale != nullptr) v = v * scale[col] + offset[col];
      yp[col] = from_f32<T>(apply_act(v, act));
    }
  }
}

// Rows per band for a map Wo pixels wide: as many as fit 256 pixels.
int band_rows(int ho, int wo) {
  if (wo <= 0 || wo > MAX_PIX) return 0;
  int to = MAX_PIX / wo;
  return to < ho ? to : ho;
}

long long smem_bytes(int wd, int to) {
  return (static_cast<long long>(2 * to + 2) * (wd + 2) * CI_CHUNK + 16 * CI_CHUNK * CO_TILE) *
         static_cast<long long>(sizeof(float));
}

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

// rows > 0: the tensor-core path with `rows` output rows per block (the
// wrapper's tile plan); rows == 0: the FMA path. pairs, x_ps, w_ps, aff_ps:
// the pair axis (common.cuh), w_ps 0 for a shared weight; pair p's y
// starts N*HO*WO*CO values after pair 0's (the grid's z is pair * N +
// image).
extern "C" int discogan_halo_conv_k4s2p1(const void* x, const void* w, const void* scale,
                                         const void* offset, void* y, int n, int h, int wd,
                                         int ci, int co, int act, int dtype, int rows, int pairs,
                                         long long x_ps, long long w_ps, long long aff_ps,
                                         void* stream) {
  const int ho = h / 2, wo = wd / 2;
  if (pairs == 0) return 0;
  const int itemsize = dtype == DT_F32 ? 4 : 2;
  if (pairs < 1 || static_cast<long long>(pairs) * n > 65535 ||
      !pair_aligned(pairs, x_ps, itemsize) || !pair_aligned(pairs, w_ps, itemsize) ||
      !pair_aligned(pairs, aff_ps, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairStrides ps{x_ps, w_ps, static_cast<long long>(n) * ho * wo * co, aff_ps, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (rows > 0) {
    if (!tc::applies(dtype, ci, co)) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || ho == 0 || wo == 0) return 0;
    const dim3 grid(static_cast<unsigned>((co + tc::CO_TILE - 1) / tc::CO_TILE),
                    static_cast<unsigned>((wo + tc::STRIP - 1) / tc::STRIP *
                                          ((ho + rows - 1) / rows)),
                    static_cast<unsigned>(n * pairs));
    switch (ci / 16) {
      case 1: return tc::launch<1>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      case 2: return tc::launch<2>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      case 3: return tc::launch<3>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
      default: return tc::launch<4>(grid, s, x, w, sc, of, y, n, h, wd, co, rows, act, ps);
    }
  }
  const int to = band_rows(ho, wo);
  if (to <= 0 || ci % CI_CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || co == 0) return 0;
  const dim3 grid(static_cast<unsigned>((ho + to - 1) / to),
                  static_cast<unsigned>((co + CO_TILE - 1) / CO_TILE),
                  static_cast<unsigned>(n * pairs));
  const long long smem = smem_bytes(wd, to);
  cudaError_t err;
  if (dtype == DT_F32) {
    err = cudaFuncSetAttribute(halo_conv_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    halo_conv_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, of,
        static_cast<float*>(y), n, h, wd, ci, co, to, act, ps);
  } else {
    err = cudaFuncSetAttribute(halo_conv_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    halo_conv_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), sc, of,
        static_cast<__nv_bfloat16*>(y), n, h, wd, ci, co, to, act, ps);
  }
  return launch_status();
}
