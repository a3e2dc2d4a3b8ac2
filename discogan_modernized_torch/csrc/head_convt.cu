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
// Bound on the H100: bytes. At 512px, batch 8, it reads 67.1 MB of x and
// writes 12.6 MB of y (bf16) for 3.2 GFLOP of useful products, about 40
// flop/byte, far under the bf16 ridge of 295: 23.8 us at 3.35 TB/s. What
// counts is reading x once and writing y in whole lines.
//
// Two paths; the wrapper picks one by dtype and shape (ops/head.py::
// head_plan) and passes the plan's `rows` > 0 for the first:
// - bf16 with CI % 16 == 0, 16 <= CI <= 128 and 1 <= CO <= 8 (the head and
//   the stems' input gradient at every geometry): head_convt_mma_kernel on
//   the tensor cores, below (namespace tc).
// - everything else (f32, which --precision f32 and the f32 equivalence
//   step use, and other channel counts): head_convt_kernel, f32 FMA on the
//   CUDA cores. A block owns one input row i of one image, 256 columns
//   wide, and each thread one input position (i, j): it computes the four
//   output pixels the position's 3x3 neighbourhood feeds, for all CO
//   channels, in registers, from 16-channel chunks of rows i-1..i+1 staged
//   as f32 with an odd per-column pitch, and weights staged once as f32.
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

constexpr int THREADS = 256;  // input columns per block
constexpr int CC = 16;        // input channels staged per chunk
constexpr int PITCH = CC + 1;  // floats per staged column, odd against bank conflicts
constexpr int COLS = THREADS + 2;

template <typename T, int CO>
__global__ void __launch_bounds__(THREADS)
    head_convt_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int h,
                      int wd, int ci) {
  extern __shared__ float smem[];
  float* ws = smem;                 // [4][4][ci][CO], the HWIO weight as f32
  float* xs = smem + 16 * ci * CO;  // [3][COLS][PITCH]
  const int i = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * THREADS;
  const int j = j0 + threadIdx.x;
  for (int e = threadIdx.x; e < 16 * ci * CO; e += THREADS) ws[e] = to_f32(w[e]);

  float acc[2][2][CO];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[a][bb][o] = 0.f;

  const T* xb = x + static_cast<long long>(b) * h * wd * ci;
  for (int c0 = 0; c0 < ci; c0 += CC) {
    const int cc = min(CC, ci - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * COLS * CC; e += THREADS) {
      const int c = e % CC;
      const int col = (e / CC) % COLS;
      const int r = e / (CC * COLS);
      const int iy = i - 1 + r, ix = j0 - 1 + col;
      float v = 0.f;
      if (c < cc && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = to_f32(xb[(static_cast<long long>(iy) * wd + ix) * ci + c0 + c]);
      }
      xs[(r * COLS + col) * PITCH + c] = v;
    }
    __syncthreads();
    if (j >= wd) continue;
    for (int c = 0; c < cc; ++c) {
      float xv[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          xv[dy][dx] = xs[(dy * COLS + threadIdx.x + dx) * PITCH + c];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int kh = 3 - a - 2 * u, kw = 3 - bb - 2 * v;
              const float xval = xv[a + u][bb + v];
              const float* wt = ws + ((kh * 4 + kw) * ci + c0 + c) * CO;
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[a][bb][o] = fmaf(xval, wt[o], acc[a][bb][o]);
            }
    }
  }
  if (j >= wd) return;

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      T* yp = y + ((static_cast<long long>(b) * 2 * h + 2 * i + a) * 2 * wd + 2 * j + bb) * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) yp[o] = from_f32<T>(acc[a][bb][o]);
    }
}

template <typename T, int CO>
int launch(const void* x, const void* w, void* y, int n, int h, int wd, int ci,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((wd + THREADS - 1) / THREADS), static_cast<unsigned>(h),
                  static_cast<unsigned>(n));
  const int smem = (16 * ci * CO + 3 * COLS * PITCH) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_convt_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  head_convt_kernel<T, CO><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), h, wd, ci);
  return launch_status();
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int h, int wd, int ci, int co,
             cudaStream_t s) {
  switch (co) {
    case 1: return launch<T, 1>(x, w, y, n, h, wd, ci, s);
    case 2: return launch<T, 2>(x, w, y, n, h, wd, ci, s);
    case 3: return launch<T, 3>(x, w, y, n, h, wd, ci, s);
    case 4: return launch<T, 4>(x, w, y, n, h, wd, ci, s);
    case 5: return launch<T, 5>(x, w, y, n, h, wd, ci, s);
    case 6: return launch<T, 6>(x, w, y, n, h, wd, ci, s);
    case 7: return launch<T, 7>(x, w, y, n, h, wd, ci, s);
    case 8: return launch<T, 8>(x, w, y, n, h, wd, ci, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
                          bf16* __restrict__ y, int h, int wd, int co, int rows) {
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
           int h, int wd, int co, int rows) {
  const cudaError_t err =
      cudaFuncSetAttribute(head_convt_mma_kernel<KS, NP, AHEAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  head_convt_mma_kernel<KS, NP, AHEAD><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), h, wd, co,
      rows);
  return launch_status();
}

template <int KS>
int launch_ks(int np, int slots, dim3 grid, long long smem, cudaStream_t s, const void* x,
              const void* w, void* y, int h, int wd, int co, int rows) {
  if (np == 16)
    return slots == 5 ? launch<KS, 16, 2>(grid, smem, s, x, w, y, h, wd, co, rows)
                      : launch<KS, 16, 1>(grid, smem, s, x, w, y, h, wd, co, rows);
  return slots == 5 ? launch<KS, 32, 2>(grid, smem, s, x, w, y, h, wd, co, rows)
                    : launch<KS, 32, 1>(grid, smem, s, x, w, y, h, wd, co, rows);
}

}  // namespace tc

}  // namespace

// rows > 0: the tensor-core path with the wrapper's plan (bands of `rows`
// input rows, `strips` strips of 128 columns, a ring of `slots` rows,
// `smem` bytes), refused unless it covers every input row and column once
// and matches the kernel's own layout; rows == 0: the FMA path.
extern "C" int discogan_head_convt(const void* x, const void* w, void* y, int n, int h, int wd,
                                   int ci, int co, int dtype, int rows, int bands, int strips,
                                   int slots, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype != DT_BF16 || ci % 16 != 0 || ci < 16 || ci > tc::MAX_CI || co < 1 ||
        co > tc::MAX_CO || (slots != 4 && slots != 5) ||
        smem != tc::smem_bytes(ci, co, slots))
      return static_cast<int>(cudaErrorInvalidValue);
    if (static_cast<long long>(n) * h * wd == 0) return 0;
    const bool rows_once = static_cast<long long>(bands) * rows >= h &&
                           static_cast<long long>(bands - 1) * rows < h;
    if (!rows_once || strips != (wd + tc::STRIP - 1) / tc::STRIP)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(strips * bands), static_cast<unsigned>(n));
    const int np = tc::np_of(co);
    switch (ci / 16) {
      case 1: return tc::launch_ks<1>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 2: return tc::launch_ks<2>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 3: return tc::launch_ks<3>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 4: return tc::launch_ks<4>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 5: return tc::launch_ks<5>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 6: return tc::launch_ks<6>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      case 7: return tc::launch_ks<7>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
      default: return tc::launch_ks<8>(np, slots, grid, smem, s, x, w, y, h, wd, co, rows);
    }
  }
  if (static_cast<long long>(n) * h * wd == 0) return 0;
  if (dtype == DT_F32) return dispatch<float>(x, w, y, n, h, wd, ci, co, s);
  return dispatch<__nv_bfloat16>(x, w, y, n, h, wd, ci, co, s);
}
