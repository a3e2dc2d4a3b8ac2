// The wgmma weight gradient of the k4/s2/p1 conv, shared by K4
// (conv_k4s2p1_dw.cu: conv_dw_wgmma_kernel, enc2..enc6) and K5b
// (halo_conv_k4s2p1_dw.cu: halo_dw_wgmma_kernel, enc1 and dis1). Each file
// has its own __global__ entry around `body`, so a profile keeps the two
// apart by name.
//
// x (N,H,W,I) NHWC, dy (N,H/2,W/2,O), bf16, I % 8 == 0, O % 8 == 0;
// dw[kh,kw,i,o] = sum_{b,r,c} x_pad[b, 2r+kh, 2c+kw, i] * dy[b,r,c,o] with
// f32 accumulation: a GEMM whose contraction runs over the M = N*Ho*Wo
// output pixels. A tile is one kernel row kh (its four taps kw), 64 input
// channels and 128 output channels: a 256 x 128 slice of dw, 128 f32
// accumulators a thread over two warpgroups (taps kw 0, 1 and kw 2, 3). The
// contraction runs over chunks of 64 output pixels through a ring of
// shared-memory stages that cp.async fills two chunks ahead. Both wgmma
// operands are MN-major ("transposed"): x's tile is A, [pixel][64
// channels], and dy's is B, [pixel][128 o] as two 64-wide halves, in
// 128-byte rows with the 128-byte swizzle (wgmma.cuh), 8-pixel groups along
// the contraction. x is staged once per chunk for the four taps: where
// WO % 8 == 0, each 8-pixel group's input segment as two column-parity
// planes of 9 pixels, so tap kw's window is plane kw & 1 shifted by kw >> 1
// pixels (groups 1152 bytes apart: the descriptor's stride), the JAX
// kernels' column-pair view; elsewhere as the four taps' windows. wgmma
// m64n128k16 runs 8 times a chunk per warpgroup, one chunk's group in
// flight across the barrier that admits the next. The wrapper's plan
// (ops/conv_k4s2p1.py::dw_plan) splits M only while the tiles fill less
// than one wave of the card's SMs; split parts write f32 partials that a
// second pass sums in a fixed order (no float atomics: two launches give
// the same bits). Unsplit, one block per SM walks its tiles with the copies
// running ahead across tile boundaries, and a tile's epilogue (through a
// bf16 buffer, whole rows in 16-byte stores) overlaps the next tile's
// loads.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

// The plan's paths (ops/conv_k4s2p1.py::DW_PATH_CODES): the f32 FMA kernel,
// this kernel with parity planes (WO % 8 == 0) or per-tap windows, K4's stem.
enum DwPath { PATH_FMA = 0, PATH_PLANES = 1, PATH_WINDOWS = 2, PATH_STEM = 3 };

namespace dw_wgmma {

using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int THREADS = 256;        // two warpgroups: taps kw 0, 1 and kw 2, 3
constexpr int CH = 64;              // input channels of a tile: dw rows per tap
constexpr int BN = 128;             // output channels of a tile
constexpr int CHUNK = 64;           // output pixels a pipeline stage holds
constexpr int GROUPS = CHUNK / 8;   // 8-pixel groups of a chunk
constexpr int GROUP_PX = 9;         // plane pixels staged per group: 8 + the kw >= 2 shift
constexpr int PLANE_BYTES = GROUPS * GROUP_PX * 128;
constexpr int DY_BYTES = CHUNK * BN * 2;
constexpr int EPI_PITCH = BN + 8;   // bf16 epilogue row, in values (against bank conflicts)
constexpr int EPI_BYTES = 4 * CH * EPI_PITCH * 2;
constexpr int MAX_TILES = 64;       // tiles a block walks (the plan keeps to it)

// x bytes of a stage: two column-parity planes, or four per-tap windows.
template <bool PLANES>
__host__ __device__ constexpr int x_bytes() { return PLANES ? 2 * PLANE_BYTES : 4 * CHUNK * 128; }
template <bool PLANES>
__host__ __device__ constexpr int stage_bytes() { return x_bytes<PLANES>() + DY_BYTES; }
// Stages of the ring (as many as fit beside the epilogue's buffer); copies
// run stages - 2 chunks ahead.
template <bool PLANES>
__host__ __device__ constexpr int stages() { return PLANES ? 4 : 3; }
template <bool PLANES>
__host__ __device__ constexpr int smem_bytes() {
  return stages<PLANES>() * stage_bytes<PLANES>() + EPI_BYTES + MAX_TILES * 16;
}
// A tile is kernel row kh, input channels ci0 .. ci0+63, output channels
// o0 .. o0+127 and one part of the split contraction: tile index
// ((split * Y + y) * X + x), x the o tile, y = 4 * (channel block) + kh.
// Block b takes tiles b, b + gridDim.x, ... (one tile where M is split);
// its work is the sequence of (tile, chunk) items, which the copies walk
// ahead of the wgmmas across tile boundaries, so a tile's epilogue runs
// while the next tile's first chunks land. Warpgroup g accumulates taps
// kw = 2g, 2g + 1, each a 64 (channel) x 128 (o) f32 tile in registers.
// Run by THREADS threads, one block an SM, with smem_bytes<PLANES>() of
// dynamic shared memory.
template <bool PLANES>
__device__ __forceinline__ void body(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                     bf16* __restrict__ dw, float* __restrict__ partial, int n,
                                     int h, int wd, int ci, int co, int splits,
                                     int steps_per_split) {
  constexpr int STAGE = stage_bytes<PLANES>(), XB = x_bytes<PLANES>(), STAGES = stages<PLANES>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* epi = smem + STAGES * STAGE;
  int4* tab = reinterpret_cast<int4*>(epi + EPI_BYTES);  // this block's tiles
  const int ho = h / 2, wo = wd / 2, hw = ho * wo;
  const int m_total = n * hw;
  const int x_tiles = (co + BN - 1) / BN, y_tiles = (ci + CH - 1) / CH * 4;
  const int tiles = x_tiles * y_tiles * splits;
  const int chunks = (m_total + CHUNK - 1) / CHUNK;
  // chunks per tile: all of M, or this block's one part of the split
  const int nch = splits > 1 ? min(steps_per_split, chunks - (blockIdx.x / (x_tiles * y_tiles)) *
                                                            steps_per_split)
                             : chunks;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int items = my_tiles * nch;
  const int tid = threadIdx.x, g = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  // Tile k of this block: {o0, ci0, kh, split}.
  if (tid < my_tiles) {
    const int tile = blockIdx.x + tid * gridDim.x;
    const int xt = tile % x_tiles, rest = tile / x_tiles, yt = rest % y_tiles;
    tab[tid] = make_int4(xt * BN, (yt >> 2) * CH, yt & 3, rest / y_tiles);
  }
  __syncthreads();

  // Copy the next item (chunk cur_t of tile cur_k, the cur_q-th item) into
  // its ring slot, if `go`; zero-filled past M, past the map's edges (the
  // padding), past CI and past CO. Each thread's copies keep their place
  // in every chunk, so their shared-memory offsets are fixed here and an
  // item costs one pixel decomposition. Unrolled and predicated: it runs while
  // wgmmas are in flight. Every stage starts on a 1024-byte boundary, so a
  // unit's swizzle depends on its offset in the stage alone.
  // dy: 64 pixels x 128 channels as two 64-channel halves of 64 rows; this
  // thread copies 16 bytes at channel o0 + dy_o of pixels dy_px + 16i.
  const int dy_px = tid >> 4, dy_o = ((tid >> 3) & 1) * 64 + (tid & 7) * 8;
  const uint32_t dy_soff =
      XB + (((tid >> 3) & 1) * CHUNK + dy_px) * 128 + ((tid & 7) ^ (dy_px & 7)) * 16;
  // x, parity planes: warp w copies group w (pixels 8w .. 8w+7 of the
  // chunk), lane: channel chunk lane % 8 of columns lane / 8 + 4k; windows:
  // pixel tid / 4, channel chunks tid % 4 and tid % 4 + 4, the four taps.
  constexpr int XU = PLANES ? 5 : 2;
  const int xw = tid >> 5, xu = PLANES ? (lane & 7) : (tid & 3), xpx = tid >> 2;
  uint32_t x_soff[XU];
#pragma unroll
  for (int k = 0; k < XU; ++k) {
    if constexpr (PLANES) {
      const int j = (lane >> 3) + 4 * k, row = (j & 1) * GROUPS * GROUP_PX + xw * GROUP_PX + (j >> 1);
      x_soff[k] = (row * 8 + (xu ^ (row & 7))) * 16;
    } else {
      x_soff[k] = (xpx * 8 + ((xu + 4 * k) ^ (xpx & 7))) * 16;
    }
  }
  int cur_q = 0, cur_k = 0, cur_t = 0;
  auto stage = [&](bool go) {
    const int4 tl = tab[min(cur_k, my_tiles - 1)];  // .x o0, .y ci0, .z kh, .w split
    const int c = tl.w * steps_per_split + cur_t;
    const uint32_t slot = sbase + (cur_q % STAGES) * STAGE;
    ++cur_q;
    ++cur_t;
    const bool wrap = cur_t == nch;
    cur_t = wrap ? 0 : cur_t;
    cur_k += wrap;
    const bf16* dy_src = dy + static_cast<long long>(c * CHUNK + dy_px) * co + tl.x + dy_o;
#pragma unroll
    for (int i = 0; i < CHUNK * BN / 8 / THREADS; ++i) {
      const bool ok = (c * CHUNK + dy_px + 16 * i < m_total) & (tl.x + dy_o < co);
      cp_async16(slot + dy_soff + i * 16 * 128, ok ? dy_src + 16LL * i * co : dy, ok, go);
    }
    const int m = c * CHUNK + (PLANES ? 8 * xw : xpx);
    const int b = m / hw, r = m - b * hw, oy = r / wo, ox = r - oy * wo;
    const int iy = 2 * oy - 1 + tl.z, ix0 = 2 * ox - 1;
    const bool row_ok = (m < m_total) & (iy >= 0) & (iy < h);
    const bf16* xrow = x + ((static_cast<long long>(b) * h + iy) * wd + ix0) * ci + tl.y;
    if constexpr (PLANES) {
      // input row 2oy - 1 + kh, columns 2ox - 1 .. 2ox + 16 of the group,
      // as two column-parity planes of 9 pixels: [plane][group][9 pixels]
#pragma unroll
      for (int k2 = 0; k2 < XU; ++k2) {
        const int j = (lane >> 3) + 4 * k2;
        const bool ok = row_ok & (j < 2 * GROUP_PX) & (ix0 + j >= 0) & (ix0 + j < wd) &
                        (tl.y + xu * 8 < ci);
        cp_async16(slot + x_soff[k2], ok ? xrow + j * ci + xu * 8 : x, ok,
                   go & (j < 2 * GROUP_PX));
      }
    } else {
      // the four taps' windows, [kw][64 pixels]
#pragma unroll
      for (int kw = 0; kw < 4; ++kw)
#pragma unroll
        for (int k2 = 0; k2 < XU; ++k2) {
          const int u = xu + 4 * k2;
          const bool ok = row_ok & (ix0 + kw >= 0) & (ix0 + kw < wd) & (tl.y + u * 8 < ci);
          cp_async16(slot + x_soff[k2] + kw * CHUNK * 128, ok ? xrow + kw * ci + u * 8 : x, ok,
                     go);
        }
    }
  };

  float acc[2][64];  // set by each tile's first wgmmas (scale-d 0)
#pragma unroll
  for (int q = 0; q < STAGES - 2; ++q) {
    stage(q < items);
    cp_async_commit();
  }
  const long long ko = 16LL * ci * co;
#pragma unroll 1
  for (int k = 0; k < my_tiles; ++k) {
    // Item q: its copies landed (this thread's, then everyone's at the
    // barrier, which also sees every warpgroup past item q - 2's wgmmas);
    // its wgmmas issued; item q + STAGES - 2 copied into item q - 2's slot;
    // then wait until only item q's wgmmas are in flight.
#pragma unroll 1
    for (int t = 0; t < nch; ++t) {
      const int q = k * nch + t;
      cp_async_wait<STAGES - 3>();
      __syncthreads();
      const uint32_t slot = sbase + (q % STAGES) * STAGE;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < CHUNK / 16; ++s) {
        // B: dy pixels 16s .. 16s+15, the halves 8192 bytes apart.
        const uint64_t desc_b = sw128_desc(slot + XB + s * 16 * 128, CHUNK * 128, 1024);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // A: tap kw = 2g + j at pixels 16s .. 16s+15. Parity planes:
          // plane j, groups 2s and 2s+1 (9 pixels apart), shifted by g
          // pixels.
          const uint32_t a = PLANES ? slot + j * PLANE_BYTES + (2 * s * GROUP_PX + g) * 128
                                    : slot + ((2 * g + j) * CHUNK + 16 * s) * 128;
          wgmma_m64n128k16<1>(acc[j], sw128_desc(a, 8192, PLANES ? GROUP_PX * 128 : 1024),
                              desc_b, (t | s) != 0);
        }
      }
      wgmma_commit();
      stage(q + STAGES - 2 < items);
      cp_async_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 64; ++e) keep(acc[j][e]);

    // The tile's epilogue. acc[j][4 nt + 2 hf + e]: channel 16 warp +
    // lane/4 + 8 hf of tap kw = 2g + j, o 8 nt + 2 (lane % 4) + e. A split
    // part stores f32 pairs from the registers (a quad writes one 32-byte
    // sector); dw goes through shared memory as bf16 pairs and out in
    // 16-byte stores of whole rows.
    const int4 tl = tab[k];
    if (partial != nullptr) {
      float* part = partial + tl.w * ko;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int ch = tl.y + 16 * warp + (lane >> 2) + 8 * hf;
          float* prow = part + (static_cast<long long>(tl.z * 4 + 2 * g + j) * ci + ch) * co;
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
            const int o = tl.x + 8 * nt + 2 * (lane & 3);
            if (ch < ci && o < co)
              *reinterpret_cast<float2*>(prow + o) =
                  make_float2(acc[j][4 * nt + 2 * hf], acc[j][4 * nt + 2 * hf + 1]);
          }
        }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = (2 * g + j) * CH + 16 * warp + (lane >> 2) + 8 * hf;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
          *reinterpret_cast<uint32_t*>(epi + (row * EPI_PITCH + 8 * nt + 2 * (lane & 3)) * 2) =
              pack_bf16x2(acc[j][4 * nt + 2 * hf], acc[j][4 * nt + 2 * hf + 1]);
      }
    __syncthreads();
    constexpr int UNITS = BN / 8;  // 16-byte units of a row
    for (int e = tid; e < 4 * CH * UNITS; e += THREADS) {
      const int row = e / UNITS, u = e - row * UNITS;
      const int ch = tl.y + row % CH, o = tl.x + u * 8;
      if (ch >= ci || o >= co) continue;
      *reinterpret_cast<uint4*>(dw + (static_cast<long long>(tl.z * 4 + row / CH) * ci + ch) * co +
                                o) =
          *reinterpret_cast<const uint4*>(epi + (row * EPI_PITCH + u * 8) * 2);
    }
    // The next tile's epilogue writes this buffer after the barrier of its
    // first chunk.
  }
  cp_async_wait();
}

// A __global__ entry around body<PLANES>.
using Kernel = void (*)(const bf16*, const bf16*, bf16*, float*, int, int, int, int, int, int,
                        int);

// Launches `kernel` under the wrapper's plan after checking it: the shape is
// the kernel's (CI and CO multiples of 8, WO % 8 == 0 for the planes, M
// under 2^31), the parts cover M's chunks exactly once, a split launches one
// block a tile and an unsplit grid walks at most MAX_TILES tiles a block, and
// the shared memory holds the ring. `partial`: splits x 16*CI*CO f32, or
// null where M is not split.
template <bool PLANES>
int launch(Kernel kernel, int blocks, int smem, cudaStream_t s, const void* x, const void* dy,
           void* dw, float* partial, int n, int h, int wd, int ci, int co, int splits,
           int steps_per_split) {
  const long long m = static_cast<long long>(n) * (h / 2) * (wd / 2);
  const int tiles = (co + BN - 1) / BN * ((ci + CH - 1) / CH * 4) * splits;
  if (ci % 8 || co % 8 || (PLANES && (wd / 2) % 8) || m >= (1LL << 31) ||
      !covers_once((m + CHUNK - 1) / CHUNK, splits, steps_per_split) || blocks < 1 ||
      blocks > tiles || (splits > 1 && blocks != tiles) ||
      (tiles + blocks - 1) / blocks > MAX_TILES || smem < smem_bytes<PLANES>())
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, THREADS, smem, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                                       static_cast<bf16*>(dw), partial, n, h, wd, ci, co, splits,
                                       steps_per_split);
  return launch_status();
}

}  // namespace dw_wgmma
