// Adam: one optimizer step over many tensors in one launch.
//
// Replaces the per-tensor loop of train/optim.py (Adam._apply_plain), about
// twenty PyTorch elementwise kernels a tensor, with one pass that reads p,
// g, m and v once and writes p, m and v once. It writes that loop's bits:
//
//   g = g + wd * p;  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*(g*g)
//   p = p - (lr * (m / bc1)) / (sqrt(v / bc2) + eps)
//
// each operation rounded to f32 as PyTorch's kernel for it rounds, in the
// same order. nvcc contracts a*b + c into one FMA by default, which would
// round once where PyTorch rounds twice, so every step is an explicit
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn. The constants come from
// the host as the doubles PyTorch rounds against an f32 tensor, and are
// rounded to f32 here. Moments store in their dtype rounded to nearest
// even; a bf16 parameter stores by stochastic rounding: the f32 result's
// word plus 16 hashed bits, truncated (optim.stochastic_round_bf16 with
// optim.rounding_bits: murmur3's finalizer of index * golden + seed, in
// uint32 arithmetic).
//
// Bound on the H100: bytes (20 an element under f32 p and g with bf16
// moments). The layout:
// - Pointers in the arguments: every tensor's p, g, m, v, element count,
//   seed slot and shard arrive by value in one argument block, as
//   PyTorch's multi_tensor_apply passes them, so a launch captured in a
//   CUDA graph replays with nothing copied to the device. The block holds
//   at most MAX_TENSORS tensors under the 4 KB parameter limit; the
//   planner (ops/adam.py::adam_plan) splits a larger group into more
//   launches.
// - Balanced blocks: a block takes one chunk of `chunk` elements of one
//   tensor, so a 4.2M-element weight takes hundreds of blocks and a bias
//   one. The block finds its tensor by a binary search over the tensors'
//   first chunks.
// - Vector loads: from the first 16-byte boundary of p (`head` elements,
//   done one a thread by the tensor's first chunk), a thread takes 8
//   elements at a time with 16-byte loads and stores (two per f32
//   operand, one per bf16 operand) for each operand that is aligned there,
//   and 8 scalar accesses for one that is not (a gradient viewed at an
//   arbitrary offset of a flat buffer, parallel/dp.py); a chunk's last
//   elements past the vectors go one a thread.
// - Gradients in another order: a conv weight's gradient comes back dense
//   in the order of the permuted view the forward cast
//   (models/regions.py::materialize), with one channel dim contiguous and
//   the 16 taps outermost or in the middle. Such a tensor is walked by
//   (x, y) pairs of its two channel dims, y the gradient's contiguous one,
//   a pair's 16 taps contiguous in p, m and v. Four threads take a pair,
//   4 taps each: a quad reads its p, m and v run whole in 16-byte (f32) or
//   8-byte (bf16) accesses, and the warp's 8 pairs are 8 neighbouring y,
//   so each tap's gradient loads cover whole 32-byte sectors. Where p
//   keeps x contiguous (a conv's weight, y its output channel), the pairs
//   go in rows of 8 y with x fastest, so the block's warps take
//   neighbouring x and its p, m and v accesses form long runs.
// - Device scalars: bc1 and bc2 and each tensor's seed word are read from
//   the device tensors the step is given (with their strides: the chunk
//   table's words, train/chunk.py), so each replay takes that step's.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;            // elements a thread's vector step
constexpr int MAX_TENSORS = 52;   // tensors a launch (ops/adam.py)
constexpr int META = 13;          // ints a tensor in the entry's meta array
constexpr int TAPS = 16;          // a gathered pair's elements: a 4x4 kernel's taps
constexpr int Y_ROW = 8;          // y a row of a gathered walk: a 32-byte f32 sector of g

enum Aligned { AL_P = 1, AL_G = 2, AL_M = 4, AL_V = 8 };

struct AdamArgs {
  const float* bc;   // bc1 at 0, bc2 at bc_stride
  const int* seeds;  // tensor i's seed word at i * seed_stride
  int bc_stride, seed_stride;
  float lr, b1, omb1, b2, omb2, eps, wd;
  int decay, tensors, chunk;
  void* p[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  void* m[MAX_TENSORS];
  void* v[MAX_TENSORS];
  int n[MAX_TENSORS];
  int first[MAX_TENSORS + 1];  // each tensor's first chunk; then the grid's
  int meta[MAX_TENSORS];       // slot (its place in the optimizer: its seed) | head << 16
                               // | aligned << 20
  // A slice of a whole tensor (a mesh's model axis): its element e is
  // (e / block) * wstride + e % block + offset there; block 0: not a slice.
  int block[MAX_TENSORS], wstride[MAX_TENSORS], offset[MAX_TENSORS];
  // A gradient in another order, walked by pairs (x, y), q = x * ys + y:
  // tap t of the pair at x * px + y * py + t in p, m, v and at
  // x * gx + y + t * gt in g; ys 0: g in p's order.
  int ys[MAX_TENSORS], px[MAX_TENSORS], py[MAX_TENSORS], gx[MAX_TENSORS], gt[MAX_TENSORS];
};
static_assert(sizeof(AdamArgs) <= 4096, "the argument block exceeds the parameter limit");

struct Step {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
  int decay;
};

// One element's update in the plain loop's order; m and v in place, the
// new parameter in f32 returned.
__device__ __forceinline__ float update(float p, float g, float& m, float& v, const Step& s) {
  if (s.decay) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(s.lr, __fdiv_rn(m, s.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  return __fsub_rn(p, __fdiv_rn(num, den));
}

// The 16 rounding bits of element e (its index in the whole tensor).
__device__ __forceinline__ uint32_t rounding_bits(uint32_t e, uint32_t seed) {
  uint32_t h = e * 0x9E3779B1u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >> 16;
}

// The parameter's new value as stored: f32 as it is; bf16 stochastically
// rounded (its low word cleared, so the conversion is exact).
template <typename P>
__device__ __forceinline__ float finish(float q, uint32_t e, uint32_t seed) {
  if constexpr (sizeof(P) == 2) {
    return __uint_as_float((__float_as_uint(q) + rounding_bits(e, seed)) & 0xFFFF0000u);
  } else {
    return q;
  }
}

// 8 elements at a, as f32: 16-byte loads where `vec`, else one at a time.
template <typename T>
__device__ __forceinline__ void load8(const T* a, bool vec, float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const uint4* u = reinterpret_cast<const uint4*>(a);
      float lo[4], hi[4];
      Vec16<float>::unpack(u[0], lo);
      Vec16<float>::unpack(u[1], hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = lo[k], x[k + 4] = hi[k];
    } else {
      Vec16<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(a), x);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = to_f32(a[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* a, bool vec, const float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      uint4* u = reinterpret_cast<uint4*>(a);
      const float lo[4] = {x[0], x[1], x[2], x[3]}, hi[4] = {x[4], x[5], x[6], x[7]};
      u[0] = Vec16<float>::pack(lo);
      u[1] = Vec16<float>::pack(hi);
    } else {
      *reinterpret_cast<uint4*>(a) = Vec16<__nv_bfloat16>::pack(x);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = from_f32<T>(x[k]);
  }
}

// 4 elements at a as f32, and back: one 16-byte access in f32, one 8-byte
// access in bf16 (a aligned to it).
template <typename T>
__device__ __forceinline__ void load4(const T* a, float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    Vec16<float>::unpack(*reinterpret_cast<const uint4*>(a), x);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(a);
    const float2 lo = Vec16<__nv_bfloat16>::half(u.x), hi = Vec16<__nv_bfloat16>::half(u.y);
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* a, const float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(a) = Vec16<float>::pack(x);
  } else {
    *reinterpret_cast<uint2*>(a) = make_uint2(Vec16<__nv_bfloat16>::word(x[0], x[1]),
                                              Vec16<__nv_bfloat16>::word(x[2], x[3]));
  }
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ AdamArgs a) {
  const int c = static_cast<int>(blockIdx.x);
  int lo = 0, hi = a.tensors - 1;  // the last tensor whose first chunk is at or before c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.first[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int t = lo;
  P* p = static_cast<P*>(a.p[t]);
  const G* g = static_cast<const G*>(a.g[t]);
  M* m = static_cast<M*>(a.m[t]);
  M* v = static_cast<M*>(a.v[t]);
  const int n = a.n[t], head = a.meta[t] >> 16 & 0xF, aligned = a.meta[t] >> 20;
  const int block = a.block[t], wstride = a.wstride[t], offset = a.offset[t];
  const Step s{a.lr, a.b1, a.omb1, a.b2, a.omb2, a.eps, a.wd,
               __ldg(a.bc), __ldg(a.bc + a.bc_stride), a.decay};
  const uint32_t seed =
      sizeof(P) == 2
          ? static_cast<uint32_t>(__ldg(a.seeds + (a.meta[t] & 0xFFFF) * a.seed_stride))
          : 0u;
  auto where = [&](int e) -> uint32_t {
    return block == 0 ? static_cast<uint32_t>(e)
                      : static_cast<uint32_t>(e / block) * static_cast<uint32_t>(wstride) +
                            static_cast<uint32_t>(e % block) + static_cast<uint32_t>(offset);
  };
  const int j = c - a.first[t];
  if (a.ys[t] > 0) {
    // LANES threads a pair, 4 neighbouring taps each: a quad reads its
    // pair's p, m, v run whole, and a warp's 8 pairs read 8 neighbouring y
    // of each tap of g.
    constexpr int LANES = TAPS / 4, STEP = THREADS / LANES;
    const int ys = a.ys[t], px = a.px[t], py = a.py[t], gx = a.gx[t], gt = a.gt[t];
    const int pairs = n / TAPS, xs = pairs / ys;
    // Rows of `rows` neighbouring y, x fastest inside a row, where p keeps
    // x contiguous (px < py): a block's warps then take neighbouring x, so
    // its p, m, v accesses are runs of many pairs for each y; else y
    // fastest throughout (one row).
    const int rows = py > px ? min(ys, Y_ROW) : ys, row_pairs = rows * xs;
    const int per = a.chunk / TAPS;
    const int q1 = min(pairs, (j + 1) * per);
    const int h = static_cast<int>(threadIdx.x) % LANES * 4;
    for (int q0 = j * per + static_cast<int>(threadIdx.x) / LANES; q0 < q1; q0 += 2 * STEP) {
      float pv[2][4], gv[2][4], mv[2][4], vv[2][4];
      int e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q0 + u * STEP;
        if (q >= q1) break;
        const int r = q / row_pairs, in_row = q - r * row_pairs;
        const int w = min(rows, ys - r * rows);
        const int x = in_row / w, y = r * rows + in_row - x * w;
        e[u] = x * px + y * py + h;
        const G* gq = g + (x * gx + y + h * gt);
        load4(p + e[u], pv[u]);
        load4(m + e[u], mv[u]);
        load4(v + e[u], vv[u]);
#pragma unroll
        for (int k = 0; k < 4; ++k) gv[u][k] = to_f32(gq[k * gt]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (q0 + u * STEP >= q1) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pv[u][k] = finish<P>(update(pv[u][k], gv[u][k], mv[u][k], vv[u][k], s),
                               where(e[u] + k), seed);
        }
        store4(p + e[u], pv[u]);
        store4(m + e[u], mv[u]);
        store4(v + e[u], vv[u]);
      }
    }
    return;
  }
  auto one = [&](int e) {
    float mi = to_f32(m[e]), vi = to_f32(v[e]);
    const float q = update(to_f32(p[e]), to_f32(g[e]), mi, vi, s);
    p[e] = from_f32<P>(finish<P>(q, where(e), seed));
    m[e] = from_f32<M>(mi);
    v[e] = from_f32<M>(vi);
  };
  if (j == 0) {
    for (int e = threadIdx.x; e < head; e += THREADS) one(e);
  }
  const int start = head + j * a.chunk;
  const int end = min(n, start + a.chunk);
  const int vend = start + (end - start) / VEC * VEC;
  for (int e = start + static_cast<int>(threadIdx.x) * VEC; e < vend; e += THREADS * VEC) {
    float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
    load8(p + e, aligned & AL_P, pv);
    load8(g + e, aligned & AL_G, gv);
    load8(m + e, aligned & AL_M, mv);
    load8(v + e, aligned & AL_V, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      pv[k] = finish<P>(update(pv[k], gv[k], mv[k], vv[k], s), where(e + k), seed);
    }
    store8(p + e, aligned & AL_P, pv);
    store8(m + e, aligned & AL_M, mv);
    store8(v + e, aligned & AL_V, vv);
  }
  for (int e = vend + static_cast<int>(threadIdx.x); e < end; e += THREADS) one(e);
}

template <typename P, typename G, typename M>
int launch(const AdamArgs& a, int blocks, cudaStream_t s) {
  adam_kernel<P, G, M><<<blocks, THREADS, 0, s>>>(a);
  return launch_status();
}

template <typename P, typename G>
int launch_m(int m_dtype, const AdamArgs& a, int blocks, cudaStream_t s) {
  return m_dtype == DT_F32 ? launch<P, G, float>(a, blocks, s)
                           : launch<P, G, __nv_bfloat16>(a, blocks, s);
}

template <typename P>
int launch_g(int g_dtype, int m_dtype, const AdamArgs& a, int blocks, cudaStream_t s) {
  return g_dtype == DT_F32 ? launch_m<P, float>(m_dtype, a, blocks, s)
                           : launch_m<P, __nv_bfloat16>(m_dtype, a, blocks, s);
}

}  // namespace

// One launch over `tensors` tensors of one dtype group, as
// ops/adam.py::adam_plan lays them out. ptrs: p, g, m, v of each tensor;
// meta: META ints a tensor (numel, first chunk, seed slot, head, aligned,
// block, wstride, offset, ys, px, py, gx, gt). bc and seeds are device
// tensors read with their element strides. The plan is checked: chunks
// that cover every tensor's elements past its head exactly once (a
// gathered tensor's pairs), a head before p's 16-byte boundary, the
// operands marked aligned 16-byte aligned there, and a gathered tensor's
// offsets inside it.
extern "C" int discogan_adam(const long long* ptrs, const int* meta, int tensors, int chunk,
                             int blocks, const void* bc, long long bc_stride, const void* seeds,
                             long long seed_stride, double lr, double b1, double omb1, double b2,
                             double omb2, double eps, double wd, int decay, int p_dtype,
                             int g_dtype, int m_dtype, void* stream) {
  constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
  if (tensors < 1 || tensors > MAX_TENSORS || chunk < TAPS || chunk > (1 << 20) ||
      chunk % TAPS != 0 || blocks < 1 || bc == nullptr || seeds == nullptr || bc_stride < 1 ||
      seed_stride < 1 || bc_stride > (1 << 20) || seed_stride > (1 << 20)) {
    return BAD;
  }
  for (int dt : {p_dtype, g_dtype, m_dtype}) {
    if (dt != DT_F32 && dt != DT_BF16) return BAD;
  }
  const int sizes[4] = {p_dtype == DT_F32 ? 4 : 2, g_dtype == DT_F32 ? 4 : 2,
                        m_dtype == DT_F32 ? 4 : 2, m_dtype == DT_F32 ? 4 : 2};
  AdamArgs a{};
  a.bc = static_cast<const float*>(bc);
  a.seeds = static_cast<const int*>(seeds);
  a.bc_stride = static_cast<int>(bc_stride);
  a.seed_stride = static_cast<int>(seed_stride);
  a.lr = static_cast<float>(lr);
  a.b1 = static_cast<float>(b1);
  a.omb1 = static_cast<float>(omb1);
  a.b2 = static_cast<float>(b2);
  a.omb2 = static_cast<float>(omb2);
  a.eps = static_cast<float>(eps);
  a.wd = static_cast<float>(wd);
  a.decay = decay != 0;
  a.tensors = tensors;
  a.chunk = chunk;
  int next = 0;
  for (int t = 0; t < tensors; ++t) {
    const int* row = meta + META * t;
    const int n = row[0], first = row[1], slot = row[2], head = row[3], aligned = row[4];
    const int ys = row[8], px = row[9], py = row[10], gx = row[11], gt = row[12];
    if (n < 1 || n > (1 << 30) || first != next || slot < 0 || slot > 0xFFFF || head < 0 ||
        head >= VEC || head > n || aligned < 0 || aligned > 15 || row[5] < 0 || row[6] < 0 ||
        row[7] < 0 || ys < 0 || px < 0 || py < 0 || gx < 0 || gt < 0) {
      return BAD;
    }
    const long long* q = ptrs + 4 * t;
    if (q[0] == 0 || q[1] == 0 || q[2] == 0 || q[3] == 0) return BAD;
    for (int k = 0; k < 4; ++k) {
      if ((aligned >> k & 1) && (q[k] + static_cast<long long>(head) * sizes[k]) % 16 != 0) {
        return BAD;
      }
    }
    if (ys > 0) {
      // Whole pairs from p, m, v's 16-byte boundaries, every offset inside.
      const long long pairs = n / TAPS, xs = pairs / ys;
      if (n % TAPS != 0 || pairs % ys != 0 || head != 0 ||
          (aligned & (AL_P | AL_M | AL_V)) != (AL_P | AL_M | AL_V) || px % VEC != 0 ||
          py % VEC != 0 || (xs - 1) * px + (ys - 1LL) * py + TAPS > n ||
          (xs - 1) * gx + (ys - 1LL) + (TAPS - 1LL) * gt >= n) {
        return BAD;
      }
      next = first + static_cast<int>((n + chunk - 1) / chunk);
    } else {
      if ((q[0] + static_cast<long long>(head) * sizes[0]) % 16 != 0 && head != n) return BAD;
      const long long body = n - head;
      next = first + static_cast<int>(body > 0 ? (body + chunk - 1) / chunk : 1);
    }
    a.p[t] = reinterpret_cast<void*>(q[0]);
    a.g[t] = reinterpret_cast<const void*>(q[1]);
    a.m[t] = reinterpret_cast<void*>(q[2]);
    a.v[t] = reinterpret_cast<void*>(q[3]);
    a.n[t] = n;
    a.first[t] = first;
    a.meta[t] = slot | head << 16 | aligned << 20;
    a.block[t] = row[5];
    a.wstride[t] = row[6];
    a.offset[t] = row[7];
    a.ys[t] = ys;
    a.px[t] = px;
    a.py[t] = py;
    a.gx[t] = gx;
    a.gt[t] = gt;
  }
  if (next != blocks) return BAD;
  a.first[tensors] = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_dtype == DT_F32 ? launch_g<float>(g_dtype, m_dtype, a, blocks, s)
                           : launch_g<__nv_bfloat16>(g_dtype, m_dtype, a, blocks, s);
}
