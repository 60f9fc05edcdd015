// The fused ring allreduce / reduce-scatter / all-gather over the virtual
// ranks of one card (Hopper, sm_90a): a dense ring (float32, bfloat16, int32),
// its gather-only mode, and an int8 ring.
//
// Replaces the TPU kernel mlsl_tpu/ops/ring_kernels.py:698 (_ring_call), in
// its dense form (B3, body _ring_kernel_factory :473), its gather-only form
// (B3-AG, mode="all_gather", the hops from base = 0 at :649) and its
// quantized form (B4, bodies quant_ring_body :885 and _quantize_rows :463).
//
// On the TPU each member is a chip and every hop is a remote DMA between
// them. Here every member is a row of one world buffer (W, ld) on one card,
// addressed through `ring`, a (C, G) table of world ranks in ring order. The
// G-1 reduce-scatter hops become a loop over the members inside one thread
// (dense) or one warp (int8), in the TPU kernel's order, and the all-gather,
// which only copies, becomes G stores of the owner's value:
//
//   chunk i of an instance starts at ring member i+sign with its chunk i and
//   members i+2*sign, ..., i+G*sign = i each add theirs: acc = got + loc.
//   sign = +1, or -1 for the elements from `split` on (the bidirectional
//   variant's second half of the rows).
//
// Ring chunk i is logical chunk chunk_of[i] (the identity, or the snake
// permutation of a 2-D group). Both kernels write the logical layout: for an
// allreduce out is (W, count) and every member receives every chunk; for a
// reduce_scatter out is (W, rc) and ring member i receives ring chunk i.
//
// Bound: memory traffic. Each input element is read once and each output
// element written once; the arithmetic is one add (dense) or a few operations
// of the int8 codec (int8) per element and hop. No slot buffers, semaphores or
// handshakes: nothing is in flight between members.
//
// The dense ring (B3) is bound by how many bytes are in flight. A thread
// owns 16-byte vectors of a chunk (4 float32 or int32, 8 bfloat16) where the
// addresses allow it, grid-stride, with a scalar head and tail in the same
// kernel. For G = 2, 4 and 8 the hop loop is unrolled at compile time and
// every member's vector of kRingLoads / G vectors is loaded before the
// first add, so 8 x 16 bytes a thread are in flight (one 4-byte load at a
// time, each behind a ring-table load and a `%`, reaches about half the
// bound); other group sizes load eight members at a time. The block reads
// its instance's ring row once into shared memory as row offsets in hop
// order. Each byte is touched once, so the stores stream (__stcs). The sum
// is the same hop chain as the plain version's, bit for bit.
//
// The int8 ring (B4): a warp owns one block row, its lanes hold the row's
// partial in registers across all hops (lane l has elements l, l+32, ...),
// so a hop costs one coalesced row load and a five-step shuffle for max|x|,
// and nothing is written until the end.
//
// The all-gather (B3-AG) is the ZeRO-1 increment exchange: each member brings
// only its own shard of rc elements and ends with all G shards in group-
// position order, (G*rc,). On the TPU the shards travel G-1 hops; here the
// owner at ring slot i is read once and its element stored into every
// member's row at chunk_of[i] * rc (chunk_of undoes the snake permutation, as
// ring_kernels.py:858-866 does). No arithmetic: the kernel moves bit patterns
// (4 or 2 bytes), so it is bit-exact, -0.0 and NaN payloads included. Bound:
// memory traffic, G*rc elements read and G*G*rc written an instance; one
// thread per (instance, owner, element), coalesced loads and G coalesced
// stores.
//
// Numerics, bit-exact against the plain PyTorch version:
// - dense: the accumulator has the buffer's type. bfloat16 adds in float32
//   and rounds to bfloat16 after every hop; int32 wraps (unsigned adds).
// - int8: per hop acc = dequant(quant(acc)) + loc with B1's arithmetic:
//   scale = amax / 127 (__fdiv_rn) or 1 where amax == 0, q = clamp(rintf(
//   x / scale), -127, 127) as an integer (so no -0.0 survives, as in int8),
//   dequant = __fmul_rn(q, scale), then __fadd_rn.
//   The explicit roundings keep nvcc from contracting a multiply-add. Build
//   without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerCta = 8;

__device__ __forceinline__ int wrap(int v, int g) {
  v %= g;
  return v < 0 ? v + g : v;
}

template <typename T>
struct Add;

template <>
struct Add<float> {
  static __device__ __forceinline__ float apply(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Add<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <>
struct Add<int32_t> {
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  }
};

// B3's launch shape, each measured against its neighbours in one H100 call:
// 256 threads a block; 8 member values in flight a thread before its first
// add (fixed group sizes); blocks of all (instance, ring chunk) columns
// together 8 a SM (sizing the grid to whole waves of resident blocks by the
// occupancy API measured no faster). Each byte is touched once: plain loads
// with streaming (__stcs) stores measured best (reduce_scatter at
// 8 x 32 Mi float32, G = 4: 0.4477 ms against 0.4617 with __ldcs loads and
// 0.4832 with __ldcs loads and plain stores; ld.global.nc.L1::no_allocate
// and an L2::256B prefetch hint were no faster).
constexpr int kRingThreads = 256;
constexpr int kRingLoads = 8;
constexpr int kRingBlocksPerSm = 8;

constexpr int kMaxGroup = 64;   // ops/ring_kernels.py MAX_GROUP

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<2> { using type = unsigned short; };

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using R = typename RawOf<sizeof(T) * VEC>::type;
  Pack<T, VEC> out;
  *reinterpret_cast<R*>(&out) = *reinterpret_cast<const R*>(p);
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  using R = typename RawOf<sizeof(T) * VEC>::type;
  __stcs(reinterpret_cast<R*>(p), *reinterpret_cast<const R*>(&v));
}

template <typename T, int VEC>
__device__ __forceinline__ void add_into(Pack<T, VEC>& acc, const Pack<T, VEC>& b) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc.v[k] = Add<T>::apply(acc.v[k], b.v[k]);
}

// The ring sum at element offset e of one chunk, any group size: the members'
// values in hop order (row offsets src[0..g)), loaded eight at a time into
// registers, then added in order.
template <typename T, int W>
__device__ __forceinline__ Pack<T, W> ring_sum_batched(const T* __restrict__ x,
                                                       const long long* src, int g,
                                                       long long e) {
  Pack<T, W> acc;
  for (int s0 = 0; s0 < g; s0 += 8) {
    Pack<T, W> val[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (s0 + k < g) val[k] = load_pack<T, W>(x + src[s0 + k] + e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (s0 + k < g) {
        if (s0 + k == 0) acc = val[k];
        else add_into(acc, val[k]);
      }
    }
  }
  return acc;
}

// B3: one block column per (instance, ring chunk i) pair (blockIdx.y); the
// blocks of a column stride over the chunk's elements. Logical element
// idx = chunk_of[i] * rc + e; elements past `count` are the last chunk's zero
// padding and are neither read nor written (they only pad reduce_scatter,
// whose count is G * rc).
//
// The instance's ring row is read once a block into shared memory as row
// offsets in hop order, both directions (hop[0][s]: member i+1+s, hop[1][s]:
// member i-1-s), so no table load and no `%` stand on the path of a data
// load. VEC elements (16 bytes) a load where the addresses allow it, with a
// scalar head and tail per direction segment; G = 2, 4 or 8 is fixed at
// compile time, every member load of U = kRingLoads / G vectors is in
// flight before the first add; G = 0 is any group size (batches of eight).
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kRingThreads)
dense_ring_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ ring,
                  const int* __restrict__ chunk_of, int g_rt, long long ld, long long rc,
                  long long count, long long split, int rs) {
  const int g = G > 0 ? G : g_rt;
  const int i = blockIdx.y % g;
  const int* rr = ring + static_cast<long long>(blockIdx.y / g) * g;
  const long long base = static_cast<long long>(chunk_of[i]) * rc;
  const long long end = rs ? rc : min(rc, count - base);
  __shared__ long long hop[2][kMaxGroup];
  __shared__ long long dst[kMaxGroup];
  if (end <= 0) return;
  const int nd = rs ? 1 : g;
  for (int s = threadIdx.x; s < g; s += blockDim.x) {
    hop[0][s] = static_cast<long long>(rr[wrap(i + 1 + s, g)]) * ld + base;
    hop[1][s] = static_cast<long long>(rr[wrap(i - 1 - s, g)]) * ld + base;
    // reduce_scatter: ring member i's (W, rc) row; allreduce: every member's
    // (W, count) row at the chunk's logical place
    dst[s] = rs ? static_cast<long long>(rr[i]) * rc
                : static_cast<long long>(rr[s]) * count + base;
  }
  __syncthreads();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int d = 0; d < 2; ++d) {
    // sign +1 below split, -1 from split on (split is a multiple of 1024)
    const long long lo = d ? split : 0, hi = d ? end : min(split, end);
    if (lo >= hi) continue;
    const long long* src = hop[d];
    // [lo, a): scalar head up to the first 16-byte aligned element; [a, b):
    // whole vectors; [b, hi): scalar tail
    const long long a = min(hi, lo + (VEC - (base + lo) % VEC) % VEC);
    const long long nv = (hi - a) / VEC;
    const long long b = a + nv * VEC;
    if (VEC > 1 && blockIdx.x == 0) {
      const long long head = a - lo;   // fewer than VEC elements each
      const long long t = threadIdx.x;
      if (t < head + (hi - b)) {
        const long long e = t < head ? lo + t : b + (t - head);
        const Pack<T, 1> acc = ring_sum_batched<T, 1>(x, src, g, e);
        for (int m = 0; m < nd; ++m) store_pack<T, 1>(out + dst[m] + e, acc);
      }
    }
    if constexpr (G > 0) {
      constexpr int U = kRingLoads / G > 0 ? kRingLoads / G : 1;
      long long off[G], od[G];
#pragma unroll
      for (int s = 0; s < G; ++s) {
        off[s] = src[s];
        od[s] = dst[s];
      }
      for (long long v = tid; v < nv; v += U * stride) {
        Pack<T, VEC> val[U][G];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v + u * stride < nv) {
            const long long e = a + (v + u * stride) * VEC;
#pragma unroll
            for (int s = 0; s < G; ++s) val[u][s] = load_pack<T, VEC>(x + off[s] + e);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v + u * stride < nv) {
            const long long e = a + (v + u * stride) * VEC;
            Pack<T, VEC> acc = val[u][0];
#pragma unroll
            for (int s = 1; s < G; ++s) add_into(acc, val[u][s]);
#pragma unroll
            for (int m = 0; m < G; ++m)
              if (m < nd) store_pack<T, VEC>(out + od[m] + e, acc);
          }
        }
      }
    } else {
      for (long long v = tid; v < nv; v += stride) {
        const long long e = a + v * VEC;
        const Pack<T, VEC> acc = ring_sum_batched<T, VEC>(x, src, g, e);
        for (int m = 0; m < nd; ++m) store_pack<T, VEC>(out + dst[m] + e, acc);
      }
    }
  }
}

// grid: x over the rc elements of a shard, y over the C*G (instance, owner's
// ring slot i) pairs. T is an unsigned integer of the element's width: the
// kernel copies bits.
template <typename T>
__global__ void dense_gather_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    const int* __restrict__ ring,
                                    const int* __restrict__ chunk_of, int G, long long ld,
                                    long long rc) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rc) return;
  const int i = blockIdx.y % G;
  const int* rr = ring + static_cast<long long>(blockIdx.y / G) * G;
  const T v = x[static_cast<long long>(rr[i]) * ld + e];
  const long long width = static_cast<long long>(G) * rc;
  const long long off = static_cast<long long>(chunk_of[i]) * rc + e;
  for (int m = 0; m < G; ++m) out[static_cast<long long>(rr[m]) * width + off] = v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dequant(quant(v)) of a whole block row held by one warp, MAXV values a lane
// of which the first nv are live.
template <int MAXV>
__device__ __forceinline__ void qdq_row(float (&v)[MAXV], int nv) {
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXV; ++k)
    if (k < nv) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_max(amax);
  const float scale = (amax == 0.0f) ? 1.0f : __fdiv_rn(amax, 127.0f);
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < nv) {
      // through an integer, as int8 is: a value that rounds to -0.0 comes
      // back as +0.0
      const int q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[k], scale)), -127.0f), 127.0f));
      v[k] = __fmul_rn(static_cast<float>(q), scale);
    }
  }
}

// One warp per (instance, ring chunk i, block row r). x is the padded ring
// layout: member row p holds G chunks of rows*block elements, logical chunk j
// at [j*chunk, j*chunk + rc). Rows r >= ra walk the other direction.
template <int MAXV>
__global__ void quant_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  const int* __restrict__ ring, int C, int G, long long ld,
                                  int rows, int block, int ra, long long rc, long long count,
                                  int rs) {
  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(C) * G * rows) return;
  const int r = static_cast<int>(warp % rows);
  const long long ci = warp / rows;
  const int i = static_cast<int>(ci % G);
  const int* rr = ring + (ci / G) * G;
  const int sign = r >= ra ? -1 : 1;
  const int nv = block >> 5;
  const long long chunk = static_cast<long long>(rows) * block;
  const long long off = i * chunk + static_cast<long long>(r) * block + lane;

  float acc[MAXV];
  {
    const float* src = x + static_cast<long long>(rr[wrap(i + sign, G)]) * ld + off;
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
      if (k < nv) acc[k] = src[k * 32];
  }
  for (int s = 2; s <= G; ++s) {
    qdq_row<MAXV>(acc, nv);
    const float* src = x + static_cast<long long>(rr[wrap(i + sign * s, G)]) * ld + off;
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
      if (k < nv) acc[k] = __fadd_rn(acc[k], src[k * 32]);
  }
  const long long e0 = static_cast<long long>(r) * block + lane;   // offset in the chunk
  if (rs) {
    float* dst = out + static_cast<long long>(rr[i]) * rc;
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
      if (k < nv && e0 + k * 32 < rc) dst[e0 + k * 32] = acc[k];
    return;
  }
  qdq_row<MAXV>(acc, nv);   // the all-gather's one quantization of the owner's chunk
  const long long base = i * rc;   // logical chunk i starts here
  for (int m = 0; m < G; ++m) {
    float* dst = out + static_cast<long long>(rr[m]) * count + base;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const long long e = e0 + k * 32;
      if (k < nv && e < rc && base + e < count) dst[e] = acc[k];
    }
  }
}

template <typename T, int VEC, int G>
int launch_dense_as(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                    int g, long long ld, long long rc, long long count, long long split, int rs,
                    int sms, cudaStream_t stream) {
  constexpr int U = G > 0 && kRingLoads / G > 0 ? kRingLoads / G : 1;
  const long long pairs = static_cast<long long>(C) * g;
  const long long per_block = static_cast<long long>(kRingThreads) * U;
  const long long want = (rc / VEC + per_block - 1) / per_block;
  const long long cap = (static_cast<long long>(sms) * kRingBlocksPerSm +
                         pairs - 1) / pairs;
  const dim3 grid(static_cast<unsigned int>(want < 1 ? 1 : (want < cap ? want : cap)),
                  static_cast<unsigned int>(pairs));
  dense_ring_kernel<T, VEC, G><<<grid, kRingThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(ring),
      static_cast<const int*>(chunk_of), g, ld, rc, count, split, rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_dense_vec(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                     int G, long long ld, long long rc, long long count, long long split,
                     int rs, int sms, cudaStream_t stream) {
  switch (G) {
    case 2:
      return launch_dense_as<T, VEC, 2>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs,
                                        sms, stream);
    case 4:
      return launch_dense_as<T, VEC, 4>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs,
                                        sms, stream);
    case 8:
      return launch_dense_as<T, VEC, 8>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs,
                                        sms, stream);
    default:
      return launch_dense_as<T, VEC, 0>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs,
                                        sms, stream);
  }
}

// 16-byte accesses when both base pointers are 16-byte aligned, the row
// stride keeps every member row aligned and the output rows are whole
// vectors (reduce_scatter: rc; allreduce: count); else one element a load.
template <typename T>
int launch_dense(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                 int G, long long ld, long long rc, long long count, long long split, int rs,
                 cudaStream_t stream) {
  if (rc <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 2 || G > kMaxGroup || split % 1024 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the current device's SM count sizes the grid; queried each launch
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && ld % kVec == 0 &&
                   (rs ? rc : count) % kVec == 0;
  if (vec)
    return launch_dense_vec<T, kVec>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs,
                                     sms, stream);
  return launch_dense_vec<T, 1>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs, sms,
                                stream);
}

template <typename T>
int launch_gather(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                  int G, long long ld, long long rc, cudaStream_t stream) {
  if (rc <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned int>((rc + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(C * G));
  dense_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(ring),
      static_cast<const int*>(chunk_of), G, ld, rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (W, >= count) rows of stride ld, dtype 0 = float32, 1 = bfloat16,
// 2 = int32; ring: (C, G) int32 world ranks in ring order; chunk_of: (G,)
// int32. out: (W, rc) when rs, else (W, count). Returns cudaGetLastError()
// after the launch (0 = launched).
int mlsl_dense_ring(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                    int G, long long ld, long long rc, long long count, long long split,
                    int rs, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dense<float>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs, s);
    case 1:
      return launch_dense<__nv_bfloat16>(x, out, ring, chunk_of, C, G, ld, rc, count, split,
                                         rs, s);
    case 2:
      return launch_dense<int32_t>(x, out, ring, chunk_of, C, G, ld, rc, count, split, rs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The all-gather (B3-AG). x: (W, >= rc) rows of stride ld, dtype as above;
// ring: (C, G) int32 world ranks in ring order; chunk_of: (G,) int32 group
// position of ring slot i. out: (W, G*rc), contiguous.
int mlsl_dense_ring_gather(const void* x, void* out, const void* ring, const void* chunk_of,
                           int C, int G, long long ld, long long rc, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
    case 2:
      return launch_gather<uint32_t>(x, out, ring, chunk_of, C, G, ld, rc, s);
    case 1:
      return launch_gather<uint16_t>(x, out, ring, chunk_of, C, G, ld, rc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (W, G*rows*block) float32 rows of stride ld; ring: (C, G) int32; block a
// multiple of 32 up to 1024; rows from ra on run the opposite direction.
// out: (W, rc) when rs, else (W, count).
int mlsl_quant_ring(const void* x, void* out, const void* ring, int C, int G, long long ld,
                    int rows, int block, int ra, long long rc, long long count, int rs,
                    void* stream) {
  const long long warps = static_cast<long long>(C) * G * rows;
  if (warps <= 0) return static_cast<int>(cudaGetLastError());
  if (block % 32 != 0 || block > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      static_cast<unsigned int>((warps + kWarpsPerCta - 1) / kWarpsPerCta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* rt = static_cast<const int*>(ring);
  if (block <= 256) {
    quant_ring_kernel<8><<<grid, kWarpsPerCta * 32, 0, s>>>(xf, of, rt, C, G, ld, rows, block,
                                                            ra, rc, count, rs);
  } else {
    quant_ring_kernel<32><<<grid, kWarpsPerCta * 32, 0, s>>>(xf, of, rt, C, G, ld, rows,
                                                             block, ra, rc, count, rs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
