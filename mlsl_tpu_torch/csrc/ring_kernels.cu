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
// of the int8 codec (int8) per element and hop. The design streams: for the
// dense ring a thread owns one element of a chunk and its G loads are
// coalesced across the warp; for the int8 ring a warp owns one block row, its
// lanes hold the row's partial in registers across all hops (lane l has
// elements l, l+32, ...), so a hop costs one coalesced row load and a
// five-step shuffle for max|x|, and nothing is written until the end. No slot
// buffers, semaphores or handshakes: nothing is in flight between members.
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

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.0f); }
template <>
__device__ __forceinline__ int32_t zero<int32_t>() { return 0; }

// grid: x over the rc elements of a chunk, y over the C*G (instance, ring chunk)
// pairs. Logical element idx = chunk_of[i] * rc + e; elements past `count`
// are the zero padding of the last chunk.
template <typename T>
__global__ void dense_ring_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const int* __restrict__ ring,
                                  const int* __restrict__ chunk_of, int G, long long ld,
                                  long long rc, long long count, long long split, int rs) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rc) return;
  const int i = blockIdx.y % G;
  const int* rr = ring + static_cast<long long>(blockIdx.y / G) * G;
  const long long idx = static_cast<long long>(chunk_of[i]) * rc + e;
  const bool valid = idx < count;
  const int sign = e >= split ? -1 : 1;

  T acc = valid ? x[static_cast<long long>(rr[wrap(i + sign, G)]) * ld + idx] : zero<T>();
  for (int s = 2; s <= G; ++s) {
    const T loc = valid ? x[static_cast<long long>(rr[wrap(i + sign * s, G)]) * ld + idx]
                        : zero<T>();
    acc = Add<T>::apply(acc, loc);
  }
  if (rs) {
    out[static_cast<long long>(rr[i]) * rc + e] = acc;
  } else if (valid) {
    for (int m = 0; m < G; ++m) out[static_cast<long long>(rr[m]) * count + idx] = acc;
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

template <typename T>
int launch_dense(const void* x, void* out, const void* ring, const void* chunk_of, int C,
                 int G, long long ld, long long rc, long long count, long long split, int rs,
                 cudaStream_t stream) {
  if (rc <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned int>((rc + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(C * G));
  dense_ring_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(ring),
      static_cast<const int*>(chunk_of), G, ld, rc, count, split, rs);
  return static_cast<int>(cudaGetLastError());
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
