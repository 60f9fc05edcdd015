// The fused all-to-all over the virtual ranks of one card (Hopper, sm_90a): a
// dense variant (float32 copies) and an int8 variant (every chunk makes one
// codec round trip on its way).
//
// Replaces the TPU kernel mlsl_tpu/ops/a2a_kernels.py:250 (_a2a_call, body
// _a2a_kernel_factory :141, wrappers alltoall_body :342 and alltoall_body_ef
// :368). On the TPU each member is a chip and the kernel owns G-1
// shifted-permutation steps of remote DMAs between VMEM slots, the codec
// fused at the slot boundary. Here every member is a row of one world buffer
// on one card, addressed through `rows`, a (C, G) table of world ranks, so the
// schedule falls away and the kernel computes the function itself:
//
//   out[rows[c][j]][i*out_chunk + e] = T(x[rows[c][i]][j*in_chunk + e]),  e < rc
//
// for every instance c and members i, j. T is the identity (dense) or, per
// block row of `block` elements of the input chunk, dequant(quant(.)) with B1's
// arithmetic (int8): scale = amax / 127 (__fdiv_rn) or 1 where amax == 0,
// q = clamp(rintf(x / scale), -127, 127) taken through an integer (so a value
// that rounds to -0.0 comes back +0.0, as through int8), then __fmul_rn(q,
// scale). The explicit roundings keep nvcc from contracting; build without
// --use_fast_math. The self chunk (i == j) makes the round trip too, as on
// the TPU.
//
// Bound: memory traffic. Each element is read once and written once; the
// codec costs a few operations per element. The dense variant gives each
// thread one 16-byte vector (or one float where the chunks are not 16-byte
// aligned), neighbouring threads on neighbouring addresses of one chunk. The
// int8 variant gives one warp a (instance, source member, chunk, block row):
// lane l loads elements l, l+32, ... of the row (coalesced), the row's
// max|x| is a five-step shuffle, and the row is written once. No slot
// buffers, semaphores or handshakes: nothing is in flight between members.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerCta = 8;
constexpr unsigned int kMaxGridX = 1u << 20;

// grid.y over the (c, i, j) triples, grid.x strides over the chunk's elements
// (VEC: float4 vectors, rc a multiple of 4).
template <bool VEC>
__global__ void dense_a2a_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 const int* __restrict__ rows, int G, long long ld_in,
                                 long long ld_out, long long in_chunk, long long out_chunk,
                                 long long rc) {
  const int j = blockIdx.y % G;
  const int ci = blockIdx.y / G;
  const int i = ci % G;
  const int* rr = rows + static_cast<long long>(ci / G) * G;
  const float* src = x + static_cast<long long>(rr[i]) * ld_in + j * in_chunk;
  float* dst = out + static_cast<long long>(rr[j]) * ld_out + i * out_chunk;
  const long long n = VEC ? rc / 4 : rc;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    if (VEC) {
      reinterpret_cast<float4*>(dst)[t] = reinterpret_cast<const float4*>(src)[t];
    } else {
      dst[t] = src[t];
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp per (instance c, source member i, chunk j, block row r); warps
// run r fastest, so a warp's neighbours read the next rows of the same chunk.
template <int MAXV>
__global__ void quant_a2a_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 const int* __restrict__ rows, int C, int G, long long ld_in,
                                 long long ld_out, int nrows, int block, long long out_chunk,
                                 long long rc) {
  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(C) * G * G * nrows) return;
  const int r = static_cast<int>(warp % nrows);
  long long rest = warp / nrows;
  const int j = static_cast<int>(rest % G);
  rest /= G;
  const int i = static_cast<int>(rest % G);
  const int* rr = rows + (rest / G) * G;
  const int nv = block >> 5;
  const long long in_chunk = static_cast<long long>(nrows) * block;
  const long long e0 = static_cast<long long>(r) * block + lane;   // offset in the chunk
  const float* src = x + static_cast<long long>(rr[i]) * ld_in + j * in_chunk + e0;

  float v[MAXV];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < nv) {
      v[k] = src[k * 32];
      amax = fmaxf(amax, fabsf(v[k]));
    }
  }
  amax = warp_max(amax);
  const float scale = (amax == 0.0f) ? 1.0f : __fdiv_rn(amax, 127.0f);
  float* dst = out + static_cast<long long>(rr[j]) * ld_out + i * out_chunk;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const long long e = e0 + k * 32;
    if (k < nv && e < rc) {
      const int q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[k], scale)), -127.0f), 127.0f));
      dst[e] = __fmul_rn(static_cast<float>(q), scale);
    }
  }
}

}  // namespace

extern "C" {

// x: (W, >= G*in_chunk) float32 rows of stride ld_in; rows: (C, G) int32 world
// ranks; out: (W, >= G*out_chunk) rows of stride ld_out. Copies rc elements
// per (c, i, j). Returns cudaGetLastError() after the launch (0 = launched).
int mlsl_a2a_dense(const void* x, void* out, const void* rows, int C, int G, long long ld_in,
                   long long ld_out, long long in_chunk, long long out_chunk, long long rc,
                   void* stream) {
  const long long triples = static_cast<long long>(C) * G * G;
  if (rc <= 0 || triples <= 0) return static_cast<int>(cudaGetLastError());
  if (triples > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = rc % 4 == 0 && in_chunk % 4 == 0 && out_chunk % 4 == 0 && ld_in % 4 == 0 &&
                   ld_out % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n = vec ? rc / 4 : rc;
  long long gx = (n + kThreads - 1) / kThreads;
  if (gx > kMaxGridX) gx = kMaxGridX;
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(triples));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* rt = static_cast<const int*>(rows);
  if (vec) {
    dense_a2a_kernel<true><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld_in, ld_out, in_chunk,
                                                     out_chunk, rc);
  } else {
    dense_a2a_kernel<false><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld_in, ld_out, in_chunk,
                                                      out_chunk, rc);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (W, >= G*nrows*block) float32 rows of stride ld_in, chunk j of a row at
// j*nrows*block; block a multiple of 32 up to 1024. Writes the first rc
// elements of each chunk's round trip to out at i*out_chunk.
int mlsl_a2a_quant(const void* x, void* out, const void* rows, int C, int G, long long ld_in,
                   long long ld_out, int nrows, int block, long long out_chunk, long long rc,
                   void* stream) {
  const long long warps = static_cast<long long>(C) * G * G * nrows;
  if (warps <= 0 || rc <= 0) return static_cast<int>(cudaGetLastError());
  if (block % 32 != 0 || block > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = (warps + kWarpsPerCta - 1) / kWarpsPerCta;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(ctas);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* rt = static_cast<const int*>(rows);
  if (block <= 256) {
    quant_a2a_kernel<8><<<grid, kWarpsPerCta * 32, 0, s>>>(xf, of, rt, C, G, ld_in, ld_out,
                                                           nrows, block, out_chunk, rc);
  } else {
    quant_a2a_kernel<32><<<grid, kWarpsPerCta * 32, 0, s>>>(xf, of, rt, C, G, ld_in, ld_out,
                                                            nrows, block, out_chunk, rc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
