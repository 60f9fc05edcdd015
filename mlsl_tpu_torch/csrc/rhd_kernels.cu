// Recursive halving/doubling SUM allreduce over the virtual ranks of one card
// (Hopper, sm_90a).
//
// Replaces the TPU kernel mlsl_tpu/ops/rhd_kernels.py:256 (_rhd_call, body
// _rhd_kernel_factory :146): a pre-fold for groups that are not a power of
// two, log2(c) halving rounds, log2(c) doubling rounds and a post-fold, each
// a remote-DMA exchange between chips. What every member ends with is the
// value its element's owner computed, a fixed binary tree over the G inputs
// (c = 2^k <= G, r = G - c):
//
//   pre-fold   w[j] = v[j] + v[c + j]   for j < r      (only when r > 0)
//              w[j] = v[j] + 0.0        for r <= j < c  (the TPU's masked add:
//                                                         -0.0 becomes +0.0)
//   halving    w[j] = w[j] + w[j + d]   for j < d, d = c/2, c/4, ..., 1
//   result     w[0], copied to all G members (doubling and post-fold copy)
//
// (The TPU computes v[i] + v[i ^ d] on every member of a pair; the two sums
// are equal because IEEE addition is commutative, so the tree above is the
// owner's value for every element.)
//
// Bound: at the sizes the selection table sends here (<= 40,000 bytes by
// default) the launch latency; at large counts memory traffic (G float32
// reads and G writes per element). One thread owns one element: its G loads
// are coalesced across the warp, the tree runs in registers (the core size is
// a template parameter so the c partials stay in registers), and the result
// is stored G times. Build without --use_fast_math; the adds are __fadd_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// grid: x over the count elements, y over the C group instances; rows is the
// (C, G) member table of world ranks in group-position order.
template <int CORE>
__global__ void rhd_kernel(const float* __restrict__ x, float* __restrict__ out,
                           const int* __restrict__ rows, int G, long long ld, long long count) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const int* rr = rows + static_cast<long long>(blockIdx.y) * G;
  const int r = G - CORE;
  float w[CORE];
#pragma unroll
  for (int j = 0; j < CORE; ++j) {
    w[j] = x[static_cast<long long>(rr[j]) * ld + e];
    if (r > 0) {
      const float f = (j < r) ? x[static_cast<long long>(rr[CORE + j]) * ld + e] : 0.0f;
      w[j] = __fadd_rn(w[j], f);
    }
  }
#pragma unroll
  for (int d = CORE / 2; d >= 1; d >>= 1) {
#pragma unroll
    for (int j = 0; j < d; ++j) w[j] = __fadd_rn(w[j], w[j + d]);
  }
  for (int m = 0; m < G; ++m) out[static_cast<long long>(rr[m]) * count + e] = w[0];
}

}  // namespace

extern "C" {

// x: (W, >= count) float32 rows of stride ld; rows: (C, G) int32, 2 <= G <= 64;
// out: (W, count) float32. Returns cudaGetLastError() after the launch.
int mlsl_rhd_allreduce(const void* x, void* out, const void* rows, int C, int G, long long ld,
                       long long count, void* stream) {
  if (count <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 2 || G > 64) return static_cast<int>(cudaErrorInvalidValue);
  int core = 1;
  while (core * 2 <= G) core *= 2;
  const dim3 grid(static_cast<unsigned int>((count + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(C));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* rt = static_cast<const int*>(rows);
  switch (core) {
    case 2: rhd_kernel<2><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
    case 4: rhd_kernel<4><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
    case 8: rhd_kernel<8><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
    case 16: rhd_kernel<16><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
    case 32: rhd_kernel<32><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
    default: rhd_kernel<64><<<grid, kThreads, 0, s>>>(xf, of, rt, G, ld, count); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
