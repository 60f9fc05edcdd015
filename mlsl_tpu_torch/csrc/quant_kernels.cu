// Blockwise int8 codec for Hopper (sm_90a): quantize and dequantize rows.
//
// Replaces the TPU kernels mlsl_tpu/ops/quant_kernels.py:99 (_quantize_pallas,
// bodies _quant_kernel / _quant_kernel_packed) and :140 (_dequantize_pallas,
// bodies _dequant_kernel / _dequant_kernel_packed).
//
// Semantics, identical to quantize_blocks_ref in both packages:
//   amax  = max |x|  over the row (one row = one quantization block)
//   scale = amax / 127 in float32, or 1.0 when amax == 0
//   q     = clip(round_half_even(x / scale), -127, 127) as int8
//   x'    = float(q) * scale
// The division is a true IEEE division (__fdiv_rn) and the rounding is rintf
// (half to even), so the results are bit-exact against the plain PyTorch
// version. Build without --use_fast_math.
//
// Both kernels are bound by memory traffic: quantize reads 4 B per element and
// writes 1 B per element plus 4 B per block; dequantize reads 1 B per element
// plus 4 B per block and writes 4 B per element. The design therefore spends
// nothing on compute and everything on streaming: one warp owns one row, its
// lanes read neighbouring 16-byte vectors (float4 / char4) so every warp load
// is fully coalesced, the row maximum is a __shfl_xor_sync butterfly in
// registers, and the second pass re-reads the row (a 1 KiB row is still in L1)
// to write the int8 values. Scales are a dense (n_rows,) array: the TPU's
// packed (rows/128, 128) scale layout was a Mosaic tiling rule and has no
// counterpart here. Rows run to any count (the last CTA masks its idle warps)
// and `block` may be any multiple of 32; a multiple of 128 on 16-byte-aligned
// storage takes the vector path, anything else the scalar path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ signed char quant1(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     signed char* __restrict__ q,
                                     float* __restrict__ scales,
                                     long long n_rows, int block, int vec) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* xr = x + row * block;
  signed char* qr = q + row * block;

  float amax = 0.0f;
  if (vec) {
    for (int i = lane * 4; i < block; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(xr[i]));
  }
  amax = warp_max(amax);
  const float scale = (amax == 0.0f) ? 1.0f : __fdiv_rn(amax, 127.0f);

  if (vec) {
    for (int i = lane * 4; i < block; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      char4 o;
      o.x = quant1(v.x, scale);
      o.y = quant1(v.y, scale);
      o.z = quant1(v.z, scale);
      o.w = quant1(v.w, scale);
      *reinterpret_cast<char4*>(qr + i) = o;
    }
  } else {
    for (int i = lane; i < block; i += 32) qr[i] = quant1(xr[i], scale);
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void dequantize_rows_kernel(const signed char* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x,
                                       long long n_rows, int block, int vec) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const signed char* qr = q + row * block;
  float* xr = x + row * block;
  const float scale = scales[row];
  if (vec) {
    for (int i = lane * 4; i < block; i += 128) {
      const char4 v = *reinterpret_cast<const char4*>(qr + i);
      float4 o;
      o.x = static_cast<float>(v.x) * scale;
      o.y = static_cast<float>(v.y) * scale;
      o.z = static_cast<float>(v.z) * scale;
      o.w = static_cast<float>(v.w) * scale;
      *reinterpret_cast<float4*>(xr + i) = o;
    }
  } else {
    for (int i = lane; i < block; i += 32) xr[i] = static_cast<float>(qr[i]) * scale;
  }
}

unsigned int grid_for(long long n_rows) {
  return static_cast<unsigned int>((n_rows + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

extern "C" {

// x: (n_rows, block) float32; q: (n_rows, block) int8; scales: (n_rows,) float32.
// Returns cudaGetLastError() after the launch (0 = launched).
int mlsl_quantize_rows(const void* x, void* q, void* scales, long long n_rows,
                       int block, int vec, void* stream) {
  if (n_rows > 0) {
    quantize_rows_kernel<<<grid_for(n_rows), kWarpsPerCta * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<signed char*>(q),
        static_cast<float*>(scales), n_rows, block, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_rows, block) int8; scales: (n_rows,) float32; x: (n_rows, block) float32.
int mlsl_dequantize_rows(const void* q, const void* scales, void* x, long long n_rows,
                         int block, int vec, void* stream) {
  if (n_rows > 0) {
    dequantize_rows_kernel<<<grid_for(n_rows), kWarpsPerCta * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const signed char*>(q), static_cast<const float*>(scales),
        static_cast<float*>(x), n_rows, block, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
