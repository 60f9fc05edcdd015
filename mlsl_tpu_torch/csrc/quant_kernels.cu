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
// The quotient is the correctly rounded IEEE one (__fdiv_rn, or for scales in
// [2^-96, 2^96] a reciprocal and one FMA correction that gives the same bits,
// see FmaDiv) and the rounding is rintf (half to even), so the results are
// bit-exact against the plain PyTorch version. Build without --use_fast_math.
//
// What bounds them: HBM bytes. Quantize reads 4 B and writes 1 B an element,
// plus 4 B a row for the scale; dequantize reads 1 B an element plus 4 B a row
// and writes 4 B an element. Neither has arithmetic worth counting, so the
// design is about the bytes: many in flight on every SM, accesses that fill
// whole 32-byte sectors, and each byte touched once.
//
// Geometry of the vector path. A thread owns one segment, 16 consecutive
// elements of a row: four float4 of float32 or one 16-byte access of int8. A
// row's block / 16 segments spread over a group of `lanes` neighbouring lanes,
// the power of two at or above block / 16, at most a warp: block 64 takes 4
// lanes (8 rows a warp), block 256 takes 16 (2 rows a warp), block 96 (6
// segments) takes 8 with 2 lanes idle. Above block 512 a row takes the whole
// warp and lane l owns segments l, l + 32, ... . The wrapper chooses lanes
// and rows a CTA (ops/quant_kernels.py `geometry`: up to 256 threads, down to
// one warp where a launch has too few rows for one CTA a SM); rows run to any
// count, the last CTA's extra rows idle.
//
// Quantize starts all of a thread's loads (up to four segments, 256 B) before
// it uses any, keeps them in registers, takes the row maximum with a
// __shfl_xor_sync butterfly over the group's lanes (max is order-free, so the
// scale is bit for bit the plain version's), and writes each segment's 16
// int8 values as one 16-byte store; the group's first lane writes the scale.
// A row is read once, except rows of more than 2,048 elements (over four
// segments a lane), which are read a second time to quantize. Loads and
// stores carry the streaming hints (__ldcs / __stcs): no byte is touched twice.
//
// Dequantize keeps the geometry but deals a segment's four 4-byte words (four
// int8 values each) out across the group: lane s takes words s, s + lanes,
// s + 2 lanes and s + 3 lanes of each round of 4 * lanes words, so each of its
// four 4-byte loads and four float4 stores is contiguous over the group and
// every store writes whole 32-byte sectors; the group reads its row's scale at
// one address. (A thread's own 16 int8 values in one 16-byte load, written as
// four float4 64 B apart from its neighbours', was slower on the card than the
// one-warp-a-row kernel before it: each store instruction wrote half sectors.)
//
// The scalar path, one warp a row and one element a lane, remains for one
// case only: storage that is not 16-byte aligned (a view at an element
// offset), where a 16-byte access would fault. Scales are a dense (n_rows,)
// array: the TPU's packed (rows/128, 128) scale layout was a Mosaic tiling
// rule and has no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 16;        // elements of a row one thread owns (a segment)
constexpr int kMaxThreads = 1024;

// the int8 value of a quotient x / scale: rounded half to even, clipped
__device__ __forceinline__ int to_int8(float quotient) {
  return static_cast<int>(fminf(fmaxf(rintf(quotient), -127.0f), 127.0f));
}

__device__ __forceinline__ int quant1(float v, float scale) {
  return to_int8(__fdiv_rn(v, scale));
}

__device__ __forceinline__ float scale_of(float amax) {
  return (amax == 0.0f) ? 1.0f : __fdiv_rn(amax, 127.0f);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

// x / scale by __fdiv_rn: a call with a slow path each, so a thread's
// divisions run one after the other
struct IeeeDiv {
  float scale;
  __device__ float operator()(float v) const { return __fdiv_rn(v, scale); }
};

// The same quotient without a branch: q0 = x * (1 / scale) with the
// reciprocal correctly rounded, then one correction by the exact residual
// x - scale * q0 (an FMA). With the reciprocal within half an ulp and q0
// within one, the corrected quotient is the correctly rounded one
// (Markstein's theorem) as long as nothing under- or overflows, which holds
// for scales in [2^-96, 2^96] (x / scale lies in [-127, 127]); outside that
// range IeeeDiv takes over. A thread's 16 divisions then overlap, which is
// what a launch of a few rows (a decode step's 64) waits on.
struct FmaDiv {
  float scale, inv;
  __device__ float operator()(float v) const {
    const float q0 = __fmul_rn(v, inv);
    return __fmaf_rn(__fmaf_rn(-q0, scale, v), inv, q0);
  }
};

__device__ __forceinline__ bool fma_div_exact(float scale) {
  return scale >= 0x1p-96f && scale <= 0x1p96f;
}

// four int8 values, little-endian in one word
template <class Div>
__device__ __forceinline__ unsigned int pack4(float4 v, Div div) {
  return (static_cast<unsigned int>(to_int8(div(v.x))) & 0xffu) |
         ((static_cast<unsigned int>(to_int8(div(v.y))) & 0xffu) << 8) |
         ((static_cast<unsigned int>(to_int8(div(v.z))) & 0xffu) << 16) |
         (static_cast<unsigned int>(to_int8(div(v.w))) << 24);
}

template <class Div>
__device__ __forceinline__ uint4 quant16(const float4 (&v)[4], Div div) {
  return make_uint4(pack4(v[0], div), pack4(v[1], div), pack4(v[2], div), pack4(v[3], div));
}

// streaming loads (__ldcs): every byte is read once, so none is kept in L1/L2
__device__ __forceinline__ void load16(const float* p, float4 (&v)[4]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __ldcs(p4 + i);
}

// the four sign-extended bytes of w, each times the scale
__device__ __forceinline__ float4 dequant4(unsigned int w, float scale) {
  const int b = static_cast<int>(w);
  return make_float4(static_cast<float>((b << 24) >> 24) * scale,
                     static_cast<float>((b << 16) >> 24) * scale,
                     static_cast<float>((b << 8) >> 24) * scale,
                     static_cast<float>(b >> 24) * scale);
}

// max over the aligned group of `lanes` (a power of two) neighbouring lanes;
// every lane of the warp takes part
__device__ __forceinline__ float group_max(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// S > 0: a lane keeps up to S segments of its row in registers; S == 0: any
// number of segments, the row read twice.
template <int S>
__global__ void quantize_rows_vec(const float* __restrict__ x, signed char* __restrict__ q,
                                  float* __restrict__ scales, long long n_rows, int block,
                                  int lanes) {
  const int sub = threadIdx.x & (lanes - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> (__ffs(lanes) - 1);
  const bool live = row < n_rows;     // no early return: the group shuffles below
  const int nseg = block / kSeg;
  const float* xr = x + row * block;
  signed char* qr = q + row * block;

  float amax = 0.0f;
  if constexpr (S > 0) {
    float4 v[S][4];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = sub + k * lanes;
      if (live && j < nseg) {
        load16(xr + j * kSeg, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[k][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) amax = abs_max4(amax, v[k][i]);
    const float scale = scale_of(group_max(amax, lanes));
    auto write = [&](auto div) {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int j = sub + k * lanes;
        if (live && j < nseg) __stcs(reinterpret_cast<uint4*>(qr + j * kSeg), quant16(v[k], div));
      }
    };
    if (fma_div_exact(scale)) write(FmaDiv{scale, __frcp_rn(scale)});
    else write(IeeeDiv{scale});
    if (live && sub == 0) scales[row] = scale;
  } else {
    float4 v[4];
    for (int j = sub; live && j < nseg; j += lanes) {
      load16(xr + j * kSeg, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) amax = abs_max4(amax, v[i]);
    }
    const float scale = scale_of(group_max(amax, lanes));
    auto write = [&](auto div) {
      for (int j = sub; live && j < nseg; j += lanes) {
        load16(xr + j * kSeg, v);
        __stcs(reinterpret_cast<uint4*>(qr + j * kSeg), quant16(v, div));
      }
    };
    if (fma_div_exact(scale)) write(FmaDiv{scale, __frcp_rn(scale)});
    else write(IeeeDiv{scale});
    if (live && sub == 0) scales[row] = scale;
  }
}

// A round of a group covers 16 * lanes elements of its row, 4 * lanes words of
// four int8 values; lane s takes words s, s + lanes, s + 2 lanes and s + 3
// lanes, so each of its four 4-byte loads and four 16-byte stores is
// contiguous over the group and every store fills whole sectors.
__global__ void dequantize_rows_vec(const signed char* __restrict__ q,
                                    const float* __restrict__ scales, float* __restrict__ x,
                                    long long n_rows, int block, int lanes) {
  const int sub = threadIdx.x & (lanes - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> (__ffs(lanes) - 1);
  if (row >= n_rows) return;
  const int nwords = block / 4;
  const unsigned int* qr = reinterpret_cast<const unsigned int*>(q + row * block);
  float4* xr = reinterpret_cast<float4*>(x + row * block);
  const float scale = scales[row];
  for (int base = sub; base < nwords; base += 4 * lanes) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = base + i * lanes;
      w[i] = k < nwords ? __ldcs(qr + k) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = base + i * lanes;
      if (k < nwords) __stcs(xr + k, dequant4(w[i], scale));
    }
  }
}

// the scalar path: one warp a row, one element a lane at a time
__global__ void quantize_rows_scalar(const float* __restrict__ x, signed char* __restrict__ q,
                                     float* __restrict__ scales, long long n_rows, int block) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;         // a whole warp leaves together
  const float* xr = x + row * block;
  signed char* qr = q + row * block;
  float amax = 0.0f;
  for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(xr[i]));
  const float scale = scale_of(group_max(amax, 32));
  for (int i = lane; i < block; i += 32) qr[i] = static_cast<signed char>(quant1(xr[i], scale));
  if (lane == 0) scales[row] = scale;
}

__global__ void dequantize_rows_scalar(const signed char* __restrict__ q,
                                       const float* __restrict__ scales, float* __restrict__ x,
                                       long long n_rows, int block) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const signed char* qr = q + row * block;
  float* xr = x + row * block;
  const float scale = scales[row];
  for (int i = lane; i < block; i += 32) xr[i] = static_cast<float>(qr[i]) * scale;
}

// lanes a power of two up to 32, one warp a row on the scalar path, and at
// most kMaxThreads a CTA
bool geometry_ok(int block, int vec, int lanes, int rows_per_cta) {
  const int threads = lanes * rows_per_cta;
  return block > 0 && block % 32 == 0 && lanes >= 1 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0 && (vec || lanes == 32) && rows_per_cta >= 1 &&
         threads % 32 == 0 && threads <= kMaxThreads;
}

unsigned int grid_for(long long n_rows, int rows_per_cta) {
  return static_cast<unsigned int>((n_rows + rows_per_cta - 1) / rows_per_cta);
}

}  // namespace

extern "C" {

// x: (n_rows, block) float32; q: (n_rows, block) int8; scales: (n_rows,) float32.
// vec: 1 for the vector path (x and q 16-byte aligned), 0 for the scalar one;
// lanes: lanes a row (a power of two; 32 on the scalar path); rows_per_cta: a
// CTA runs lanes * rows_per_cta threads. Returns cudaGetLastError() after the
// launch (0 = launched).
int mlsl_quantize_rows(const void* x, void* q, void* scales, long long n_rows, int block,
                       int vec, int lanes, int rows_per_cta, void* stream) {
  if (!geometry_ok(block, vec, lanes, rows_per_cta))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const unsigned int grid = grid_for(n_rows, rows_per_cta);
    const int threads = lanes * rows_per_cta;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    signed char* qc = static_cast<signed char*>(q);
    float* sf = static_cast<float*>(scales);
    const int per_lane = (block / kSeg + lanes - 1) / lanes;   // segments a lane
    if (!vec) {
      quantize_rows_scalar<<<grid, threads, 0, s>>>(xf, qc, sf, n_rows, block);
    } else if (per_lane <= 1) {
      quantize_rows_vec<1><<<grid, threads, 0, s>>>(xf, qc, sf, n_rows, block, lanes);
    } else if (per_lane <= 4) {
      quantize_rows_vec<4><<<grid, threads, 0, s>>>(xf, qc, sf, n_rows, block, lanes);
    } else {
      quantize_rows_vec<0><<<grid, threads, 0, s>>>(xf, qc, sf, n_rows, block, lanes);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_rows, block) int8; scales: (n_rows,) float32; x: (n_rows, block) float32;
// vec, lanes and rows_per_cta as above (q and x 16-byte aligned for vec).
int mlsl_dequantize_rows(const void* q, const void* scales, void* x, long long n_rows,
                         int block, int vec, int lanes, int rows_per_cta, void* stream) {
  if (!geometry_ok(block, vec, lanes, rows_per_cta))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const unsigned int grid = grid_for(n_rows, rows_per_cta);
    const int threads = lanes * rows_per_cta;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const signed char* qc = static_cast<const signed char*>(q);
    const float* sf = static_cast<const float*>(scales);
    float* xf = static_cast<float*>(x);
    if (vec) {
      dequantize_rows_vec<<<grid, threads, 0, s>>>(qc, sf, xf, n_rows, block, lanes);
    } else {
      dequantize_rows_scalar<<<grid, threads, 0, s>>>(qc, sf, xf, n_rows, block);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
