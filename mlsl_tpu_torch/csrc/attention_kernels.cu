// Flash attention on Hopper (sm_90a): the forward (B7), its two backward passes
// (B8: dq over key tiles, dk/dv over query tiles) and the ring hop's carried-state
// update (B9). Plain C interface, bound with ctypes by ops/attention_kernels.py.
//
// Replaces (mlsl_tpu/ops/attention_kernels.py):
//   mlsl_flash_fwd          B7 `_flash_fwd` (:154, bodies `_flash_kernel`, `_tile_accumulate`)
//   mlsl_flash_bwd_dq       B8 `_flash_bwd` (:297), its dq pallas_call (:311, `_bwd_dq_kernel`)
//   mlsl_flash_bwd_dkv      B8 `_flash_bwd` (:297), its dk/dv pallas_call (:335, `_bwd_dkv_kernel`)
//   mlsl_flash_block_update B9 `_block_update_fwd` (:442, body `_block_kernel`)
//
// Shapes: q (BH, Sq, D), k/v (BH, Sk, D) row-major, float32 or bfloat16 (one type
// for q, k, v, dO and the typed outputs); Sq and Sk multiples of 64 (the wrapper
// admits only what supports() admits: multiples of 128), D a multiple of 8 up to
// 128. Offsets are int32 per (b, h) row -- one launch spans virtual ranks whose
// sequence shards sit at different global positions. The carried state and the
// lse are float32 (BH, Sq): the TPU's (BH, Sq, 128) lane broadcast is dropped.
//
// Arithmetic: as the TPU kernels, in float32 whatever the input type: s = (q.k) *
// scale; causal entries with k_pos > q_pos become NEG = -1e30; p = exp(s - m) and
// p = 0 where s <= NEG/2, so a fully masked row keeps l = 0, gives output 0 and
// exact zero gradients; l is floored at 1e-30 when dividing. Tiles add in another
// order than on the TPU, so results agree to rounding, not bit for bit.
//
// Design: one block of 8 warps per (bh, 64-row tile) of the dimension the pass
// owns (q rows for B7, B9 and dq; k rows for dk/dv); a loop over the 64-row tiles
// of the other dimension stages them in shared memory as float32, skipping whole
// tiles that the causal mask hides (the TPU's `_tile_visible`). Each warp owns 8
// rows of the block's tile; each lane owns 2 columns of the 64x64 score tile and
// D/32 (rounded up) columns of the output. Row statistics reduce with warp
// shuffles; P and dS go through warp-private shared memory, so the only block
// barriers are around the staged tiles. Each block owns its output rows: no
// atomics, deterministic results.
//
// Bound on an H100 SXM: operations. Per visible (q, k) pair B7 and B9 do 4*D
// operations, dq 6*D, dk/dv 8*D; at the path's causal (128, 2048, 64) in bf16, B7
// moves ~135 MB (0.04 ms at 3.35 TB/s) and does ~69 GFLOP (0.07 ms at the bf16
// tensor-core rate of 989 TFLOP/s). These kernels use float32 FMAs on the CUDA
// cores (67 TFLOP/s peak, and shared-memory loads hold them below that): a simple,
// exact first form. wgmma tiles fed by TMA are the way to the bound, in a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;            // rows of the tile a block owns
constexpr int TK = 64;            // rows of each staged tile of the other side
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = TQ / WARPS;    // rows a warp owns
constexpr int CL = TK / 32;       // score-tile columns a lane owns
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// 64 contiguous rows of d elements -> shared memory as float32, row stride lds.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int lds, const T* src, int d) {
  for (int i = threadIdx.x; i < 64 * d; i += THREADS) {
    const int r = i / d;
    dst[r * lds + (i - r * d)] = load_f(src + i);
  }
}

// out[i][j] = sum_c A[i][c] * B[lane + 32 j][c] for the warp's RW rows of A (row
// stride lda; every lane reads the same row: a broadcast) against the lane's CL
// rows of B (row stride ldb = 4 mod 8 floats: conflict-free 16-byte loads).
__device__ __forceinline__ void tile_dot(float (&out)[RW][CL], const float* A, int lda,
                                         const float* B, int ldb, int d, int lane) {
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CL; ++j) out[i][j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    float4 b[CL];
#pragma unroll
    for (int j = 0; j < CL; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (lane + 32 * j) * ldb + c);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + i * lda + c);
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        float s = out[i][j];
        s = fmaf(a.x, b[j].x, s);
        s = fmaf(a.y, b[j].y, s);
        s = fmaf(a.z, b[j].z, s);
        s = fmaf(a.w, b[j].w, s);
        out[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum_t P[i][t] * X[t][lane + 32 j] over a 64-wide tile: P is the
// warp's RW rows (row stride 64, broadcast loads), X a staged tile (row stride ldx).
template <int NJ>
__device__ __forceinline__ void tile_acc(float (&acc)[RW][NJ], const float* P,
                                         const float* X, int ldx, int d, int lane) {
  for (int t0 = 0; t0 < 64; t0 += 4) {
    float x[4][NJ];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        x[t][j] = c < d ? X[(t0 + t) * ldx + c] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(P + i * 64 + t0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float a = acc[i][j];
        a = fmaf(p.x, x[0][j], a);
        a = fmaf(p.y, x[1][j], a);
        a = fmaf(p.z, x[2][j], a);
        a = fmaf(p.w, x[3][j], a);
        acc[i][j] = a;
      }
    }
  }
}

// B7 (CARRY = false: fresh state, normalised output and lse) and B9 (CARRY =
// true: the state comes in and goes out unnormalised).
template <typename T, int NJ, bool CARRY>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ q_off, const int* __restrict__ k_off,
           int sq, int sk, int d, float scale, int causal,
           T* __restrict__ o, float* __restrict__ lse,
           const float* __restrict__ acc_in, const float* __restrict__ m_in,
           const float* __restrict__ l_in, float* __restrict__ acc_out,
           float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = d + 4;
  float* Qs = smem;                  // TQ x d
  float* Ks = Qs + TQ * d;           // TK x ldk
  float* Vs = Ks + TK * ldk;         // TK x d
  float* Ps = Vs + TK * d;           // TQ x TK, rows private to their warp

  const int q_tiles = sq / TQ;
  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RW;
  const int qo = q_off[bh], ko = k_off[bh];
  const long rbase = (long)bh * sq + (long)qt * TQ;   // first global row of the tile

  stage(Qs, d, q + rbase * d, d);

  float acc[RW][NJ], m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long r = rbase + row0 + i;
    m[i] = CARRY ? m_in[r] : NEG;
    l[i] = CARRY ? l_in[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      acc[i][j] = (CARRY && c < d) ? acc_in[r * d + c] : 0.f;
    }
  }

  const int q_last = qo + qt * TQ + TQ - 1;
  for (int kt = 0; kt < sk / TK; ++kt) {
    if (causal && ko + kt * TK > q_last) break;   // this and later tiles are all future
    __syncthreads();
    const long kbase = ((long)bh * sk + (long)kt * TK) * d;
    stage(Ks, ldk, k + kbase, d);
    stage(Vs, d, v + kbase, d);
    __syncthreads();

    float s[RW][CL];
    tile_dot(s, Qs + row0 * d, d, Ks, ldk, d, lane);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int q_pos = qo + qt * TQ + row0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        float x = s[i][j] * scale;
        if (causal && ko + kt * TK + lane + 32 * j > q_pos) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        const float p = s[i][j] <= 0.5f * NEG ? 0.f : expf(s[i][j] - m_new);
        Ps[(row0 + i) * TK + lane + 32 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();
    tile_acc<NJ>(acc, Ps + row0 * TK, Vs, d, d, lane);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long r = rbase + row0 + i;
    if (CARRY) {
      if (lane == 0) {
        m_out[r] = m[i];
        l_out[r] = l[i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < d) acc_out[r * d + c] = acc[i][j];
      }
    } else {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < d) store_f(o + r * d + c, acc[i][j] / denom);
      }
      if (lse != nullptr && lane == 0) lse[r] = m[i] + logf(denom);
    }
  }
}

// B8, first pass: dq = scale * sum over visible key tiles of dS K, with
// P = exp(s - lse) recomputed and dS = P * (dO V^T - dd).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dd, const int* __restrict__ q_off,
          const int* __restrict__ k_off, int sq, int sk, int d, float scale, int causal,
          T* __restrict__ dq) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = d + 4;
  float* Qs = smem;                  // TQ x d
  float* Os = Qs + TQ * d;           // dO, TQ x d
  float* Ks = Os + TQ * d;           // TK x ldk
  float* Vs = Ks + TK * ldk;         // TK x ldk
  float* Ss = Vs + TK * ldk;         // dS, TQ x TK, rows private to their warp

  const int q_tiles = sq / TQ;
  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RW;
  const int qo = q_off[bh], ko = k_off[bh];
  const long rbase = (long)bh * sq + (long)qt * TQ;

  stage(Qs, d, q + rbase * d, d);
  stage(Os, d, dout + rbase * d, d);
  float row_lse[RW], row_dd[RW], acc[RW][NJ];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    row_lse[i] = lse[rbase + row0 + i];
    row_dd[i] = dd[rbase + row0 + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = qo + qt * TQ + TQ - 1;
  for (int kt = 0; kt < sk / TK; ++kt) {
    if (causal && ko + kt * TK > q_last) break;
    __syncthreads();
    const long kbase = ((long)bh * sk + (long)kt * TK) * d;
    stage(Ks, ldk, k + kbase, d);
    stage(Vs, ldk, v + kbase, d);
    __syncthreads();

    float s[RW][CL], dp[RW][CL];
    tile_dot(s, Qs + row0 * d, d, Ks, ldk, d, lane);
    tile_dot(dp, Os + row0 * d, d, Vs, ldk, d, lane);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int q_pos = qo + qt * TQ + row0 + i;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        float x = s[i][j] * scale;
        if (causal && ko + kt * TK + lane + 32 * j > q_pos) x = NEG;
        const float p = x <= 0.5f * NEG ? 0.f : expf(x - row_lse[i]);
        Ss[(row0 + i) * TK + lane + 32 * j] = p * (dp[i][j] - row_dd[i]);
      }
    }
    __syncwarp();
    tile_acc<NJ>(acc, Ss + row0 * TK, Ks, ldk, d, lane);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) store_f(dq + (rbase + row0 + i) * d + c, scale * acc[i][j]);
    }
}

// B8, second pass: for one key tile, dV = sum over visible query tiles of P^T dO
// and dK = scale * sum of dS^T Q. The block's warps own key rows here.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dd, const int* __restrict__ q_off,
           const int* __restrict__ k_off, int sq, int sk, int d, float scale, int causal,
           T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = d + 4;
  float* Ks = smem;                  // TK x d
  float* Vs = Ks + TK * d;           // TK x d
  float* Qs = Vs + TK * d;           // TQ x ldq
  float* Os = Qs + TQ * ldq;         // dO, TQ x ldq
  float* Ps = Os + TQ * ldq;         // P^T, TK x TQ, rows private to their warp
  float* Ds = Ps + TK * TQ;          // dS^T, TK x TQ, likewise
  float* Ls = Ds + TK * TQ;          // lse of the staged query rows
  float* Es = Ls + TQ;               // dd of the staged query rows

  const int k_tiles = sk / TK;
  const int bh = blockIdx.x / k_tiles, kt = blockIdx.x % k_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RW;
  const int qo = q_off[bh], ko = k_off[bh];
  const long kbase = (long)bh * sk + (long)kt * TK;

  stage(Ks, d, k + kbase * d, d);
  stage(Vs, d, v + kbase * d, d);
  float gk[RW][NJ], gv[RW][NJ];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int k_first = ko + kt * TK;
  for (int qt = 0; qt < sq / TQ; ++qt) {
    if (causal && k_first > qo + qt * TQ + TQ - 1) continue;   // all of it is past
    __syncthreads();
    const long rbase = (long)bh * sq + (long)qt * TQ;
    stage(Qs, ldq, q + rbase * d, d);
    stage(Os, ldq, dout + rbase * d, d);
    if (threadIdx.x < TQ) {
      Ls[threadIdx.x] = lse[rbase + threadIdx.x];
      Es[threadIdx.x] = dd[rbase + threadIdx.x];
    }
    __syncthreads();

    float s[RW][CL], dp[RW][CL];
    tile_dot(s, Ks + row0 * d, d, Qs, ldq, d, lane);
    tile_dot(dp, Vs + row0 * d, d, Os, ldq, d, lane);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int k_pos = k_first + row0 + i;
#pragma unroll
      for (int j = 0; j < CL; ++j) {
        const int qc = lane + 32 * j;
        float x = s[i][j] * scale;
        if (causal && k_pos > qo + qt * TQ + qc) x = NEG;
        const float p = x <= 0.5f * NEG ? 0.f : expf(x - Ls[qc]);
        Ps[(row0 + i) * TQ + qc] = p;
        Ds[(row0 + i) * TQ + qc] = p * (dp[i][j] - Es[qc]);
      }
    }
    __syncwarp();
    tile_acc<NJ>(gv, Ps + row0 * TQ, Os, ldq, d, lane);
    tile_acc<NJ>(gk, Ds + row0 * TQ, Qs, ldq, d, lane);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        store_f(dk + (kbase + row0 + i) * d + c, scale * gk[i][j]);
        store_f(dv + (kbase + row0 + i) * d + c, gv[i][j]);
      }
    }
}

size_t fwd_smem(int d) { return sizeof(float) * (TQ * d + TK * (d + 4) + TK * d + TQ * TK); }
size_t dq_smem(int d) { return sizeof(float) * (2 * TQ * d + 2 * TK * (d + 4) + TQ * TK); }
size_t dkv_smem(int d) {
  return sizeof(float) * (2 * TK * d + 2 * TQ * (d + 4) + 2 * TK * TQ + 2 * TQ);
}

template <typename K>
int launch_prep(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int NJ, bool CARRY>
int fwd_t(const void* q, const void* k, const void* v, const int* qo, const int* ko,
          void* o, float* lse, const float* ai, const float* mi, const float* li,
          float* ao, float* mo, float* lo, int bh, int sq, int sk, int d, float scale,
          int causal, cudaStream_t st) {
  auto kern = fwd_kernel<T, NJ, CARRY>;
  const size_t smem = fwd_smem(d);
  int rc = launch_prep(kern, smem);
  if (rc) return rc;
  kern<<<bh * (sq / TQ), THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, qo, ko, sq, sk, d, scale, causal, (T*)o, lse,
      ai, mi, li, ao, mo, lo);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int bwd_t(bool dkv, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* dd, const int* qo, const int* ko, void* g0,
          void* g1, int bh, int sq, int sk, int d, float scale, int causal,
          cudaStream_t st) {
  if (!dkv) {
    auto kern = dq_kernel<T, NJ>;
    const size_t smem = dq_smem(d);
    int rc = launch_prep(kern, smem);
    if (rc) return rc;
    kern<<<bh * (sq / TQ), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd, qo, ko, sq, sk, d,
        scale, causal, (T*)g0);
  } else {
    auto kern = dkv_kernel<T, NJ>;
    const size_t smem = dkv_smem(d);
    int rc = launch_prep(kern, smem);
    if (rc) return rc;
    kern<<<bh * (sk / TK), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd, qo, ko, sq, sk, d,
        scale, causal, (T*)g0, (T*)g1);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. NJ = output columns a lane owns (D <= 32 NJ).
bool shapes_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh > 0 && sq > 0 && sk > 0 && sq % TQ == 0 && sk % TK == 0 && d >= 8 && d % 8 == 0 &&
         d <= 128 && (dtype == 0 || dtype == 1);
}

#define MLSL_DISPATCH(FN, ...)                                                       \
  do {                                                                               \
    if (dtype == 0) {                                                                \
      if (d <= 32) return FN<float, 1>(__VA_ARGS__);                                 \
      if (d <= 64) return FN<float, 2>(__VA_ARGS__);                                 \
      return FN<float, 4>(__VA_ARGS__);                                              \
    }                                                                                \
    if (d <= 32) return FN<__nv_bfloat16, 1>(__VA_ARGS__);                           \
    if (d <= 64) return FN<__nv_bfloat16, 2>(__VA_ARGS__);                           \
    return FN<__nv_bfloat16, 4>(__VA_ARGS__);                                        \
  } while (0)

template <typename T, int NJ>
int fwd_plain(const void* q, const void* k, const void* v, const int* qo, const int* ko,
              void* o, float* lse, int bh, int sq, int sk, int d, float scale, int causal,
              cudaStream_t st) {
  return fwd_t<T, NJ, false>(q, k, v, qo, ko, o, lse, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, bh, sq, sk, d, scale, causal, st);
}

template <typename T, int NJ>
int fwd_carry(const void* q, const void* k, const void* v, const int* qo, const int* ko,
              const float* ai, const float* mi, const float* li, float* ao, float* mo,
              float* lo, int bh, int sq, int sk, int d, float scale, int causal,
              cudaStream_t st) {
  return fwd_t<T, NJ, true>(q, k, v, qo, ko, nullptr, nullptr, ai, mi, li, ao, mo, lo, bh,
                            sq, sk, d, scale, causal, st);
}

}  // namespace

extern "C" {

// B7. o (BH, Sq, D) in the input type; lse (BH, Sq) float32, or null to skip it.
int mlsl_flash_fwd(const void* q, const void* k, const void* v, const int* q_off,
                   const int* k_off, void* o, float* lse, int bh, int sq, int sk, int d,
                   float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MLSL_DISPATCH(fwd_plain, q, k, v, q_off, k_off, o, lse, bh, sq, sk, d, scale, causal, st);
}

// B8, dq pass. dd = rowsum(dO * O) and lse are float32 (BH, Sq).
int mlsl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, const int* q_off, const int* k_off,
                      void* dq, int bh, int sq, int sk, int d, float scale, int causal,
                      int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MLSL_DISPATCH(bwd_t, false, q, k, v, dout, lse, dd, q_off, k_off, dq, nullptr, bh, sq, sk,
                d, scale, causal, st);
}

// B8, dk/dv pass.
int mlsl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dd, const int* q_off,
                       const int* k_off, void* dk, void* dv, int bh, int sq, int sk, int d,
                       float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MLSL_DISPATCH(bwd_t, true, q, k, v, dout, lse, dd, q_off, k_off, dk, dv, bh, sq, sk, d,
                scale, causal, st);
}

// B9. acc (BH, Sq, D), m and l (BH, Sq), all float32, in and out; the outputs
// are separate buffers (the TPU kernel aliases them; the wrapper keeps the inputs
// for the backward).
int mlsl_flash_block_update(const void* q, const void* k, const void* v,
                            const float* acc_in, const float* m_in, const float* l_in,
                            const int* q_off, const int* k_off, float* acc_out,
                            float* m_out, float* l_out, int bh, int sq, int sk, int d,
                            float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MLSL_DISPATCH(fwd_carry, q, k, v, q_off, k_off, acc_in, m_in, l_in, acc_out, m_out, l_out,
                bh, sq, sk, d, scale, causal, st);
}

}  // extern "C"
