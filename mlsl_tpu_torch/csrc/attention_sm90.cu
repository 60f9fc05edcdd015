// Flash attention for Hopper tensor cores (sm_90a): the forward (B7) and both
// backward passes (B8) on bf16 wgmma tiles fed by TMA, built on sm90_tiles.cuh.
// Plain C interface, bound with ctypes by ops/attention_kernels.py, which picks
// this form for bf16 inputs with head_dim 64 or 128 (`kernel_form`).
//
// Replaces (mlsl_tpu/ops/attention_kernels.py), as a second design of the kernels
// that attention_kernels.cu ports on the CUDA cores:
//   mlsl_flash_fwd_sm90      B7 `_flash_fwd` (:154, body `_tile_accumulate` :88)
//   mlsl_flash_bwd_dq_sm90   B8 `_flash_bwd` (:297), dq pallas_call (:311, `_bwd_dq_kernel` :236)
//   mlsl_flash_bwd_dkv_sm90  B8 `_flash_bwd` (:297), dk/dv pallas_call (:335, `_bwd_dkv_kernel` :264)
//   mlsl_sm90_tile_test      one 64 x 64 x 64 product of the tile layer, for its own test
//
// Contract (that of attention_kernels.cu): q (BH, Sq, D), k/v (BH, Sk, D) bf16
// row-major, here with D 64 or 128 and Sq, Sk multiples of 128; int32 offsets per
// (b, h) row; s = (q.k) * scale, causal entries with k_pos > q_pos set to NEG =
// -1e30; p = 0 where s <= NEG/2, so a fully masked row gives output 0 and exact
// zero gradients; l floored at 1e-30; lse (BH, Sq) float32; dd = rowsum(dO * O)
// from the caller. Each block owns its output rows: no atomics, results repeat bit
// for bit.
//
// Rounding: the products Q K^T, dO V^T and V dO^T take bf16 inputs and sum in
// float32, as the reference does up to order. P (forward, dk/dv) and dS (dq, dk)
// are rounded to bf16 (nearest even) where they enter a product; the row sums l
// use P in float32. The plain versions reproduce this with p_dtype=bfloat16.
//
// Design. Blocks of NWG consumer warpgroups (64 rows of the side the pass owns
// each) and one producer warp whose first lane issues every TMA load. The owned
// tiles (Q, or Q and dO, or K and V) are loaded once; the other side streams in
// 64-row tiles through a ring of STAGES slots, each with a `full` barrier (TMA
// bytes) and an `empty` barrier (one arrival per consumer warp once its wgmma
// reads are done). Every product is wgmma m64n64k16 with float32 accumulators in
// registers: score-like products (Q K^T, dO V^T, K Q^T, V dO^T) read both
// operands K-major from shared memory (SS); the accumulating products (P V,
// dS K, P^T dO, dS^T Q) take the probabilities from registers (RS: the
// accumulator fragment is the A fragment, sm90_tiles.cuh) and B MN-major from
// the same swizzled tile. The online softmax (forward) and the recomputed P
// (backward) stay in registers; a row's statistics reduce over the 4 lanes that
// hold it. Under the causal mask whole tiles that the block's offsets hide are
// never loaded, a warpgroup skips a tile hidden from its own rows, and only the
// tiles that cross the diagonal are masked element by element. Blocks that own
// the most visible tiles are launched first.
//
// Element work. Scores stay raw until the exponent: P = 2^(s c - m) with c =
// scale log2 e is one FFMA and one ex2.approx per entry; a tile that does not
// cross the diagonal has no masked entry, tests none and underflows to exactly
// 0 where it must, so only crossing tiles select. The forward reduces a row's
// maximum over its 4 lanes each tile but its sum only once, at the end.
//
// Bound on an H100 SXM: operations on the bf16 tensor cores (989 TFLOP/s): 4 D
// per visible (q, k) pair in B7, 6 D in the dq pass, 8 D in dk/dv. At D = 64
// the element work weighs about as much as the products: one ex2 per 256
// operations of the forward, where an SM does 16 ex2 and 2,048 tensor-core
// operations a cycle, besides the FFMA, max and sum. Inside a warpgroup
// the softmax and the products run one after the other: the two warpgroups of
// a block and the second block an SM (B7 at D = 64 fits two in 112 registers
// a thread) are what overlap them. Computing tile i's scores during tile i -
// 1's P V (FlashAttention-3's in-warpgroup pipelining) was tried and lost: its
// extra registers leave one block an SM.

#include "sm90_tiles.cuh"

namespace {

using namespace sm90;

constexpr int STAGES = 4;                // slots of the ring
constexpr int PRODUCER = 32;          // threads of the producer warp
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 2^x on the special-function unit (flushes denormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(a[i]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Ring barriers: full[STAGES], empty[STAGES], then one for the owned tiles.
struct Bars {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t owned;
};

__device__ __forceinline__ void init_bars(Bars* b, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&b->full[s], 1);
      mbar_init(&b->empty[s], consumer_warps);
    }
    mbar_init(&b->owned, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer waits for slot i % STAGES to be free before its i-th fill.
__device__ __forceinline__ void wait_slot(Bars* b, int i) {
  if (i >= STAGES) mbar_wait(&b->empty[i % STAGES], ((i / STAGES) - 1) & 1);
}

// A consumer warp gives its slot back once its wgmma reads are complete.
__device__ __forceinline__ void release_slot(Bars* b, int i) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&b->empty[i % STAGES]);
}

// acc[0..NB) (+)= A B over a 64-deep reduction whose A is the four k-steps of
// `a` (registers) and whose B is NB MN-major tiles side by side along N.
template <int NB>
__device__ __forceinline__ void rs_product(float (&acc)[NB][32], const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<1>(acc[nb], a[kk], desc_mn(b + nb * TILE_BYTES, kk), 1);
}

// d = A B^T over D = 64 NB columns: A and B are NB K-major tiles each.
template <int NB>
__device__ __forceinline__ void ss_product(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<0>(d, desc_k(a + nb * TILE_BYTES, kk), desc_k(b + nb * TILE_BYTES, kk),
                (nb | kk) != 0);
}

template <int NB>
__device__ __forceinline__ void fence_all(float (&acc)[NB][32]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
}

// The element work of one tile, for this thread's two rows (row_pos, row_pos +
// 8) and its 16 columns (col_first + 8 j + c0 + e, j < 8, e < 2) of a 64 x 64
// score tile. MASK: the tile crosses the causal diagonal, so an entry whose key
// lies after its query is hidden (KEY_ROWS: the rows are keys, as in the dk/dv
// pass); tiles that do not cross it skip the test.
template <bool MASK, bool KEY_ROWS = false>
__device__ __forceinline__ bool hidden(int col_first, int row_pos, int j, int h, int e, int c0) {
  const int col = col_first + 8 * j + c0 + e, row = row_pos + 8 * h;
  return MASK && (KEY_ROWS ? row > col : col > row);
}

// B7's online softmax over the raw scores s = Q K^T. m2: the running row
// maxima of s * c (c = scale * log2 e; NEG while a row has seen no key); lp:
// this thread's share of the row sums. -> s holds P = 2^(s c - m2) in float32,
// corr the factor for what came before.
template <bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m2)[2], float (&lp)[2],
                                             float (&corr)[2], float c, int k_first, int q_row,
                                             int c0) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (MASK) x = hidden<MASK>(k_first, q_row, j, h, e, c0) ? NEG : x * c;
        mx[h] = fmaxf(mx[h], x);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // unmasked, max(s) c = max(s c): c > 0 and rounding is monotone
    const float m_new = fmaxf(m2[h], MASK ? quad_max(mx[h]) : quad_max(mx[h]) * c);
    corr[h] = ex2(m2[h] - m_new);
    m2[h] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        // a row with no key yet (m2 = NEG) must not turn its hidden NEGs into 1s
        x = MASK ? (x <= 0.5f * NEG ? 0.f : ex2(x - m2[h])) : ex2(fmaf(x, c, -m2[h]));
        ps[h] += x;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) lp[h] = lp[h] * corr[h] + ps[h];
}

// B8's recomputed P = 2^(s c - lse log2 e) (0 where hidden) into s, and dS =
// P (dP - dd) into dp. Each entry's lse and dd are those of its query: lse[h],
// dd[h] of row h in the dq pass (registers); lse[col], dd[col] of its column in
// the dk/dv pass (KEY_ROWS: shared memory, read where used).
template <bool MASK, bool KEY_ROWS>
__device__ __forceinline__ void ds_step(float (&s)[32], float (&dp)[32], const float* lse,
                                        const float* dd, float c, int col_first, int row_pos,
                                        int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * h + e, i = KEY_ROWS ? 8 * j + c0 + e : h;
        const float x = hidden<MASK, KEY_ROWS>(col_first, row_pos, j, h, e, c0)
                            ? 0.f : ex2(fmaf(s[r], c, -lse[i] * LOG2E));
        s[r] = x;
        dp[r] = x * (dp[r] - dd[i]);
      }
}

// -- B7 ---------------------------------------------------------------------------

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_off,
         const int* __restrict__ k_off, int sq, int sk, float scale, int causal,
         __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  constexpr int NB = D / 64, BM = 64 * NWG;
  constexpr uint32_t SLOT = 2 * NB * TILE_BYTES;      // K and V tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);                  // NWG x NB tiles
  uint8_t* sKV = sQ + NWG * NB * TILE_BYTES;          // STAGES slots
  Bars* bars = reinterpret_cast<Bars*>(sKV + STAGES * SLOT);

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int q0 = qt * BM, qo = q_off[bh], ko = k_off[bh];
  int n_kt = sk / 64;
  if (causal) {
    const int last = qo + q0 + BM - 1 - ko;          // last visible key position
    n_kt = last < 0 ? 0 : min(n_kt, last / 64 + 1);
  }
  init_bars(bars, 4 * NWG);

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {                                    // the producer warp
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(&bars->owned, NWG * NB * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int b = 0; b < NB; ++b)
          tma_load(sQ + (w * NB + b) * TILE_BYTES, &tq, &bars->owned, bh * sq + q0 + 64 * w,
                   64 * b);
      for (int i = 0; i < n_kt; ++i) {
        wait_slot(bars, i);
        uint64_t* full = &bars->full[i % STAGES];
        uint8_t* slot = sKV + (i % STAGES) * SLOT;
        mbar_expect_tx(full, SLOT);
        for (int b = 0; b < NB; ++b) {
          tma_load(slot + b * TILE_BYTES, &tk, full, bh * sk + 64 * i, 64 * b);
          tma_load(slot + (NB + b) * TILE_BYTES, &tv, full, bh * sk + 64 * i, 64 * b);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128, r0 = frag_row(t), c0 = frag_col(t);
  const int wg_q = qo + q0 + 64 * wg;                 // first query position of the warpgroup
  const int q_row = wg_q + r0;
  const uint8_t* myQ = sQ + wg * NB * TILE_BYTES;
  // this warpgroup's visible tiles are a prefix of the block's: the rest it
  // only waits for and gives back
  int n_my = n_kt;
  if (causal) {
    const int last = wg_q + 63 - ko;
    n_my = last < 0 ? 0 : min(n_kt, last / 64 + 1);
  }
  const float c = scale * LOG2E;
  float acc[NB][32], m2[2] = {NEG, NEG}, lp[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float s[32];
  uint32_t pa[4][4];
  auto slot = [&](int i) { return sKV + (i % STAGES) * SLOT; };
  auto softmax = [&](int i) {
    const int k_first = ko + 64 * i;
    if (causal && k_first + 63 > wg_q)
      softmax_step<true>(s, m2, lp, corr, c, k_first, q_row, c0);
    else
      softmax_step<false>(s, m2, lp, corr, c, k_first, q_row, c0);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[nb][4 * j + 2 * h] *= corr[h];
          acc[nb][4 * j + 2 * h + 1] *= corr[h];
        }
  };
  auto scores = [&](int i) {                          // S = Q K_i^T, issued
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    fence_all(acc);
    wg_fence();
    ss_product<NB>(s, myQ, slot(i));
    wg_commit();
  };
  auto pv = [&](int i) {                              // O += P V_i, issued
    rs_product<NB>(acc, pa, slot(i) + NB * TILE_BYTES);
    wg_commit();
  };
  auto done = [&](int i) {                            // every product waited for
    fence_all(acc);
    fence_frag(pa);
    release_slot(bars, i);
  };
  mbar_wait(&bars->owned, 0);

  for (int i = 0; i < n_my; ++i) {
    scores(i);
    wg_wait<0>();
    fence_regs(s);
    softmax(i);
    rescale();
    acc_to_a(s, pa);
    fence_all(acc);
    wg_fence();
    pv(i);
    wg_wait<0>();
    done(i);
  }
  for (int i = n_my; i < n_kt; ++i) {               // tiles hidden from this warpgroup
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    release_slot(bars, i);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(lp[h]), 1e-30f);
    const long row = (long)bh * sq + q0 + 64 * wg + r0 + 8 * h;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(o + row * D + 64 * nb + 8 * j + c0, acc[nb][4 * j + 2 * h] / denom,
                   acc[nb][4 * j + 2 * h + 1] / denom);
    if (lse != nullptr && (t & 3) == 0)
      lse[row] = (m2[h] == NEG ? NEG : m2[h] * LN2) + logf(denom);
  }
}

// -- B8, dq pass -------------------------------------------------------------------

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ dd,
        const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
        float scale, int causal, __nv_bfloat16* __restrict__ dq) {
  constexpr int NB = D / 64, BM = 64 * NWG;
  constexpr uint32_t SLOT = 2 * NB * TILE_BYTES;      // K and V tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);                  // NWG x NB tiles
  uint8_t* sO = sQ + NWG * NB * TILE_BYTES;           // dO, NWG x NB tiles
  uint8_t* sKV = sO + NWG * NB * TILE_BYTES;
  Bars* bars = reinterpret_cast<Bars*>(sKV + STAGES * SLOT);

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BM, qo = q_off[bh], ko = k_off[bh];
  int n_kt = sk / 64;
  if (causal) {
    const int last = qo + q0 + BM - 1 - ko;
    n_kt = last < 0 ? 0 : min(n_kt, last / 64 + 1);
  }
  init_bars(bars, 4 * NWG);

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(&bars->owned, 2 * NWG * NB * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_load(sQ + (w * NB + b) * TILE_BYTES, &tq, &bars->owned, bh * sq + q0 + 64 * w,
                   64 * b);
          tma_load(sO + (w * NB + b) * TILE_BYTES, &tdo, &bars->owned, bh * sq + q0 + 64 * w,
                   64 * b);
        }
      for (int i = 0; i < n_kt; ++i) {
        wait_slot(bars, i);
        uint64_t* full = &bars->full[i % STAGES];
        uint8_t* slot = sKV + (i % STAGES) * SLOT;
        mbar_expect_tx(full, SLOT);
        for (int b = 0; b < NB; ++b) {
          tma_load(slot + b * TILE_BYTES, &tk, full, bh * sk + 64 * i, 64 * b);
          tma_load(slot + (NB + b) * TILE_BYTES, &tv, full, bh * sk + 64 * i, 64 * b);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128, r0 = frag_row(t), c0 = frag_col(t);
  const int wg_q = qo + q0 + 64 * wg;
  const int q_row = wg_q + r0;
  const long row0 = (long)bh * sq + q0 + 64 * wg + r0;
  const uint8_t* myQ = sQ + wg * NB * TILE_BYTES;
  const uint8_t* myO = sO + wg * NB * TILE_BYTES;
  const float c = scale * LOG2E;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse[row0 + 8 * h];
    dd_r[h] = dd[row0 + 8 * h];
  }
  int n_my = n_kt;
  if (causal) {
    const int last = wg_q + 63 - ko;
    n_my = last < 0 ? 0 : min(n_kt, last / 64 + 1);
  }
  float acc[NB][32], s[32], dp[32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  uint32_t da[4][4];
  auto slot = [&](int i) { return sKV + (i % STAGES) * SLOT; };
  auto scores = [&](int i) {                          // S = Q K_i^T, dP = dO V_i^T, issued
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    fence_all(acc);
    wg_fence();
    ss_product<NB>(s, myQ, slot(i));
    ss_product<NB>(dp, myO, slot(i) + NB * TILE_BYTES);
    wg_commit();
  };
  auto grads = [&](int i) {                           // dS -> bf16 A fragments
    fence_regs(s);
    fence_regs(dp);
    const int k_first = ko + 64 * i;
    if (causal && k_first + 63 > wg_q)
      ds_step<true, false>(s, dp, lse_r, dd_r, c, k_first, q_row, c0);
    else
      ds_step<false, false>(s, dp, lse_r, dd_r, c, k_first, q_row, c0);
  };
  auto dsk = [&](int i) {                             // dQ += dS K_i (K read MN-major), issued
    rs_product<NB>(acc, da, slot(i));
    wg_commit();
  };
  auto done = [&](int i) {
    fence_all(acc);
    fence_frag(da);
    release_slot(bars, i);
  };
  mbar_wait(&bars->owned, 0);

  for (int i = 0; i < n_my; ++i) {
    scores(i);
    wg_wait<0>();
    grads(i);
    acc_to_a(dp, da);
    fence_all(acc);
    wg_fence();
    dsk(i);
    wg_wait<0>();
    done(i);
  }
  for (int i = n_my; i < n_kt; ++i) {
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    release_slot(bars, i);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(dq + (row0 + 8 * h) * D + 64 * nb + 8 * j + c0,
                   scale * acc[nb][4 * j + 2 * h], scale * acc[nb][4 * j + 2 * h + 1]);
}

// -- B8, dk/dv pass ----------------------------------------------------------------

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
         const float* __restrict__ lse, const float* __restrict__ dd,
         const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
         float scale, int causal, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv) {
  constexpr int NB = D / 64, BN = 64 * NWG;
  // a slot: Q and dO tiles, then the 64 lse and 64 dd values of their rows
  constexpr uint32_t TILES = 2 * NB * TILE_BYTES, SLOT = TILES + 1024;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);                  // NWG x NB tiles
  uint8_t* sV = sK + NWG * NB * TILE_BYTES;
  uint8_t* sQO = sV + NWG * NB * TILE_BYTES;
  Bars* bars = reinterpret_cast<Bars*>(sQO + STAGES * SLOT);

  const int bh = blockIdx.x, kt = blockIdx.y;         // heaviest (first keys) first
  const int k0 = kt * BN, qo = q_off[bh], ko = k_off[bh];
  const int n_qt = sq / 64;
  int qt_first = 0;
  if (causal) {                                       // first query tile with a row at or after k0
    const int need = ko + k0 - qo - 63;
    qt_first = need <= 0 ? 0 : min(n_qt, (need + 63) / 64);
  }
  const int n_it = n_qt - qt_first;
  init_bars(bars, 4 * NWG);

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(&bars->owned, 2 * NWG * NB * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_load(sK + (w * NB + b) * TILE_BYTES, &tk, &bars->owned, bh * sk + k0 + 64 * w,
                   64 * b);
          tma_load(sV + (w * NB + b) * TILE_BYTES, &tv, &bars->owned, bh * sk + k0 + 64 * w,
                   64 * b);
        }
      for (int i = 0; i < n_it; ++i) {
        wait_slot(bars, i);
        uint64_t* full = &bars->full[i % STAGES];
        uint8_t* slot = sQO + (i % STAGES) * SLOT;
        const long qrow = (long)bh * sq + 64 * (qt_first + i);
        mbar_expect_tx(full, TILES + 512);
        for (int b = 0; b < NB; ++b) {
          tma_load(slot + b * TILE_BYTES, &tq, full, (int)qrow, 64 * b);
          tma_load(slot + (NB + b) * TILE_BYTES, &tdo, full, (int)qrow, 64 * b);
        }
        bulk_load(slot + TILES, lse + qrow, 256, full);
        bulk_load(slot + TILES + 256, dd + qrow, 256, full);
      }
    }
    return;
  }

  const int t = threadIdx.x % 128, r0 = frag_row(t), c0 = frag_col(t);
  const int wg_k = ko + k0 + 64 * wg;                 // first key position of the warpgroup
  const uint8_t* myK = sK + wg * NB * TILE_BYTES;
  const uint8_t* myV = sV + wg * NB * TILE_BYTES;
  const float c = scale * LOG2E;
  float gk[NB][32], gv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[nb][i] = gv[nb][i] = 0.f;
  // the query tiles hidden from this warpgroup's keys are a prefix of the block's
  int n_skip = 0;
  if (causal) {
    const int need = wg_k - qo - 63;
    n_skip = min(n_it, max(0, (need <= 0 ? 0 : (need + 63) / 64) - qt_first));
  }
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];
  auto slot = [&](int i) { return sQO + (i % STAGES) * SLOT; };
  auto scores = [&](int i) {                          // S^T = K Q_i^T, dP^T = V dO_i^T, issued
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    fence_all(gv);
    fence_all(gk);
    wg_fence();
    ss_product<NB>(st, myK, slot(i));
    ss_product<NB>(dpt, myV, slot(i) + NB * TILE_BYTES);
    wg_commit();
  };
  auto grads = [&](int i) {                           // P^T into st, dS^T into dpt
    fence_regs(st);
    fence_regs(dpt);
    const float* sL = reinterpret_cast<const float*>(slot(i) + TILES);   // lse, then dd
    const int q_first = qo + 64 * (qt_first + i);
    if (causal && wg_k + 63 > q_first)
      ds_step<true, true>(st, dpt, sL, sL + 64, c, q_first, wg_k + r0, c0);
    else
      ds_step<false, true>(st, dpt, sL, sL + 64, c, q_first, wg_k + r0, c0);
  };
  auto convert = [&]() {
    acc_to_a(st, pa);
    acc_to_a(dpt, da);
  };
  auto update = [&](int i) {                          // dV += P^T dO_i, dK += dS^T Q_i, issued
    rs_product<NB>(gv, pa, slot(i) + NB * TILE_BYTES);
    rs_product<NB>(gk, da, slot(i));
    wg_commit();
  };
  auto done = [&](int i) {
    fence_all(gv);
    fence_all(gk);
    fence_frag(pa);
    fence_frag(da);
    release_slot(bars, i);
  };
  mbar_wait(&bars->owned, 0);
  for (int i = 0; i < n_skip; ++i) {
    mbar_wait(&bars->full[i % STAGES], (i / STAGES) & 1);
    release_slot(bars, i);
  }

  for (int i = n_skip; i < n_it; ++i) {
    scores(i);
    wg_wait<0>();
    grads(i);
    convert();
    fence_all(gv);
    fence_all(gk);
    wg_fence();
    update(i);
    wg_wait<0>();
    done(i);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = (long)bh * sk + k0 + 64 * wg + r0 + 8 * h;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + c0;
        store_pair(dk + row * D + col, scale * gk[nb][4 * j + 2 * h],
                   scale * gk[nb][4 * j + 2 * h + 1]);
        store_pair(dv + row * D + col, gv[nb][4 * j + 2 * h], gv[nb][4 * j + 2 * h + 1]);
      }
  }
}

// -- the tile layer's own test -------------------------------------------------------

// mode 0: C = A B1^T (SS, B K-major); 1: C = A B1 (SS, B MN-major);
// 2: C = bf16(A B1^T) B2 (SS, then RS with B MN-major); 3: C = bf16(A B1^T) B2^T
// (RS with B K-major). A, B1, B2, 64 x 64 bf16; C 64 x 64 float32.
__global__ void __launch_bounds__(128)
tile_test_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb1,
                 const __grid_constant__ CUtensorMap tb2, float* __restrict__ c, int mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align1024(smem_raw);
  uint8_t* sB1 = sA + TILE_BYTES;
  uint8_t* sB2 = sB1 + TILE_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB2 + TILE_BYTES);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * TILE_BYTES);
    tma_load(sA, &ta, bar, 0, 0);
    tma_load(sB1, &tb1, bar, 0, 0);
    tma_load(sB2, &tb2, bar, 0, 0);
  }
  mbar_wait(bar, 0);

  float d[32];
  wg_fence();
  if (mode == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss<1>(d, desc_k(sA, kk), desc_mn(sB1, kk), kk != 0);
  } else {
    ss_product<1>(d, sA, sB1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
  if (mode >= 2) {
    uint32_t a[4][4];
    acc_to_a(d, a);
    float e[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (mode == 2)
        mma_rs<1>(e, a[kk], desc_mn(sB2, kk), kk != 0);
      else
        mma_rs<0>(e, a[kk], desc_k(sB2, kk), kk != 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(e);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = e[i];
  }
  const int t = threadIdx.x, r0 = frag_row(t), c0 = frag_col(t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* out = c + (r0 + 8 * h) * 64 + 8 * j + c0;
      out[0] = d[4 * j + 2 * h];
      out[1] = d[4 * j + 2 * h + 1];
    }
}

// -- host ----------------------------------------------------------------------------

constexpr size_t BARS_BYTES = 1024 + 128;    // alignment slack and the barriers

template <int D, int NWG>
size_t fwd_smem() { return (size_t)(NWG + 2 * STAGES) * (D / 64) * TILE_BYTES + BARS_BYTES; }
template <int D, int NWG>
size_t dq_smem() { return (size_t)(2 * NWG + 2 * STAGES) * (D / 64) * TILE_BYTES + BARS_BYTES; }
template <int D, int NWG>
size_t dkv_smem() {
  return (size_t)(2 * NWG + 2 * STAGES) * (D / 64) * TILE_BYTES + STAGES * 1024 + BARS_BYTES;
}

template <typename K>
int prep(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

struct Maps {
  CUtensorMap q, k, v, o;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int bh,
              int sq, int sk, int d) {
  int rc = make_map(&m->q, q, (uint64_t)bh * sq, d);
  if (!rc) rc = make_map(&m->k, k, (uint64_t)bh * sk, d);
  if (!rc) rc = make_map(&m->v, v, (uint64_t)bh * sk, d);
  if (!rc && dout != nullptr) rc = make_map(&m->o, dout, (uint64_t)bh * sq, d);
  return rc;
}

// Each pass: D = 64 with two consumer warpgroups; D = 128 with two for B7 and
// dq and one for dk/dv, whose two D-wide float32 accumulators leave no room for
// a second warpgroup's registers.
template <int D>
int fwd_t(const Maps& m, const int* qo, const int* ko, void* o, float* lse, int bh, int sq,
          int sk, float scale, int causal, cudaStream_t st) {
  constexpr int NWG = 2;
  auto kern = fwd_sm90<D, NWG>;
  const size_t smem = fwd_smem<D, NWG>();
  int rc = prep(kern, smem);
  if (rc) return rc;
  kern<<<dim3(bh, sq / (64 * NWG)), NWG * 128 + PRODUCER, smem, st>>>(
      m.q, m.k, m.v, qo, ko, sq, sk, scale, causal, (__nv_bfloat16*)o, lse);
  return (int)cudaGetLastError();
}

template <int D>
int dq_t(const Maps& m, const float* lse, const float* dd, const int* qo, const int* ko,
         void* dq, int bh, int sq, int sk, float scale, int causal, cudaStream_t st) {
  constexpr int NWG = 2;
  auto kern = dq_sm90<D, NWG>;
  const size_t smem = dq_smem<D, NWG>();
  int rc = prep(kern, smem);
  if (rc) return rc;
  kern<<<dim3(bh, sq / (64 * NWG)), NWG * 128 + PRODUCER, smem, st>>>(
      m.q, m.k, m.v, m.o, lse, dd, qo, ko, sq, sk, scale, causal, (__nv_bfloat16*)dq);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_t(const Maps& m, const float* lse, const float* dd, const int* qo, const int* ko,
          void* dk, void* dv, int bh, int sq, int sk, float scale, int causal,
          cudaStream_t st) {
  constexpr int NWG = D == 64 ? 2 : 1;
  auto kern = dkv_sm90<D, NWG>;
  const size_t smem = dkv_smem<D, NWG>();
  int rc = prep(kern, smem);
  if (rc) return rc;
  kern<<<dim3(bh, sk / (64 * NWG)), NWG * 128 + PRODUCER, smem, st>>>(
      m.q, m.k, m.v, m.o, lse, dd, qo, ko, sq, sk, scale, causal, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv);
  return (int)cudaGetLastError();
}

bool shapes_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh > 0 && sq > 0 && sk > 0 && sq % 128 == 0 && sk % 128 == 0 && (d == 64 || d == 128) &&
         dtype == 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// B7. o (BH, Sq, D) bf16; lse (BH, Sq) float32, or null to skip it. dtype must
// be 1 (bfloat16).
int mlsl_flash_fwd_sm90(const void* q, const void* k, const void* v, const int* q_off,
                        const int* k_off, void* o, float* lse, int bh, int sq, int sk, int d,
                        float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  Maps m;
  int rc = make_maps(&m, q, k, v, nullptr, bh, sq, sk, d);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? fwd_t<64>(m, q_off, k_off, o, lse, bh, sq, sk, scale, causal, st)
                 : fwd_t<128>(m, q_off, k_off, o, lse, bh, sq, sk, scale, causal, st);
}

// B8, dq pass. lse and dd = rowsum(dO * O) are float32 (BH, Sq).
int mlsl_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, const int* q_off,
                           const int* k_off, void* dq, int bh, int sq, int sk, int d,
                           float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  Maps m;
  int rc = make_maps(&m, q, k, v, dout, bh, sq, sk, d);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? dq_t<64>(m, lse, dd, q_off, k_off, dq, bh, sq, sk, scale, causal, st)
                 : dq_t<128>(m, lse, dd, q_off, k_off, dq, bh, sq, sk, scale, causal, st);
}

// B8, dk/dv pass. lse and dd must be 16-byte aligned: their rows travel by bulk copy.
int mlsl_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, const int* q_off,
                            const int* k_off, void* dk, void* dv, int bh, int sq, int sk,
                            int d, float scale, int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  if (!aligned16(lse) || !aligned16(dd)) return (int)cudaErrorMisalignedAddress;
  Maps m;
  int rc = make_maps(&m, q, k, v, dout, bh, sq, sk, d);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? dkv_t<64>(m, lse, dd, q_off, k_off, dk, dv, bh, sq, sk, scale, causal, st)
                 : dkv_t<128>(m, lse, dd, q_off, k_off, dk, dv, bh, sq, sk, scale, causal, st);
}

// The tile layer's test: one 64 x 64 x 64 product (see tile_test_kernel).
int mlsl_sm90_tile_test(const void* a, const void* b1, const void* b2, float* c, int mode,
                        void* stream) {
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb1, tb2;
  int rc = make_map(&ta, a, 64, 64);
  if (!rc) rc = make_map(&tb1, b1, 64, 64);
  if (!rc) rc = make_map(&tb2, b2, 64, 64);
  if (rc) return rc;
  const size_t smem = 3 * TILE_BYTES + BARS_BYTES;
  rc = prep(tile_test_kernel, smem);
  if (rc) return rc;
  tile_test_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(ta, tb1, tb2, c, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
